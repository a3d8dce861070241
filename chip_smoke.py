#!/usr/bin/env python3
"""Smoke run of brpc_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --peer`` is the second process of phase 6; the
script starts it itself.)

It drives the port's main path through the entry points a user calls and
fails (non-zero exit, no result line) when any phase fails, when CUDA is
unavailable, or when the port is not beside it:

1. card   — the card's name and power limit, from nvidia-smi; every time,
            rate and size printed below carries them;
2. serve  — a TensorStore server on 127.0.0.1:0. (a) A device channel:
            handshake ESTABLISHED, same process, so the in-process lane
            hands the pushed tensors back as the same storage. (b) A plain
            channel: the wire lane, float32/bfloat16/int32 at 8 KB-8 MB,
            pulled onto the card; byte-identical, the <= 2 MB ones through
            DeviceBlockPool, and none aliasing a block refilled since;
3. forward — the flagship forward at the widest configuration the
            reference runs (its bench's "big" model, bf16, 4 x 512 tokens),
            random weights from a seed, on the token batch pulled in 2b;
4. card against CPU — the same weights at full width, one layer, fp32,
            on the card and on the CPU;
5. kernels — the JAX package has no Pallas kernel, so none is ported;
6. serve across processes — a TensorStore server on the card in a second
            process (``--peer``). Float32/bfloat16/int32 at 8 KiB and 2 MiB,
            the flagship's [4, 512, 2048] bfloat16 activations (8 MiB) and a
            64 MiB bfloat16 tensor go there and back by three lanes: wire (a
            plain channel), shm (a device channel: one copy into a
            page-locked shared arena, a descriptor on the wire) and xfer
            (device_transport_prefer_xfer set in both processes: CUDA IPC,
            device to device). Each pull lands on the card byte-identical;
            shm and xfer carry 0 attachment bytes; lane counters, retention,
            window and arena spans return to rest on both sides; a write to
            the producer's tensor after the ACK leaves the consumer's copy
            as it was; neither process leaks card memory. The peer is
            always stopped;
7. train  — the SPMD train step on the card, each run in a spawned rank
            on NCCL (world 1: one card, every mesh axis 1). (a) The dry run
            ``dryrun_multichip(1)``: forward parity, then four SGD steps
            whose loss must fall. (b) One train step of the tests' small
            fp32 config on the card and on the CPU (gloo) from the same
            parameters, TF32 off: the loss and every updated leaf within a
            stated bound. (c) The full-width train step of the reference's
            bench (the "big" model, bf16, 4 x 512 tokens, lr 1e-2): median
            step time by CUDA events, steps/s, tokens/s, peak memory, and
            the share of the bf16 bound by two FLOP counts; the loss finite
            at every step.

The last line is the result: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import select
import statistics
import subprocess
import sys
import time

import torch

from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.entry import dryrun_multichip
from brpc_tpu_torch.parallel import run_ranks
from brpc_tpu_torch.parallel.world import tensors_to_numpy
from brpc_tpu_torch.rpc import Channel, Controller, Server, ServerOptions
from brpc_tpu_torch.rpc import cuda_ipc_transfer
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.service import Service, rpc_method
from brpc_tpu_torch.rpc.tensor_service import (
    TensorClient,
    TensorStoreService,
    make_device_channel,
)
from brpc_tpu_torch.tensor import ModelConfig, forward_local, init_params
from brpc_tpu_torch.tensor.config import MeshSpec
from brpc_tpu_torch.tensor.model import make_spmd_train_step, params_from_numpy

# brpc_tpu/bench.py's "big" model: the widest configuration the repo runs
BIG = ModelConfig(vocab=32768, d_model=2048, n_heads=16, d_head=128,
                  d_ff=8192, n_layers=8, n_experts=2,
                  expert_capacity_factor=1.25, dtype="bfloat16")
BATCH, SEQ = 4, 512
ROUNDS = 5  # push/pull rounds per tensor on the wire lane
FWD_WARMUP, FWD_RUNS = 2, 7
# Phase 4: max |logit| difference, card vs CPU, fp32 without TF32. The two
# sides sum in different orders; fp32 keeps ~7 digits on O(1) logits. The
# difference on an NVIDIA H100 80GB HBM3 (700 W) was 1.3e-5 with max
# |logit| 5.2; 1e-4 leaves a 7x margin.
CARD_VS_CPU_ATOL = 1e-4


# Phase 7b: the tests' small fp32 config (tests/test_tensor_model.py CFG),
# one step at lr 0.1, card vs CPU, TF32 off. The bounds are the ones the
# CPU tests hold the port to against the JAX package: the loss within 1e-4
# and every updated leaf within 1e-5 (fp32 sums at most 64 deep on O(1)
# values; lr 0.1 times gradients that agree to fp32 rounding).
SMALL = ModelConfig(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=32,
                    n_layers=1, n_experts=4, expert_capacity_factor=4.0,
                    dtype="float32")
SMALL_LR = 0.1
TRAIN_LOSS_ATOL, TRAIN_LEAF_ATOL = 1e-4, 1e-5
# Phase 7c: the reference bench's training row (brpc_tpu/bench.py:2234-2244)
BIG_LR = 1e-2
TRAIN_WARMUP, TRAIN_STEPS = 2, 12


# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """FLOPs of forward_local by part, from the shapes (2 per multiply-add):
    the dense one-hot dispatch/combine einsums run over every token, expert
    and capacity slot, as in the reference."""
    n = batch * seq
    slots = cfg.n_experts * max(1, int(cfg.expert_capacity_factor * n
                                       / cfg.n_experts))
    per_layer = {
        "qkv+o": 2 * n * cfg.d_model * cfg.d_qkv * 4,
        "attention": 2 * 2 * batch * cfg.n_heads * seq * seq * cfg.d_head,
        "router": 2 * n * cfg.d_model * cfg.n_experts,
        "dispatch+combine": 2 * 2 * n * slots * cfg.d_model,
        "experts": 2 * 2 * slots * cfg.d_model * cfg.d_ff,
    }
    parts = {k: v * cfg.n_layers for k, v in per_layer.items()}
    parts["unembed"] = 2 * n * cfg.d_model * cfg.vocab
    return parts


def reference_train_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """brpc_tpu/bench.py:2239-2244: 3 x the forward's model matmuls (the
    one-hot dispatch/combine not counted)."""
    d, dq, L = cfg.d_model, cfg.d_qkv, cfg.n_layers
    fwd_per_tok = (L * (2 * 4 * d * dq + 2 * 2 * seq * dq
                        + 2 * 2 * d * cfg.d_ff) + 2 * d * cfg.vocab)
    return 3.0 * fwd_per_tok * batch * seq


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def u8(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_inproc(endpoint: str, tag: str, gen):
    dev = torch.device("cuda")
    ch = make_device_channel(endpoint)
    try:
        client = TensorClient(ch)
        tokens = torch.randint(0, BIG.vocab, (BATCH, SEQ), dtype=torch.int32,
                               device=dev, generator=gen)
        act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                          device=dev, generator=gen)
        for name, x in (("tokens", tokens), ("act", act)):
            rtts = []
            for _ in range(ROUNDS):
                t0 = time.perf_counter()
                cntl, resp = client.push(name, [x])
                check(not cntl.failed() and resp.ok,
                      f"inproc push {name}: {cntl.error_text}")
                cntl, got = client.pull(name)
                rtts.append(time.perf_counter() - t0)
                check(not cntl.failed(), f"inproc pull {name}: {cntl.error_text}")
                spec = cntl._response_rpc_meta.tensors[0].sharding_spec
                check(spec.startswith("inproc:"), f"{name} took lane {spec}")
                check(got[0].data_ptr() == x.data_ptr(),
                      f"{name}: in-process pull is not the same storage")
            ep = cntl._current_sock.app_state
            check(ep.state == dt.ESTABLISHED and ep.same_process,
                  "device channel not ESTABLISHED in process")
            nbytes = x.numel() * x.element_size()
            print(f"serve/inproc {name} {x.dtype} {list(x.shape)} "
                  f"{nbytes} B: same storage (data_ptr {x.data_ptr():#x}), "
                  f"median push+pull {statistics.median(rtts) * 1e3:.3f} ms "
                  f"{tag}")
    finally:
        ch.close()


def phase_wire(endpoint: str, tag: str, gen):
    """Returns the token batch as pulled onto the card."""
    dev = torch.device("cuda")
    ch = Channel()
    check(ch.init(endpoint) == 0, "plain channel init")
    pool = dt.default_block_pool(dev)
    sizes = (("8KB", 8 << 10), ("64KB", 64 << 10), ("2MB", 2 << 20),
             ("8MB", 8 << 20))
    cases = []
    for label, nbytes in sizes:
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            n = nbytes // dt.DTYPES[dt.dtype_name(dtype)][1]
            if dtype == torch.int32 and nbytes == 8 << 10:
                # the token batch the forward consumes
                x = torch.randint(0, BIG.vocab, (BATCH, SEQ),
                                  dtype=torch.int32, device=dev,
                                  generator=gen)
            elif dtype == torch.int32:
                x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,),
                                  dtype=torch.int32, device=dev,
                                  generator=gen)
            else:
                x = torch.randn((n,), dtype=dtype, device=dev, generator=gen)
            cases.append((label, nbytes, dtype, x))
    try:
        client = TensorClient(ch)
        kept = []  # round-0 pooled results, checked again after refills
        acquired0 = pool.acquired
        tokens = None
        for label, nbytes, dtype, x in cases:
            name = f"{label}-{dt.dtype_name(dtype)}"
            rtts = []
            for r in range(ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cntl, resp = client.push(name, [x])
                check(not cntl.failed() and resp.ok,
                      f"wire push {name}: {cntl.error_text}")
                cntl, got = client.pull(name, device=dev)
                torch.cuda.synchronize()
                rtts.append(time.perf_counter() - t0)
                check(not cntl.failed(), f"wire pull {name}: {cntl.error_text}")
                spec = cntl._response_rpc_meta.tensors[0].sharding_spec
                check(spec.startswith("wire::"), f"{name} took lane {spec}")
                y = got[0]
                check(y.device.type == dev.type and y.dtype == dtype and y.shape == x.shape,
                      f"{name}: pulled {y.dtype} {tuple(y.shape)} on {y.device}")
                check(torch.equal(u8(y), u8(x)), f"{name}: bytes differ")
                check(y.data_ptr() != x.data_ptr(), f"{name}: wire result aliases the source")
                if r == 0 and nbytes <= dt.DeviceBlockPool.SIZE_CLASSES[-1]:
                    kept.append((name, x, y))
            if label == "8KB" and dtype == torch.int32:
                tokens = y
            med = statistics.median(rtts)
            print(f"serve/wire {name}: {nbytes} B byte-identical x{ROUNDS}, "
                  f"median push+pull {med * 1e3:.3f} ms, "
                  f"{2 * nbytes / med / 1e9:.3f} GB/s {tag}")
        n_pooled = sum(1 for c in cases
                       if c[1] <= dt.DeviceBlockPool.SIZE_CLASSES[-1])
        took = pool.acquired - acquired0
        check(took == n_pooled * ROUNDS,
              f"pool handed out {took} blocks, expected {n_pooled * ROUNDS}")
        check(pool.released == pool.acquired, "pool blocks not returned")
        for name, x, y in kept:
            check(torch.equal(u8(y), u8(x)),
                  f"{name}: a pooled result changed after its block was refilled")
        print(f"serve/wire pool: {took} landings through DeviceBlockPool "
              f"(<= 2 MB payloads), {len(kept)} round-0 results unchanged "
              f"after {ROUNDS - 1} refills of their blocks; 8 MB payloads "
              f"went by plain .to(device) {tag}")
        return tokens
    finally:
        ch.close()


def phase_forward(tokens: torch.Tensor, tag: str):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(BIG, gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    logits = forward_local(params, tokens, BIG)
    torch.cuda.synchronize()
    check(logits.dtype == torch.float32
          and tuple(logits.shape) == (BATCH, SEQ, BIG.vocab),
          f"logits {logits.dtype} {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    for _ in range(FWD_WARMUP):
        forward_local(params, tokens, BIG)
    times = []
    for _ in range(FWD_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward_local(params, tokens, BIG)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    parts = forward_flops(BIG, BATCH, SEQ)
    flops = sum(parts.values())
    # bytes: every weight read once, tokens in, logits out
    nbytes = (sum(t.numel() * t.element_size() for t in _leaves(params))
              + tokens.numel() * tokens.element_size()
              + logits.numel() * logits.element_size())
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    print(f"forward work: {flops / 1e9:.1f} GFLOP ("
          + ", ".join(f"{k} {v / 1e9:.1f}" for k, v in parts.items())
          + f"), {nbytes / 1e9:.3f} GB moved at least; bound "
          f"{max(bound_ops, bound_bytes):.3f} ms by "
          f"{'operations' if bound_ops >= bound_bytes else 'bytes'} "
          f"(989 TFLOP/s bf16, 3.35 TB/s); achieved "
          f"{flops / ms / 1e9:.1f} TFLOP/s, "
          f"{max(bound_ops, bound_bytes) / ms:.1%} of the bound {tag}")
    print(f"forward: {BIG} params={n_params} "
          f"logits float32{list(logits.shape)} finite; median of {FWD_RUNS} "
          f"(CUDA events) {ms:.3f} ms, {BATCH * SEQ / ms * 1e3:.1f} tokens/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"{tag}")
    del params, logits


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _to(tree, dev):
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, dev) for x in tree))
    return tree.to(dev)


def phase_card_vs_cpu(tag: str):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(BIG, n_layers=1, dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 128), dtype=torch.int32,
                           generator=gen)
    want = forward_local(params, tokens, cfg)
    got = forward_local(_to(params, "cuda"), tokens.cuda(), cfg).cpu()
    err = float((got - want).abs().max())
    print(f"card-vs-cpu: full widths, 1 layer, B1xT128, fp32 (no TF32): "
          f"max |logit| diff {err:.3e} (tolerance {CARD_VS_CPU_ATOL:g}, "
          f"max |logit| {float(want.abs().max()):.3f}) {tag}")
    check(err <= CARD_VS_CPU_ATOL, f"card vs CPU error {err} > {CARD_VS_CPU_ATOL}")


# -- phase 6: serve across processes -----------------------------------------

PREFER_XFER = "device_transport_prefer_xfer"
XROUNDS = 7  # push + pull + ACK rounds per payload and lane (median)
PEER_READY_S = 180
LANE_PREFIX = {"wire": "wire::", "shm": "shm:", "xfer": "xfer|"}


class SmokePeer(Service):
    """The peer's side door for the checks: set the prefer-xfer flag,
    overwrite a stored tensor in place, clear the store, and report the
    state of the calling connection's endpoint, the lanes, the arena and
    card memory (as JSON in the response attachment)."""

    def __init__(self, store: TensorStoreService):
        self.store = store

    @rpc_method(wire.TensorPullRequest, wire.TensorAckResponse)
    def Control(self, cntl, request, response, done):
        cmd = json.loads(request.name)
        if cmd["op"] == "flag":
            check(flags.set_flag(PREFER_XFER, bool(cmd["on"])), "set flag")
        elif cmd["op"] == "scribble":
            for t in self.store.get(cmd["name"]):
                u8(t).bitwise_not_()  # in place: stored tensors are contiguous
        elif cmd["op"] == "reset":
            with self.store._lock:
                self.store._store.clear()
        torch.cuda.synchronize()
        ep = cntl._server_socket.app_state
        arena = dt.default_send_arena()
        server = dt._global_xfer_server()
        state = {
            "lanes": dt.lane_counters(),
            "retained": ep.retained_count if ep is not None else 0,
            "inflight": ep.inflight_bytes if ep is not None else 0,
            "arena_free": arena.free_bytes(), "arena_size": arena.size,
            "arena_pinned": arena.pinned,
            "attached_pinned": {n: a.pinned
                                for n, a in dt._attached_arenas.items()},
            "published": server.published_count() if server else 0,
            "memory_allocated": torch.cuda.memory_allocated(),
        }
        cntl.response_attachment.append(json.dumps(state).encode())
        response.ok = True
        done()


def peer_main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke --peer: CUDA is not available", file=sys.stderr)
        return 2
    store = TensorStoreService()
    srv = Server(ServerOptions())
    check(srv.add_service(store) == 0, "peer add_service")
    check(srv.add_service(SmokePeer(store)) == 0, "peer add_service")
    check(srv.start("127.0.0.1:0") == 0, "peer server start")
    print(f"peer ready {srv.listen_endpoint.port}", flush=True)
    sys.stdin.readline()  # the parent closes stdin to stop us
    srv.stop()
    return 0


def start_peer():
    """The peer in a fresh interpreter (never a fork after CUDA started);
    returns (process, port). Fails when it prints no ready line."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--peer"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=here)
    ready, _, _ = select.select([proc.stdout], [], [], PEER_READY_S)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("peer ready "):
        stop_peer(proc)
        raise RuntimeError(f"chip_smoke: the peer printed no ready line "
                           f"({line!r}, exit code {proc.returncode})")
    return proc, int(line.split()[2])


def stop_peer(proc) -> int:
    try:
        proc.stdin.close()
    except OSError:
        pass
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return -9


def peer_control(ch, op: str, **kw) -> dict:
    cntl = Controller()
    cntl.timeout_ms = 60000
    ch.call_method("SmokePeer.Control", cntl,
                   wire.TensorPullRequest(name=json.dumps({"op": op, **kw})),
                   wire.TensorAckResponse())
    check(not cntl.failed(), f"peer control {op}: {cntl.error_text}")
    return json.loads(cntl.response_attachment.to_bytes())


def cross_payloads(gen):
    dev = torch.device("cuda")
    out = []
    for label, nbytes in (("8KiB", 8 << 10), ("2MiB", 2 << 20)):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            n = nbytes // dt.DTYPES[dt.dtype_name(dtype)][1]
            if dtype == torch.int32:
                x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,),
                                  dtype=dtype, device=dev, generator=gen)
            else:
                x = torch.randn((n,), dtype=dtype, device=dev, generator=gen)
            out.append((f"{label}-{dt.dtype_name(dtype)}", x))
    out.append(("8MiB-act", torch.randn((BATCH, SEQ, BIG.d_model),
                                        dtype=torch.bfloat16, device=dev,
                                        generator=gen)))
    out.append(("64MiB-bfloat16", torch.randn((32 << 20,),
                                              dtype=torch.bfloat16,
                                              device=dev, generator=gen)))
    return out


def run_lane_payload(client, devch, lane: str, label: str, x, tag: str):
    """XROUNDS timed push+pull+ACK rounds and the after-ACK write checks;
    returns the median seconds."""
    dev = torch.device("cuda")
    name = f"{lane}-{label}"
    nbytes = x.numel() * x.element_size()
    arena = dt.default_send_arena()
    free0 = arena.free_bytes()
    times = []
    for _ in range(XROUNDS):
        torch.cuda.synchronize()
        sent0 = dt.lane_counters()[lane]
        t0 = time.perf_counter()
        cntl, resp = client.push(name, [x])
        check(not cntl.failed() and resp.ok,
              f"{name} push: {cntl.error_text}")
        pcntl, got = client.pull(name, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(not pcntl.failed() and got is not None,
              f"{name} pull: {pcntl.error_text}")
        check(dt.lane_counters()[lane] == sent0 + 1,
              f"{name}: the push took another lane than {lane}")
        spec = pcntl._response_rpc_meta.tensors[0].sharding_spec
        check(spec.startswith(LANE_PREFIX[lane]),
              f"{name}: the pull came back by {spec}")
        if lane != "wire":
            check(len(cntl.request_attachment) == 0
                  and pcntl._response_rpc_meta.attachment_size == 0,
                  f"{name}: payload bytes on the RPC wire")
        y = got[0]
        check(y.device.type == dev.type and y.dtype == x.dtype
              and y.shape == x.shape,
              f"{name}: pulled {y.dtype} {tuple(y.shape)} on {y.device}")
        check(torch.equal(u8(y), u8(x)), f"{name}: bytes differ")
    del got, y
    # after the ACKs: a write by the producer leaves the consumer's copy
    ref = x.clone()
    cntl, resp = client.push(name, [x])
    check(not cntl.failed() and resp.ok, f"{name} push: {cntl.error_text}")
    u8(x).bitwise_not_()  # the client's tensor, after the push's ACK
    pcntl, got = client.pull(name, device=dev)
    check(not pcntl.failed(), f"{name} pull: {pcntl.error_text}")
    x.copy_(ref)
    y = got[0]
    check(torch.equal(u8(y), u8(ref)),
          f"{name}: the peer's copy changed with the producer's tensor")
    peer_control(devch, "scribble", name=name)  # the peer's, after the ACK
    torch.cuda.synchronize()
    check(torch.equal(u8(y), u8(ref)),
          f"{name}: the pulled copy changed with the peer's tensor")
    del got, y, ref
    check(arena.free_bytes() == free0, f"{name}: send arena spans not freed")
    ep = devch._sock.app_state if devch._sock is not None else None
    check(ep is None or (ep.retained_count == 0 and ep.inflight_bytes == 0),
          f"{name}: client endpoint holds {ep.retained_count} sends, "
          f"{ep.inflight_bytes} B")
    server = dt._global_xfer_server()
    check(server is None or server.published_count() == 0,
          f"{name}: publications left on the client's transfer server")
    state = peer_control(devch, "state")
    check(state["retained"] == 0 and state["inflight"] == 0,
          f"{name}: peer endpoint not at rest: {state}")
    check(state["arena_free"] == state["arena_size"],
          f"{name}: peer arena spans not freed: {state}")
    check(state["published"] == 0, f"{name}: peer publications left")
    med = statistics.median(times)
    print(f"serve/x-proc/{lane} {label} {x.dtype} {list(x.shape)} {nbytes} B: "
          f"byte-identical x{XROUNDS}, median push+pull+ACK "
          f"{med * 1e3:.3f} ms, {2 * nbytes / med / 1e9:.3f} GB/s {tag}")
    return med, state


def phase_cross_process(tag: str, gen):
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    cuda_ipc_transfer.load_library()  # built once, before the peer needs it
    flags.set_flag(PREFER_XFER, False)
    proc, port = start_peer()
    plain = devch = None
    failed = True
    try:
        endpoint = f"127.0.0.1:{port}"
        plain = Channel()
        check(plain.init(endpoint) == 0, "plain channel init")
        devch = make_device_channel(endpoint)
        check(devch is not None, "device channel init")
        payloads = cross_payloads(gen)
        clients = {"wire": TensorClient(plain), "shm": TensorClient(devch),
                   "xfer": TensorClient(devch)}
        # warm every lane once (arena attach, IPC build and first mapping),
        # then take the memory baselines
        warm = torch.arange(1024, dtype=torch.float32, device=dev)
        for lane, client in clients.items():
            on = lane == "xfer"
            flags.set_flag(PREFER_XFER, on)
            peer_control(devch, "flag", on=on)
            client.push("warm", [warm])
            client.pull("warm", device=dev)
        peer0 = peer_control(devch, "reset")["memory_allocated"]
        torch.cuda.synchronize()
        mine0 = torch.cuda.memory_allocated()
        medians = {}
        for lane, client in clients.items():
            on = lane == "xfer"
            flags.set_flag(PREFER_XFER, on)
            peer_control(devch, "flag", on=on)
            lanes0 = peer_control(devch, "state")["lanes"][lane]
            for label, x in payloads:
                medians[lane, label], state = run_lane_payload(
                    client, devch, lane, label, x, tag)
            check(state["lanes"][lane] - lanes0 == (XROUNDS + 1) * len(payloads),
                  f"the peer answered pulls by another lane than {lane}")
        state = peer_control(devch, "reset")
        torch.cuda.synchronize()
        mine1 = torch.cuda.memory_allocated()
        check(mine1 == mine0, f"card memory leaked here: {mine0} -> {mine1} B")
        check(state["memory_allocated"] == peer0,
              f"card memory leaked in the peer: {peer0} -> "
              f"{state['memory_allocated']} B")
        arena = dt.default_send_arena()
        pinned = {n: a.pinned for n, a in dt._attached_arenas.items()}
        check(arena.pinned and all(pinned.values()),
              "an arena on the shm lane is not page-locked")
        big = "64MiB-bfloat16"
        ratio = medians["wire", big] / medians["xfer", big]
        print(f"serve/x-proc: card memory {mine0} B here and {peer0} B in "
              f"the peer, the same after every lane; send arena "
              f"{arena.name} ({arena.size} B) page-locked={arena.pinned}, "
              f"peer arena page-locked={state['arena_pinned']}, attached "
              f"here page-locked={pinned}; xfer is {ratio:.1f}x the wire "
              f"lane's rate at 64 MiB; phase took "
              f"{time.perf_counter() - t_start:.1f} s {tag}")
        print("lanes " + json.dumps({
            f"{lane}/{label}": round(m * 1e3, 3)
            for (lane, label), m in medians.items()}))
        failed = False
    finally:
        flags.set_flag(PREFER_XFER, False)
        for ch in (plain, devch):
            if ch is not None:
                ch.close()
        rc = stop_peer(proc)
    check(failed or rc == 0, f"the peer exited with code {rc}")


# -- phase 7: training on the card -------------------------------------------

def small_step_rank(device, params, tokens):
    """One rank (world 1) of phase 7b: one train step from the given
    parameters; returns (loss, new params) as numpy."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _, step = make_spmd_train_step(SMALL, MeshSpec(), lr=SMALL_LR)
    tokens = torch.from_numpy(tokens).to(device)
    loss, new = step(params_from_numpy(params, device=device), tokens,
                     torch.roll(tokens, -1, dims=1))
    return tensors_to_numpy((loss, new))


def big_train_rank(device):
    """One rank (world 1) of phase 7c: the full-width train step, warmed up
    twice feeding the returned params back, then timed step by step."""
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(BIG, gen, device=device)
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.randint(0, BIG.vocab, (BATCH, SEQ), dtype=torch.int32,
                           device=device, generator=gen.manual_seed(1))
    labels = torch.roll(tokens, -1, dims=1)
    _, step = make_spmd_train_step(BIG, MeshSpec(), lr=BIG_LR)
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, params = step(params, tokens, labels)
        end.record()
        end.synchronize()
        if i >= TRAIN_WARMUP:
            times.append(start.elapsed_time(end))
        losses.append(float(loss))
    return {"n_params": n_params, "times_ms": times, "losses": losses,
            "peak_bytes": torch.cuda.max_memory_allocated(device)}


def phase_train(tag: str):
    t_start = time.perf_counter()
    # 7a: the dry run, world 1 on NCCL
    with contextlib.redirect_stdout(io.StringIO()) as said:
        (dry,) = dryrun_multichip(1)
    check(dry["loss3"] < dry["loss0"], f"dry run loss {dry}")
    print(f"train/dryrun world 1 (NCCL, one card): {said.getvalue().strip()}"
          f"; loss0={dry['loss0']:.6f} loss3={dry['loss3']:.6f} {tag}")

    # 7b: one small fp32 step, card vs CPU, from the same parameters
    gen = torch.Generator().manual_seed(2)
    params = tensors_to_numpy(init_params(SMALL, gen, device="cpu"))
    tokens = torch.randint(0, SMALL.vocab, (4, 32), dtype=torch.int32,
                           generator=gen).numpy()
    (card,) = run_ranks(small_step_rank, 1, args=(params, tokens))
    (host,) = run_ranks(small_step_rank, 1, args=(params, tokens),
                        device="cpu")
    loss_err = abs(float(card[0]) - float(host[0]))
    names = ("embed", "ln1", "wq", "wk", "wv", "wo", "ln2", "router",
             "w_in", "w_out", "final_norm")
    leaf_err = {n: float(abs(a - b).max()) for n, a, b in
                zip(names, _leaves(card[1]), _leaves(host[1]))}
    print(f"train/card-vs-cpu: small fp32 config, B4xT32, one step at lr "
          f"{SMALL_LR} (no TF32): loss {float(card[0]):.6f} card, "
          f"{float(host[0]):.6f} CPU, |diff| {loss_err:.3e} (bound "
          f"{TRAIN_LOSS_ATOL:g}); max |updated leaf diff| "
          + ", ".join(f"{n} {e:.2e}" for n, e in leaf_err.items())
          + f" (bound {TRAIN_LEAF_ATOL:g}) {tag}")
    check(loss_err <= TRAIN_LOSS_ATOL, f"train loss card vs CPU {loss_err}")
    check(max(leaf_err.values()) <= TRAIN_LEAF_ATOL,
          f"updated params card vs CPU {leaf_err}")

    # 7c: the full-width train step
    (big,) = run_ranks(big_train_rank, 1)
    losses = big["losses"]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    ms = statistics.median(big["times_ms"])
    ref_flops = reference_train_flops(BIG, BATCH, SEQ)
    own_flops = 3 * sum(forward_flops(BIG, BATCH, SEQ).values())
    bound = {k: f / H100_BF16_FLOPS * 1e3 for k, f in
             (("ref", ref_flops), ("own", own_flops))}
    print(f"train/full width: {BIG} params={big['n_params']} B{BATCH}xT{SEQ} "
          f"lr {BIG_LR}, world 1 on NCCL; median of {TRAIN_STEPS} steps "
          f"(CUDA events, after {TRAIN_WARMUP} warm-up) {ms:.3f} ms "
          f"[{min(big['times_ms']):.3f}-{max(big['times_ms']):.3f}], "
          f"{1e3 / ms:.2f} steps/s, {BATCH * SEQ / ms * 1e3:.1f} tokens/s, "
          f"peak memory {big['peak_bytes'] / 2**30:.3f} GiB {tag}")
    print(f"train/full width work: reference formula "
          f"{ref_flops / 1e12:.3f} TFLOP/step (bound {bound['ref']:.3f} ms, "
          f"{bound['ref'] / ms:.1%} of it achieved), forward_flops x 3 "
          f"{own_flops / 1e12:.3f} TFLOP/step (bound {bound['own']:.3f} ms, "
          f"{bound['own'] / ms:.1%}); 989 TFLOP/s bf16; losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; phase took {time.perf_counter() - t_start:.1f} s {tag}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_name_and_limit()
    tag = f"[{card}]"
    print(card)  # as nvidia-smi gives it: name, power limit

    gen = torch.Generator(device="cuda").manual_seed(1234)
    srv = Server(ServerOptions())
    check(srv.add_service(TensorStoreService()) == 0, "add_service")
    check(srv.start("127.0.0.1:0") == 0, "server start")
    try:
        endpoint = str(srv.listen_endpoint)
        phase_inproc(endpoint, tag, gen)
        tokens = phase_wire(endpoint, tag, gen)
    finally:
        srv.stop()

    phase_forward(tokens, tag)
    phase_card_vs_cpu(tag)
    phase_cross_process(tag, gen)
    phase_train(tag)

    print("kernels: none ported - brpc_tpu has no Pallas kernel "
          "(no pallas_call in its sources); its device work is XLA-lowered "
          "jnp/lax, which the port runs as torch ops")
    print(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(peer_main() if sys.argv[1:] == ["--peer"] else main())
