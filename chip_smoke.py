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
            at every step;
8. serve behind a naming service — three ``--peer`` TensorStore servers on
            the card, which land every push there, behind one device
            channel over ``list://p1,p2,p3`` (the shm lane between
            processes), with the flagship's [4, 512, 2048] bfloat16
            activations (8 MiB) and a 64 MiB bfloat16 tensor. (a) With
            ``rr``, then ``la``: pushes until every peer holds each tensor
            (12 under rr), each peer storing what the balancer sent it; 24
            pulls with their ACKs, byte-identical, far more bytes than one
            send window; every endpoint, window and arena at rest after.
            (b) Failover: one peer SIGKILLed; 12 pushes with max_retry=3
            all succeed on the live two, the dead socket is failed, and no
            client endpoint retains a send. (c) Backup requests: one peer
            delays its Push by 300 ms; with backup_request_ms=30 every push
            completes in under 150 ms on the other peer, rpc_backup_requests
            counts each, and each losing send stays held until the slow
            peer's late answer, then is released (the slow peer's copies
            are byte-identical). (d) A SelectiveChannel over two
            single-address device channels, one peer killed: pushes still
            succeed and land on the live peer's card. A killed peer's shared
            arena is unlinked here. The peers are always stopped.

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
from brpc_tpu_torch.bvar import find_exposed
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    SelectiveChannel,
    Server,
    ServerOptions,
)
from brpc_tpu_torch.rpc import cuda_ipc_transfer
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.service import Service, rpc_method
from brpc_tpu_torch.rpc.socket import Socket
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
        elif cmd["op"] == "delay":
            self.store.push_delay_s = float(cmd["seconds"])
        elif cmd["op"] == "to_card":
            self.store.to_card = bool(cmd["on"])
        torch.cuda.synchronize()
        ep = cntl._server_socket.app_state
        arena = dt.default_send_arena()
        server = dt._global_xfer_server()
        # every connection's endpoint, the balanced channels' included
        eps = [s.app_state for s in list(cntl.server._conns)
               if s.app_state is not None]
        with self.store._lock:
            contents = {n: [str(t.device) for t in ts]
                        for n, ts in self.store._store.items()}
        state = {
            "all_retained": sum(e.retained_count for e in eps),
            "all_inflight": sum(e.inflight_bytes for e in eps),
            "contents": contents,
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


class SmokeStore(TensorStoreService):
    """The peer's store. Phase 8 switches on ``to_card`` (a push lands on
    the peer's card before it is answered) and sets ``push_delay_s`` on
    one peer (a slow server for the backup requests)."""

    def __init__(self):
        super().__init__()
        self.push_delay_s = 0.0
        self.to_card = False

    @rpc_method(wire.TensorPushRequest, wire.TensorPushResponse)
    def Push(self, cntl, request, response, done):
        if self.push_delay_s:
            time.sleep(self.push_delay_s)
        if not self.to_card:
            return super().Push(cntl, request, response, done)

        def landed():
            with self._lock:
                held = self._store.get(request.name)
                if held is not None:
                    self._store[request.name] = [t.to("cuda") for t in held]
            torch.cuda.synchronize()
            done()

        super().Push(cntl, request, response, landed)


def peer_main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke --peer: CUDA is not available", file=sys.stderr)
        return 2
    store = SmokeStore()
    srv = Server(ServerOptions())
    check(srv.add_service(store) == 0, "peer add_service")
    check(srv.add_service(SmokePeer(store)) == 0, "peer add_service")
    check(srv.start("127.0.0.1:0") == 0, "peer server start")
    arena = dt.default_send_arena()  # named here: a killed peer leaves it
    print(f"peer ready {srv.listen_endpoint.port} "
          f"{arena.name if arena is not None else '-'}", flush=True)
    sys.stdin.readline()  # the parent closes stdin to stop us
    srv.stop()
    return 0


def spawn_peer():
    """The peer in a fresh interpreter (never a fork after CUDA started)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--peer"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=here)


def await_peer(proc):
    """(port, shared arena name) from the peer's ready line; fails, and
    stops the peer, when it prints none."""
    ready, _, _ = select.select([proc.stdout], [], [], PEER_READY_S)
    line = proc.stdout.readline() if ready else ""
    if not line.startswith("peer ready "):
        stop_peer(proc)
        raise RuntimeError(f"chip_smoke: the peer printed no ready line "
                           f"({line!r}, exit code {proc.returncode})")
    _, _, port, arena = line.split()
    return int(port), arena


def start_peer():
    """One peer; returns (process, port)."""
    proc = spawn_peer()
    return proc, await_peer(proc)[0]


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
    sock = Socket.address(devch._single_sid)
    ep = sock.app_state if sock is not None else None
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


# -- phase 8: serve behind a naming service ----------------------------------

N_PEERS = 3
PULLS_8A = 24
PUSHES_8B = 12
PUSHES_8C = 6
PUSH_DELAY_S = 0.3
BACKUP_MS = 30
BACKUP_BOUND_S = 0.150  # a backed-up push against the 300 ms peer
SHM_DIR = "/dev/shm"


def _device_channel(target: str, lb: str = "", **opts) -> Channel:
    ch = Channel(ChannelOptions(use_device_transport=True, **opts))
    check(ch.init(target, lb) == 0, f"device channel init {target} {lb}")
    return ch


def _client_at_rest(ch, what: str):
    """Every connection of ``ch`` retains no send; the send arena is
    whole; no publication is left."""
    sids = (ch._lb.server_ids() if ch._lb is not None
            else [ch._single_sid] if ch._single_sid is not None else [])
    for sid in sids:
        sock = Socket.address(sid)
        ep = sock.app_state if sock is not None else None
        if ep is not None:
            check(ep.retained_count == 0 and ep.inflight_bytes == 0,
                  f"{what}: client endpoint of {sock} holds "
                  f"{ep.retained_count} sends, {ep.inflight_bytes} B")
    arena = dt.default_send_arena()
    check(arena.free_bytes() == arena.size, f"{what}: send arena spans held")
    server = dt._global_xfer_server()
    check(server is None or server.published_count() == 0,
          f"{what}: publications left")


def _peers_at_rest(ctl: dict, what: str):
    for port, c in ctl.items():
        st = peer_control(c, "state")
        check(st["all_retained"] == 0 and st["all_inflight"] == 0
              and st["arena_free"] == st["arena_size"],
              f"{what}: peer {port} not at rest: retained "
              f"{st['all_retained']}, {st['all_inflight']} B in flight, "
              f"arena {st['arena_free']}/{st['arena_size']} B free")


def _wait(cond, deadline_s: float, what: str):
    end = time.monotonic() + deadline_s
    while not cond():
        check(time.monotonic() < end, f"{what} within {deadline_s} s")
        time.sleep(0.01)


def _ms(xs) -> float:
    return round(statistics.median(xs) * 1e3, 3)


def naming_balanced(url: str, lb: str, tensors: dict, ctl: dict, tag: str):
    """8a: pushes until every peer holds each tensor, then 24 pulls with
    their ACKs through one balanced channel."""
    dev = torch.device("cuda")
    for c in ctl.values():
        peer_control(c, "reset")
    ch = _device_channel(url, lb)
    try:
        client = TensorClient(ch)
        sent = {port: set() for port in ctl}
        push_s = {name: [] for name in tensors}
        pushes = 0
        for name, x in tensors.items():
            holders = set()
            while len(holders) < N_PEERS:
                check(pushes < 60, f"8a/{lb}: {lb} never reached every peer")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cntl, resp = client.push(name, [x])
                push_s[name].append(time.perf_counter() - t0)
                check(not cntl.failed() and resp.ok,
                      f"8a/{lb} push {name}: {cntl.error_text}")
                port = cntl.remote_side.port
                holders.add(port)
                sent[port].add(name)
                pushes += 1
        if lb == "rr":
            check(pushes == N_PEERS * len(tensors),
                  f"8a/rr took {pushes} pushes")
        for port, c in ctl.items():
            contents = peer_control(c, "state")["contents"]
            check(set(contents) == sent[port],
                  f"8a/{lb}: peer {port} holds {sorted(contents)}, "
                  f"{lb} sent it {sorted(sent[port])}")
            check(all(d.startswith("cuda") for ds in contents.values()
                      for d in ds), f"8a/{lb}: peer {port} off the card")
        names = list(tensors)
        pull_s = {name: [] for name in tensors}
        pulled = 0
        for j in range(PULLS_8A):
            name = names[j % len(names)]
            x = tensors[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pcntl, got = client.pull(name, device=dev)
            torch.cuda.synchronize()
            pull_s[name].append(time.perf_counter() - t0)
            check(not pcntl.failed() and got is not None,
                  f"8a/{lb} pull {name}: {pcntl.error_text}")
            check(torch.equal(u8(got[0]), u8(x)), f"8a/{lb} {name}: bytes differ")
            pulled += x.numel() * x.element_size()
            del got
        check(pulled > dt.DEFAULT_WINDOW_BYTES,
              f"8a/{lb}: {pulled} B pulled is not past one window")
        _client_at_rest(ch, f"8a/{lb}")
        _peers_at_rest(ctl, f"8a/{lb}")
        out = {"pushes": pushes, "pulled_bytes": pulled,
               "push_ms_8MiB": _ms(push_s["act0"] + push_s["act1"]
                                    + push_s["act2"]),
               "push_ms_64MiB": _ms(push_s["big"]),
               "pull_ack_ms_8MiB": _ms(pull_s["act0"] + pull_s["act1"]
                                        + pull_s["act2"]),
               "pull_ack_ms_64MiB": _ms(pull_s["big"])}
        print(f"naming/{lb}: {pushes} pushes over list:// of {N_PEERS} peers, "
              f"each peer holding what {lb} sent it; {PULLS_8A} pulls + ACKs "
              f"byte-identical, {pulled} B through one channel "
              f"({pulled / dt.DEFAULT_WINDOW_BYTES:.1f} windows); median push "
              f"{out['push_ms_8MiB']} ms (8 MiB) {out['push_ms_64MiB']} ms "
              f"(64 MiB), pull+ACK {out['pull_ack_ms_8MiB']} ms (8 MiB) "
              f"{out['pull_ack_ms_64MiB']} ms (64 MiB); every endpoint, "
              f"window and arena at rest {tag}")
        return out
    finally:
        ch.close()


def _kill(peer: dict):
    """SIGKILL a peer and unlink the shared arena it can no longer
    unlink; True when the segment was still there."""
    peer["proc"].kill()
    peer["proc"].wait()
    peer["killed"] = True
    path = os.path.join(SHM_DIR, peer["arena"])
    try:
        os.unlink(path)
        return True
    except FileNotFoundError:
        return False


def naming_failover(url: str, peers: list, tensors: dict, tag: str):
    """8b: one peer killed; 12 pushes with max_retry=3 on the live two."""
    ch = _device_channel(url, "rr", max_retry=3)
    try:
        client = TensorClient(ch)
        act = tensors["act0"]
        for i in range(N_PEERS):  # every connection up before the kill
            cntl, _ = client.push(f"warm{i}", [act])
            check(not cntl.failed(), f"8b warm: {cntl.error_text}")
        victim = peers[0]
        left = _kill(victim)
        lat, retried = [], 0
        for i in range(PUSHES_8B):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cntl, resp = client.push(f"fo{i}", [act])
            lat.append(time.perf_counter() - t0)
            check(not cntl.failed() and resp.ok,
                  f"8b push {i} after the kill: {cntl.error_text}")
            check(cntl.remote_side.port != victim["port"],
                  "8b: a push was answered by the killed peer")
            retried += cntl.retried_count
        dead = [Socket.address(sid) for sid in ch._lb.server_ids()
                if Socket.address(sid).remote_side.port == victim["port"]]
        check(len(dead) == 1 and dead[0].failed(),
              "8b: the killed peer's socket is not failed")
        _client_at_rest(ch, "8b")
        out = {"first_push_after_kill_ms": round(lat[0] * 1e3, 3),
               "median_push_ms": _ms(lat), "retries": retried,
               "arena_left_by_kill": left}
        print(f"naming/failover: peer {victim['port']} SIGKILLed; "
              f"{PUSHES_8B} pushes (8 MiB, max_retry=3) all served by the "
              f"live two, {retried} retried; first push after the kill "
              f"{out['first_push_after_kill_ms']} ms, median "
              f"{out['median_push_ms']} ms; the dead socket failed, no client "
              f"endpoint retains a send; its shared arena "
              f"{'was left and is unlinked here' if left else 'was gone'} "
              f"{tag}")
        return out
    finally:
        ch.close()


def naming_backup(live: list, ctl: dict, tensors: dict, tag: str):
    """8c: the slow peer is rr's first pick for every push; the backup
    request goes to the other."""
    fast, slow = live  # rr's first pick on a fresh channel is the second
    url = "list://" + ",".join(f"127.0.0.1:{p['port']}" for p in live)
    ch = _device_channel(url, "rr", backup_request_ms=BACKUP_MS)
    try:
        client = TensorClient(ch)
        for i in range(2):  # both connections up, no delay yet
            cntl, _ = client.push(f"bwarm{i}", [tensors["act0"]])
            check(not cntl.failed(), f"8c warm: {cntl.error_text}")
        peer_control(ctl[slow["port"]], "delay", seconds=PUSH_DELAY_S)
        counter = find_exposed("rpc_backup_requests")
        backups0 = counter.get_value()
        names = [n for n in tensors if n != "big"]
        lat = []
        for i in range(PUSHES_8C):
            x = tensors[names[i % len(names)]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cntl, resp = client.push(f"bk{i}", [x])
            lat.append(time.perf_counter() - t0)
            check(not cntl.failed() and resp.ok, f"8c push {i}: {cntl.error_text}")
            check(cntl.has_backup_request
                  and cntl.remote_side.port == fast["port"],
                  f"8c push {i}: not served by the backup request")
            check(lat[-1] < BACKUP_BOUND_S,
                  f"8c push {i} took {lat[-1] * 1e3:.1f} ms")
        counted = counter.get_value() - backups0
        check(counted == PUSHES_8C, f"8c: rpc_backup_requests counted {counted}")
        # each losing send stays held until the slow peer's late answer
        t0 = time.perf_counter()
        _wait(lambda: all(Socket.address(sid).app_state.retained_count == 0
                          for sid in ch._lb.server_ids()),
              PUSHES_8C * PUSH_DELAY_S + 10, "8c: the losing sends released")
        released_s = time.perf_counter() - t0
        peer_control(ctl[slow["port"]], "delay", seconds=0)
        reader = TensorClient(ctl[slow["port"]])
        for i in range(PUSHES_8C):
            cntl, got = reader.pull(f"bk{i}")
            check(not cntl.failed() and got is not None,
                  f"8c pull bk{i} from the slow peer: {cntl.error_text}")
            want = tensors[names[i % len(names)]]
            check(torch.equal(u8(got[0]), u8(want.cpu())),
                  f"8c: the slow peer's copy of bk{i} differs")
        _client_at_rest(ch, "8c")
        out = {"push_ms": [round(t * 1e3, 3) for t in lat],
               "backup_requests": counted,
               "losers_released_after_ms": round(released_s * 1e3, 3)}
        print(f"naming/backup: peer {slow['port']} delays Push by "
              f"{PUSH_DELAY_S * 1e3:.0f} ms; backup_request_ms={BACKUP_MS}: "
              f"{PUSHES_8C} pushes (8 MiB) served by peer {fast['port']} in "
              f"{out['push_ms']} ms (bound {BACKUP_BOUND_S * 1e3:.0f} ms), "
              f"rpc_backup_requests +{counted}; the losing sends were held "
              f"until the late answers and released "
              f"{out['losers_released_after_ms']} ms after the last push; "
              f"the slow peer's copies byte-identical {tag}")
        return out
    finally:
        ch.close()


def naming_selective(live: list, ctl: dict, tensors: dict, tag: str):
    """8d: a SelectiveChannel over two single-address device channels; the
    second peer is killed."""
    keep, victim = live
    subs = [_device_channel(f"127.0.0.1:{p['port']}") for p in live]
    sc = SelectiveChannel(max_retry=2)
    for ch in subs:
        sc.add_channel(ch)
    try:
        client = TensorClient(sc)
        act = tensors["act1"]
        cntl, _ = client.push("sel-warm", [act])
        check(not cntl.failed(), f"8d warm: {cntl.error_text}")
        left = _kill(victim)
        lat = []
        for i in range(4):
            t0 = time.perf_counter()
            cntl, resp = client.push(f"sel{i}", [act])
            lat.append(time.perf_counter() - t0)
            check(not cntl.failed() and resp.ok, f"8d push {i}: {cntl.error_text}")
            check(cntl.remote_side.port == keep["port"],
                  "8d: a push was answered by the killed peer")
        check(sc._health.get(1, 0) >= 1, "8d: no call failed over")
        contents = peer_control(ctl[keep["port"]], "state")["contents"]
        check(all(contents.get(f"sel{i}", [""])[0].startswith("cuda")
                  for i in range(4)), f"8d: not on the live card: {contents}")
        cntl, got = client.pull("sel3", device=torch.device("cuda"))
        check(not cntl.failed() and torch.equal(u8(got[0]), u8(act)),
              "8d: pull through the SelectiveChannel")
        for ch in subs:
            _client_at_rest(ch, "8d")
        out = {"push_ms": [round(t * 1e3, 3) for t in lat],
               "arena_left_by_kill": left}
        print(f"naming/selective: SelectiveChannel over 2 device channels, "
              f"peer {victim['port']} SIGKILLed; 4 pushes (8 MiB) succeed in "
              f"{out['push_ms']} ms and land on peer {keep['port']}'s card; "
              f"a pull through it byte-identical {tag}")
        return out
    finally:
        for ch in subs:
            ch.close()


def phase_naming(tag: str, gen):
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    flags.set_flag(PREFER_XFER, False)
    procs = [spawn_peer() for _ in range(N_PEERS)]  # they start together
    peers, ctl = [], {}
    failed = True
    try:
        for proc in procs:
            port, arena = await_peer(proc)
            peers.append({"proc": proc, "port": port, "arena": arena,
                          "killed": False})
        for p in peers:
            ctl[p["port"]] = Channel()
            check(ctl[p["port"]].init(f"127.0.0.1:{p['port']}") == 0,
                  "control channel init")
            peer_control(ctl[p["port"]], "to_card", on=True)
        url = "list://" + ",".join(f"127.0.0.1:{p['port']}" for p in peers)
        tensors = {f"act{i}": torch.randn((BATCH, SEQ, BIG.d_model),
                                          dtype=torch.bfloat16, device=dev,
                                          generator=gen) for i in range(3)}
        tensors["big"] = torch.randn((32 << 20,), dtype=torch.bfloat16,
                                     device=dev, generator=gen)
        result = {lb: naming_balanced(url, lb, tensors, ctl, tag)
                  for lb in ("rr", "la")}
        result["failover"] = naming_failover(url, peers, tensors, tag)
        live = [p for p in peers if not p["killed"]]
        result["backup"] = naming_backup(live, ctl, tensors, tag)
        result["selective"] = naming_selective(live, ctl, tensors, tag)
        result["seconds"] = round(time.perf_counter() - t_start, 1)
        print(f"naming: phase took {result['seconds']} s {tag}")
        print("channel " + json.dumps(result))
        failed = False
    finally:
        for c in ctl.values():
            c.close()
        rcs = []
        for i, proc in enumerate(procs):
            if i < len(peers) and peers[i]["killed"]:
                proc.wait()
            else:
                rcs.append(stop_peer(proc))
    check(failed or all(rc == 0 for rc in rcs),
          f"phase 8 peers exited with codes {rcs}")


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
    phase_naming(tag, gen)

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
