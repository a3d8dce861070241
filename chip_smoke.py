#!/usr/bin/env python3
"""Smoke run of brpc_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --peer`` is the second process of phases 6, 8,
9, 10, 12, 13, 14, 15, 16 and 18, ``--peer --tls`` that of phase 17 and
``--peer19`` those of phase 19; the script starts them itself.)

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
            arena is unlinked here. The peers are always stopped;
9. serve many connections — one ``--peer``: the full Server (8 task-control
            workers, the event dispatcher, the shm lane), landing every push
            on its card through the block pool. (b) 16 client threads, each
            on a connection of its own, push and pull + ACK the flagship's
            activations 10 times: byte-identical, every tensor on the peer's
            card, the pool's free lists full again, every endpoint, window
            and arena at rest; client push and pull + ACK median and p99,
            the peer's TensorStore_Push p50 / p99, the aggregate rate, beside
            phase 8's single-stream push. (a) 256 connections open at once,
            each with its device handshake, one 8 KiB push and one pull +
            ACK: byte-identical, at rest, and the thread count of both
            processes grows by fewer than 8. (c) A limit of 2 on
            TensorStore.Push and a 50 ms push: 16 concurrent pushes with
            max_retry=0; the client's ELIMITs equal the peer's rejected
            count, every accepted push is stored byte-identical, no
            rejected one is stored, the client's window and arena at rest.
            (d) The peer stops while 8 pushes of 64 MiB are in flight: each
            fails with a socket error well before its deadline, every
            client endpoint and the send arena at rest, the peer exits 0.
            (e) The peer's cuda_device_count is 1. (f) Threads pull +
            ACK 9b's tensors through one device Channel (one connection),
            as many at once as its send window holds: byte-identical, at
            rest. More at once would stall on the window (ROADMAP queue C
            #11);
10. streams — one ``--peer`` whose stream service accepts with a 64 MiB
            window, lands each message on its card and echoes it back from
            there. Through a plain Channel this process opens a stream and
            makes 16 ``write_tensor`` calls of 4 MiB bfloat16 chunks from
            its card (64 MiB), flipping each chunk in place right after its
            call; the echoes land on the card bit-equal to the bytes at the
            calls. Prints the one-way rate (to the peer's last landing) and
            the round-trip rate (to the last echo landed here), both
            windows' unconsumed bytes at 0, stream_count back to 0 on both
            sides after close, and that the peer's on_closed ran;
11. trace  — a thread takes ``cuda_trace(1.0)`` while this one runs phase
            3's forward in a loop, one at a time, a marker kernel after
            each. From the zipped Chrome trace: the 10 kernels with the
            most device time, the kernels launched per forward (between
            markers), the kernel time per forward, the busy share of the
            window (the union of kernel intervals) and its longest idle
            gaps;
12. console — one ``--peer`` on the card with its builtin services (the
            default) while a thread here pushes the activations as their 4
            rows of [512, 2048] bfloat16 (2 MiB each, so each lands on the
            peer's card through a block of its pool) over the shm lane and
            pulls + ACKs them, in a loop. Meanwhile, on the peer's one port,
            by ``http.client`` and by the port's ``Channel(protocol="http")``:
            /health, /version, /status, /vars, /brpc_metrics, /connections
            (listing this process's device connection), /flags/<the
            prefer-xfer flag>, SmokePeer.Control called as JSON,
            /hotspots/cpu?seconds=0.5 naming the Push handler,
            /hotspots/tpu?seconds=1 (a zip whose Chrome trace holds the
            peer's H2D copies on its card and its TensorStore.Push
            landings) and a second /hotspots/tpu during the first, refused.
            With the load stopped, /status's TensorStore.Push count,
            /vars's device_transport_shm_transfers and /brpc_metrics's
            device_block_pool_acquired/released move by exactly the pushes
            made (the blocks 4x); both sides at rest; the peer exits 0.
            Prints each page's latency under load and the trace's size and
            event counts;
13. tracing and recording — one ``--peer`` landing pushes on its card.
            (a) A trace across three hops: the peer starts a second port
            Server in its process, and its store forwards each push it
            lands there. 8 pushes of the activations over the shm lane;
            for each, the peer's /rpcz?trace_id= holds its server Push,
            its client Push and the second server's Push, with this
            process's client span one trace whose parents chain hop by
            hop, every error 0, and the second server stores each push.
            (b) The host time of one span opened and ended; then 9b's
            load (16 connections, 10 rounds) with enable_rpcz on in both
            processes and off, in turns (on, off, off, on, twice): push
            and pull + ACK median and p99 of each run; the peer's
            collector holds one server span per push when on and none
            when off. (c) SmokePeer.Echo of the
            flagship's int32 token ids (4 MiB under gzip and zlib, 512 KiB
            under snappy), request and response compressed: bytes equal,
            ms per call, the compressed size the peer's span saw; then a
            push of the activations with compress_type gzip lands on the
            peer's card bit-equal. (d) A progressive download: the peer
            answers at once, then writes the activations it holds on its
            card as 8 chunks of 1 MiB, each copied from the card as it is
            written; the bytes equal the tensor; MB/s and the time to the
            first chunk. (e) With rpc_dump on under a temporary directory,
            16 SmokePeer.Control calls and 16 pushes give 32 records; their
            replay by ``brpc_tpu_torch.tools.rpc_replay`` prints ok=16
            failed=16 skipped=0, and the peer's server spans show the 16
            Control calls answered and the 16 Pushes failed with 1003 (the
            recorder holds no tensors, as in the reference: ROADMAP queue
            C #16). At the end the peer's windows, arena, streams and card
            memory are back at rest and it exits 0;
14. examples and tools — the port's programs (``brpc_tpu_torch.examples``,
            ``brpc_tpu_torch.tools``) on the card, beside one ``--peer``
            that lands every push on its card and serves an EchoService.
            (a) ``tensor_transport --mb 8 --iters 10`` as a user runs it:
            in process a ticket stands for the card tensor, the pull is
            verified bit for bit, and its own server in a subprocess takes
            the shm lane; then its cross-process pushes of a random 8 MiB
            card tensor at the peer, by shm and by xfer (the prefer-xfer
            flag in both processes), each lane moved 11 times, x0 pulled
            back bit-equal, the peer's windows, pool and card memory at rest
            after. (b) ``device_performance`` as the reference writes it:
            host bytes on the in-process ticket lane, no card memory
            allocated (it never touches the card), its native bulk half
            deferred to 20b (19a times the library's build); then its
            pushers at the peer, 4 threads x 8 MiB x 16 pushes over shm,
            every push on the peer's card, 0 errors: avg, p99 and GB/s.
            (c) ``rpc_press`` at
            the peer's EchoService for 3 s with 4 threads unthrottled, at
            ``--qps 200`` (within 10%, 0 errors), and 1 s over HTTP. (e)
            ``rpc_view`` of the peer's /vars: TensorStore_Push_count moved
            by 14b's pushes, the pool's counts balanced; ``parallel_http``
            with 64 fetches of /status on 4 threads, all answered; a
            trackme ping to a ``trackme_server`` here, counted under the
            port's version. (f) Each host example once, exit code 0. (d is
            13e's replay.) The peer exits 0;
15. grpc — one ``--peer`` whose one port serves TensorStore, the
            console, SmokeEcho and, with h2, gRPC. (a) A port
            ``Channel(protocol="h2:grpc")``: 200 sequential Echo calls
            (median and p99 us), 16 threads at once on one connection each
            getting its own reply, an unknown method giving ENOMETHOD, and
            a 300 ms handler under a 100 ms timeout giving ERPCTIMEDOUT
            (the peer reads the grpc-timeout); a tpu_std Echo and GET
            /status answer on the same port between them. (b) An 8 MiB
            ASCII string made on this card from the seeded generator,
            echoed over h2 5 times and landed on the card bit-equal: ms a
            call, MB/s beside phase 6's wire lane at 8 MiB, and the DATA
            and WINDOW_UPDATE frames each side read (both connection
            windows are crossed). (c) ``rpc_press --protocol h2:grpc`` at
            the Echo with 4 threads, 3 s unthrottled and 3 s at ``--qps
            200``, beside 14c's tpu_std numbers. (d) During the
            unthrottled run, 16 pushes of the activations by shm to the
            same port land on the peer's card bit-equal; then /status
            counts every Echo call made, /vars TensorStore_Push_count moved
            by 16, every h2 stream is closed and window whole, the device
            endpoints, arena and pool at rest. (e) The ``grpc_echo``
            example exits 0 with the reference's two lines. (f) 15c's
            latencies, in ``fleet.hist`` log2 buckets one rollup a second,
            go through one ``SloEngine`` latency objective with
            second-long windows: the burn rates and the alert state are
            printed, and the samples ingested must equal the calls made.
            The peer exits 0;
16. legacy — one ``--peer`` whose one port serves TensorStore, the
            console, SmokeEcho, h2, a ``DictRedisService``, a
            ``MemcacheService``, a thrift Echo and an nshead mcpack adaptor
            bound to SmokeEcho's Echo. (a) 200 sequential calls each over
            tpu_std, hulu_pbrpc, sofa_pbrpc (Echo), redis and memcache
            (GET), thrift (Echo) and nshead (Echo): median and p99 us
            beside 15a's gRPC numbers. (b) An unknown method gives
            ENOMETHOD over hulu and sofa and the reference's exception over
            thrift, an unknown redis command an error reply; hulu and sofa
            each echo 4 KiB with gzip, zlib and snappy. (c) An 8 MiB value
            made on this card from the seeded generator goes through redis
            SET+GET, memcache set+get and a thrift Echo, 3 calls each, and
            lands on the card bit-equal every time: ms a call and MB/s
            beside phase 6's wire lane at 8 MiB. (d) 16 threads make 64
            redis and 64 memcache calls pipelined on one connection each;
            every call gets its own reply. (e) ``rpc_press --protocol
            hulu_pbrpc`` at the Echo with 4 threads, 3 s unthrottled,
            beside 14c's tpu_std qps, while 16 shm pushes of the
            activations land on the peer's card bit-equal; then /status
            counts every Echo call made over tpu_std, hulu, sofa and
            nshead, /vars TensorStore_Push_count moved by 16, the device
            endpoints, arena and pool at rest. (f) The ``redis_kv``,
            ``memcache_kv``, ``thrift_echo`` and ``legacy_pbrpc_echo``
            examples exit 0 with the reference's lines. The peer exits 0;
17. tls — one ``--peer --tls`` whose one port speaks TLS only (the
            test-only pair in brpc_tpu_torch/testdata) and checks an
            ``HmacAuthenticator`` credential on tpu_std and hulu: it serves
            TensorStore, SmokeEcho, the console, h2, a ``NovaServiceAdaptor``
            as its nshead service, a mongo adaptor and an esp service; in
            the same process plaintext ports serve nova (with mongo and
            esp), public_pbrpc and ubrpc, one adaptor each. (a) The
            activations [4, 512, 2048] bfloat16 (8 MiB, from the seeded
            generator) pushed and pulled + ACKed 5 times by the wire lane
            (the bytes inside TLS) and by shm (a descriptor inside TLS, the
            bytes in the shared arena, as in the reference), landed on the
            peer's card and back bit-equal: ms a round beside phase 6's
            plaintext wire lane at 8 MiB, and the lane each push took. (b) A
            wrong secret and no credential get EAUTH over tpu_std and hulu;
            the handler sees the client's user; a plaintext client fails
            within its timeout and a TLS call is answered at once after it.
            (c) 16 threads make 64 Echo calls each on one TLS connection
            while two threads echo 8 MiB made on the card each way; every
            reply reaches its own call. (d) /status and /vars over HTTPS:
            the Echo calls and the pushes counted exactly; a gRPC call over
            TLS. (e) 200 sequential calls each over nova, public_pbrpc,
            ubrpc, mongo (a ping) and esp in plaintext: median and p99 us
            beside 16a's nshead; one call of nova, mongo and esp inside TLS.
            (f) ``nshead_extension`` exits 0 with the reference's line; the
            output of the ``mcpack2pb_gen`` command line imports in a fresh
            interpreter (nothing of jax, brpc_tpu or protobuf) and serves
            an nshead call there. The device endpoints, arena and pool at
            rest, the peer's card memory back; the peer exits 0.
18. rtmp — one ``--peer`` whose plaintext one port also serves an
            ``RtmpService``. (a) One 1080p30 live stream as Twitch's
            broadcasting guidelines set it (video 6,000 kbit/s, 30 frames/s,
            a keyframe every 2 s and about 8 inter frames in size; AAC 160
            kbit/s at 44.1 kHz), payloads from the seeded generator behind
            real FLV AVC and AAC tag headers, ``onMetaData`` and both
            sequence headers first, paced in real time for 10 s (300 video
            and 431 audio frames): a port ``RtmpClient`` publishes it into
            the peer over the digest handshake; 8 players play it there; an
            edge server here pulls it by ``pull_into_service`` (digest) and
            serves 4 more; one player joins the peer 5 s late. Meanwhile a
            plain channel pushes the activations (8 MiB) to the peer's card
            once a second and pulls them back. Every player gets every
            frame bit-equal and in order, the late joiner the metadata and
            both sequence headers before its first live frame; every pull
            lands on the card byte-identical; printed: the relay's latency
            from the publisher's send to each player's receipt on this
            host's clock, median and p99, origin and edge players apart;
            messages and bytes per player against those sent; the pushes'
            ms a round beside phase 6's wire round. (b) One player of a
            second stream stops reading while its publisher bursts 64
            keyframes of 256 KiB: the peer fails its socket once its backlog
            passes 8 MiB, the other two players get every frame; after every
            client closes, the peer's streams and ``rtmp_sessions`` are back
            at rest, its endpoints and pool at rest, the wire lane moved by
            the pushes made, its card memory back. (c)
            ``IOBuf.device_arrays`` of a chain holding two card tensors is
            their storage (``data_ptr`` equal); ``cut_into_file_descriptor``
            of it into a pipe writes their bytes. (d) ``python -m
            brpc_tpu_torch.examples.rtmp_relay``, started with the phase,
            exits 0 with the reference's lines. The peer exits 0;
19. native — the native runtime, with the descriptor-ring fabric on in
            three of four ``--peer19`` processes (phases 6-18 keep it off
            in both processes, so they measure the shm lane). (a) The port's native
            library built from ``brpc_tpu_torch/native/src`` (g++'s version
            and the seconds printed). (b) A peer on a Python listener:
            float32, bfloat16 and int32 at 8 KiB and 2 MiB and the
            activations pushed by the ring lane (written once into the
            peer's page-locked blob arena, copied from there to its card),
            pulled back and ACKed, XROUNDS each, each round in turn with
            the same round to a peer alike but for its fabric, which is off
            (``--no-fabric``: the shm lane, landing on the card too): every
            byte equal, ``ring`` moving by the first peer's pushes and
            ``shm`` by the second's, ``wire`` not, median and p99 of both
            beside phase 6's shm round; then the ring peer holds no record,
            no lease and no arena span. (c) A ``use_native_runtime`` peer
            with 2 shm workers: 4 pushes of the activations by ring from
            another process and one by wire land on its card bit-equal;
            Echo from 16 connections on its Python lane, on a second native
            peer's native echo and on (b)'s Python listener: qps, p50, p99,
            beside phase 14's rpc_press; whether io_uring or epoll served;
            /status over the native HTTP lane. (d) Kind-8 records of 8 KiB,
            2 MiB and 8 MiB land on the card in the workers with the
            sender's checksums, no unregistered drop; one HTTP and one gRPC
            call answered by workers. (f) A NativeCluster (rr) over the two
            native peers: ``parallel_call`` and ``partition_call`` bodies
            equal the Python ParallelChannel's and PartitionChannel's;
            ``MeshChannel.host_parallel_call`` the same. (e) The worker
            peer stops under 16 pushing connections: every call answered
            or refused with the reference's codes, no lease, record, span,
            worker or ``/dev/shm`` segment left, every peer exits 0.
20. native observability and client lanes — two ``--peer19 --native``
            peers (one with the native builtin echo), started beside phase
            19's. (a) From this process's native clients: ``channel_call``
            and ``channel_acall`` Echo, a 150 ms deadline on a stalled call
            (1008), HTTP GET /status and a JSON Echo POST, gRPC Echo; the
            four native examples through ``main(argv)`` in children. (b)
            ``rpc_client_bench`` (16 connections x 32 fibers, 16 B, 2 s)
            against the native Python lane and the native echo, beside
            19c's rate from 16 Python connections; the native bulk lane of
            ``device_performance`` at 8 MiB. (c) Another process pushes the
            activations by ring onto the first peer's card, bytes checked,
            while C++ clients press the second; the pushes counted by the
            peer; the ``nat_*`` counters on ``/vars`` and ``/brpc_metrics``
            moved by the calls the clients counted; the native section of
            ``/status``; one native ``/connections`` row per open client
            connection; a call under ``trace_scope`` chained through its
            client span to a native server span in ``/rpcz``;
            ``/hotspots/native`` with native frames, the native lock
            section of ``/hotspots/contention``, ``/heap/native`` and
            ``/growth/native`` with sites and bytes. (d)
            ``/rpc_dump?seconds=2`` during a tpu_std, HTTP, gRPC and push
            mix, replayed by ``rpc_replay --native``: records loaded =
            captured, the pushes failing as queue C #16 says. (e) A
            constant:4 limiter under 32 calls (2004 past the limit, in
            flight <= 4); a second port taking a push onto the card, then
            removed; a seeded fault spec, faults = failed calls;
            ``server_draining`` during the graceful stop; no lease, record,
            segment or worker left.

The last line is the result: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import gc
import glob
import http.client
import io
import json
import math
import os
import re
import select
import shutil
import socket as pysocket
import ssl
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zipfile

import torch

from brpc_tpu_torch import rpcz
from brpc_tpu_torch import mcpack2pb
from brpc_tpu_torch.builtin.profilers import cuda_trace
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.butil.recordio import RecordReader
from brpc_tpu_torch.entry import dryrun_multichip
from brpc_tpu_torch.examples import (
    asynchronous_echo,
    auto_concurrency_limiter,
    backup_request,
    cascade_echo,
    device_performance,
    dynamic_partition_echo,
    echo,
    grpc_echo,
    http_server,
    legacy_pbrpc_echo,
    memcache_kv,
    multi_threaded_echo,
    nshead_extension,
    partition_echo,
    redis_kv,
    selective_echo,
    session_data,
    streaming_echo,
    tensor_transport,
    thrift_echo,
)
from brpc_tpu_torch.parallel import run_ranks
from brpc_tpu_torch.parallel.world import tensors_to_numpy
from brpc_tpu_torch.butil.endpoint import EndPoint
import brpc_tpu_torch
from brpc_tpu_torch import bvar, fleet
from brpc_tpu_torch.bvar import (
    Adder,
    LatencyRecorder,
    expose_default_variables,
    find_exposed,
)
from brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Controller,
    SelectiveChannel,
    Server,
    ServerOptions,
    StreamInputHandler,
    StreamOptions,
    stream_accept,
    stream_create,
)
from brpc_tpu_torch.rpc import (
    amf,
    cuda_ipc_transfer,
    errors,
    esp_protocol,
    h2_protocol,
    mongo,
    rpc_dump,
    rtmp_client,
    rtmp_protocol,
    trackme,
)
from brpc_tpu_torch.rpc.authenticator import HmacAuthenticator
from brpc_tpu_torch.rpc.channel import call_on_socket, get_client_messenger
from brpc_tpu_torch.rpc.compress import (
    COMPRESS_GZIP,
    COMPRESS_SNAPPY,
    COMPRESS_ZLIB,
)
from brpc_tpu_torch.rpc.concurrency_limiter import create_concurrency_limiter
from brpc_tpu_torch.rpc.http_message import HttpRequest
from brpc_tpu_torch.rpc.legacy_nshead_family import (
    NovaServiceAdaptor,
    PublicPbrpcServiceAdaptor,
    UbrpcServiceAdaptor,
)
from brpc_tpu_torch.rpc.memcache import (
    MemcacheRequest,
    MemcacheResponse,
    MemcacheService,
)
from brpc_tpu_torch.rpc.nshead_protocol import (
    NsheadMessage,
    NsheadPbServiceAdaptor,
)
from brpc_tpu_torch.rpc.progressive import (
    ProgressiveReader,
    attach_progressive_reader,
    create_progressive_attachment,
)
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.redis import (
    DictRedisService,
    RedisRequest,
    RedisResponse,
)
from brpc_tpu_torch.rpc.service import Service, rpc_method
from brpc_tpu_torch.rpc.socket import Socket, TLSSocket
from brpc_tpu_torch.rpc.tensor_service import (
    TensorClient,
    TensorStoreService,
    make_device_channel,
)
from brpc_tpu_torch.rpc.thrift import T_STRING, ThriftMessage, ThriftService
from brpc_tpu_torch.tensor import ModelConfig, forward_local, init_params
from brpc_tpu_torch.tools import (
    mcpack2pb_gen,
    parallel_http,
    rpc_press,
    rpc_replay,
    rpc_view,
    trackme_server,
)
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
PUSH_LABEL = "TensorStore.Push"  # the peer's landing, in its card trace
PEER_THREADS = 8  # the peer's task-control workers
XROUNDS = 7  # push + pull + ACK rounds per payload and lane (median)
PEER_READY_S = 180
LANE_PREFIX = {"wire": "wire::", "shm": "shm:", "xfer": "xfer|"}


PROGRESSIVE_CHUNK = 1 << 20  # 13d: under the stream's 2 MiB window


class Blob:
    """A message that is its bytes: 13c's payloads are raw token ids."""

    def __init__(self, data: bytes = b""):
        self.data = data

    def SerializeToString(self) -> bytes:
        return self.data

    def ParseFromString(self, data) -> None:
        self.data = bytes(data)


class SmokePeer(Service):
    """The peer's side door for the checks: set the prefer-xfer flag or
    any flag, overwrite a stored tensor in place, clear the store, slow or
    land pushes, set a method's limit, stop the server after a while,
    relay pushes to a second server, clear the spans, and report the
    state of the calling connection's endpoint, every connection's, the
    lanes, the arena, the block pool, card memory, the thread count,
    TensorStore.Push's method status, the relay's store and the server
    Push spans collected (as JSON in the response attachment). ``Echo``
    answers 13c's bytes; ``Download`` writes a stored tensor from the card
    as a progressive attachment (13d)."""

    def __init__(self, store: TensorStoreService, streams: "SmokeStreams"):
        self.store = store
        self.streams = streams
        self.stopped_at = None
        self.stop_concurrency = None
        self.relay = self.relay_store = self.relay_channel = None
        self.side_ports = {}  # phase 17: the plaintext ports of the family

    def set_relay(self, on: bool):
        """13a: a second Server in this process; with ``on`` the store
        forwards each push it lands there, inside its Push handler (so
        under the handler's server span)."""
        if on and self.relay is None:
            self.relay_store = TensorStoreService()
            self.relay = Server(ServerOptions(num_threads=PEER_THREADS))
            check(self.relay.add_service(self.relay_store) == 0,
                  "relay add_service")
            check(self.relay.start("127.0.0.1:0") == 0, "relay start")
            self.relay_channel = make_device_channel(
                str(self.relay.listen_endpoint))
        relay = TensorClient(self.relay_channel) if on else None

        def forward(name, arrays):
            cntl, resp = relay.push(name, arrays)
            check(not cntl.failed() and resp.ok,
                  f"relay push {name}: {cntl.error_text}")

        self.store._on_push = forward if on else None

    def close_relay(self):
        if self.relay is not None:
            self.relay_channel.close()
            self.relay.stop()

    @rpc_method(wire.TensorPullRequest, wire.TensorAckResponse)
    def Control(self, cntl, request, response, done):
        cmd = json.loads(request.name)
        if cmd["op"] == "flag":
            check(flags.set_flag(PREFER_XFER, bool(cmd["on"])), "set flag")
        elif cmd["op"] == "scribble":
            for t in self.store.get(cmd["name"]):
                u8(t).bitwise_not_()  # in place: stored tensors are contiguous
        elif cmd["op"] == "reset":
            for store in (self.store, self.relay_store):
                if store is not None:
                    with store._lock:
                        store._store.clear()
        elif cmd["op"] == "delay":
            self.store.push_delay_s = float(cmd["seconds"])
        elif cmd["op"] == "to_card":
            self.store.to_card = bool(cmd["on"])
        elif cmd["op"] == "limit":
            status = cntl.server.method_statuses()[cmd["method"]]
            status.limiter = (create_concurrency_limiter(int(cmd["max"]))
                              if cmd["max"] else None)
        elif cmd["op"] == "relay":
            self.set_relay(bool(cmd["on"]))
        elif cmd["op"] == "set_flag":
            check(flags.set_flag(cmd["name"], cmd["value"]),
                  f"set flag {cmd['name']}")
        elif cmd["op"] == "rpcz_clear":
            rpcz.clear_for_tests()
        elif cmd["op"] == "stop":
            # the server stops after_s from now, wherever its calls are
            srv = cntl.server

            def stop():
                self.stopped_at = time.time()
                self.stop_concurrency = srv.method_statuses()[
                    "TensorStore.Push"].concurrency
                srv.stop()

            threading.Timer(float(cmd["after_s"]), stop).start()
        torch.cuda.synchronize()
        # a call over HTTP (phase 12) has no tpu_std connection
        sock = cntl._server_socket
        ep = sock.app_state if sock is not None else None
        arena = dt.default_send_arena()
        server = dt._global_xfer_server()
        # every connection's endpoint, the balanced channels' included
        conns = cntl.server.list_connections()
        eps = [s.app_state for s in conns if s.app_state is not None]
        push = cntl.server.method_statuses()["TensorStore.Push"]
        rec = push.latency_recorder
        relay = cntl.server.options.rtmp_service
        if relay is not None:
            with relay._lock:
                rtmp = {n: {"players": len(st.players),
                            "publisher": st.publisher is not None}
                        for n, st in relay._streams.items()}
            rtmp = {"streams": rtmp,
                    "sessions": find_exposed("rtmp_sessions").get_value(),
                    "relayed": find_exposed(
                        "rtmp_relayed_messages").get_value()}
        else:
            rtmp = None
        with self.store._lock:
            contents = {n: [str(t.device) for t in ts]
                        for n, ts in self.store._store.items()}
        max_spans = flags.get_flag("rpcz_max_spans")
        server_pushes = sum(
            1 for sp in rpcz.recent_spans(max_spans)
            if (sp.kind, sp.full_method) == ("server", PUSH_LABEL))
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
            "connections": len(conns),
            "threads": find_exposed("process_thread_count").get_value(),
            "cuda_device_count": find_exposed("cuda_device_count").get_value(),
            # the free blocks of each size class, of every pool made
            "pool_free": {str(dev): {str(k): v for k, v in pool.stats().items()}
                          for dev, pool in list(dt._default_pools.items())},
            "streams": self.streams.state(),
            "h2": [h2_state(s.h2_conn) for s in conns
                   if getattr(s, "h2_conn", None) is not None],
            "echo_timeouts_ms": SmokeEcho.timeouts_ms,
            "side_ports": self.side_ports,
            "rtmp": rtmp,
            "relay_stored": (sorted(self.relay_store._store)
                             if self.relay_store is not None else None),
            "rpcz": {"server_pushes": server_pushes, "max_spans": max_spans,
                     "sample_every": flags.get_flag("rpcz_sample_every"),
                     "enabled": flags.get_flag("enable_rpcz")},
            "push_status": {
                "concurrency": push.concurrency,
                "rejected_count": push.rejected_count,
                "count": rec.count(),
                "p50_us": rec.latency_percentile(0.5),
                "p99_us": rec.latency_percentile(0.99)},
        }
        cntl.response_attachment.append(json.dumps(state).encode())
        response.ok = True
        done()

    @rpc_method(Blob, Blob)
    def Echo(self, cntl, request, response, done):
        """13c: the bytes back, compressed as the request was."""
        response.data = request.data
        done()

    @rpc_method(wire.TensorPullRequest, wire.TensorAckResponse)
    def Download(self, cntl, request, response, done):
        """13d: answer at once, then write the stored tensor from the card
        in PROGRESSIVE_CHUNK pieces, each copied to the host as it is
        written, and close."""
        held = self.store.get(request.name)
        pa = create_progressive_attachment(cntl) if held else None
        response.ok = pa is not None
        done()
        if pa is None:
            return
        flat = u8(held[0])

        def write_all():
            try:
                for i in range(0, flat.numel(), PROGRESSIVE_CHUNK):
                    chunk = flat[i:i + PROGRESSIVE_CHUNK].cpu().numpy()
                    if pa.write(chunk.tobytes()) != 0:
                        return  # the client sees the body cut short
            finally:
                pa.close()

        threading.Thread(target=write_all, daemon=True).start()


class SmokeEcho(Service):
    """The echo service rpc_press drives at the peer (phases 14c and 15c),
    over tpu_std, HTTP and gRPC. A request's ``sleep_us`` holds the
    answer; the timeout that came with such a request (over gRPC, its
    ``grpc-timeout``) is kept in ``timeouts_ms`` (15a)."""

    SERVICE_NAME = "EchoService"
    timeouts_ms = []

    @rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.sleep_us:
            SmokeEcho.timeouts_ms.append(cntl.timeout_ms)
            time.sleep(request.sleep_us / 1e6)
        response.message = request.message
        if request.message == AUTH_PROBE_17:  # 17b: who the server saw
            ctx = cntl.auth_context
            response.message = ctx.user if ctx is not None else ""
        done()


class SmokeMongo(mongo.MongoServiceAdaptor):
    """17e: a ping answers ok, any other query its collection."""

    def process_mongo_request(self, cntl, request, response, done):
        query = request.query or {}
        response.documents = [{"ok": 1.0} if "ping" in query
                              else {"collection": request.collection}]
        done()


def smoke_thrift() -> ThriftService:
    """The peer's thrift Echo (phase 16): field 1 of the call back as
    field 0 of the reply."""
    svc = ThriftService()
    svc.add_method("Echo", lambda body: {0: body.get(1, (T_STRING, b""))})
    return svc


class SmokeStore(TensorStoreService):
    """The peer's store. Phases 8 and 9 switch on ``to_card`` (a push
    lands on the peer's card, through the block pool, before it is
    answered) and set ``push_delay_s`` (a slow server for the backup
    requests, a held push for the limiter and the stop)."""

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
            # through the block pool on this worker: its copies and the
            # sync before a block goes back run on one thread; phase 12
            # finds these host ops in the peer's trace by the label
            pool = dt.default_block_pool()
            with torch.profiler.record_function(PUSH_LABEL), self._lock:
                held = self._store.get(request.name)
                if held is not None:
                    self._store[request.name] = [
                        pool.put_via_pool(u8(t), t.dtype, t.shape)
                        for t in held]
            torch.cuda.synchronize()
            done()

        super().Push(cntl, request, response, landed)


def peer_main(tls: bool = False) -> int:
    """With ``tls`` (phase 17) the one port speaks TLS only and checks an
    HmacAuthenticator credential; its nshead service is a nova adaptor
    beside a mongo adaptor and an esp service, and plaintext ports in
    this process serve nova (with mongo and esp), public_pbrpc and ubrpc,
    one adaptor each."""
    if not torch.cuda.is_available():
        print("chip_smoke --peer: CUDA is not available", file=sys.stderr)
        return 2
    store = SmokeStore()
    streams = SmokeStreams()
    side = SmokePeer(store, streams)
    echo = SmokeEcho()
    opts = dict(
        num_threads=PEER_THREADS, redis_service=DictRedisService(),
        memcache_service=MemcacheService(), thrift_service=smoke_thrift(),
        nshead_service=NsheadPbServiceAdaptor.for_method(
            "EchoService.Echo"),
        rtmp_service=None if tls else rtmp_protocol.RtmpService())
    side_servers = []
    if tls:
        cert, key = tls_pair()
        opts.update(ssl_certfile=cert, ssl_keyfile=key,
                    auth=HmacAuthenticator(TLS_SECRET_17),
                    nshead_service=NovaServiceAdaptor(echo),
                    mongo_service_adaptor=SmokeMongo(),
                    esp_service=esp_protocol.EspService())
        for proto, adaptor in FAMILY_17.items():
            extra = (dict(mongo_service_adaptor=SmokeMongo(),
                          esp_service=esp_protocol.EspService())
                     if proto == "nova_pbrpc" else {})
            s = Server(ServerOptions(num_threads=PEER_THREADS,
                                     has_builtin_services=False,
                                     nshead_service=adaptor(echo), **extra))
            check(s.start("127.0.0.1:0") == 0, f"peer {proto} server start")
            side.side_ports[proto] = s.listen_endpoint.port
            side_servers.append(s)
    srv = Server(ServerOptions(**opts))
    for svc in (store, side, streams, echo):
        check(srv.add_service(svc) == 0, "peer add_service")
    check(srv.start("127.0.0.1:0") == 0, "peer server start")
    arena = dt.default_send_arena()  # named here: a killed peer leaves it
    print(f"peer ready {srv.listen_endpoint.port} "
          f"{arena.name if arena is not None else '-'}", flush=True)
    # the parent closes stdin to stop us, or a "stop" op stops the server
    quit_ = threading.Event()
    threading.Thread(target=lambda: (sys.stdin.readline(), quit_.set()),
                     daemon=True).start()
    while srv.is_running and not quit_.wait(0.05):
        pass
    srv.stop()
    for s in side_servers:
        s.stop()
    side.close_relay()
    if side.stopped_at is not None:
        print(f"peer stopped {side.stopped_at} {side.stop_concurrency}",
              flush=True)
    # calls still in their handlers (a held push) end before we exit
    end = time.monotonic() + 30
    while (any(st.concurrency for st in srv.method_statuses().values())
           and time.monotonic() < end):
        time.sleep(0.01)
    return 0


def spawn_peer(tls: bool = False):
    """The peer in a fresh interpreter (never a fork after CUDA started)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--peer"]
        + (["--tls"] if tls else []),
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
    return {f"{lane}/{label}": m for (lane, label), m in medians.items()}


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
    return result

# -- phase 9: many connections to the full server ------------------------------

CONNS_9A = 256
THREADS_9B, ROUNDS_9B = 16, 10
PUSHES_9C, LIMIT_9C, DELAY_9C = 16, 2, 0.05
PUSHES_9D, STOP_AFTER_9D, DELAY_9D, DEADLINE_9D_MS = 8, 1.0, 2.0, 10000
ROUNDS_9F = 10


class PinnedChannel:
    """One connection as a channel, so a TensorClient runs on a connection
    of its own (device channels to one server share one connection)."""

    def __init__(self, sock: Socket):
        self.sock = sock

    def call_method(self, method, cntl, request, response, done=None):
        call_on_socket(self.sock, method, cntl, request, response, done)


def device_socket(port: int) -> Socket:
    """A new connection to the peer with its device handshake, read by
    the process's client messenger."""
    sid = Socket.create(
        remote_side=EndPoint("127.0.0.1", port),
        on_edge_triggered_events=get_client_messenger().on_new_messages,
        app_connect=dt.DeviceEndpoint().app_connect)
    sock = Socket.address(sid)
    check(sock.connect(5.0) == 0, f"connect to the peer {port}")
    check(sock.app_state.state == dt.ESTABLISHED,
          f"handshake with the peer {port}: {sock.app_state.state}")
    return sock


def _threads_here() -> int:
    expose_default_variables()  # done by a server start, once
    return find_exposed("process_thread_count").get_value()


def _sockets_at_rest(socks, what: str):
    for sock in socks:
        ep = sock.app_state
        check(ep.retained_count == 0 and ep.inflight_bytes == 0,
              f"{what}: client endpoint of {sock} holds {ep.retained_count} "
              f"sends, {ep.inflight_bytes} B")
    arena = dt.default_send_arena()
    check(arena.free_bytes() == arena.size, f"{what}: send arena spans held")


def _peer_at_rest(st: dict, what: str):
    check(st["all_retained"] == 0 and st["all_inflight"] == 0
          and st["arena_free"] == st["arena_size"],
          f"{what}: peer not at rest: retained {st['all_retained']}, "
          f"{st['all_inflight']} B in flight, arena "
          f"{st['arena_free']}/{st['arena_size']} B free")


def _pool_full(st: dict, what: str):
    for dev, free in st["pool_free"].items():
        check(all(n == 8 for n in free.values()),
              f"{what}: the peer's block pool on {dev} lacks blocks: {free}")


def _run_threads(fns, what: str, timeout_s: float = 120):
    errs, threads = [], []

    def guard(fn):
        try:
            fn()
        except Exception as e:  # reported below, with the others
            errs.append(e)

    for fn in fns:
        threads.append(threading.Thread(target=guard, args=(fn,)))
        threads[-1].start()
    for t in threads:
        t.join(timeout_s)
        check(not t.is_alive(), f"{what}: a client thread hangs")
    if errs:
        raise errs[0]


def _p99(xs) -> float:
    return round(sorted(xs)[min(len(xs) - 1, int(0.99 * len(xs)))] * 1e3, 3)


def serve_concurrent(port: int, ctl, act, naming: dict, tag: str):
    """9b: 16 threads, each on its own connection, push and pull + ACK the
    activations 10 times against the peer's workers."""
    dev = torch.device("cuda")
    socks = [device_socket(port) for _ in range(THREADS_9B)]
    push_s, pull_s = [], []
    lock = threading.Lock()

    def rounds(k):
        client = TensorClient(PinnedChannel(socks[k]))
        for _ in range(ROUNDS_9B):
            t0 = time.perf_counter()
            cntl, resp = client.push(f"b{k}", [act])
            t1 = time.perf_counter()
            check(not cntl.failed() and resp.ok,
                  f"9b push {k}: {cntl.error_text}")
            pcntl, got = client.pull(f"b{k}", device=dev)
            t2 = time.perf_counter()
            check(not pcntl.failed() and got is not None,
                  f"9b pull {k}: {pcntl.error_text}")
            check(torch.equal(u8(got[0]), u8(act)), f"9b {k}: bytes differ")
            with lock:
                push_s.append(t1 - t0)
                pull_s.append(t2 - t1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_threads([lambda k=k: rounds(k) for k in range(THREADS_9B)], "9b")
    wall = time.perf_counter() - t0
    st = peer_control(ctl, "state")
    stored = {n: ds for n, ds in st["contents"].items() if n.startswith("b")}
    check(len(stored) == THREADS_9B
          and all(d.startswith("cuda") for ds in stored.values() for d in ds),
          f"9b: the peer holds {stored}")
    _peer_at_rest(st, "9b")
    _pool_full(st, "9b")
    _sockets_at_rest(socks, "9b")
    nbytes = act.numel() * act.element_size()
    moved = 2 * nbytes * THREADS_9B * ROUNDS_9B
    ps = st["push_status"]
    single = naming["rr"]["push_ms_8MiB"]
    out = {"push_ms_median": _ms(push_s), "push_ms_p99": _p99(push_s),
           "pull_ack_ms_median": _ms(pull_s), "pull_ack_ms_p99": _p99(pull_s),
           "peer_push_p50_ms": round(ps["p50_us"] / 1e3, 3),
           "peer_push_p99_ms": round(ps["p99_us"] / 1e3, 3),
           "peer_push_count": ps["count"],
           "aggregate_GBps": round(moved / wall / 1e9, 3),
           "wall_s": round(wall, 3), "phase8_single_push_ms": single}
    print(f"serve/9b: {THREADS_9B} threads x {ROUNDS_9B} push + pull + ACK of "
          f"{list(act.shape)} {act.dtype} on {THREADS_9B} connections, "
          f"byte-identical, all on the peer's card, pool full, at rest; "
          f"client push median {out['push_ms_median']} ms p99 "
          f"{out['push_ms_p99']} ms, pull+ACK median "
          f"{out['pull_ack_ms_median']} ms p99 {out['pull_ack_ms_p99']} ms; "
          f"peer TensorStore_Push p50 {out['peer_push_p50_ms']} ms p99 "
          f"{out['peer_push_p99_ms']} ms ({ps['count']} pushes); "
          f"{out['aggregate_GBps']} GB/s in {out['wall_s']} s; phase 8's "
          f"single-stream push {single} ms {tag}")
    return out, socks


def serve_one_channel(port: int, ctl, act, tag: str):
    """9f: threads pull + ACK 9b's tensors through one device Channel (one
    connection), as many at once as the connection's send window holds:
    more would wait in the peer's prepare_send and hold the worker that
    reads the connection (ROADMAP queue C #11)."""
    dev = torch.device("cuda")
    nbytes = act.numel() * act.element_size()
    pullers = dt.DEFAULT_WINDOW_BYTES // nbytes
    ch = _device_channel(f"127.0.0.1:{port}")
    pull_s, conns = [], set()
    lock = threading.Lock()

    def rounds(k):
        client = TensorClient(ch)
        for _ in range(ROUNDS_9F):
            t0 = time.perf_counter()
            cntl, got = client.pull(f"b{k % THREADS_9B}", device=dev)
            t1 = time.perf_counter()
            check(not cntl.failed() and got is not None,
                  f"9f pull {k}: {cntl.error_text}")
            check(torch.equal(u8(got[0]), u8(act)), f"9f {k}: bytes differ")
            with lock:
                pull_s.append(t1 - t0)
                conns.add(cntl._current_sock.socket_id)

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _run_threads([lambda k=k: rounds(k) for k in range(pullers)], "9f")
        wall = time.perf_counter() - t0
        check(len(conns) == 1, f"9f: the pulls used {len(conns)} connections")
        _client_at_rest(ch, "9f")
    finally:
        ch.close()
    _peer_at_rest(peer_control(ctl, "state"), "9f")
    out = {"pullers": pullers, "pull_ack_ms_median": _ms(pull_s),
           "pull_ack_ms_p99": _p99(pull_s),
           "aggregate_GBps": round(nbytes * pullers * ROUNDS_9F / wall / 1e9,
                                   3),
           "wall_s": round(wall, 3)}
    print(f"serve/9f: {pullers} threads x {ROUNDS_9F} pull + ACK of "
          f"{list(act.shape)} {act.dtype} through one device Channel (a "
          f"{dt.DEFAULT_WINDOW_BYTES >> 20} MiB window), byte-identical, at "
          f"rest; pull+ACK median {out['pull_ack_ms_median']} ms p99 "
          f"{out['pull_ack_ms_p99']} ms; {out['aggregate_GBps']} GB/s in "
          f"{out['wall_s']} s {tag}")
    return out


def serve_many_connections(port: int, ctl, gen, tag: str):
    """9a: 256 connections open at once, each with a handshake, one 8 KiB
    push and one pull + ACK."""
    dev = torch.device("cuda")
    x = torch.randn((2048,), dtype=torch.float32, device=dev, generator=gen)
    peer0 = peer_control(ctl, "state")
    mine0 = _threads_here()
    socks = []
    t0 = time.perf_counter()
    try:
        for _ in range(CONNS_9A):
            socks.append(device_socket(port))

        def serve(chunk):
            for i in chunk:
                client = TensorClient(PinnedChannel(socks[i]))
                cntl, resp = client.push(f"a{i}", [x])
                check(not cntl.failed() and resp.ok,
                      f"9a push {i}: {cntl.error_text}")
                pcntl, got = client.pull(f"a{i}", device=dev)
                check(not pcntl.failed() and got is not None,
                      f"9a pull {i}: {pcntl.error_text}")
                check(torch.equal(u8(got[0]), u8(x)), f"9a {i}: bytes differ")

        chunks = [range(k, CONNS_9A, 16) for k in range(16)]
        _run_threads([lambda c=c: serve(c) for c in chunks], "9a")
        wall = time.perf_counter() - t0
        mine1 = _threads_here()
        st = peer_control(ctl, "state")
        check(st["connections"] >= CONNS_9A,
              f"9a: the peer counts {st['connections']} connections")
        _peer_at_rest(st, "9a")
        _pool_full(st, "9a")
        _sockets_at_rest(socks, "9a")
    finally:
        for sock in socks:
            sock.recycle()
    out = {"connections": CONNS_9A, "wall_s": round(wall, 3),
           "peer_threads": [peer0["threads"], st["threads"]],
           "client_threads": [mine0, mine1]}
    print(f"serve/9a: {CONNS_9A} connections open at once, each with its "
          f"handshake, an 8 KiB push and a pull + ACK, byte-identical, at "
          f"rest, in {out['wall_s']} s; threads: peer {peer0['threads']} -> "
          f"{st['threads']}, here {mine0} -> {mine1} {tag}")
    check(st["threads"] - peer0["threads"] < 8,
          f"9a: the peer grew by {st['threads'] - peer0['threads']} threads")
    check(mine1 - mine0 < 8, f"9a: this process grew by {mine1 - mine0} "
          f"threads")
    return out


def serve_limited(ctl, socks, act, tag: str):
    """9c: TensorStore.Push limited to 2 and slowed to 50 ms; 16 concurrent
    pushes with max_retry=0."""
    dev = torch.device("cuda")
    peer_control(ctl, "limit", method="TensorStore.Push", max=LIMIT_9C)
    peer_control(ctl, "delay", seconds=DELAY_9C)
    codes = {}

    def push(k):
        cntl, resp = TensorClient(PinnedChannel(socks[k])).push(f"c{k}", [act])
        codes[k] = cntl.error_code

    try:
        _run_threads([lambda k=k: push(k) for k in range(PUSHES_9C)], "9c")
    finally:
        peer_control(ctl, "delay", seconds=0)
        peer_control(ctl, "limit", method="TensorStore.Push", max=0)
    rejected = sorted(k for k, c in codes.items() if c == errors.ELIMIT)
    accepted = sorted(k for k, c in codes.items() if c == 0)
    check(len(rejected) + len(accepted) == PUSHES_9C,
          f"9c: codes other than 0 and ELIMIT: {codes}")
    check(rejected, "9c: no push was refused with ELIMIT")
    st = peer_control(ctl, "state")
    check(st["push_status"]["rejected_count"] == len(rejected),
          f"9c: {len(rejected)} ELIMIT here, the peer rejected "
          f"{st['push_status']['rejected_count']}")
    stored = sorted(int(n[1:]) for n in st["contents"] if n.startswith("c"))
    check(stored == accepted,
          f"9c: the peer stored {stored}, it accepted {accepted}")
    for k in accepted:
        _, got = TensorClient(PinnedChannel(socks[k])).pull(f"c{k}", device=dev)
        check(got is not None and torch.equal(u8(got[0]), u8(act)),
              f"9c {k}: bytes differ")
    _sockets_at_rest(socks, "9c")
    _peer_at_rest(peer_control(ctl, "state"), "9c")
    out = {"accepted": len(accepted), "rejected": len(rejected),
           "peer_rejected_count": st["push_status"]["rejected_count"]}
    print(f"serve/9c: TensorStore.Push limited to {LIMIT_9C}, 50 ms each: of "
          f"{PUSHES_9C} concurrent pushes {len(accepted)} stored "
          f"byte-identical, {len(rejected)} refused with ELIMIT, as the "
          f"peer counts; no refused push stored; every client endpoint and "
          f"the send arena at rest {tag}")
    return out


def serve_stop(ctl, socks, big, tag: str):
    """9d: the peer stops while 8 pushes of 64 MiB are in flight."""
    peer_control(ctl, "delay", seconds=DELAY_9D)
    peer_control(ctl, "stop", after_s=STOP_AFTER_9D)
    ends = {}

    def push(k):
        cntl = Controller()
        cntl.timeout_ms = DEADLINE_9D_MS
        cntl._outbound_tensors = [big]
        call_on_socket(socks[k], "TensorStore.Push", cntl,
                       wire.TensorPushRequest(name=f"d{k}"),
                       wire.TensorPushResponse())
        ends[k] = (time.time(), cntl.error_code)

    t0 = time.time()
    _run_threads([lambda k=k: push(k) for k in range(PUSHES_9D)], "9d")
    codes = sorted({c for _, c in ends.values()})
    # the stop reaches a push as a read's EOF (ECLOSE), a failed write
    # (EFAILEDSOCKET) or a read's own errno when the peer reset the
    # connection with bytes still unread (ECONNRESET)
    check(all(c in (errors.ECLOSE, errors.EFAILEDSOCKET, errno.ECONNRESET)
              for c in codes),
          f"9d: the pushes ended with {codes}, not a socket error")
    last = max(t for t, _ in ends.values())
    check(last - t0 < DEADLINE_9D_MS / 1e3 / 2,
          f"9d: the last push failed {last - t0:.3f} s after it started")
    _sockets_at_rest(socks, "9d")
    out = {"codes": codes, "last_failure_after_start_s": round(last - t0, 3)}
    print(f"serve/9d: {PUSHES_9D} pushes of {list(big.shape)} {big.dtype} "
          f"in flight when the peer stopped {STOP_AFTER_9D} s in: every one "
          f"ended with {codes} within {out['last_failure_after_start_s']} s "
          f"of its start (deadline {DEADLINE_9D_MS / 1e3} s); every client "
          f"endpoint and the send arena at rest {tag}")
    return out, last


def phase_serve(tag: str, gen, naming: dict):
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                      device=dev, generator=gen)
    big = torch.randn((32 << 20,), dtype=torch.bfloat16, device=dev,
                      generator=gen)
    proc, port = start_peer()
    ctl = socks = None
    result, rc = {}, None
    try:
        ctl = Channel()
        check(ctl.init(f"127.0.0.1:{port}") == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        # 9b first: the peer's latency recorder then holds its pushes only
        result["concurrent"], socks = serve_concurrent(port, ctl, act, naming,
                                                       tag)
        result["one_channel"] = serve_one_channel(port, ctl, act, tag)
        result["connections"] = serve_many_connections(port, ctl, gen, tag)
        result["limiter"] = serve_limited(ctl, socks, act, tag)
        st = peer_control(ctl, "state")
        check(st["cuda_device_count"] == 1,
              f"9e: cuda_device_count reads {st['cuda_device_count']}")
        print(f"serve/9e: the peer's cuda_device_count is "
              f"{st['cuda_device_count']} {tag}")
        result["cuda_device_count"] = st["cuda_device_count"]
        result["stop"], last = serve_stop(ctl, socks[:PUSHES_9D], big, tag)
        rc = stop_peer(proc)
        said = proc.stdout.read().split()
        proc = None
        check(rc == 0, f"9d: the peer exited with code {rc}")
        check(said[:2] == ["peer", "stopped"],
              f"9d: the peer did not say when it stopped: {said}")
        stopped_at, in_flight = float(said[2]), int(said[3])
        check(in_flight >= 1, "9d: no push was in its handler at the stop")
        result["stop"].update(
            pushes_in_handlers_at_stop=in_flight,
            last_failure_after_stop_ms=round((last - stopped_at) * 1e3, 3))
        print(f"serve/9d: the peer stopped with {in_flight} pushes in their "
              f"handlers; the last push failed "
              f"{result['stop']['last_failure_after_stop_ms']} ms after the "
              f"stop; the peer exited 0 {tag}")
    finally:
        for sock in socks or []:
            sock.recycle()
        if ctl is not None:
            ctl.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"serve: phase took {result['seconds']} s {tag}")
    print("server " + json.dumps(result))
    return result


# -- phase 10: streams between two processes --------------------------------

# stream_lane_bench's shape (brpc_tpu/bench.py:310-380): 16 chunks of 4 MiB
# through a 64 MiB window, so no write waits for the window
STREAM_CHUNK = (2048, 1024)  # bfloat16: 4 MiB
STREAM_CHUNKS = 16
STREAM_WINDOW = 64 << 20
STREAM_WAIT_S = 120


def land(msg, shape, dev) -> torch.Tensor:
    """A stream message's bytes as a bfloat16 tensor on the card."""
    host = torch.frombuffer(msg.copy_to_bytes(), dtype=torch.bfloat16)
    return host.view(shape).to(dev)


class LandAndEcho(StreamInputHandler):
    """The peer's handler: lands each chunk on its card, echoes it back
    from there, and notes when the last one landed and when it closed."""

    def __init__(self, owner: "SmokeStreams"):
        self.owner = owner

    def on_received_messages(self, stream, messages):
        for m in messages:
            x = land(m, STREAM_CHUNK, torch.device("cuda"))
            torch.cuda.synchronize()
            with self.owner.lock:
                self.owner.landed += 1
                self.owner.landed_at = time.time()
                self.owner.landed_on = str(x.device)
            check(stream.write_tensor(x) == 0, "peer: echo write failed")

    def on_closed(self, stream):
        with self.owner.lock:
            self.owner.closed += 1


class SmokeStreams(Service):
    """The peer's stream service (examples/streaming_echo.py's shape):
    accepts a stream with a 64 MiB window and echoes what lands."""

    def __init__(self):
        self.lock = threading.Lock()
        self.accepted = []
        self.landed, self.landed_at, self.landed_on = 0, None, None
        self.closed = 0

    @rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Open(self, cntl, request, response, done):
        s = stream_accept(cntl, StreamOptions(handler=LandAndEcho(self),
                                              max_buf_size=STREAM_WINDOW))
        if s is None:
            cntl.set_failed(errors.EINVAL, "no stream in request")
        else:
            with self.lock:
                self.accepted.append(s)
        response.message = "accepted"
        done()

    def state(self) -> dict:
        with self.lock:
            return {"accepted": len(self.accepted),
                    "unconsumed": [s.unconsumed_bytes for s in self.accepted],
                    "open": [not s.closed for s in self.accepted],
                    "landed": self.landed, "landed_at": self.landed_at,
                    "landed_on": self.landed_on, "on_closed": self.closed,
                    "stream_count": find_exposed("stream_count").get_value()}


class LandEchoes(StreamInputHandler):
    """The client's handler: lands every echo on the card."""

    def __init__(self):
        self.lock = threading.Lock()
        self.got = []
        self.done = threading.Event()
        self.done_at = None
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        landed = [land(m, STREAM_CHUNK, torch.device("cuda"))
                  for m in messages]
        torch.cuda.synchronize()
        with self.lock:
            self.got.extend(landed)
            if len(self.got) >= STREAM_CHUNKS and not self.done.is_set():
                self.done_at = time.time()
                self.done.set()

    def on_closed(self, stream):
        self.closed.set()


def phase_streams(tag: str, gen):
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    chunks = [torch.randn(STREAM_CHUNK, dtype=torch.bfloat16, device=dev,
                          generator=gen) for _ in range(STREAM_CHUNKS)]
    expected = [c.clone() for c in chunks]
    nbytes = sum(c.numel() * c.element_size() for c in chunks)
    proc, port = start_peer()
    ch = stream = None
    failed = True
    try:
        ch = Channel()
        check(ch.init(f"127.0.0.1:{port}") == 0, "stream channel init")
        count0 = find_exposed("stream_count").get_value()
        handler = LandEchoes()
        cntl = Controller()
        cntl.timeout_ms = 60000
        stream = stream_create(cntl, StreamOptions(handler=handler,
                                                   max_buf_size=STREAM_WINDOW))
        ch.call_method("SmokeStreams.Open", cntl,
                       wire.EchoRequest(message="open"), wire.EchoResponse())
        check(not cntl.failed(), f"stream open: {cntl.error_text}")
        check(stream.wait_connected(30), "the stream was not bound")
        torch.cuda.synchronize()
        t0 = time.time()
        for c in chunks:
            check(stream.write_tensor(c) == 0, "stream write_tensor failed")
            # in place, on the card, right after the call: the bytes sent
            # are the ones the chunk held at the call
            u8(c).bitwise_not_()
        check(handler.done.wait(STREAM_WAIT_S),
              f"{len(handler.got)} of {STREAM_CHUNKS} echoes came back")
        round_trip = handler.done_at - t0
        st = peer_control(ch, "state")["streams"]
        one_way = st["landed_at"] - t0
        on = st["landed_on"]
        check(st["landed"] == STREAM_CHUNKS and on.startswith("cuda"),
              f"the peer landed {st['landed']} on {on}")
        check(all(y.device.type == "cuda" for y in handler.got),
              "an echo did not land on the card")
        check(all(torch.equal(u8(y), u8(x))
                  for y, x in zip(handler.got, expected)),
              "the echoes differ from what was written")
        check(not any(torch.equal(u8(y), u8(c))
                      for y, c in zip(handler.got, chunks)),
              "a change made after write_tensor reached the peer")
        _wait(lambda: stream.unconsumed_bytes == 0, 30,
              "the client's window at rest")
        _wait(lambda: peer_control(ch, "state")["streams"]["unconsumed"]
              == [0], 30, "the peer's window at rest")
        count_open = find_exposed("stream_count").get_value()
        stream.close()
        check(handler.closed.wait(30), "the client's on_closed did not run")
        _wait(lambda: peer_control(ch, "state")["streams"]["on_closed"] == 1,
              30, "the peer's on_closed")
        st = peer_control(ch, "state")["streams"]
        count1 = find_exposed("stream_count").get_value()
        check(count1 == count0 and st["stream_count"] == 0
              and st["open"] == [False],
              f"stream_count {count1} here (was {count0}), "
              f"{st['stream_count']} in the peer")
        print(f"streams: {STREAM_CHUNKS} write_tensor of bfloat16"
              f"{list(STREAM_CHUNK)} ({nbytes} B) from the card to the "
              f"peer's card in {one_way * 1e3:.3f} ms, "
              f"{nbytes / one_way / 1e9:.3f} GB/s one way; echoed back and "
              f"landed here in {round_trip * 1e3:.3f} ms, "
              f"{nbytes / round_trip / 1e9:.3f} GB/s round trip; "
              f"bit-equal {tag}")
        print(f"streams: each chunk flipped in place right after its "
              f"write_tensor came back with its old bytes; unconsumed_bytes "
              f"0 here and {st['unconsumed']} in the peer; stream_count "
              f"{count_open} -> {count1} here and {st['stream_count']} in the "
              f"peer after close; the peer's on_closed ran "
              f"({st['on_closed']}); phase took "
              f"{time.perf_counter() - t_start:.1f} s {tag}")
        print("streams " + json.dumps({
            "bytes": nbytes, "one_way_ms": round(one_way * 1e3, 3),
            "one_way_GBps": round(nbytes / one_way / 1e9, 3),
            "round_trip_ms": round(round_trip * 1e3, 3),
            "round_trip_GBps": round(nbytes / round_trip / 1e9, 3)}))
        failed = False
    finally:
        if stream is not None:
            stream.close()
        if ch is not None:
            ch.close()
        rc = stop_peer(proc)
    check(failed or rc == 0, f"the stream peer exited with code {rc}")


# -- phase 11: the card trace -------------------------------------------------

TRACE_S = 1.0
MARK_CYCLES = 1000  # torch.cuda._sleep between forwards: ~1 us on the card
MARKER = "spin_kernel"  # its kernel's name (aten/src/ATen/cuda/Sleep.cu)


# kernel kinds by name, first match wins (copies run as elementwise kernels)
KERNEL_KINDS = (("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
                ("copy", ("copy",)), ("scan", ("scan",)),
                ("reduce", ("reduce",)), ("softmax", ("softmax",)),
                ("elementwise", ("elementwise",)))


def kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def summarize_trace(body: bytes) -> dict:
    """The forward's device time from cuda_trace's zipped Chrome trace:
    kernels by device time and by kind, kernels per forward (between the
    markers the loop launches after each forward), the busy share of the
    window (the union of kernel intervals over it) and its longest idle
    gaps with the kernels on either side."""
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        (name,) = zf.namelist()
        events = json.loads(zf.read(name))["traceEvents"]
    window = max((e for e in events if e.get("cat") == "Trace"),
                 key=lambda e: e["dur"])
    w0, w1 = window["ts"], window["ts"] + window["dur"]
    kernels = sorted(
        (e for e in events if e.get("cat") == "kernel"
         and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
        key=lambda e: e["ts"])
    memcpy_us = sum(e["dur"] for e in events if e.get("cat") == "gpu_memcpy"
                    and w0 <= e["ts"] < w1)
    # cuBLAS launches with cuLaunchKernel, the rest with cudaLaunchKernel
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    host_ops = [e for e in events if e.get("cat") == "cpu_op"]

    def op_of(kernel) -> str:
        """The innermost host op that launched the kernel, or its name."""
        launch = launches.get(kernel.get("args", {}).get("correlation"))
        inner = None
        if launch is not None:
            for op in host_ops:
                if (op["tid"] == launch["tid"]
                        and op["ts"] <= launch["ts"] <= op["ts"] + op["dur"]
                        and (inner is None or op["dur"] < inner["dur"])):
                    inner = op
        return inner["name"] if inner is not None else kernel["name"][:60]

    marks = [k for k, e in enumerate(kernels) if MARKER in e["name"]]
    work = [e for e in kernels if MARKER not in e["name"]]
    # idle gaps: where no kernel runs, from the window's start to its end
    gaps, end, last = [], w0, None
    for e in work:
        if e["ts"] > end:
            gaps.append((e["ts"] - end, last, e))
        if e["ts"] + e["dur"] > end:
            end, last = min(e["ts"] + e["dur"], w1), e
    if w1 > end:
        gaps.append((w1 - end, last, None))
    busy_us = (w1 - w0) - sum(g for g, _, _ in gaps)
    fwds = [kernels[marks[i] + 1:marks[i + 1]] for i in range(len(marks) - 1)]
    per_fwd = [len(f) for f in fwds]
    by_name, by_kind = {}, {}
    for e in work:
        n, t, first = by_name.get(e["name"], (0, 0.0, e))
        by_name[e["name"]] = (n + 1, t + e["dur"], first)
    for f in fwds:
        for e in f:
            n, t = by_kind.get(kernel_kind(e["name"]), (0, 0.0))
            by_kind[kernel_kind(e["name"])] = (n + 1, t + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    fwd_us = sum(t for _, t in by_kind.values())
    return {
        "window_ms": round((w1 - w0) / 1e3, 3),
        "kernels": len(work), "forwards": len(fwds),
        "kernels_per_forward": (statistics.median(per_fwd)
                                if per_fwd else None),
        "kernels_per_forward_range": ([min(per_fwd), max(per_fwd)]
                                      if per_fwd else None),
        "forward_device_ms": (round(statistics.median(
            sum(e["dur"] for e in f) for f in fwds) / 1e3, 3)
            if fwds else None),
        "per_forward_by_kind": {
            k: {"launches": round(n / len(fwds), 1),
                "ms": round(t / len(fwds) / 1e3, 3),
                "share": round(t / fwd_us, 4)}
            for k, (n, t) in sorted(by_kind.items(),
                                    key=lambda kv: -kv[1][1])},
        "busy_ms": round(busy_us / 1e3, 3),
        "busy_share": round(busy_us / (w1 - w0), 4),
        "memcpy_ms": round(memcpy_us / 1e3, 3),
        "longest_idle_gaps": [
            {"ms": round(g / 1e3, 3),
             "after": op_of(a) if a is not None else "window start",
             "before": op_of(b) if b is not None else "window end"}
            for g, a, b in sorted(gaps, key=lambda g: -g[0])[:5]],
        "idle_gaps_over_100us": sum(1 for g, _, _ in gaps if g > 100),
        "top10": [{"name": n[:120], "op": op_of(first), "count": c,
                   "ms": round(t / 1e3, 3),
                   "share_of_busy": round(t / busy_us, 4) if busy_us else None}
                  for n, (c, t, first) in top],
    }


def phase_trace(tokens: torch.Tensor, tag: str):
    """A thread takes cuda_trace while this one runs phase 3's forward in
    a loop, one forward at a time, a marker kernel after each."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(BIG, gen, device=dev)
    for _ in range(FWD_WARMUP):
        forward_local(params, tokens, BIG)
    torch.cuda.synchronize()
    out = {}
    tracer = threading.Thread(
        target=lambda: out.update(trace=cuda_trace(TRACE_S)))
    t_trace = time.perf_counter()
    tracer.start()
    forwards, fwd_s = 0, []
    while tracer.is_alive():
        t0 = time.perf_counter()
        forward_local(params, tokens, BIG)
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        forwards += 1
    tracer.join()
    trace_s = time.perf_counter() - t_trace
    del params
    ctype, body = out["trace"]
    check(ctype == "application/zip", f"cuda_trace gave {ctype}: {body!r}")
    summary = summarize_trace(body)
    check(summary["kernels"] > 0, "the trace holds no kernel")
    check(summary["forwards"] >= 1, "the trace holds no whole forward")
    summary["call_s"] = round(trace_s, 3)
    print(f"trace: cuda_trace({TRACE_S}) took {summary['call_s']} s (the "
          f"profiler's start, the window, its stop and the export) while "
          f"{forwards} forwards ran "
          f"(host median {statistics.median(fwd_s) * 1e3:.3f} ms each, the "
          f"profiler's host cost included): "
          f"a {len(body)} B zip, window {summary['window_ms']} ms, "
          f"{summary['kernels']} kernels, {summary['forwards']} whole "
          f"forwards of {summary['kernels_per_forward']} kernels "
          f"(range {summary['kernels_per_forward_range']}), "
          f"{summary['forward_device_ms']} ms of kernel time per forward; "
          f"the card was busy {summary['busy_ms']} ms, "
          f"{summary['busy_share']:.1%} of the window; "
          f"{summary['memcpy_ms']} ms of copies by the copy engines; "
          f"{summary['idle_gaps_over_100us']} idle gaps over 100 us {tag}")
    for kind, row in summary["per_forward_by_kind"].items():
        print(f"trace per forward (mean): {kind} {row['launches']} "
              f"launches, {row['ms']} ms ({row['share']:.1%} of its kernel "
              f"time)")
    for k, row in enumerate(summary["top10"], 1):
        print(f"trace top {k}: {row['ms']} ms in {row['count']} launches "
              f"({row['share_of_busy']:.1%} of busy) by {row['op']}: "
              f"{row['name']}")
    for row in summary["longest_idle_gaps"]:
        print(f"trace idle gap: {row['ms']} ms after {row['after']} "
              f"before {row['before']}")
    print(f"trace: phase took {time.perf_counter() - t_start:.1f} s {tag}")
    print("trace " + json.dumps(summary))


# -- phase 12: the console of a card server, under load ----------------------

CONSOLE_ROWS = 4  # the activations pushed as their 4 sequences, 2 MiB each
CONSOLE_PAGES = ("/health", "/version", "/status", "/vars",
                 "/vars/device_transport_shm_transfers", "/brpc_metrics",
                 "/connections", f"/flags/{PREFER_XFER}")
CONSOLE_TRACE_S = 1.0
CONSOLE_CPU_S = 0.5
TRACE_BUSY = "profiler trace failed: a trace is running\n"


def http_get(port: int, path: str, timeout_s: float = 60.0, method="GET",
             body=None, headers=None):
    """(status, headers, body, ms) of one request on a new connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        return r.status, {k.lower(): v for k, v in r.getheaders()}, data, ms
    finally:
        conn.close()


def channel_get(ch: Channel, path: str):
    """A console page through the port's HTTP channel: (body, ms)."""
    cntl = Controller()
    cntl.timeout_ms = 60000
    cntl.http_request = HttpRequest("GET", path)
    t0 = time.perf_counter()
    ch.call_method("", cntl, None, None)
    ms = round((time.perf_counter() - t0) * 1e3, 3)
    check(not cntl.failed(), f"12: GET {path} over the port's HTTP channel: "
          f"{cntl.error_text}")
    return cntl.http_response.body.to_bytes(), ms


def _var_of(text: bytes, name: str, sep: bytes = b" : ") -> int:
    """The value of ``name`` on a /vars (sep " : ") or /brpc_metrics
    (sep " ") page."""
    for line in text.split(b"\n"):
        if line.startswith(name.encode() + sep):
            return int(float(line[len(name) + len(sep):]))
    raise RuntimeError(f"chip_smoke: {name} is not on the page")


def _push_count(status_page: bytes, method: str = PUSH_LABEL) -> int:
    """The count /status gives ``method`` (TensorStore.Push by default)."""
    for line in status_page.split(b"\n"):
        if line.startswith(method.encode() + b": "):
            return int(line.split(b" count=")[1].split()[0])
    raise RuntimeError(f"chip_smoke: /status lists no {method}")


def summarize_peer_trace(body: bytes) -> dict:
    """The peer's card work and its Push landings in its cuda_trace."""
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        (name,) = zf.namelist()
        events = json.loads(zf.read(name))["traceEvents"]
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    d2h = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    pushes = [e for e in events if e.get("name") == PUSH_LABEL
              and e.get("cat") in ("user_annotation", "cpu_op")]
    devices = sorted({e.get("args", {}).get("device") for e in h2d + d2h
                      if e.get("args", {}).get("device") is not None})
    return {"zip_bytes": len(body), "events": len(events),
            "by_category": {str(k): v for k, v in sorted(
                cats.items(), key=lambda kv: -kv[1])[:8]},
            "h2d_copies": len(h2d),
            "h2d_mb": round(sum(e.get("args", {}).get("bytes", 0)
                                for e in h2d) / 1e6, 3),
            "d2h_copies": len(d2h), "push_ops": len(pushes),
            "card_devices": devices}


def phase_console(tag: str, gen):
    """12: the console of a --peer on the card while this process pushes
    and pulls the activations over the shm lane from a thread."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                      device=dev, generator=gen)
    rows = list(act.unbind(0))  # 2 MiB each: one pool block each
    proc, port = start_peer()
    ctl = sock = hch = None
    result, rc = {"pages_ms": {}}, None
    stop, errs, made = threading.Event(), [], [0]
    push_s, pull_s = [], []

    def load():
        client = TensorClient(PinnedChannel(sock))
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                cntl, resp = client.push("c12", rows)
                t1 = time.perf_counter()
                check(not cntl.failed() and resp.ok,
                      f"12 push: {cntl.error_text}")
                made[0] += 1
                pcntl, got = client.pull("c12", device=dev)
                push_s.append(t1 - t0)
                pull_s.append(time.perf_counter() - t1)
                check(not pcntl.failed() and got is not None,
                      f"12 pull: {pcntl.error_text}")
                check(all(torch.equal(u8(g), u8(r)) for g, r in
                          zip(got, rows)), "12: pulled bytes differ")
        except Exception as e:  # reported by the phase
            errs.append(e)

    loader = threading.Thread(target=load)
    try:
        ctl = Channel()
        check(ctl.init(f"127.0.0.1:{port}") == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        hch = Channel(ChannelOptions(protocol="http", timeout_ms=60000))
        check(hch.init(f"127.0.0.1:{port}") == 0, "12: HTTP channel init")
        sock = device_socket(port)
        lanes0 = dt.lane_counters()
        before = {"vars": http_get(port, "/vars/device_")[2],
                  "metrics": http_get(port, "/brpc_metrics")[2]}
        loader.start()
        _wait(lambda: made[0] >= 2 or errs, 60, "12: the load starts")
        pages = {}
        for path in CONSOLE_PAGES:
            status, headers, body, ms = http_get(port, path)
            check(status == 200, f"12: GET {path} answered {status}")
            pages[path] = body
            result["pages_ms"][path] = ms
        check(pages["/health"] == b"OK\n", "12: /health")
        check(pages["/version"].startswith(b"brpc_tpu_torch/"), "12: /version")
        local = "%s:%d" % sock.fd().getsockname()[:2]
        check(local.encode() in pages["/connections"],
              f"12: /connections does not list {local}")
        check(pages[f"/flags/{PREFER_XFER}"].startswith(
            f"{PREFER_XFER}=False (default=False) [reloadable]".encode()),
            f"12: /flags/{PREFER_XFER}")
        # the port's HTTP channel: pages and a JSON call
        for path in ("/status", "/vars/device_transport_shm_transfers",
                     "/brpc_metrics"):
            body, ms = channel_get(hch, path)
            # the same first line but for a count the load moves meanwhile
            check(body.split(b"\n")[0].split(b" : ")[0]
                  == pages[path].split(b"\n")[0].split(b" : ")[0],
                  f"12: {path} over the channel: {body[:80]!r}")
            result["pages_ms"][f"channel {path}"] = ms
        state = json.dumps({"name": json.dumps({"op": "state"})})
        status, _, body, ms = http_get(
            port, "/SmokePeer/Control", method="POST", body=state,
            headers={"Content-Type": "application/json"})
        check((status, json.loads(body)) == (200, {"ok": True}),
              f"12: SmokePeer.Control as JSON: {status} {body!r}")
        result["pages_ms"]["POST /SmokePeer/Control"] = ms
        t0 = time.perf_counter()
        cntl, resp = hch.call("SmokePeer.Control",
                              wire.TensorPullRequest(name=json.dumps(
                                  {"op": "state"})), wire.TensorAckResponse,
                              timeout_ms=60000)
        result["pages_ms"]["channel SmokePeer.Control"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        check(not cntl.failed() and resp.ok,
              f"12: SmokePeer.Control over the HTTP channel: {cntl.error_text}")
        # the profilers
        status, _, body, ms = http_get(
            port, f"/hotspots/cpu?seconds={CONSOLE_CPU_S}")
        check(status == 200 and b"Push (" in body,
              "12: /hotspots/cpu names no Push handler")
        result["pages_ms"][f"/hotspots/cpu?seconds={CONSOLE_CPU_S}"] = ms
        traced = {}
        tracer = threading.Thread(target=lambda: traced.update(zip(
            ("status", "headers", "body", "ms"),
            http_get(port, f"/hotspots/tpu?seconds={CONSOLE_TRACE_S}"))))
        tracer.start()
        time.sleep(0.3)  # the first trace holds the profiler by now
        status, _, second, ms = http_get(port, "/hotspots/tpu?seconds=0.1")
        check(status == 200 and second == TRACE_BUSY.encode(),
              f"12: a second trace was not refused: {second[:80]!r}")
        result["pages_ms"]["/hotspots/tpu refused"] = ms
        tracer.join(120)
        check(not tracer.is_alive(), "12: /hotspots/tpu hangs")
        check(traced.get("status") == 200
              and traced["headers"].get("content-type") == "application/zip",
              f"12: /hotspots/tpu answered {traced.get('status')} "
              f"{traced.get('body', b'')[:80]!r}")
        result["pages_ms"][f"/hotspots/tpu?seconds={CONSOLE_TRACE_S}"] = (
            traced["ms"])
        trace = summarize_peer_trace(traced["body"])
        check(trace["h2d_copies"] > 0 and trace["push_ops"] > 0,
              f"12: the peer's trace lacks its card work: {trace}")
        result["trace"] = trace
        stop.set()
        loader.join(60)
        check(not loader.is_alive(), "12: the load hangs")
        if errs:
            raise errs[0]
        # the counts, with the load stopped
        pushes = made[0]
        after = {"vars": http_get(port, "/vars/device_")[2],
                 "metrics": http_get(port, "/brpc_metrics")[2],
                 "status": http_get(port, "/status")[2]}
        moved = {
            "status_push_count": _push_count(after["status"]),
            "shm_transfers": (
                _var_of(after["vars"], "device_transport_shm_transfers")
                - _var_of(before["vars"], "device_transport_shm_transfers")),
            "pool_acquired": (
                _var_of(after["metrics"], "device_block_pool_acquired", b" ")
                - _var_of(before["metrics"], "device_block_pool_acquired",
                          b" ")),
            "pool_released": (
                _var_of(after["metrics"], "device_block_pool_released", b" ")
                - _var_of(before["metrics"], "device_block_pool_released",
                          b" ")),
            "client_shm_sends": dt.lane_counters()["shm"] - lanes0["shm"]}
        want = {"status_push_count": pushes, "shm_transfers": pushes,
                "pool_acquired": CONSOLE_ROWS * pushes,
                "pool_released": CONSOLE_ROWS * pushes,
                "client_shm_sends": pushes}
        check(moved == want, f"12: the console's counts {moved}, the pushes "
              f"made say {want}")
        result.update(pushes=pushes, counts=moved,
                      push_ms_median=_ms(push_s), push_ms_p99=_p99(push_s),
                      pull_ack_ms_median=_ms(pull_s),
                      pull_ack_ms_p99=_p99(pull_s))
        st = peer_control(ctl, "state")
        _peer_at_rest(st, "12")
        _pool_full(st, "12")
        _sockets_at_rest([sock], "12")
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"12: the peer exited with code {rc}")
    finally:
        stop.set()
        if loader.is_alive():
            loader.join(60)
        if sock is not None:
            sock.recycle()
        for ch in (ctl, hch):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    t = result["trace"]
    print(f"console/12: {result['pushes']} pushes of the activations as "
          f"{CONSOLE_ROWS} x {list(rows[0].shape)} {act.dtype} over the shm "
          f"lane, each landed on the peer's card through its block pool, and "
          f"as many pulls + ACKs, byte-identical (push median "
          f"{result['push_ms_median']} ms p99 {result['push_ms_p99']} ms, "
          f"pull+ACK median {result['pull_ack_ms_median']} ms p99 "
          f"{result['pull_ack_ms_p99']} ms); meanwhile every page "
          f"answered: " + ", ".join(f"{p} {ms} ms" for p, ms in
                                    result["pages_ms"].items()) + "; "
          f"/status, /vars and /brpc_metrics moved by the pushes made "
          f"({result['counts']}); the peer's {CONSOLE_TRACE_S} s trace: "
          f"{t['zip_bytes']} B zipped, {t['events']} events, "
          f"{t['h2d_copies']} H2D copies ({t['h2d_mb']} MB) and "
          f"{t['d2h_copies']} D2H on devices {t['card_devices']}, "
          f"{t['push_ops']} {PUSH_LABEL} landings; the second trace refused; "
          f"both sides at rest, the peer exited 0 {tag}")
    print(f"console: phase took {result['seconds']} s {tag}")
    print("console " + json.dumps(result))
    return result

# -- phase 13: spans, compression, a progressive download, record, replay ---

TRACE_PUSHES_13 = 8
CODECS_13 = (("gzip", COMPRESS_GZIP, 4 << 20), ("zlib", COMPRESS_ZLIB, 4 << 20),
             ("snappy", COMPRESS_SNAPPY, 512 << 10))  # snappy is pure Python
REPLAYS_13 = 16
_SPAN_LINE = re.compile(
    r"trace=([0-9a-f]{16}) span=([0-9a-f]{16}) parent=([0-9a-f]{16}) "
    r"\[(\w+)\] (\S+) remote=\S+ latency=(\d+)us error=(-?\d+) "
    r"req=(\d+)B resp=(\d+)B")


def peer_spans(port: int, trace_id: int):
    """The spans of one trace on the peer's /rpcz page, and the page's ms."""
    status, _, body, ms = http_get(port, f"/rpcz?trace_id={trace_id:x}")
    check(status == 200, f"13: /rpcz answered {status}")
    spans = []
    for line in body.decode().splitlines():
        m = _SPAN_LINE.match(line)
        if m:
            spans.append({"trace": int(m[1], 16), "span": int(m[2], 16),
                          "parent": int(m[3], 16), "kind": m[4],
                          "method": m[5], "latency_us": int(m[6]),
                          "error": int(m[7]), "req": int(m[8])})
    return spans, ms


def trace_three_hops(port: int, ctl, devch, act, tag: str) -> dict:
    """13a: each push's four spans, linked hop by hop."""
    client = TensorClient(devch)
    peer_control(ctl, "relay", on=True)
    push_s, page_ms, sizes = [], [], set()
    for i in range(TRACE_PUSHES_13):
        t0 = time.perf_counter()
        cntl, resp = client.push(f"t{i}", [act])
        push_s.append(time.perf_counter() - t0)
        check(not cntl.failed() and resp.ok, f"13a push {i}: {cntl.error_text}")
        mine = rpcz.find_trace(cntl.trace_id)
        check(len(mine) == 1 and (mine[0].kind, mine[0].full_method,
                                  mine[0].error_code)
              == ("client", PUSH_LABEL, 0),
              f"13a push {i}: this process's spans {[s.describe() for s in mine]}")
        theirs, ms = peer_spans(port, cntl.trace_id)
        page_ms.append(ms)
        chain, parent = [], mine[0].span_id
        for kind in ("server", "client", "server"):
            hop = [s for s in theirs if s["parent"] == parent]
            check(len(hop) == 1 and hop[0]["kind"] == kind
                  and hop[0]["method"] == PUSH_LABEL and hop[0]["error"] == 0
                  and hop[0]["trace"] == cntl.trace_id,
                  f"13a push {i}: no {kind} span under {parent:016x} "
                  f"on the peer: {theirs}")
            chain.append(hop[0])
            parent = hop[0]["span"]
        check(len(theirs) == 3, f"13a push {i}: the peer's trace {theirs}")
        sizes.add(chain[0]["req"])
    st = peer_control(ctl, "state")
    want = sorted(f"t{i}" for i in range(TRACE_PUSHES_13))
    check(st["relay_stored"] == want,
          f"13a: the second server stores {st['relay_stored']}")
    check(all(d.startswith("cuda") for n in want for d in st["contents"][n]),
          "13a: a push is not on the peer's card")
    peer_control(ctl, "relay", on=False)
    out = {"pushes": TRACE_PUSHES_13, "push_ms_median": _ms(push_s),
           "rpcz_page_ms_median": round(statistics.median(page_ms), 3),
           "server_span_request_size_B": sorted(sizes)}
    print(f"tracing/13a: {TRACE_PUSHES_13} pushes of {list(act.shape)} "
          f"{act.dtype} (push median {out['push_ms_median']} ms), each one "
          f"trace of 4 spans: this process's client Push -> the peer's "
          f"server Push -> its client Push -> the second server's Push, "
          f"parents chained, errors 0, the second server holding each; "
          f"/rpcz?trace_id= median {out['rpcz_page_ms_median']} ms; the "
          f"server span's request_size {sorted(sizes)} B for "
          f"{act.numel() * act.element_size()} B of tensor (queue C #17) "
          f"{tag}")
    return out


# spans on and off in turns, so that neither always runs first or last
RPCZ_TURNS_13 = (True, False, False, True) * 2
SPANS_TIMED_13 = 10000


def rpcz_cost(port: int, ctl, act, naming: dict, tag: str) -> dict:
    """13b: the host time of one span, then 9b's load with spans on in
    both processes and off, in turns."""
    holder = Controller()
    t0 = time.perf_counter()
    for _ in range(SPANS_TIMED_13):
        rpcz.start_client_span(PUSH_LABEL, holder).end(0)
    span_us = (time.perf_counter() - t0) / SPANS_TIMED_13 * 1e6
    rpcz.clear_for_tests()
    out = {"span_open_end_us": round(span_us, 3), "on": [], "off": []}
    try:
        for on in RPCZ_TURNS_13:
            label = "on" if on else "off"
            check(flags.set_flag("enable_rpcz", on), "enable_rpcz here")
            peer_control(ctl, "set_flag", name="enable_rpcz", value=on)
            peer_control(ctl, "rpcz_clear")
            res, socks = serve_concurrent(port, ctl, act, naming,
                                          f"(13b, rpcz {label}) {tag}")
            for sock in socks:
                sock.recycle()
            st = peer_control(ctl, "state")["rpcz"]
            pushes = THREADS_9B * ROUNDS_9B
            want = min(pushes, st["max_spans"]) if on else 0
            check(st["sample_every"] == 1 and st["server_pushes"] == want,
                  f"13b rpcz {label}: the peer collected "
                  f"{st['server_pushes']} server Push spans, want {want}")
            run = {k: res[k] for k in (
                "push_ms_median", "push_ms_p99", "pull_ack_ms_median",
                "pull_ack_ms_p99", "aggregate_GBps")}
            run["peer_server_push_spans"] = st["server_pushes"]
            out[label].append(run)
    finally:
        flags.set_flag("enable_rpcz", True)
        peer_control(ctl, "set_flag", name="enable_rpcz", value=True)

    def runs(label, key):
        return [r[key] for r in out[label]]

    turns = ", ".join("on" if on else "off" for on in RPCZ_TURNS_13)
    print(f"tracing/13b: a span opened and ended in {out['span_open_end_us']} "
          f"us on this host; 9b's load ({THREADS_9B} connections x {ROUNDS_9B} "
          f"push + pull + ACK) in turns {turns}; rpcz on: "
          f"push median {runs('on', 'push_ms_median')} ms p99 "
          f"{runs('on', 'push_ms_p99')} ms, pull+ACK median "
          f"{runs('on', 'pull_ack_ms_median')} ms, "
          f"{runs('on', 'peer_server_push_spans')} server Push spans on the "
          f"peer; off: push median {runs('off', 'push_ms_median')} ms p99 "
          f"{runs('off', 'push_ms_p99')} ms, pull+ACK median "
          f"{runs('off', 'pull_ack_ms_median')} ms, "
          f"{runs('off', 'peer_server_push_spans')} spans {tag}")
    return out


def _push_compressed(devch, name: str, tensors, ctype: int):
    """TensorClient.push with the request message compressed."""
    cntl = Controller()
    cntl.timeout_ms = 60000
    cntl.compress_type = ctype
    cntl._outbound_tensors = tensors
    resp = wire.TensorPushResponse()
    devch.call_method("TensorStore.Push", cntl,
                      wire.TensorPushRequest(name=name), resp)
    check(not cntl.failed() and resp.ok,
          f"13c compressed push: {cntl.error_text}")
    ep = cntl._current_sock.app_state
    if isinstance(ep, dt.DeviceEndpoint) and resp.ack_seq:
        ep.on_ack(resp.ack_seq)
    return cntl


def compressed_calls(port: int, ctl, devch, act, gen, tag: str) -> dict:
    """13c: token ids each way under every codec, then a gzip push."""
    dev = torch.device("cuda")
    n = max(nbytes for _, _, nbytes in CODECS_13) // 4
    tokens = torch.randint(0, BIG.vocab, (n,), dtype=torch.int32, device=dev,
                           generator=gen)
    raw = tokens.cpu().numpy().tobytes()
    out = {}
    for codec, ctype, nbytes in CODECS_13:
        data = raw[:nbytes]
        cntl = Controller()
        cntl.timeout_ms = 60000
        cntl.compress_type = ctype
        resp = Blob()
        t0 = time.perf_counter()
        ctl.call_method("SmokePeer.Echo", cntl, Blob(data), resp)
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        check(not cntl.failed(), f"13c {codec}: {cntl.error_text}")
        check(resp.data == data, f"13c {codec}: the echoed bytes differ")
        check(cntl._response_rpc_meta.compress_type == ctype,
              f"13c {codec}: the response came with compress_type "
              f"{cntl._response_rpc_meta.compress_type}")
        server = [s for s in peer_spans(port, cntl.trace_id)[0]
                  if s["kind"] == "server"]
        check(len(server) == 1 and 0 < server[0]["req"] < nbytes,
              f"13c {codec}: the peer's span {server}")
        out[codec] = {"bytes": nbytes, "compressed_bytes": server[0]["req"],
                      "ms": ms}
    cntl = _push_compressed(devch, "gz", [act], COMPRESS_GZIP)
    server = [s for s in peer_spans(port, cntl.trace_id)[0]
              if s["kind"] == "server"]
    check(len(server) == 1 and server[0]["error"] == 0,
          f"13c gzip push: the peer's span {server}")
    st = peer_control(ctl, "state")
    check([d[:4] for d in st["contents"]["gz"]] == ["cuda"],
          "13c gzip push: not on the peer's card")
    pcntl, got = TensorClient(devch).pull("gz", device=dev)
    check(not pcntl.failed() and got is not None
          and torch.equal(u8(got[0]), u8(act)),
          f"13c gzip push: the landing differs ({pcntl.error_text})")
    out["gzip_push"] = {"request_payload_B": server[0]["req"],
                        "tensor_B": act.numel() * act.element_size()}
    print("tracing/13c: SmokePeer.Echo of the flagship's int32 token ids, "
          "request and response compressed, bytes equal: " + ", ".join(
              f"{c} {v['bytes']} B -> {v['compressed_bytes']} B in "
              f"{v['ms']} ms" for c, v in out.items() if c != "gzip_push")
          + f"; a gzip push of {list(act.shape)} {act.dtype} "
          f"({out['gzip_push']['request_payload_B']} B of payload) landed "
          f"on the peer's card bit-equal {tag}")
    return out


def progressive_download(ctl, devch, act, tag: str) -> dict:
    """13d: the activations from the peer's card, chunk by chunk."""
    cntl, resp = TensorClient(devch).push("p13", [act])
    check(not cntl.failed() and resp.ok, f"13d push: {cntl.error_text}")
    want = u8(act).cpu().numpy().tobytes()
    reader = ProgressiveReader()
    cntl = Controller()
    cntl.timeout_ms = 60000
    attach_progressive_reader(cntl, reader)
    resp = wire.TensorAckResponse()
    t0 = time.perf_counter()
    ctl.call_method("SmokePeer.Download", cntl,
                    wire.TensorPullRequest(name="p13"), resp)
    check(not cntl.failed() and resp.ok, f"13d Download: {cntl.error_text}")
    chunks, first = [], None
    while True:
        chunk = reader.next_chunk(STREAM_WAIT_S)
        if chunk is None:
            break
        first = first or time.perf_counter()
        chunks.append(chunk)
    wall = time.perf_counter() - t0
    check(reader.ended, "13d: the body did not end")
    check(len(chunks) == len(want) // PROGRESSIVE_CHUNK
          and b"".join(chunks) == want,
          f"13d: {len(chunks)} chunks, {sum(map(len, chunks))} B, not the "
          f"tensor's bytes")
    out = {"bytes": len(want), "chunks": len(chunks),
           "first_chunk_ms": round((first - t0) * 1e3, 3),
           "MBps": round(len(want) / wall / 1e6, 3)}
    print(f"tracing/13d: a progressive download of {len(want)} B in "
          f"{len(chunks)} chunks from the peer's card, equal to the tensor; "
          f"first chunk after {out['first_chunk_ms']} ms, {out['MBps']} MB/s "
          f"{tag}")
    return out


def record_and_replay(port: int, ctl, devch, act, tag: str) -> dict:
    """13e: rpc_dump of Control calls and pushes, then their replay."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_rpc_dump_")
    client = TensorClient(devch)
    try:
        rpc_dump.reset_for_tests()  # the next record opens a new file
        check(flags.set_flag("rpc_dump_dir", directory), "rpc_dump_dir")
        check(flags.set_flag("rpc_dump", True), "rpc_dump")
        try:
            for i in range(REPLAYS_13):
                peer_control(ctl, "state")
                cntl, resp = client.push(f"r{i}", [act])
                check(not cntl.failed() and resp.ok,
                      f"13e push {i}: {cntl.error_text}")
        finally:
            flags.set_flag("rpc_dump", False)
            rpc_dump.reset_for_tests()  # closes the file
        records = []
        for path in sorted(glob.glob(os.path.join(directory, "*.rio"))):
            with RecordReader(path) as reader:
                records.extend(reader)
        methods = sorted(f"{m['service']}.{m['method']}" for m, _ in records)
        check(methods == ["SmokePeer.Control"] * REPLAYS_13
              + [PUSH_LABEL] * REPLAYS_13,
              f"13e: the dump holds {len(records)} records: {methods}")
        push_bytes = {len(p) for m, p in records if m["method"] == "Push"}
        # the replay by the port's tool; its server spans on the peer say
        # how each call ended
        peer_control(ctl, "rpcz_clear")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = rpc_replay.main(["--dir", directory, "--server",
                                  f"127.0.0.1:{port}", "--timeout-ms",
                                  "60000"])
        ms = round((time.perf_counter() - t0) * 1e3, 3)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    line = printed.getvalue().strip()
    check(rc == 1 and line.startswith(
        f"replayed ok={REPLAYS_13} failed={REPLAYS_13} skipped=0 in "),
        f"13e: rpc_replay exited {rc}: {line!r}")
    status, _, body, _ = http_get(port, "/rpcz?limit=200")
    check(status == 200, f"13e: /rpcz answered {status}")
    outcomes = {}
    for m in map(_SPAN_LINE.match, body.decode().splitlines()):
        if m and m[4] == "server":
            key = f"{m[5]} {m[7]}"
            outcomes[key] = outcomes.get(key, 0) + 1
    # the Control call that cleared the spans is the 17th Control span
    want = {"SmokePeer.Control 0": REPLAYS_13 + 1,
            f"{PUSH_LABEL} {errors.EREQUEST}": REPLAYS_13}
    check(outcomes == want, f"13e: the replay gave {outcomes}, want {want}")
    out = {"records": len(records), "push_record_bytes": sorted(push_bytes),
           "replay_ms": ms, "replay_line": line, "outcomes": outcomes}
    print(f"tracing/13e: rpc_dump recorded {len(records)} requests "
          f"({REPLAYS_13} SmokePeer.Control, {REPLAYS_13} pushes of "
          f"{sorted(push_bytes)} B each: the tensors are not recorded); "
          f"replayed by tools/rpc_replay in {ms} ms ({line}): the Control "
          f"calls answered, every Push "
          f"failed with {errors.EREQUEST} on the peer (its server spans), "
          f"as in the reference (queue C #16) {tag}")
    return out


def phase_tracing(tag: str, gen, naming: dict):
    """13: rpcz across three hops and its cost on the lane, compression,
    a progressive download from the card, rpc_dump and its replay."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                      device=dev, generator=gen)
    proc, port = start_peer()
    ctl = devch = None
    result, rc = {}, None
    streams0 = find_exposed("stream_count").get_value()
    try:
        ctl = Channel()
        check(ctl.init(f"127.0.0.1:{port}") == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        devch = _device_channel(f"127.0.0.1:{port}")
        # a warm landing and pull, then the peer's card memory at rest
        client = TensorClient(devch)
        check(not client.push("warm", [act])[0].failed(), "13: warm push")
        check(not client.pull("warm", device=dev)[0].failed(), "13: warm pull")
        peer0 = peer_control(ctl, "reset")["memory_allocated"]
        result["trace"] = trace_three_hops(port, ctl, devch, act, tag)
        result["rpcz_cost"] = rpcz_cost(port, ctl, act, naming, tag)
        result["compress"] = compressed_calls(port, ctl, devch, act, gen, tag)
        result["progressive"] = progressive_download(ctl, devch, act, tag)
        result["rpc_dump"] = record_and_replay(port, ctl, devch, act, tag)
        st = peer_control(ctl, "reset")
        _peer_at_rest(st, "13")
        _pool_full(st, "13")
        _client_at_rest(devch, "13")
        check(st["memory_allocated"] == peer0,
              f"13: card memory leaked in the peer: {peer0} -> "
              f"{st['memory_allocated']} B")
        check(st["streams"]["stream_count"] == 0
              and find_exposed("stream_count").get_value() == streams0,
              f"13: streams left open: the peer's "
              f"{st['streams']['stream_count']}, here "
              f"{find_exposed('stream_count').get_value()} (was {streams0})")
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"13: the peer exited with code {rc}")
    finally:
        flags.set_flag("rpc_dump", False)
        for ch in (ctl, devch):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"tracing/13: the peer's windows, arena, streams and card memory "
          f"({st['memory_allocated']} B) at rest, the peer exited 0; phase "
          f"took {result['seconds']} s {tag}")
    print("tracing " + json.dumps(result))
    return result


# -- phase 14: the examples and the tools -------------------------------------

MB_14, ITERS_14 = 8, 10  # tensor_transport --mb 8 --iters 10
PUSHERS_14 = (4, 8, 16)  # 14b at the peer: threads, MiB, pushes each
PRESS_S_14 = 3.0
PRESS_QPS_14 = 200
FETCHES_14 = (64, 4)  # 14e: fetches of /status, threads
VARS_14 = ("TensorStore_Push_count", "device_block_pool_acquired",
           "device_block_pool_released", "device_transport_zero_copy_transfers",
           "device_transport_shm_transfers", "device_transport_wire_transfers",
           "device_transport_xfer_transfers")
HOST_EXAMPLES_14 = (
    (echo, ["demo"]), (asynchronous_echo, []),
    (multi_threaded_echo, ["--threads", "2", "--seconds", "0.5"]),
    (streaming_echo, []), (http_server, []), (session_data, []),
    (backup_request, []), (auto_concurrency_limiter, []), (cascade_echo, []),
    (partition_echo, []), (selective_echo, []), (dynamic_partition_echo, []))


def run_main(main, argv):
    """(exit code, printed lines, seconds) of a program's main, run here."""
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = main(argv)
    return rc, printed.getvalue().splitlines(), round(
        time.perf_counter() - t0, 3)


def _one_line(lines, prefix: str, what: str) -> str:
    hit = [line for line in lines if line.startswith(prefix)]
    check(len(hit) == 1, f"{what}: no one line {prefix!r} in {lines}")
    return hit[0]


def _rate(line: str) -> float:
    return float(re.search(r"-> ([0-9.]+) GB/s", line)[1])


def transport_example(tag: str) -> dict:
    """14a, as a user runs it: tensor_transport on the card, in process
    (a ticket stands for the card tensor) and to its own port server in a
    subprocess on the same card (the shm lane)."""
    rc, lines, secs = run_main(tensor_transport.main,
                               ["--mb", str(MB_14), "--iters", str(ITERS_14)])
    check(rc == 0, f"14a: tensor_transport exited {rc}: {lines}")
    check(_one_line(lines, "endpoint state: ", "14a")
          == "endpoint state: 2 (2=ESTABLISHED, 3=FALLBACK_TCP), "
             "same_process=True", f"14a: {lines}")
    inproc = _one_line(lines, f"pushed {ITERS_14} x {MB_14}MB in ", "14a")
    _one_line(lines, "pull verified", "14a")
    cross = _one_line(lines, "cross-process pushed ", "14a")
    check(cross.endswith("(shm lane, same_host=True, same_process=False)"),
          f"14a: {cross}")
    check(not any(line.startswith("mesh allreduce") for line in lines),
          "14a: a mesh probe on one card")
    out = {"seconds": secs, "inproc_ticket_GBps": _rate(inproc),
           "example_server_shm_GBps": _rate(cross)}
    print(f"examples/14a: tensor_transport --mb {MB_14} --iters {ITERS_14} "
          f"in {secs} s: in process {out['inproc_ticket_GBps']} GB/s (a "
          f"ticket for the card tensor, no bytes moved), the pull verified "
          f"bit for bit; to its own server in a subprocess "
          f"{out['example_server_shm_GBps']} GB/s by shm {tag}")
    return out


def transport_at_peer(ctl, devch, gen, tag: str) -> dict:
    """14a at the peer: the example's cross-process pushes of a random 8
    MiB card tensor, landed on the peer's card, by shm and by xfer (the
    prefer-xfer flag in both processes); x0 pulled back bit-equal."""
    dev = torch.device("cuda")
    x = torch.randn(((MB_14 << 20) // 4,), dtype=torch.float32, device=dev,
                    generator=gen)
    client = TensorClient(devch)
    out = {}
    try:
        for lane in ("shm", "xfer"):
            on = lane == "xfer"
            flags.set_flag(PREFER_XFER, on)
            peer_control(ctl, "flag", on=on)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                run = tensor_transport.across_processes(client, x, MB_14,
                                                        ITERS_14)
            moved = {k: v for k, v in run["lanes"].items() if v}
            check(moved == {lane: ITERS_14 + 1},
                  f"14a {lane}: the pushes moved the lanes {moved}")
            pcntl, got = client.pull("x0", device=dev)
            check(not pcntl.failed() and got is not None
                  and torch.equal(u8(got[0]), u8(x)),
                  f"14a {lane}: x0 pulled back differs ({pcntl.error_text})")
            del got
            st = peer_control(ctl, "state")
            check(all(d.startswith("cuda") for i in range(ITERS_14)
                      for d in st["contents"][f"x{i}"]),
                  f"14a {lane}: a push is not on the peer's card")
            nbytes = x.numel() * x.element_size()
            out[lane] = {
                "GBps": round(nbytes * ITERS_14 / run["seconds"] / 1e9, 3),
                "push_ms_mean": round(run["seconds"] / ITERS_14 * 1e3, 3),
                "line": printed.getvalue().strip()}
    finally:
        flags.set_flag(PREFER_XFER, False)
        peer_control(ctl, "flag", on=False)
    print(f"examples/14a at the peer: {ITERS_14} pushes of {MB_14} MiB "
          f"landed on its card, x0 pulled back bit-equal: shm "
          f"{out['shm']['GBps']} GB/s ({out['shm']['push_ms_mean']} ms a "
          f"push), xfer {out['xfer']['GBps']} GB/s "
          f"({out['xfer']['push_ms_mean']} ms); the example's line for xfer "
          f"names the lane by the reference's rule: {out['xfer']['line']!r} "
          f"{tag}")
    return out


NATIVE_DEFERRED = "run in phase 20b (phase 19a times the library's build)"


@contextlib.contextmanager
def native_half_deferred():
    """device_performance's native bulk half, refused here: its server
    would build the native library before phase 19a times the build; 20b
    runs it."""
    from brpc_tpu_torch import native

    def refuse(*args, **kw):
        raise native.NativeUnavailable(NATIVE_DEFERRED)

    start, native.rpc_server_start = native.rpc_server_start, refuse
    try:
        yield
    finally:
        native.rpc_server_start = start


def pushers_example(port: int, ctl, tag: str) -> dict:
    """14b: device_performance as the reference writes it (host bytes,
    in process: the card is not touched), then its pushers at the peer,
    which lands each push on its card."""
    lanes0 = dt.lane_counters()
    gc.collect()  # tensors of earlier phases in cycles go now, not during
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with native_half_deferred():
        rc, lines, secs = run_main(device_performance.main, [])
    torch.cuda.synchronize()
    mem1 = torch.cuda.max_memory_allocated()
    lanes1 = dt.lane_counters()
    check(rc == 0, f"14b: device_performance exited {rc}: {lines}")
    check(lines[0] == "lane=inproc pushes=16 errors=0", f"14b: {lines}")
    moved = {k: lanes1[k] - lanes0[k] for k in lanes1 if lanes1[k] - lanes0[k]}
    check(moved == {"inproc": 16}, f"14b: the example moved {moved}")
    check(mem1 == mem0, f"14b: card memory {mem0} B, at most {mem1} B "
          f"while device_performance ran")
    check(lines[-1] == f"native bulk lane unavailable: {NATIVE_DEFERRED}",
          f"14b: {lines[-1]}")
    out = {"example": {"seconds": secs, "lines": lines[:3],
                       "card_bytes_allocated": mem1 - mem0}}

    threads, mb, iters = PUSHERS_14
    target = f"127.0.0.1:{port}"
    rec, moved_b, errs = LatencyRecorder(), Adder(), Adder()
    lanes0 = dt.lane_counters()
    wall = device_performance.run_pushers(
        target, device_performance.make_payload(mb), threads, iters, "cuda",
        rec, moved_b, errs)
    lanes1 = dt.lane_counters()
    moved = {k: lanes1[k] - lanes0[k] for k in lanes1 if lanes1[k] - lanes0[k]}
    pushes = threads * iters
    check(errs.get_value() == 0 and rec.count() == pushes,
          f"14b: {errs.get_value()} errors, {rec.count()} pushes")
    st = peer_control(ctl, "state")
    names = [f"t{t}.{i}" for t in range(threads) for i in range(iters)]
    check(all(st["contents"].get(n, [""])[0].startswith("cuda")
              for n in names), "14b: a push is not on the peer's card")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        device_performance.report(rec, moved_b, errs, wall, moved)
    out["at_peer"] = {
        "pushes": pushes, "errors": errs.get_value(), "lanes": moved,
        "avg_ms": round(rec.latency() / 1e3, 3),
        "p99_ms": round(rec.latency_percentile(0.99) / 1e3, 3),
        "max_ms": round(rec.max_latency() / 1e3, 3),
        "GBps": round(moved_b.get_value() / wall / 1e9, 3),
        "wall_s": round(wall, 3), "lines": printed.getvalue().splitlines()}
    print(f"examples/14b: device_performance as the reference writes it "
          f"({secs} s): {lines[0]}, its payload host bytes on the "
          f"in-process ticket lane, {mem1 - mem0} B of card memory "
          f"allocated: it never touches the card; its pushers at the peer "
          f"({threads} threads x {mb} MiB x {iters}): "
          f"{out['at_peer']['lines']} {tag}")
    return out


def press_example(port: int, tag: str) -> dict:
    """14c: rpc_press at the peer's EchoService: unthrottled, at --qps
    200, and over HTTP."""
    base = ["--server", f"127.0.0.1:{port}", "--method", "EchoService.Echo",
            "--input", '{"message": "chip"}', "--threads", "4"]
    out = {}
    for label, extra in (
            ("unthrottled", ["--duration", str(PRESS_S_14)]),
            (f"qps{PRESS_QPS_14}", ["--duration", str(PRESS_S_14), "--qps",
                                    str(PRESS_QPS_14)]),
            ("http", ["--duration", "1", "--protocol", "http"])):
        gc.collect()  # leave no collection of this large heap pending
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res = rpc_press.press(rpc_press.parse_args(base + extra))
        check(res["sent"] > 0 and res["errors"] == 0,
              f"14c {label}: {printed.getvalue()}")
        out[label] = {k: round(v, 3) for k, v in res.items()}
    got = out[f"qps{PRESS_QPS_14}"]["qps"]
    check(abs(got - PRESS_QPS_14) <= 0.1 * PRESS_QPS_14,
          f"14c: --qps {PRESS_QPS_14} achieved {got} qps")
    print("examples/14c: rpc_press at the peer's EchoService, 4 threads: "
          + "; ".join(f"{k} {v['sent']} calls, {v['qps']} qps, errors "
                      f"{v['errors']}, avg {v['avg_us']} us, p99 "
                      f"{v['p99_us']} us" for k, v in out.items()) + f" {tag}")
    return out


def console_example(port: int, vars0: bytes, pushes: int, tag: str) -> dict:
    """14e: rpc_view of the peer's /vars against 14b's pushes,
    parallel_http over /status, a trackme ping to a trackme_server here."""
    target = f"127.0.0.1:{port}"
    rc, lines, _ = run_main(rpc_view.main, [target, "vars"])
    check(rc == 0, f"14e: rpc_view exited {rc}")
    page = "\n".join(lines).encode()
    deltas = {n: _var_of(page, n) - _var_of(vars0, n) for n in VARS_14}
    check(deltas["TensorStore_Push_count"] == pushes,
          f"14e: /vars counts {deltas} for {pushes} pushes")
    check(deltas["device_block_pool_acquired"]
          == deltas["device_block_pool_released"],
          f"14e: the peer's pool is not balanced: {deltas}")
    n, threads = FETCHES_14
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = parallel_http.fetch_all([f"http://{target}/status"] * n,
                                      threads, 60)
    check((got["fetched"], got["ok"], got["failed"]) == (n, n, 0),
          f"14e: parallel_http {printed.getvalue()}")
    with contextlib.redirect_stdout(io.StringIO()):
        srv, counts = trackme_server.start(0, "", "cuda")
    try:
        check(flags.set_flag("trackme_server", str(srv.listen_endpoint)),
              "14e: trackme_server flag")
        pinged = trackme._ping_once()
    finally:
        flags.set_flag("trackme_server", "")
        srv.stop()
    check(pinged and counts == {brpc_tpu_torch.__version__: 1},
          f"14e: trackme counted {counts}")
    out = {"vars_deltas": deltas, "parallel_http": {
        k: round(v, 3) for k, v in got.items()}, "trackme": counts}
    print(f"examples/14e: rpc_view {target} vars: 14b moved {deltas}; "
          f"parallel_http {printed.getvalue().strip()}; a trackme ping "
          f"counted {counts} {tag}")
    return out


def host_examples(tag: str) -> dict:
    """14f: each host example once, here, on the card's servers."""
    out = {}
    for module, argv in HOST_EXAMPLES_14:
        name = module.__name__.rsplit(".", 1)[1]
        rc, lines, secs = run_main(module.main, argv)
        check(rc == 0, f"14f {name} exited {rc}: {lines}")
        out[name] = secs
    print(f"examples/14f: every host example exited 0, seconds each "
          f"{out} {tag}")
    return out


def _reset_at_rest(ctl, devch, peer0: int, what: str) -> dict:
    """Clear the peer's store; both sides at rest, the peer's card memory
    back at ``peer0`` (its pool)."""
    st = peer_control(ctl, "reset")
    _peer_at_rest(st, what)
    _pool_full(st, what)
    _client_at_rest(devch, what)
    check(st["memory_allocated"] == peer0,
          f"{what}: the peer's card memory {peer0} -> "
          f"{st['memory_allocated']} B")
    return st


def phase_examples(tag: str, gen):
    """14: the examples and the tools on the card, against one --peer."""
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    proc = spawn_peer()  # starts while 14a's example starts its own server
    ctl = devch = None
    result, st = {}, {}
    try:
        result["transport"] = transport_example(tag)
        port, _ = await_peer(proc)
        ctl = Channel()
        check(ctl.init(f"127.0.0.1:{port}") == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        devch = _device_channel(f"127.0.0.1:{port}")
        # a warm landing and pull, then the peer's card memory at rest
        warm = torch.ones((1 << 20,), dtype=torch.float32, device=dev)
        client = TensorClient(devch)
        check(not client.push("warm", [warm])[0].failed(), "14: warm push")
        check(not client.pull("warm", device=dev)[0].failed(), "14: warm pull")
        peer0 = peer_control(ctl, "reset")["memory_allocated"]
        result["transport_at_peer"] = transport_at_peer(ctl, devch, gen, tag)
        _reset_at_rest(ctl, devch, peer0, "14a")
        vars0 = rpc_view.fetch(f"127.0.0.1:{port}", "vars").encode()
        result["pushers"] = pushers_example(port, ctl, tag)
        st = _reset_at_rest(ctl, devch, peer0, "14b")
        result["press"] = press_example(port, tag)
        result["console"] = console_example(
            port, vars0, result["pushers"]["at_peer"]["pushes"], tag)
        result["host_examples"] = host_examples(tag)
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"14: the peer exited with code {rc}")
    finally:
        for ch in (ctl, devch):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"examples/14: the peer's windows, arena, pool and card memory "
          f"({st['memory_allocated']} B) at rest after 14a and 14b, the peer "
          f"exited 0; phase took {result['seconds']} s {tag}")
    print("examples " + json.dumps(result))
    return result


# -- phase 15: gRPC over h2 on the peer's one port ------------------------------

GRPC = "h2:grpc"
ECHO = "EchoService.Echo"
SEQ_15 = 200  # 15a: sequential calls
CONC_15 = 16  # 15a: threads calling at once on one connection
SLOW_15 = (300_000, 100)  # 15a: the handler's sleep (us), the timeout (ms)
BIG_15 = 8 << 20  # 15b: an ASCII message made on the card
ROUNDS_15 = 5
PUSHES_15 = 16  # 15d: activations pushed by shm while 15c runs
SLO_15 = dict(ceiling_ms=5.0, budget=0.01, fast_window_s=1.0,
              slow_window_s=3.0)  # 15f: second-long windows


def h2_state(conn) -> dict:
    """What an h2 connection holds: open streams, queued DATA, its send
    window and the DATA and WINDOW_UPDATE frames it read."""
    with conn.lock:
        return {"streams": len(conn.streams),
                "pending": sum(len(st.pending_out) + (st.pending_trailers
                                                      is not None)
                               for st in conn.streams.values()),
                "send_window": conn.send_window,
                "data_in": conn.frames_in.get(h2_protocol.F_DATA, 0),
                "window_updates_in": conn.frames_in.get(
                    h2_protocol.F_WINDOW_UPDATE, 0)}


def _grpc_conn(ch: Channel):
    sock = Socket.address(ch._single_sid)
    check(sock is not None and getattr(sock, "h2_conn", None) is not None,
          "15: the gRPC channel has no h2 connection")
    return sock.h2_conn


def _peer_h2(ctl) -> dict:
    """The frames the peer's h2 connections read, summed."""
    conns = peer_control(ctl, "state")["h2"]
    return {k: sum(c[k] for c in conns)
            for k in ("data_in", "window_updates_in")}


def _h2_at_rest(ch: Channel, ctl, what: str):
    """No stream open or DATA queued on either side; every send window is
    whole again (the peer's once the last WINDOW_UPDATEs are read)."""
    mine = h2_state(_grpc_conn(ch))
    check(mine["streams"] == 0 and mine["pending"] == 0
          and mine["send_window"] == h2_protocol.OUR_WINDOW,
          f"{what}: the client's h2 connection is not at rest: {mine}")

    def peer_rest():
        conns = peer_control(ctl, "state")["h2"]
        return conns and all(
            c["streams"] == 0 and c["pending"] == 0
            and c["send_window"] == h2_protocol.OUR_WINDOW for c in conns)

    _wait(peer_rest, 10, f"{what}: the peer's h2 connections at rest")


def _std_and_status(port: int, std: Channel, what: str) -> int:
    """A tpu_std Echo and GET /status on the peer's port answer; returns
    the calls made (1)."""
    cntl, resp = std.call(ECHO, wire.EchoRequest(message="std"),
                          wire.EchoResponse)
    check(not cntl.failed() and resp.message == "std",
          f"{what}: tpu_std on the port: {cntl.error_text}")
    code, _, page, _ = http_get(port, "/status")
    check(code == 200 and b"EchoService.Echo" in page,
          f"{what}: GET /status on the port answered {code}")
    return 1


def grpc_calls(port: int, gch: Channel, std: Channel, ctl, tag: str) -> dict:
    """15a: sequential calls, 16 at once on one connection, an unknown
    method, a deadline; tpu_std and /status between them."""
    times = []
    for i in range(SEQ_15):
        t0 = time.perf_counter()
        cntl, resp = gch.call(ECHO, wire.EchoRequest(message=f"s{i}"),
                              wire.EchoResponse)
        times.append(time.perf_counter() - t0)
        check(not cntl.failed() and resp.message == f"s{i}",
              f"15a call {i}: {cntl.error_text}")
    std_calls = _std_and_status(port, std, "15a")
    conn = _grpc_conn(gch)
    first = conn.next_stream_id
    got = {}

    def one(i):
        cntl, resp = gch.call(ECHO, wire.EchoRequest(message=f"c{i}"),
                              wire.EchoResponse)
        got[i] = (cntl.error_code, resp.message)

    _run_threads([lambda i=i: one(i) for i in range(CONC_15)], "15a", 60)
    check(got == {i: (0, f"c{i}") for i in range(CONC_15)},
          f"15a: concurrent replies {got}")
    check(_grpc_conn(gch) is conn
          and conn.next_stream_id == first + 2 * CONC_15,
          "15a: the concurrent calls did not share one connection")
    cntl, _ = gch.call("EchoService.Nope", wire.EchoRequest(message="x"),
                       wire.EchoResponse)
    check(cntl.error_code == errors.ENOMETHOD,
          f"15a: an unknown method gave {cntl.error_code} {cntl.error_text}")
    std_calls += _std_and_status(port, std, "15a")
    sleep_us, timeout_ms = SLOW_15
    t0 = time.perf_counter()
    cntl, _ = gch.call(ECHO, wire.EchoRequest(message="slow",
                                              sleep_us=sleep_us),
                       wire.EchoResponse, timeout_ms=timeout_ms)
    waited_ms = (time.perf_counter() - t0) * 1e3
    check(cntl.error_code == errors.ERPCTIMEDOUT
          and waited_ms < sleep_us / 1e3,
          f"15a: the slow call gave {cntl.error_code} after {waited_ms} ms")
    time.sleep(sleep_us / 1e6)  # the handler ends; its answer is dropped
    seen = peer_control(ctl, "state")["echo_timeouts_ms"]
    check(len(seen) == 1 and 0 < seen[0] <= timeout_ms,
          f"15a: the peer saw grpc-timeout {seen}")
    std_calls += _std_and_status(port, std, "15a")
    out = {"seq_median_us": round(statistics.median(times) * 1e6, 1),
           "seq_p99_us": round(_p99(times) * 1e3, 1),
           "grpc_calls": SEQ_15 + CONC_15 + 1, "std_calls": std_calls,
           "timeout_waited_ms": round(waited_ms, 3),
           "grpc_timeout_seen_ms": seen[0]}
    print(f"grpc/15a: {SEQ_15} sequential Echo calls over h2 at the peer: "
          f"median {out['seq_median_us']} us, p99 {out['seq_p99_us']} us; "
          f"{CONC_15} threads at once on one connection (streams "
          f"{first}..{conn.next_stream_id - 2}) each got its own reply; an "
          f"unknown method gave ENOMETHOD; a {sleep_us} us handler under a "
          f"{timeout_ms} ms timeout gave ERPCTIMEDOUT after {waited_ms:.1f} "
          f"ms, the peer read grpc-timeout {seen[0]} ms; tpu_std and GET "
          f"/status answered on the same port between them {tag}")
    return out


def grpc_big(gch: Channel, ctl, gen, wire_MBps: float, tag: str) -> dict:
    """15b: an 8 MiB ASCII message made on the card, echoed over h2 and
    landed on the card, bit-equal; both connection windows crossed."""
    dev = torch.device("cuda")
    codes = torch.randint(32, 127, (BIG_15,), dtype=torch.uint8, device=dev,
                          generator=gen)
    text = codes.cpu().numpy().tobytes().decode("ascii")
    body = len(wire.EchoRequest(message=text).SerializeToString()) + 5
    frames = -(-body // h2_protocol.MAX_FRAME)
    conn = _grpc_conn(gch)
    mine0, peer0 = h2_state(conn), _peer_h2(ctl)
    times = []
    for r in range(ROUNDS_15):
        t0 = time.perf_counter()
        cntl, resp = gch.call(ECHO, wire.EchoRequest(message=text),
                              wire.EchoResponse, timeout_ms=60000)
        times.append(time.perf_counter() - t0)
        check(not cntl.failed(), f"15b round {r}: {cntl.error_text}")
        back = torch.frombuffer(bytearray(resp.message.encode("ascii")),
                                dtype=torch.uint8).to(dev)
        check(torch.equal(back, codes), f"15b round {r}: the echo differs")
    mine1 = h2_state(conn)
    want_peer = {"data_in": peer0["data_in"] + ROUNDS_15 * frames,
                 "window_updates_in": peer0["window_updates_in"]
                 + 2 * ROUNDS_15 * frames}
    _wait(lambda: {k: _peer_h2(ctl)[k] for k in want_peer} == want_peer, 10,
          f"15b: the peer read {ROUNDS_15 * frames} DATA frames and two "
          f"WINDOW_UPDATEs for each of the client's")
    moved = {"client_data_in": mine1["data_in"] - mine0["data_in"],
             "client_window_updates_in":
                 mine1["window_updates_in"] - mine0["window_updates_in"],
             "peer_data_in": ROUNDS_15 * frames,
             "peer_window_updates_in": 2 * ROUNDS_15 * frames}
    check(moved["client_data_in"] == ROUNDS_15 * frames
          and moved["client_window_updates_in"] == 2 * ROUNDS_15 * frames,
          f"15b: frames read here {moved}, {frames} DATA frames a message")
    _h2_at_rest(gch, ctl, "15b")
    med = statistics.median(times)
    out = {"ms_per_call": round(med * 1e3, 3),
           "MBps": round(2 * BIG_15 / med / 1e6, 1),
           "wire_lane_8MiB_MBps": round(wire_MBps, 1),
           "frames_per_message": frames, **moved}
    print(f"grpc/15b: an {BIG_15} B ASCII message made on the card, echoed "
          f"over h2 x{ROUNDS_15} and landed on the card bit-equal: median "
          f"{out['ms_per_call']} ms a call, {out['MBps']} MB/s both ways "
          f"(phase 6's wire lane at 8 MiB: {out['wire_lane_8MiB_MBps']} "
          f"MB/s); DATA frames read: {moved['client_data_in']} here, "
          f"{moved['peer_data_in']} by the peer; WINDOW_UPDATE frames read: "
          f"{moved['client_window_updates_in']} here, "
          f"{moved['peer_window_updates_in']} by the peer; every window "
          f"whole after {tag}")
    return out


class _Tap(LatencyRecorder):
    """rpc_press's recorder, keeping each sample and its wall time (15f)."""

    made = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.samples = []
        _Tap.made.append(self)

    def update(self, value):
        self.samples.append((time.time(), value))
        super().update(value)


def grpc_press(port: int, ctl, devch, tag: str, std_press: dict) -> dict:
    """15c: rpc_press --protocol h2:grpc at the peer's Echo, unthrottled
    and at --qps 200; 15d: 16 shm pushes of the activations to the same
    port during the unthrottled run, landed on its card bit-equal."""
    dev = torch.device("cuda")
    base = ["--server", f"127.0.0.1:{port}", "--method", ECHO, "--input",
            '{"message": "chip"}', "--threads", "4", "--protocol", GRPC]
    acts = [torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                        device=dev) for _ in range(PUSHES_15)]
    client = TensorClient(devch)
    pushed = []

    def pushes():
        for i, a in enumerate(acts):
            cntl, resp = client.push(f"g{i}", [a])
            check(not cntl.failed() and resp.ok,
                  f"15d push {i}: {cntl.error_text}")
            pushed.append(i)

    out, samples = {}, []
    _Tap.made.clear()
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, bvar, "LatencyRecorder", LatencyRecorder)
        bvar.LatencyRecorder = _Tap
        for label, extra in (
                ("unthrottled", ["--duration", str(PRESS_S_14)]),
                (f"qps{PRESS_QPS_14}", ["--duration", str(PRESS_S_14),
                                        "--qps", str(PRESS_QPS_14)])):
            gc.collect()
            side = (threading.Thread(target=lambda: _run_threads(
                [pushes], "15d")) if label == "unthrottled" else None)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                if side is not None:
                    side.start()
                res = rpc_press.press(rpc_press.parse_args(base + extra))
            if side is not None:
                side.join(120)
                check(not side.is_alive() and len(pushed) == PUSHES_15,
                      f"15d: {len(pushed)} of {PUSHES_15} pushes done")
            check(res["sent"] > 0 and res["errors"] == 0,
                  f"15c {label}: {printed.getvalue()}")
            taps = [t for t in _Tap.made if len(t.samples) == res["sent"]]
            check(len(taps) == 1, f"15c {label}: no recorder of "
                  f"{res['sent']} samples")
            samples += taps[0].samples
            _Tap.made.clear()
            out[label] = {k: round(v, 3) for k, v in res.items()}
    got = out[f"qps{PRESS_QPS_14}"]["qps"]
    check(abs(got - PRESS_QPS_14) <= 0.1 * PRESS_QPS_14,
          f"15c: --qps {PRESS_QPS_14} achieved {got} qps")
    st = peer_control(ctl, "state")
    for i, a in enumerate(acts):
        check(st["contents"][f"g{i}"][0].startswith("cuda"),
              f"15d: push {i} is not on the peer's card")
        pcntl, got_t = client.pull(f"g{i}", device=dev)
        check(not pcntl.failed() and torch.equal(u8(got_t[0]), u8(a)),
              f"15d: push {i} pulled back differs ({pcntl.error_text})")
    del got_t
    print("grpc/15c: rpc_press --protocol h2:grpc at the peer's Echo, 4 "
          "threads: " + "; ".join(
              f"{k} {v['sent']} calls, {v['qps']} qps, errors {v['errors']}, "
              f"avg {v['avg_us']} us, p99 {v['p99_us']} us"
              for k, v in out.items())
          + "; 14c over tpu_std: " + "; ".join(
              f"{k} {v['qps']} qps, avg {v['avg_us']} us"
              for k, v in std_press.items()) + f" {tag}")
    print(f"grpc/15d: {PUSHES_15} pushes of the activations {list(acts[0].shape)}"
          f" bfloat16 by shm to the same port during the unthrottled run, "
          f"each on the peer's card and pulled back bit-equal {tag}")
    return {"press": out, "samples": samples,
            "grpc_calls": sum(v["sent"] for v in out.values())}


def grpc_slo(samples, tag: str) -> dict:
    """15f: 15c's latencies in log2 buckets, one second a rollup, through
    one SloEngine latency objective with second-long windows."""
    samples = sorted(samples)
    obj = fleet.SloObjective("grpc_echo", kind="latency", lane="grpc",
                             method=ECHO, **SLO_15)
    engine = fleet.SloEngine([obj])
    buckets = [0] * fleet.hist.NBUCKETS
    t0, i, burns = samples[0][0], 0, []
    edge = t0
    while i < len(samples):
        edge += 1.0
        while i < len(samples) and samples[i][0] < edge:
            buckets[fleet.hist.bucket_of(int(samples[i][1] * 1e3))] += 1
            i += 1
        engine.ingest({"methods": {f"grpc/{ECHO}": {
            "count": i, "errors": 0, "buckets": list(buckets)}}}, now=edge)
        st = engine.status()["grpc_echo"]
        burns.append((st["fast_burn"], st["slow_burn"]))
    st = engine.status()["grpc_echo"]
    check(st["stream_total"] == len(samples),
          f"15f: the engine ingested {st['stream_total']} of "
          f"{len(samples)} calls")
    out = {"ingested": st["stream_total"], "bad": st["bad_total"],
           "burns": burns, "alert": st["alert"],
           "fired_total": st["fired_total"],
           "p99_us": round(fleet.hist.quantile(buckets, 0.99) / 1e3, 1)}
    print(f"grpc/15f: {len(samples)} latencies of 15c in log2 buckets "
          f"(p99 {out['p99_us']} us off the buckets), {len(burns)} rollups "
          f"of one second into a latency objective ({SLO_15['ceiling_ms']} ms"
          f" ceiling, budget {SLO_15['budget']}, windows "
          f"{SLO_15['fast_window_s']} s / {SLO_15['slow_window_s']} s): "
          f"(fast, slow) burn each second {burns}, {out['bad']} bad, alert "
          f"{out['alert']}, fired {out['fired_total']} times {tag}")
    return out


def grpc_example(tag: str) -> dict:
    """15e: the grpc_echo example as a user runs it."""
    rc, lines, secs = run_main(grpc_echo.main, [])
    check(rc == 0 and len(lines) == 2
          and re.fullmatch(r"grpc reply: 'over grpc' latency=\d+us", lines[0])
          and lines[1] == "tpu_std reply on the same port: 'over tpu_std'",
          f"15e: grpc_echo exited {rc}: {lines}")
    print(f"grpc/15e: brpc_tpu_torch.examples.grpc_echo exited 0 in {secs} s "
          f"with the reference's two lines: {lines} {tag}")
    return {"seconds": secs, "lines": lines}


def phase_grpc(tag: str, gen, wire_MBps: float, std_press: dict) -> dict:
    """15: gRPC over h2 at a --peer's one port, beside tpu_std, HTTP and
    shm pushes."""
    t_start = time.perf_counter()
    proc = spawn_peer()
    ctl = devch = gch = std = None
    result = {}
    try:
        port, _ = await_peer(proc)
        target = f"127.0.0.1:{port}"
        ctl = Channel()
        check(ctl.init(target) == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        devch = _device_channel(target)
        std = Channel()
        check(std.init(target) == 0, "tpu_std channel init")
        gch = Channel(ChannelOptions(protocol=GRPC, timeout_ms=5000))
        check(gch.init(target) == 0, "gRPC channel init")
        # a warm landing and pull, then the peer's card memory at rest
        warm = torch.ones((1 << 20,), dtype=torch.float32,
                          device=torch.device("cuda"))
        client = TensorClient(devch)
        check(not client.push("warm", [warm])[0].failed(), "15: warm push")
        check(not client.pull("warm", device="cuda")[0].failed(),
              "15: warm pull")
        peer0 = peer_control(ctl, "reset")["memory_allocated"]
        _, _, status0, _ = http_get(port, "/status")
        _, _, vars0, _ = http_get(port, "/vars")
        echo0 = _push_count(status0, ECHO)
        result["calls"] = grpc_calls(port, gch, std, ctl, tag)
        result["big"] = grpc_big(gch, ctl, gen, wire_MBps, tag)
        pressed = grpc_press(port, ctl, devch, tag, std_press)
        result["press"] = pressed["press"]
        result["slo"] = grpc_slo(pressed["samples"], tag)
        grpc_calls_made = (result["calls"]["grpc_calls"] + ROUNDS_15
                           + pressed["grpc_calls"])
        std_calls = result["calls"]["std_calls"]
        _, _, status1, _ = http_get(port, "/status")
        _, _, vars1, _ = http_get(port, "/vars")
        echo_moved = _push_count(status1, ECHO) - echo0
        push_moved = (_var_of(vars1, "TensorStore_Push_count")
                      - _var_of(vars0, "TensorStore_Push_count"))
        check(echo_moved == grpc_calls_made + std_calls,
              f"15d: /status counts {echo_moved} Echo calls, made "
              f"{grpc_calls_made} over gRPC and {std_calls} over tpu_std")
        check(push_moved == PUSHES_15,
              f"15d: /vars moved TensorStore_Push_count by {push_moved}")
        _h2_at_rest(gch, ctl, "15d")
        st = _reset_at_rest(ctl, devch, peer0, "15d")
        result["counts"] = {"status_echo": echo_moved,
                            "grpc_calls": grpc_calls_made,
                            "std_calls": std_calls,
                            "vars_push_count": push_moved}
        print(f"grpc/15d: /status counts {echo_moved} Echo calls "
              f"({grpc_calls_made} over gRPC, {std_calls} over tpu_std), "
              f"/vars moved TensorStore_Push_count by {push_moved}; every h2 "
              f"stream closed and window whole, the device endpoints, arena "
              f"and pool at rest, the peer's card memory back at "
              f"{st['memory_allocated']} B {tag}")
        result["example"] = grpc_example(tag)
        for ch in (gch, std, devch, ctl):
            ch.close()
        gch = std = devch = ctl = None
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"15: the peer exited with code {rc}")
    finally:
        for ch in (gch, std, devch, ctl):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"grpc/15: the peer exited 0; phase took {result['seconds']} s "
          f"{tag}")
    print("grpc " + json.dumps(result))
    return result


# -- phase 16: the pb-rpc family and the key-value protocols on the port ------

KV = ("redis", "memcache")
LEGACY = ("hulu_pbrpc", "sofa_pbrpc") + KV + ("thrift", "nshead")
SEQ_16 = 200  # 16a: sequential calls a protocol
MSG_16 = 4096  # 16b: the compressed echoes
BIG_16 = 8 << 20  # 16c: a value made on the card
ROUNDS_16 = 3
CONC_16 = (16, 64)  # 16d: threads, calls on one connection
PUSHES_16 = 16  # 16e: activations pushed by shm during the press
THRIFT_NOPE = "thrift exception: \"unknown thrift method 'Nope'\""


def legacy_channel(target: str, protocol: str) -> Channel:
    ch = Channel(ChannelOptions(protocol=protocol, timeout_ms=60000))
    check(ch.init(target) == 0, f"16: {protocol} channel init")
    return ch


def legacy_call(ch: Channel, protocol: str, key: str, value: bytes = None,
                **cntl_kw):
    """One call of ``protocol``: (controller, the bytes answered). The Echo
    over tpu_std, hulu, sofa and nshead (mcpack bodies) answers ``key``;
    thrift's Echo answers ``value``, or ``key``; redis and memcache GET
    ``key``, after a SET of ``value`` in the same call when one is
    given."""
    cntl = Controller()
    cntl.timeout_ms = 60000
    for k, v in cntl_kw.items():
        setattr(cntl, k, v)
    if protocol in ("tpu_std", "hulu_pbrpc", "sofa_pbrpc"):
        resp = wire.EchoResponse()
        ch.call_method(ECHO, cntl, wire.EchoRequest(message=key), resp)
        return cntl, resp.message.encode()
    if protocol == "nshead":
        resp = NsheadMessage()
        ch.call_method("nshead", cntl, NsheadMessage(mcpack2pb.pb_to_mcpack(
            wire.EchoRequest(message=key))), resp)
        if cntl.failed():
            return cntl, None
        return cntl, mcpack2pb.mcpack_to_pb(
            resp.body, wire.EchoResponse).message.encode()
    if protocol == "thrift":
        resp = ThriftMessage()
        data = value if value is not None else key.encode()
        ch.call_method("thrift", cntl,
                       ThriftMessage("Echo", {1: (T_STRING, data)}), resp)
        return cntl, resp.body.get(0, (0, None))[1]
    if protocol == "redis":
        req, resp = RedisRequest(), RedisResponse()
        if value is not None:
            req.add_command("SET", key, value)
        req.add_command("GET", key)
        ch.call_method("redis", cntl, req, resp)
        return cntl, (resp.reply(resp.reply_count - 1).value
                      if resp.reply_count == req.command_count else None)
    req, resp = MemcacheRequest(), MemcacheResponse()
    if value is not None:
        req.set(key, value)
    ch.call_method("memcache", cntl, req.get(key), resp)
    if value is not None and not resp.pop_set():
        return cntl, None
    ok, got = resp.pop_get()
    return cntl, got if ok else None


def legacy_sequential(chans: dict, grpc_calls: dict, tag: str) -> dict:
    """16a: 200 sequential calls over each protocol, tpu_std's beside."""
    for p in KV:
        cntl, got = legacy_call(chans[p], p, "k16", b"v16")
        check(not cntl.failed() and got == b"v16",
              f"16a: {p} SET/GET: {cntl.error_text} {got!r}")
    out = {}
    for p, ch in chans.items():
        times = []
        for i in range(SEQ_16):
            key = "k16" if p in KV else f"s{i}"
            t0 = time.perf_counter()
            cntl, got = legacy_call(ch, p, key)
            times.append(time.perf_counter() - t0)
            want = b"v16" if p in KV else key.encode()
            check(not cntl.failed() and got == want,
                  f"16a: {p} call {i}: {cntl.error_text} {got!r}")
        out[p] = {"median_us": round(statistics.median(times) * 1e6, 1),
                  "p99_us": round(_p99(times) * 1e3, 1)}
    print(f"legacy/16a: {SEQ_16} sequential calls each at the peer's one "
          f"port, median / p99 us: " + "; ".join(
              f"{p} {v['median_us']} / {v['p99_us']}" for p, v in out.items())
          + f"; 15a over gRPC in this run: {grpc_calls['seq_median_us']} / "
          f"{grpc_calls['seq_p99_us']} {tag}")
    return out


def legacy_errors(chans: dict, gen, tag: str) -> dict:
    """16b: an unknown method over hulu and sofa (ENOMETHOD) and thrift
    (the reference's exception), an unknown redis command (an error
    reply); hulu and sofa echo 4 KiB with each codec."""
    for p in ("hulu_pbrpc", "sofa_pbrpc"):
        cntl = Controller()
        cntl.timeout_ms = 60000
        chans[p].call_method("EchoService.Nope", cntl,
                             wire.EchoRequest(message="x"),
                             wire.EchoResponse())
        check(cntl.error_code == errors.ENOMETHOD,
              f"16b: {p} unknown method gave {cntl.error_code} "
              f"{cntl.error_text}")
    cntl = Controller()
    cntl.timeout_ms = 60000
    chans["thrift"].call_method("thrift", cntl, ThriftMessage("Nope", {}),
                                ThriftMessage())
    check((cntl.error_code, cntl.error_text) == (errors.EREQUEST,
                                                 THRIFT_NOPE),
          f"16b: thrift unknown method gave {cntl.error_code} "
          f"{cntl.error_text}")
    req, resp, cntl = RedisRequest(), RedisResponse(), Controller()
    cntl.timeout_ms = 60000
    req.add_command("NOPE", "x")
    chans["redis"].call_method("redis", cntl, req, resp)
    check(cntl.error_code == errors.EREQUEST and resp.reply_count == 1
          and resp.reply(0).is_error()
          and resp.reply(0).value == "ERR unknown command 'nope'",
          f"16b: redis NOPE gave {cntl.error_code} {cntl.error_text}")
    text = torch.randint(32, 127, (MSG_16,), dtype=torch.uint8,
                         device=torch.device("cuda"), generator=gen
                         ).cpu().numpy().tobytes().decode("ascii")
    echoes = 0
    for p in ("hulu_pbrpc", "sofa_pbrpc"):
        for ctype in (COMPRESS_GZIP, COMPRESS_ZLIB, COMPRESS_SNAPPY):
            cntl, got = legacy_call(chans[p], p, text, compress_type=ctype)
            check(not cntl.failed() and got == text.encode(),
                  f"16b: {p} compress {ctype}: {cntl.error_text}")
            echoes += 1
    print(f"legacy/16b: an unknown method gave ENOMETHOD over hulu and sofa "
          f"and {THRIFT_NOPE!r} over thrift; redis NOPE gave the error reply "
          f"\"ERR unknown command 'nope'\"; hulu and sofa each echoed {MSG_16}"
          f" B with gzip, zlib and snappy {tag}")
    return {"echo_calls": echoes}


def legacy_big(chans: dict, gen, wire_MBps: float, tag: str) -> dict:
    """16c: an 8 MiB value made on the card, through redis SET+GET,
    memcache set+get and a thrift Echo, each landed on the card again."""
    dev = torch.device("cuda")
    value_t = torch.randint(0, 256, (BIG_16,), dtype=torch.uint8,
                            device=dev, generator=gen)
    value = value_t.cpu().numpy().tobytes()
    out = {}
    for p in ("redis", "memcache", "thrift"):
        times = []
        for r in range(ROUNDS_16):
            t0 = time.perf_counter()
            cntl, got = legacy_call(chans[p], p, f"big{r}", value)
            times.append(time.perf_counter() - t0)
            check(not cntl.failed() and got is not None,
                  f"16c: {p} round {r}: {cntl.error_text}")
            back = torch.frombuffer(bytearray(got), dtype=torch.uint8).to(dev)
            check(torch.equal(back, value_t),
                  f"16c: {p} round {r}: the value landed differs")
        med = statistics.median(times)
        out[p] = {"ms_per_call": round(med * 1e3, 3),
                  "MBps": round(2 * BIG_16 / med / 1e6, 1)}
    out["wire_lane_8MiB_MBps"] = round(wire_MBps, 1)
    print(f"legacy/16c: an {BIG_16} B value made on the card, {ROUNDS_16} "
          f"calls each (8 MiB each way), landed on the card bit-equal: "
          + "; ".join(f"{p} {out[p]['ms_per_call']} ms a call, "
                      f"{out[p]['MBps']} MB/s" for p in ("redis", "memcache",
                                                          "thrift"))
          + f" (phase 6's wire lane at 8 MiB: {out['wire_lane_8MiB_MBps']} "
          f"MB/s) {tag}")
    return out


def legacy_pipelined(target: str, tag: str) -> dict:
    """16d: 16 threads share one redis and one memcache connection, 64
    calls each way; every call gets its own reply."""
    threads, calls = CONC_16
    out = {}
    for p in KV:
        ch = legacy_channel(target, p)
        got, socks = {}, set()

        def one(t, p=p, ch=ch, got=got, socks=socks):
            for j in range(calls // threads):
                key = f"c{t}-{j}"
                cntl, v = legacy_call(ch, p, key, key[::-1].encode())
                got[key] = (cntl.error_code, v)
                socks.add(cntl._current_sock.socket_id)

        _run_threads([lambda t=t: one(t) for t in range(threads)], "16d", 60)
        ch.close()
        check(len(got) == calls and all(
            v == (0, k[::-1].encode()) for k, v in got.items()),
              f"16d: {p} replies {sorted(got.items())[:4]}")
        check(len(socks) == 1, f"16d: {p}'s calls used {len(socks)} "
              f"connections")
        out[p] = calls
    print(f"legacy/16d: {threads} threads, {calls} redis and {calls} memcache"
          f" calls pipelined on one connection each, every call got its own "
          f"reply {tag}")
    return out


def legacy_press(port: int, ctl, devch, gen, tag: str,
                 std_press: dict) -> dict:
    """16e: rpc_press --protocol hulu_pbrpc at the Echo, 3 s unthrottled,
    with 16 shm pushes of the activations to the same port meanwhile."""
    dev = torch.device("cuda")
    argv = ["--server", f"127.0.0.1:{port}", "--method", ECHO, "--input",
            '{"message": "chip"}', "--threads", "4", "--protocol",
            "hulu_pbrpc", "--duration", str(PRESS_S_14)]
    acts = [torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                        device=dev, generator=gen) for _ in range(PUSHES_16)]
    client = TensorClient(devch)
    pushed = []

    def pushes():
        for i, a in enumerate(acts):
            cntl, resp = client.push(f"l{i}", [a])
            check(not cntl.failed() and resp.ok,
                  f"16e push {i}: {cntl.error_text}")
            pushed.append(i)

    gc.collect()
    side = threading.Thread(target=lambda: _run_threads([pushes], "16e"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        side.start()
        res = rpc_press.press(rpc_press.parse_args(argv))
    side.join(120)
    check(not side.is_alive() and len(pushed) == PUSHES_16,
          f"16e: {len(pushed)} of {PUSHES_16} pushes done")
    check(res["sent"] > 0 and res["errors"] == 0,
          f"16e: {printed.getvalue()}")
    st = peer_control(ctl, "state")
    for i, a in enumerate(acts):
        check(st["contents"][f"l{i}"][0].startswith("cuda"),
              f"16e: push {i} is not on the peer's card")
        pcntl, got_t = client.pull(f"l{i}", device=dev)
        check(not pcntl.failed() and torch.equal(u8(got_t[0]), u8(a)),
              f"16e: push {i} pulled back differs ({pcntl.error_text})")
    del got_t
    out = {k: round(v, 3) for k, v in res.items()}
    std = std_press["unthrottled"]
    print(f"legacy/16e: rpc_press --protocol hulu_pbrpc at the peer's Echo, "
          f"4 threads, {PRESS_S_14} s: {out['sent']} calls, {out['qps']} qps,"
          f" errors {out['errors']}, avg {out['avg_us']} us, p99 "
          f"{out['p99_us']} us; 14c over tpu_std: {std['qps']} qps, avg "
          f"{std['avg_us']} us; {PUSHES_16} pushes of the activations "
          f"{list(acts[0].shape)} bfloat16 by shm to the same port meanwhile,"
          f" each on the peer's card and pulled back bit-equal {tag}")
    return out


LEGACY_EXAMPLES = (
    (redis_kv, ["SET -> RedisReply\\(status, 'OK'\\)",
                "GET -> RedisReply\\(string, b'v5e-8'\\)",
                "DEL -> RedisReply\\(integer, 1\\)",
                "GET after DEL -> RedisReply\\(nil, None\\) \\(nil\\)"]),
    (memcache_kv, ["get chip -> b'tpu-v5e'", "hits counter: 1 then 2"]),
    (thrift_echo, ["thrift reply: b'thrift says: hello'"]),
    (legacy_pbrpc_echo, [f"{p}: 'via {p}' \\(\\d+us\\)"
                         for p in ("hulu_pbrpc", "sofa_pbrpc", "tpu_std")]),
)


def legacy_examples(tag: str) -> dict:
    """16f: the four examples as a user runs them."""
    out = {}
    for mod, patterns in LEGACY_EXAMPLES:
        name = mod.__name__.rsplit(".", 1)[1]
        rc, lines, secs = run_main(mod.main, [])
        check(rc == 0 and len(lines) == len(patterns) and all(
            re.fullmatch(pat, line) for pat, line in zip(patterns, lines)),
              f"16f: {name} exited {rc}: {lines}")
        out[name] = {"seconds": secs, "lines": lines}
    print("legacy/16f: " + "; ".join(
        f"{n} exited 0 in {v['seconds']} s with the reference's "
        f"{len(v['lines'])} lines" for n, v in out.items()) + f" {tag}")
    return out


def phase_legacy(tag: str, gen, wire_MBps: float, grpc: dict,
                 std_press: dict) -> dict:
    """16: hulu, sofa, redis, memcache, thrift and nshead at a --peer's one
    port, beside tpu_std, the console and shm pushes."""
    t_start = time.perf_counter()
    proc = spawn_peer()
    ctl = devch = None
    chans = {}
    result = {}
    try:
        port, _ = await_peer(proc)
        target = f"127.0.0.1:{port}"
        ctl = Channel()
        check(ctl.init(target) == 0, "control channel init")
        peer_control(ctl, "to_card", on=True)
        devch = _device_channel(target)
        warm = torch.ones((1 << 20,), dtype=torch.float32,
                          device=torch.device("cuda"))
        client = TensorClient(devch)
        check(not client.push("warm", [warm])[0].failed(), "16: warm push")
        check(not client.pull("warm", device="cuda")[0].failed(),
              "16: warm pull")
        peer0 = peer_control(ctl, "reset")["memory_allocated"]
        _, _, status0, _ = http_get(port, "/status")
        _, _, vars0, _ = http_get(port, "/vars")
        echo0 = _push_count(status0, ECHO)
        chans = {p: legacy_channel(target, p) for p in ("tpu_std",) + LEGACY}
        result["sequential"] = legacy_sequential(chans, grpc["calls"], tag)
        result["errors"] = legacy_errors(chans, gen, tag)
        result["big"] = legacy_big(chans, gen, wire_MBps, tag)
        result["pipelined"] = legacy_pipelined(target, tag)
        result["press"] = legacy_press(port, ctl, devch, gen, tag, std_press)
        echo_calls = {p: SEQ_16 for p in ("tpu_std", "hulu_pbrpc",
                                          "sofa_pbrpc", "nshead")}
        echo_calls["compressed"] = result["errors"]["echo_calls"]
        echo_calls["press_hulu"] = int(result["press"]["sent"])
        _, _, status1, _ = http_get(port, "/status")
        _, _, vars1, _ = http_get(port, "/vars")
        echo_moved = _push_count(status1, ECHO) - echo0
        push_moved = (_var_of(vars1, "TensorStore_Push_count")
                      - _var_of(vars0, "TensorStore_Push_count"))
        check(echo_moved == sum(echo_calls.values()),
              f"16e: /status counts {echo_moved} Echo calls, made "
              f"{echo_calls}")
        check(push_moved == PUSHES_16,
              f"16e: /vars moved TensorStore_Push_count by {push_moved}")
        st = _reset_at_rest(ctl, devch, peer0, "16e")
        result["counts"] = {"status_echo": echo_moved, "made": echo_calls,
                            "vars_push_count": push_moved}
        print(f"legacy/16e: /status counts {echo_moved} Echo calls, each one "
              f"made ({echo_calls}), /vars moved TensorStore_Push_count by "
              f"{push_moved}; the device endpoints, arena and pool at rest, "
              f"the peer's card memory back at {st['memory_allocated']} B "
              f"{tag}")
        result["examples"] = legacy_examples(tag)
        for ch in (*chans.values(), devch, ctl):
            ch.close()
        chans, devch, ctl = {}, None, None
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"16: the peer exited with code {rc}")
    finally:
        for ch in (*chans.values(), devch, ctl):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"legacy/16: the peer exited 0; phase took {result['seconds']} s "
          f"{tag}")
    print("legacy " + json.dumps(result))
    return result


# -- phase 17: TLS and authentication; the nshead family, mongo and esp --------

TLS_SECRET_17 = b"chip-smoke-tls"
TLS_USER_17 = "smoke"
AUTH_PROBE_17 = "who-am-i"  # SmokeEcho answers the user it verified
FAMILY_17 = {"nova_pbrpc": NovaServiceAdaptor,
             "public_pbrpc": PublicPbrpcServiceAdaptor,
             "ubrpc": UbrpcServiceAdaptor}
ROUNDS_17 = 5  # 17a: push + pull + ACK rounds per lane
CONC_17 = (16, 64)  # 17c: threads, Echo calls each on one connection
BIG_17 = (2, 2, 8 << 20)  # 17c: threads, echoes each, bytes each way
SEQ_17 = 200  # 17e: sequential calls a protocol
TLS_LINE_17 = "nshead-mcpack reply: 'hELLO nshead'"


def tls_pair():
    """(certificate, key): the test-only pair beside the port."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "brpc_tpu_torch", "testdata")
    return (os.path.join(here, "tls_selfsigned_cert.pem"),
            os.path.join(here, "tls_selfsigned_key.pem"))


def _tls_opts(**kw) -> dict:
    opts = dict(use_ssl=True, connect_timeout_ms=5000, timeout_ms=60000,
                auth=HmacAuthenticator(TLS_SECRET_17, user=TLS_USER_17))
    opts.update(kw)
    return opts


def tls_channel(target: str, **kw) -> Channel:
    ch = Channel(ChannelOptions(**_tls_opts(**kw)))
    check(ch.init(target) == 0, f"17: TLS channel init {kw}")
    return ch


def _echo_17(ch: Channel, message: str):
    cntl, resp = Controller(), wire.EchoResponse()
    cntl.timeout_ms = 60000
    ch.call_method(ECHO, cntl, wire.EchoRequest(message=message), resp)
    return cntl, resp.message


def https_get(port: int, path: str) -> bytes:
    """A console page over HTTPS, the server's certificate verified."""
    ctx = ssl.create_default_context(cafile=tls_pair()[0])
    conn = http.client.HTTPSConnection("127.0.0.1", port, timeout=60,
                                       context=ctx)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        check(r.status == 200, f"17d: GET {path} over HTTPS: {r.status}")
        return body
    finally:
        conn.close()


def raw_tls_ms(payload: bytes, rounds: int = 3) -> float:
    """The floor of Python's TLS on this host: ``payload`` one way between
    two threads of this process over loopback, blocking sockets and the
    test pair, answered by one byte (median ms)."""
    cert, key = tls_pair()
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    cctx = ssl.create_default_context(cafile=cert)
    n = len(payload)
    with pysocket.create_server(("127.0.0.1", 0)) as lsock:

        def sink():
            conn, _ = lsock.accept()
            with sctx.wrap_socket(conn, server_side=True) as c:
                for _ in range(rounds):
                    got = 0
                    while got < n:
                        got += len(c.recv(1 << 20))
                    c.sendall(b"k")

        t = threading.Thread(target=sink)
        t.start()
        times = []
        with cctx.wrap_socket(pysocket.create_connection(
                lsock.getsockname(), timeout=60),
                server_hostname="127.0.0.1") as c:
            for _ in range(rounds):
                t0 = time.perf_counter()
                c.sendall(payload)
                check(c.recv(1) == b"k", "17a: the raw TLS sink")
                times.append(time.perf_counter() - t0)
        t.join(60)
    return round(statistics.median(times) * 1e3, 3)


def tls_lanes(target: str, ctl, devch, gen, wire_round_s: float,
              tag: str) -> dict:
    """17a: the activations by the wire lane inside TLS and by shm, whose
    bytes go outside it, each landed on the peer's card and pulled back."""
    dev = torch.device("cuda")
    act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                      device=dev, generator=gen)
    nbytes = act.numel() * act.element_size()
    wire_ch = tls_channel(target)
    out = {}
    try:
        for lane, ch in (("wire", wire_ch), ("shm", devch)):
            client = TensorClient(ch)
            times, pushes, took = [], [], []
            for r in range(ROUNDS_17):
                name = f"tls-{lane}-{r}"
                sent0 = dt.lane_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cntl, resp = client.push(name, [act])
                pushes.append(time.perf_counter() - t0)
                check(not cntl.failed() and resp.ok,
                      f"17a: {name} push: {cntl.error_text}")
                pcntl, got = client.pull(name, device=dev)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check(not pcntl.failed() and got is not None,
                      f"17a: {name} pull: {pcntl.error_text}")
                moved = sorted(k for k, v in dt.lane_counters().items()
                               if v != sent0.get(k))
                took.append("+".join(moved))
                check(moved == [lane], f"17a: {name} took {moved}")
                check(isinstance(cntl._current_sock.fd(), TLSSocket),
                      f"17a: {name} did not go over TLS")
                if lane != "wire":
                    check(len(cntl.request_attachment) == 0,
                          f"17a: {name}: the payload rode the RPC")
                check(torch.equal(u8(got[0]), u8(act)),
                      f"17a: {name}: the pulled bytes differ")
                del got
            st = peer_control(ctl, "state")
            for r in range(ROUNDS_17):
                check(st["contents"][f"tls-{lane}-{r}"][0].startswith("cuda"),
                      f"17a: tls-{lane}-{r} is not on the peer's card")
            med = statistics.median(times)
            out[lane] = {"ms_per_round": round(med * 1e3, 3),
                         "push_ms": round(statistics.median(pushes) * 1e3, 3),
                         "GBps": round(2 * nbytes / med / 1e9, 3),
                         "lanes": took}
    finally:
        wire_ch.close()
    out["plaintext_wire_ms_per_round"] = round(wire_round_s * 1e3, 3)
    out["raw_tls_ms_one_way"] = raw_tls_ms(u8(act).cpu().numpy().tobytes())
    print(f"tls/17a: the activations {list(act.shape)} bfloat16 ({nbytes} B)"
          f" pushed and pulled + ACKed {ROUNDS_17} times by each lane, "
          f"landed on the peer's card and back bit-equal: wire lane inside "
          f"TLS {out['wire']['ms_per_round']} ms a round, its push "
          f"{out['wire']['push_ms']} ms ({out['wire']['GBps']} GB/s), shm "
          f"(a descriptor inside TLS, the bytes in the shared arena) "
          f"{out['shm']['ms_per_round']} ms, its push {out['shm']['push_ms']}"
          f" ms ({out['shm']['GBps']} GB/s); the lane of each push: wire "
          f"{out['wire']['lanes']}, shm {out['shm']['lanes']}; phase 6's "
          f"plaintext wire lane at 8 MiB in this run: "
          f"{out['plaintext_wire_ms_per_round']} ms a round; Python's TLS "
          f"alone moved the {nbytes} B one way between two threads in "
          f"{out['raw_tls_ms_one_way']} ms {tag}")
    return out


def tls_auth(target: str, tag: str) -> dict:
    """17b: EAUTH for a wrong secret and for none, over tpu_std and hulu;
    the user the handler saw; a plaintext client refused, then TLS at
    once."""
    out = {"echo_calls": 0}
    for proto in ("tpu_std", "hulu_pbrpc"):
        ch = tls_channel(target, protocol=proto)
        try:
            cntl, user = _echo_17(ch, AUTH_PROBE_17)
            check(not cntl.failed() and user == TLS_USER_17,
                  f"17b: {proto} saw {user!r}: {cntl.error_text}")
            out["echo_calls"] += 1
        finally:
            ch.close()
        for label, auth in (("wrong", HmacAuthenticator(b"wrong",
                                                        user=TLS_USER_17)),
                            ("none", None)):
            ch = tls_channel(target, protocol=proto, auth=auth, max_retry=0)
            try:
                cntl, _ = _echo_17(ch, "x")
                check(cntl.error_code == errors.EAUTH,
                      f"17b: {proto} {label} credential gave "
                      f"{cntl.error_code} {cntl.error_text}")
            finally:
                ch.close()
    plain = Channel(ChannelOptions(timeout_ms=2000, max_retry=0))
    check(plain.init(target) == 0, "17b: plaintext channel init")
    t0 = time.perf_counter()
    cntl, _ = _echo_17(plain, "plain")
    out["plaintext_failed_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    plain.close()
    check(cntl.failed() and out["plaintext_failed_ms"] < 2000,
          f"17b: a plaintext call gave {cntl.error_code} in "
          f"{out['plaintext_failed_ms']} ms")
    out["plaintext_error"] = cntl.error_code
    ch = tls_channel(target)
    try:
        t0 = time.perf_counter()
        cntl, msg = _echo_17(ch, "after")
        out["tls_after_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        check(not cntl.failed() and msg == "after",
              f"17b: the TLS call after it: {cntl.error_text}")
        out["echo_calls"] += 1
    finally:
        ch.close()
    print(f"tls/17b: a wrong secret and no credential got EAUTH over tpu_std "
          f"and hulu_pbrpc; the handler saw user {TLS_USER_17!r} over both; "
          f"a plaintext call failed with {out['plaintext_error']} in "
          f"{out['plaintext_failed_ms']} ms (timeout 2000 ms), and a TLS call "
          f"after it was answered in {out['tls_after_ms']} ms (its handshake "
          f"included) {tag}")
    return out


def tls_load(target: str, gen, tag: str) -> dict:
    """17c: 16 threads x 64 Echo calls on one TLS connection, with 8 MiB
    echoes each way beside them; every reply is its call's."""
    threads, calls = CONC_17
    big_threads, big_calls, big_n = BIG_17
    blobs = [torch.randint(0, 256, (big_n,), dtype=torch.uint8,
                           device=torch.device("cuda"), generator=gen
                           ).cpu().numpy().tobytes() for _ in range(big_threads)]
    ch = tls_channel(target, max_retry=0)
    bad, socks, big_ms = [], set(), []

    def small(t):
        for j in range(calls):
            msg = f"{t}-{j}" * (1 + j % 4)
            cntl, got = _echo_17(ch, msg)
            socks.add(cntl._current_sock.socket_id)
            if cntl.failed() or got != msg:
                bad.append((t, j, cntl.error_code, cntl.error_text))

    def big(k):
        for r in range(big_calls):
            cntl, resp = Controller(), Blob()
            cntl.timeout_ms = 60000
            t0 = time.perf_counter()
            ch.call_method("SmokePeer.Echo", cntl, Blob(blobs[k]), resp)
            big_ms.append((time.perf_counter() - t0) * 1e3)
            socks.add(cntl._current_sock.socket_id)
            if cntl.failed() or resp.data != blobs[k]:
                bad.append(("big", k, r, cntl.error_code, cntl.error_text))

    t0 = time.perf_counter()
    try:
        _run_threads([lambda t=t: small(t) for t in range(threads)]
                     + [lambda k=k: big(k) for k in range(big_threads)],
                     "17c", 120)
    finally:
        ch.close()
    secs = time.perf_counter() - t0
    check(not bad, f"17c: {len(bad)} replies wrong, first {bad[:3]}")
    check(len(socks) == 1, f"17c: the calls used {len(socks)} connections")
    out = {"echo_calls": threads * calls, "seconds": round(secs, 3),
           "calls_per_s": round(threads * calls / secs, 1),
           "big_echo_ms_median": round(statistics.median(big_ms), 3)}
    print(f"tls/17c: {threads} threads x {calls} Echo calls and "
          f"{big_threads} x {big_calls} echoes of {big_n} B made on the card "
          f"each way, all on one TLS connection: every reply its own call's, "
          f"in {out['seconds']} s ({out['calls_per_s']} Echo calls/s), an "
          f"8 MiB echo {out['big_echo_ms_median']} ms median {tag}")
    return out


def tls_console(port: int, target: str, status0: bytes, vars0: bytes,
                echo_made: int, pushes: int, tag: str) -> dict:
    """17d: a gRPC call over TLS, then /status and /vars over HTTPS count
    every Echo call and push made in this phase."""
    gch = Channel(ChannelOptions(protocol=GRPC, use_ssl=True,
                                 connect_timeout_ms=5000, timeout_ms=60000))
    check(gch.init(target) == 0, "17d: gRPC channel init")
    try:
        cntl, msg = _echo_17(gch, "grpc over tls")
        check(not cntl.failed() and msg == "grpc over tls",
              f"17d: gRPC over TLS: {cntl.error_text}")
        check(isinstance(cntl._current_sock.fd(), TLSSocket),
              "17d: the gRPC call did not go over TLS")
    finally:
        gch.close()
    echo_made += 1
    status1, vars1 = https_get(port, "/status"), https_get(port, "/vars")
    echo_moved = _push_count(status1, ECHO) - _push_count(status0, ECHO)
    push_moved = (_var_of(vars1, "TensorStore_Push_count")
                  - _var_of(vars0, "TensorStore_Push_count"))
    check(echo_moved == echo_made,
          f"17d: /status counts {echo_moved} Echo calls, made {echo_made}")
    check(push_moved == pushes,
          f"17d: /vars moved TensorStore_Push_count by {push_moved}, "
          f"pushed {pushes}")
    print(f"tls/17d: a gRPC call over TLS answered; over HTTPS /status counts "
          f"{echo_moved} Echo calls, each one made, and /vars moved "
          f"TensorStore_Push_count by {push_moved}, the pushes made {tag}")
    return {"status_echo": echo_moved, "vars_push_count": push_moved}


def _mongo_ping_17(sock, request_id: int) -> dict:
    body = (struct.pack("<i", 0) + b"admin.$cmd\x00" + struct.pack("<ii", 0, 1)
            + mongo.bson_encode({"ping": 1}))
    sock.sendall(mongo.MongoHead(mongo.HEAD_SIZE + len(body), request_id, 0,
                                 mongo.OP_QUERY).pack() + body)
    raw = b""
    while len(raw) < mongo.HEAD_SIZE or len(raw) < struct.unpack_from(
            "<i", raw)[0]:
        chunk = sock.recv(65536)
        check(bool(chunk), "17e: the mongo connection closed")
        raw += chunk
    head = mongo.MongoHead.unpack(raw)
    check(head.op_code == mongo.OP_REPLY and head.response_to == request_id,
          f"17e: mongo reply {head.op_code} to {head.response_to}")
    return mongo.bson_decode(raw, mongo.HEAD_SIZE + 20)[0]


def _family_call(ch: Channel, proto: str, i: int):
    """(controller, whether the answer is the call's) of one call."""
    if proto == "esp":
        cntl, resp = Controller(), esp_protocol.EspMessage()
        cntl.timeout_ms = 60000
        ch.call_method("esp", cntl, esp_protocol.EspMessage(
            f"e{i}".encode(), msg=1, msg_id=i), resp)
        return cntl, resp.body == f"e{i}".encode() and resp.msg_id == i
    cntl, msg = _echo_17(ch, f"s{i}")
    return cntl, msg == f"s{i}"


def tls_family(port: int, sides: dict, legacy_seq: dict, tag: str) -> dict:
    """17e: nova, public_pbrpc, ubrpc, mongo and esp, 200 sequential calls
    each in plaintext; one nova call, mongo ping and esp call inside TLS."""
    out = {}
    for proto in (*FAMILY_17, "mongo", "esp"):
        side = sides["nova_pbrpc" if proto in ("mongo", "esp") else proto]
        times = []
        if proto == "mongo":
            with pysocket.create_connection(("127.0.0.1", side),
                                            timeout=60) as s:
                for i in range(SEQ_17):
                    t0 = time.perf_counter()
                    doc = _mongo_ping_17(s, i + 1)
                    times.append(time.perf_counter() - t0)
                    check(doc == {"ok": 1.0}, f"17e: mongo ping {i}: {doc}")
        else:
            ch = Channel(ChannelOptions(protocol=proto, timeout_ms=60000))
            check(ch.init(f"127.0.0.1:{side}") == 0, f"17e: {proto} init")
            try:
                for i in range(SEQ_17):
                    t0 = time.perf_counter()
                    cntl, ok = _family_call(ch, proto, i)
                    times.append(time.perf_counter() - t0)
                    check(not cntl.failed() and ok,
                          f"17e: {proto} call {i}: {cntl.error_text}")
            finally:
                ch.close()
        out[proto] = {"median_us": round(statistics.median(times) * 1e6, 1),
                      "p99_us": round(_p99(times) * 1e3, 1)}
    target = f"127.0.0.1:{port}"
    for proto in ("nova_pbrpc", "esp"):
        ch = tls_channel(target, protocol=proto)
        try:
            cntl, ok = _family_call(ch, proto, 7)
            check(not cntl.failed() and ok and isinstance(
                cntl._current_sock.fd(), TLSSocket),
                  f"17e: {proto} inside TLS: {cntl.error_text}")
        finally:
            ch.close()
    ctx = ssl.create_default_context(cafile=tls_pair()[0])
    with ctx.wrap_socket(pysocket.create_connection(("127.0.0.1", port),
                                                    timeout=60),
                         server_hostname="127.0.0.1") as s:
        check(_mongo_ping_17(s, 77) == {"ok": 1.0}, "17e: mongo inside TLS")
    nshead = legacy_seq["nshead"]
    print(f"tls/17e: {SEQ_17} sequential calls each in plaintext, median / "
          f"p99 us: " + "; ".join(f"{p} {v['median_us']} / {v['p99_us']}"
                                  for p, v in out.items())
          + f"; 16a's nshead in this run: {nshead['median_us']} / "
          f"{nshead['p99_us']}; a nova call, an esp call and a mongo ping "
          f"answered inside TLS on the one port {tag}")
    return out


def tls_programs(tag: str) -> dict:
    """17f: nshead_extension as a user runs it; the mcpack2pb_gen command
    line's adaptor imported and serving in a fresh interpreter, a host
    program whose server asks for the CPU (an nshead call lands nothing
    on a card, and CUDA's start would take most of the phase)."""
    rc, lines, secs = run_main(nshead_extension.main, [])
    check(rc == 0 and lines == [TLS_LINE_17],
          f"17f: nshead_extension exited {rc}: {lines}")
    here = os.path.dirname(os.path.abspath(__file__))
    script = (
        "import sys\n"
        "import echo_adaptor as g\n"
        "from brpc_tpu_torch import mcpack2pb as mp, rpc\n"
        "from brpc_tpu_torch.examples.nshead_extension import EchoService\n"
        "from brpc_tpu_torch.rpc.nshead_protocol import NsheadMessage\n"
        "srv = rpc.Server(rpc.ServerOptions(device='cpu',\n"
        "    has_builtin_services=False,\n"
        "    nshead_service=g.EchoServiceNsheadAdaptor(EchoService())))\n"
        "assert srv.start('127.0.0.1:0') == 0\n"
        "ch = rpc.Channel(rpc.ChannelOptions(protocol='nshead',"
        " timeout_ms=60000))\n"
        "assert ch.init(str(srv.listen_endpoint)) == 0\n"
        "body = mp.enc_object('', [mp.enc_str('method', 'Echo'),\n"
        "                          mp.enc_str('message', 'Generated')])\n"
        "cntl, resp = ch.call('nshead', NsheadMessage(body), NsheadMessage)\n"
        "msg = mp.loads(resp.body)['message'] if not cntl.failed() else None\n"
        "msg = msg.decode() if isinstance(msg, bytes) else msg\n"
        "ch.close()\n"
        "srv.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'brpc_tpu') or m.startswith('google.protobuf'))\n"
        "print(cntl.error_code, msg, bad)\n")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "echo_adaptor.py")
        rc_gen, _, _ = run_main(mcpack2pb_gen.main, [
            "--service", "brpc_tpu_torch.examples.nshead_extension:EchoService",
            "-o", out])
        check(rc_gen == 0 and os.path.exists(out),
              f"17f: mcpack2pb_gen exited {rc_gen}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", script], cwd=d, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join([d, here])))
        fresh_s = round(time.perf_counter() - t0, 3)
    line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    check(proc.returncode == 0 and line == "0 gENERATED []",
          f"17f: the generated adaptor in a fresh interpreter: "
          f"{proc.returncode} {line!r} {proc.stderr[-2000:]}")
    print(f"tls/17f: nshead_extension exited 0 in {secs} s with the "
          f"reference's line {TLS_LINE_17!r}; mcpack2pb_gen --service wrote "
          f"an adaptor whose module, imported in a fresh interpreter with "
          f"nothing of jax, brpc_tpu or protobuf, served an nshead call "
          f"('gENERATED') in {fresh_s} s {tag}")
    return {"example_seconds": secs, "fresh_interpreter_seconds": fresh_s}


def phase_tls(tag: str, gen, wire_round_s: float, legacy_seq: dict) -> dict:
    """17: TLS and authentication on a --peer --tls's one port, and the
    nshead family, mongo and esp."""
    t_start = time.perf_counter()
    proc = spawn_peer(tls=True)
    ctl = devch = None
    result = {}
    try:
        port, _ = await_peer(proc)
        target = f"127.0.0.1:{port}"
        ctl = tls_channel(target)
        st = peer_control(ctl, "to_card", on=True)
        sides = st["side_ports"]
        check(sorted(sides) == sorted(FAMILY_17),
              f"17: the peer's plaintext ports {sides}")
        devch = _device_channel(target, **_tls_opts())
        warm = torch.ones((1 << 20,), dtype=torch.float32,
                          device=torch.device("cuda"))
        client = TensorClient(devch)
        check(not client.push("warm", [warm])[0].failed(), "17: warm push")
        check(not client.pull("warm", device="cuda")[0].failed(),
              "17: warm pull")
        peer0 = peer_control(ctl, "reset")["memory_allocated"]
        status0, vars0 = https_get(port, "/status"), https_get(port, "/vars")
        result["lanes"] = tls_lanes(target, ctl, devch, gen, wire_round_s, tag)
        result["auth"] = tls_auth(target, tag)
        result["load"] = tls_load(target, gen, tag)
        echo_made = result["auth"]["echo_calls"] + result["load"]["echo_calls"]
        result["console"] = tls_console(port, target, status0, vars0,
                                        echo_made, 2 * ROUNDS_17, tag)
        result["family"] = tls_family(port, sides, legacy_seq, tag)
        st = _reset_at_rest(ctl, devch, peer0, "17")
        print(f"tls/17: the device endpoints, arena and pool at rest, the "
              f"peer's card memory back at {st['memory_allocated']} B {tag}")
        result["programs"] = tls_programs(tag)
        for ch in (devch, ctl):
            ch.close()
        devch = ctl = None
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"17: the peer exited with code {rc}")
    finally:
        for ch in (devch, ctl):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"tls/17: the peer exited 0; phase took {result['seconds']} s {tag}")
    print("tls " + json.dumps(result))
    return result


# -- phase 18: RTMP relayed live by the card server's port -------------------

# Twitch's broadcasting guidelines, 1080p30: video 6,000 kbit/s at 30
# frames/s with a keyframe every 2 s; AAC audio 160 kbit/s at 44.1 kHz
STREAM_18 = "live1080"
SECONDS_18 = 10
FPS_18 = 30
GOP_S_18 = 2
VIDEO_BPS_18 = 6_000_000
AUDIO_BPS_18 = 160_000
AUDIO_RATE_18 = 44100
AAC_SAMPLES_18 = 1024  # samples per AAC frame
KEY_RATIO_18 = 8  # a keyframe is about 8 inter frames
ORIGIN_PLAYERS_18 = 8
EDGE_PLAYERS_18 = 4
LATE_S_18 = 5.0
PUSHES_18 = 10  # the activations pushed and pulled, one a second
BURST_18 = (64, 256 << 10)  # 18b: keyframes, bytes each
WAIT_18 = 30.0


def stream_18(gen):
    """The priming messages and the live messages of 18a, (type, ts ms,
    payload), the live ones in send order; payloads from the seeded
    generator behind real FLV AVC and AAC tag headers."""
    per_gop = VIDEO_BPS_18 // 8 * GOP_S_18
    inter = per_gop // (KEY_RATIO_18 + FPS_18 * GOP_S_18 - 1)
    key = KEY_RATIO_18 * inter
    audio = AUDIO_BPS_18 // 8 * AAC_SAMPLES_18 // AUDIO_RATE_18
    n_video = SECONDS_18 * FPS_18
    n_audio = -(-SECONDS_18 * AUDIO_RATE_18 // AAC_SAMPLES_18)
    sizes = [key if i % (FPS_18 * GOP_S_18) == 0 else inter
             for i in range(n_video)]
    total = sum(sizes) + n_audio * audio + 64
    raw = torch.randint(0, 256, (total,), dtype=torch.uint8,
                        device=torch.device("cuda"), generator=gen)
    raw = raw.cpu().numpy().tobytes()
    pos = 0

    def take(n):
        nonlocal pos
        pos += n
        return raw[pos - n:pos]

    sps, pps = b"\x67\x64\x00\x28" + take(20), b"\x68" + take(4)
    avc_cfg = (b"\x17\x00\x00\x00\x00" + bytes([1, 0x64, 0, 0x28, 0xFF, 0xE1])
               + struct.pack(">H", len(sps)) + sps + b"\x01"
               + struct.pack(">H", len(pps)) + pps)
    aac_cfg = b"\xaf\x00\x12\x10"  # AAC LC, 44.1 kHz, stereo
    meta = amf.encode_many("onMetaData", {
        "width": 1920.0, "height": 1080.0, "framerate": float(FPS_18),
        "videodatarate": VIDEO_BPS_18 / 1e3, "videocodecid": 7.0,
        "audiodatarate": AUDIO_BPS_18 / 1e3,
        "audiosamplerate": float(AUDIO_RATE_18), "audiocodecid": 10.0,
        "stereo": True})
    priming = [(rtmp_protocol.MSG_DATA_AMF0, 0, meta),
               (rtmp_protocol.MSG_VIDEO, 0, avc_cfg),
               (rtmp_protocol.MSG_AUDIO, 0, aac_cfg)]
    live = []
    for i, n in enumerate(sizes):
        nal = (b"\x65" if n == key else b"\x41") + take(n - 10)
        live.append((round(i * 1000 / FPS_18), 0, i, (
            rtmp_protocol.MSG_VIDEO,
            (b"\x17" if n == key else b"\x27") + b"\x01\x00\x00\x00"
            + struct.pack(">I", len(nal)) + nal)))
    for j in range(n_audio):
        live.append((round(j * AAC_SAMPLES_18 * 1000 / AUDIO_RATE_18), 1, j,
                     (rtmp_protocol.MSG_AUDIO, b"\xaf\x01" + take(audio - 2))))
    live.sort()
    return priming, [(t, ts, p) for ts, _, _, (t, p) in live]


class Player18:
    """A port RtmpClient playing a stream: each message is held against
    the stream as it arrives (the three priming messages first, then the
    live ones bit-equal and in order from wherever it joined), and each
    live message's arrival time is kept."""

    def __init__(self, port: int, name: str, priming, live):
        self.priming, self.live = priming, live
        self.index = {(t, ts): i for i, (t, ts, _) in enumerate(live)}
        self.primed = 0
        self.first = self.next = None
        self.arrived = {}
        self.bytes = 0
        self.errors = []
        self.client = rtmp_client.RtmpClient("127.0.0.1", port).connect()
        self.client.start_reader()
        self.client.create_stream().play(name, self.on_media)

    def on_media(self, msg_type, ts, payload):
        now = time.perf_counter()
        if self.primed < len(self.priming):
            if (msg_type, payload) != self.priming[self.primed][::2]:
                self.errors.append(f"message {self.primed} is not the "
                                   f"priming message (type {msg_type})")
            self.primed += 1
            return
        i = self.next if self.next is not None else self.index.get(
            (msg_type, ts))
        if i is None or i >= len(self.live) or \
                self.live[i] != (msg_type, ts, payload):
            self.errors.append(f"live message {i}: type {msg_type} ts {ts} "
                               f"{len(payload)} B out of order or changed")
            return
        if self.first is None:
            self.first = i
        self.next = i + 1
        self.arrived[i] = now
        self.bytes += len(payload)

    def done(self) -> bool:
        return self.next == len(self.live) or bool(self.errors)

    def close(self):
        self.client.close()


def _rtmp_peer(ctl) -> dict:
    return peer_control(ctl, "state")["rtmp"]


def rtmp_pushes(plain, ctl, act, t0: float, out: dict):
    """18a's pushes: the activations to the peer's card by the wire lane
    and back, one round a second."""
    client = TensorClient(plain)
    dev = torch.device("cuda")
    rounds = []
    for r in range(PUSHES_18):
        time.sleep(max(0.0, t0 + r - time.perf_counter()))
        name = f"rtmp18-{r}"
        sent0 = dt.lane_counters()
        torch.cuda.synchronize()
        s = time.perf_counter()
        cntl, resp = client.push(name, [act])
        check(not cntl.failed() and resp.ok,
              f"18a: {name} push: {cntl.error_text}")
        pcntl, got = client.pull(name, device=dev)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - s)
        check(not pcntl.failed() and got is not None,
              f"18a: {name} pull: {pcntl.error_text}")
        moved = sorted(k for k, v in dt.lane_counters().items()
                       if v != sent0.get(k))
        check(moved == ["wire"], f"18a: {name} took {moved}")
        check(got[0].is_cuda and torch.equal(u8(got[0]), u8(act)),
              f"18a: {name}: the pulled bytes differ")
        del got
    out["rounds"] = rounds


def _latency_ms(players, sent_at, live) -> dict:
    video = [i for i, m in enumerate(live)
             if m[0] == rtmp_protocol.MSG_VIDEO]
    lat = [p.arrived[i] - sent_at[i] for p in players for i in video
           if i in p.arrived]
    return {"median_ms": _ms(lat), "p99_ms": _p99(lat), "samples": len(lat)}


def rtmp_live(port: int, ctl, plain, act, gen, wire_round_s: float,
              tag: str) -> tuple:
    """18a: the stream through the peer's port to 8 players there, 4 at an
    edge here that pulls it over the digest handshake, and one that joins
    5 s late, while the activations go to the peer's card and back."""
    priming, live = stream_18(gen)
    sent_bytes = sum(len(p) for _, _, p in live)
    pub = rtmp_client.RtmpClient("127.0.0.1", port).connect()
    check(pub.digest_mode, "18a: the publisher's handshake was not digest")
    stream = pub.create_stream().publish(STREAM_18)
    for t, ts, payload in priming:
        pub.sess.send_message(t, ts, payload, stream_id=stream.stream_id,
                              csid=4)
    _wait(lambda: _rtmp_peer(ctl)["streams"].get(STREAM_18, {}).get(
        "publisher"), WAIT_18, "18a: the peer's stream published")
    edge_svc = rtmp_protocol.RtmpService()
    edge = Server(ServerOptions(num_threads=PEER_THREADS,
                                has_builtin_services=False,
                                rtmp_service=edge_svc))
    check(edge.start("127.0.0.1:0") == 0, "18a: edge server start")
    players, late = [], []
    puller = None
    try:
        puller = rtmp_client.pull_into_service(edge_svc, STREAM_18,
                                               "127.0.0.1", port)
        check(puller.digest_mode, "18a: the edge pull was not digest")
        origin = [Player18(port, STREAM_18, priming, live)
                  for _ in range(ORIGIN_PLAYERS_18)]
        edge_players = [Player18(edge.listen_endpoint.port, STREAM_18,
                                 priming, live)
                        for _ in range(EDGE_PLAYERS_18)]
        players = origin + edge_players
        _wait(lambda: all(p.primed == 3 for p in players), WAIT_18,
              "18a: every player primed")
        sent_at = {}
        pushes = {}
        t0 = time.perf_counter()
        pusher = threading.Thread(
            target=_guarded, args=(rtmp_pushes, pushes, plain, ctl, act,
                                   t0 + 0.5, pushes))
        joiner = threading.Thread(target=_guarded, args=(
            lambda: (time.sleep(max(0.0, t0 + LATE_S_18
                                    - time.perf_counter())),
                     late.append(Player18(port, STREAM_18, priming, live))),
            pushes))
        pusher.start()
        joiner.start()
        for i, (t, ts, payload) in enumerate(live):
            time.sleep(max(0.0, t0 + ts / 1e3 - time.perf_counter()))
            sent_at[i] = time.perf_counter()
            (stream.send_video if t == rtmp_protocol.MSG_VIDEO
             else stream.send_audio)(payload, ts)
        streamed_s = time.perf_counter() - t0
        for th in (pusher, joiner):
            th.join(WAIT_18 + 60)
            check(not th.is_alive(), "18a: a helper thread hangs")
        check("error" not in pushes, f"18a: {pushes.get('error')}")
        players += late
        _wait(lambda: all(p.done() for p in players), WAIT_18,
              "18a: every player at the stream's end")
        for k, p in enumerate(players):
            check(not p.errors, f"18a: player {k}: {p.errors[:3]}")
        full = players[:ORIGIN_PLAYERS_18 + EDGE_PLAYERS_18]
        for k, p in enumerate(full):
            check(p.first == 0 and p.next == len(live)
                  and p.bytes == sent_bytes,
                  f"18a: player {k} got {p.next} messages, {p.bytes} B of "
                  f"{len(live)}, {sent_bytes} B")
        lp = late[0]
        check(lp.primed == 3 and lp.first is not None and lp.first > 0
              and lp.next == len(live),
              f"18a: the late joiner: primed {lp.primed}, live from "
              f"{lp.first} to {lp.next}")
        late_video = sum(1 for i in range(lp.first, len(live))
                         if live[i][0] == rtmp_protocol.MSG_VIDEO)
        st = peer_control(ctl, "state")
        for r in range(PUSHES_18):
            check(st["contents"][f"rtmp18-{r}"][0].startswith("cuda"),
                  f"18a: rtmp18-{r} is not on the peer's card")
        n_video = sum(1 for m in live if m[0] == rtmp_protocol.MSG_VIDEO)
        out = {
            "video_frames": n_video, "audio_frames": len(live) - n_video,
            "bytes_sent": sent_bytes, "streamed_s": round(streamed_s, 3),
            "origin": _latency_ms(origin, sent_at, live),
            "edge": _latency_ms(edge_players, sent_at, live),
            "per_player": [[p.next - p.first, p.bytes] for p in full],
            "late": {"from_message": lp.first, "video_frames": late_video,
                     "bytes": lp.bytes},
            "push_ms_per_round": _ms(pushes["rounds"]),
            "push_p99_ms": _p99(pushes["rounds"]),
            "plaintext_wire_ms_per_round": round(wire_round_s * 1e3, 3),
            "peer_relayed": st["rtmp"]["relayed"]}
        print(f"rtmp/18a: one 1080p30 stream ({VIDEO_BPS_18 // 1000} kbit/s "
              f"video, a keyframe every {GOP_S_18} s; AAC "
              f"{AUDIO_BPS_18 // 1000} kbit/s at {AUDIO_RATE_18} Hz) paced "
              f"for {SECONDS_18} s ({streamed_s:.3f} s): {n_video} video + "
              f"{len(live) - n_video} audio frames, {sent_bytes} B, through "
              f"the peer's one port to {ORIGIN_PLAYERS_18} players there and "
              f"{EDGE_PLAYERS_18} at an edge here pulling over the digest "
              f"handshake, every frame bit-equal and in order: each of them "
              f"{len(live)} messages, {sent_bytes} B of {sent_bytes} B; "
              f"relay latency, send to receipt on this host's clock, origin "
              f"median {out['origin']['median_ms']} ms p99 "
              f"{out['origin']['p99_ms']} ms, edge median "
              f"{out['edge']['median_ms']} ms p99 {out['edge']['p99_ms']} ms;"
              f" the late joiner (at {LATE_S_18} s) got the metadata and both "
              f"sequence headers first, then {late_video} video frames from "
              f"message {lp.first} on, in order {tag}")
        print(f"rtmp/18a: meanwhile the activations {list(act.shape)} "
              f"bfloat16 ({act.numel() * 2} B) went to the peer's card and "
              f"back {PUSHES_18} times by the wire lane, bit-equal: median "
              f"{out['push_ms_per_round']} ms a round, p99 "
              f"{out['push_p99_ms']} ms (phase 6's wire round in this run: "
              f"{out['plaintext_wire_ms_per_round']} ms) {tag}")
        return out, [pub, puller] + [p.client for p in players], edge
    except BaseException:
        for c in [pub, puller] + [p.client for p in players + late]:
            if c is not None:
                c.close()
        edge.stop()
        raise


def _guarded(fn, out: dict, *args):
    try:
        fn(*args)
    except Exception as e:  # read by the caller after the join
        out["error"] = repr(e)


def rtmp_shed(port: int, ctl, gen, tag: str) -> tuple:
    """18b: one player stops reading while the publisher bursts 64
    keyframes of 256 KiB: it is shed once its backlog passes 8 MiB, the
    other players get every frame."""
    name = "burst18"
    n, size = BURST_18
    raw = torch.randint(0, 256, (size,), dtype=torch.uint8,
                        device=torch.device("cuda"), generator=gen)
    frame = b"\x17\x01\x00\x00\x00" + raw.cpu().numpy().tobytes()[5:]
    live = [(rtmp_protocol.MSG_VIDEO, i * 33, frame) for i in range(n)]
    pub = rtmp_client.RtmpClient("127.0.0.1", port).connect()
    clients = [pub]
    conn = None
    try:
        stream = pub.create_stream().publish(name)
        conn, stalled = rtmp_protocol.rtmp_client_connect("127.0.0.1", port)
        stalled.send_command("createStream", 2.0, None)
        stalled.send_command("play", 4.0, None, name, stream_id=1)
        check(stalled.pump_until(lambda s: any(
            c[0] == "onStatus" and c[3]["code"] == "NetStream.Play.Start"
            for c in s.commands()), timeout=WAIT_18),
            "18b: the stalled player's play")
        good = [Player18(port, name, [], live) for _ in range(2)]
        clients += [p.client for p in good]
        _wait(lambda: _rtmp_peer(ctl)["streams"][name]["players"] == 3,
              WAIT_18, "18b: three players at the peer")
        t0 = time.perf_counter()
        for _, ts, payload in live:
            stream.send_video(payload, ts)
        _wait(lambda: all(p.done() for p in good), WAIT_18,
              "18b: the good players at the burst's end")
        took = time.perf_counter() - t0
        for p in good:
            check(not p.errors and p.first == 0 and p.next == n,
                  f"18b: a good player got {p.next} of {n}: {p.errors[:3]}")
        _wait(lambda: _rtmp_peer(ctl)["streams"][name]["players"] == 2,
              WAIT_18, "18b: the stalled player shed at the peer")
        conn.settimeout(WAIT_18)
        read = 0
        while chunk := conn.recv(1 << 20):  # to the peer's close
            read += len(chunk)
        limit = 8 << 20
        check(read < n * size - limit,
              f"18b: the stalled player read {read} B of {n * size} B")
        print(f"rtmp/18b: {n} keyframes of {size} B burst in {took:.3f} s "
              f"with one of three players not reading: it was shed (its "
              f"socket failed at the peer, then closed) after reading "
              f"{read} B of {n * size} B, the backlog bound being {limit} B;"
              f" the other two got all {n} bit-equal {tag}")
        return {"burst_s": round(took, 3), "stalled_read": read}, clients
    except BaseException:
        for c in clients:
            c.close()
        raise
    finally:
        if conn is not None:
            conn.close()


def rtmp_card_iobuf(gen, tag: str):
    """18c: IOBuf.device_arrays returns the card tensors of a chain as
    the same storage; cut_into_file_descriptor writes their bytes."""
    dev = torch.device("cuda")
    a = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device=dev,
                      generator=gen)
    b = torch.randn((512, 1024), dtype=torch.bfloat16, device=dev,
                    generator=gen)
    buf = IOBuf(b"head")
    buf.append_device_array(a)
    buf.append_device_array(b)
    buf.append(b"tail")
    arrays = buf.device_arrays()
    check(len(arrays) == 2 and all(x.is_cuda for x in arrays)
          and arrays[0].data_ptr() == a.data_ptr()
          and arrays[1].data_ptr() == b.data_ptr(),
          "18c: device_arrays is not the card tensors' storage")
    want = (b"head" + u8(a).cpu().numpy().tobytes()
            + u8(b).cpu().numpy().tobytes() + b"tail")
    r, w = os.pipe()
    got = []

    def drain():
        while chunk := os.read(r, 1 << 20):
            got.append(chunk)

    reader = threading.Thread(target=drain)
    reader.start()
    try:
        while not buf.empty():
            buf.cut_into_file_descriptor(w)
    finally:
        os.close(w)
        reader.join(WAIT_18)
        os.close(r)
    check(b"".join(got) == want, "18c: the pipe's bytes differ")
    print(f"rtmp/18c: IOBuf.device_arrays of a chain holding two card "
          f"tensors ({a.numel()} B uint8, {b.numel() * 2} B bfloat16) is "
          f"their storage (data_ptr equal); cut_into_file_descriptor into "
          f"a pipe wrote {len(want)} B, the tensors' bytes between the host "
          f"blocks {tag}")


def rtmp_example_start():
    """18d: the rtmp_relay example as a user runs it, started at once so
    that its interpreter and CUDA start while the rest of the phase runs
    (its own servers take ports of their own); a thread keeps its output
    and the time it took."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.examples.rtmp_relay"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    box = {}

    def run():
        box["out"], box["err"] = proc.communicate()
        box["s"] = time.perf_counter() - t0

    waiter = threading.Thread(target=run, daemon=True)
    waiter.start()
    return proc, waiter, box


def rtmp_example_finish(started, tag: str) -> float:
    proc, waiter, box = started
    waiter.join(180)
    if waiter.is_alive():
        proc.kill()
        waiter.join(10)
        check(False, "18d: rtmp_relay did not exit within 180 s")
    out, err, took = box["out"], box["err"], box["s"]
    lines = out.splitlines()
    want = (r"rtmp server on rtmp://127\.0\.0\.1:\d+/live",
            r"relayed 5 video frames; FLV dump = \d+ bytes, 6 tags",
            r"TS segment = \d+ packets, 5 PES demuxed",
            r"edge server relayed \d+ frames pulled from the origin "
            r"\(digest handshake\)", "OK")
    check(proc.returncode == 0 and len(lines) == len(want) and all(
        re.fullmatch(p, line) for p, line in zip(want, lines)),
        f"18d: rtmp_relay exited {proc.returncode}: {out!r} {err[-2000:]!r}")
    print(f"rtmp/18d: python -m brpc_tpu_torch.examples.rtmp_relay, "
          f"started with the phase, exited 0 in {took:.1f} s with the "
          f"reference's {len(want)} lines {tag}")
    return took


def phase_rtmp(tag: str, gen, wire_round_s: float) -> dict:
    """18: RTMP relayed live by a --peer's one port while pushes land on
    its card; a stalled player shed; IOBuf's card half; the example."""
    t_start = time.perf_counter()
    example = rtmp_example_start()
    proc, port = start_peer()
    ctl = plain = None
    clients, edge = [], None
    result = {}
    try:
        target = f"127.0.0.1:{port}"
        ctl = Channel()
        check(ctl.init(target) == 0, "18: control channel init")
        plain = Channel()
        check(plain.init(target) == 0, "18: plain channel init")
        peer_control(ctl, "to_card", on=True)
        act = torch.randn((BATCH, SEQ, BIG.d_model), dtype=torch.bfloat16,
                          device=torch.device("cuda"), generator=gen)
        client = TensorClient(plain)
        check(not client.push("warm", [act])[0].failed(), "18: warm push")
        check(not client.pull("warm", device="cuda")[0].failed(),
              "18: warm pull")
        st = peer_control(ctl, "reset")
        peer0, rtmp0 = st["memory_allocated"], st["rtmp"]
        check(rtmp0["streams"] == {}, f"18: the peer's relay {rtmp0}")
        wire0 = st["lanes"]["wire"]
        result["live"], clients, edge = rtmp_live(
            port, ctl, plain, act, gen, wire_round_s, tag)
        shed, more = rtmp_shed(port, ctl, gen, tag)
        result["shed"] = shed
        clients += more
        for c in clients:
            if c is not None:
                c.close()
        clients = []
        edge.stop()
        edge = None
        _wait(lambda: _rtmp_peer(ctl)["streams"] == {} and _rtmp_peer(ctl)[
            "sessions"] == rtmp0["sessions"], WAIT_18,
            "18b: the peer's relay at rest after every client closed")
        st = peer_control(ctl, "reset")
        _peer_at_rest(st, "18")
        _pool_full(st, "18")
        check(st["lanes"]["wire"] - wire0 == PUSHES_18,
              f"18: the peer answered {st['lanes']['wire'] - wire0} pulls "
              f"by the wire lane, not {PUSHES_18}")
        check(st["memory_allocated"] == peer0,
              f"18: the peer's card memory {peer0} -> "
              f"{st['memory_allocated']} B")
        print(f"rtmp/18b: every client closed: the peer's streams "
              f"{st['rtmp']['streams']}, rtmp_sessions "
              f"{st['rtmp']['sessions']} (was {rtmp0['sessions']}), its "
              f"endpoints and pool at rest, card memory back at "
              f"{st['memory_allocated']} B {tag}")
        rtmp_card_iobuf(gen, tag)
        result["example_s"] = round(rtmp_example_finish(example, tag), 1)
        example = None
        for ch in (plain, ctl):
            ch.close()
        plain = ctl = None
        rc = stop_peer(proc)
        proc = None
        check(rc == 0, f"18: the peer exited with code {rc}")
    finally:
        for c in clients:
            if c is not None:
                c.close()
        if edge is not None:
            edge.stop()
        for ch in (plain, ctl):
            if ch is not None:
                ch.close()
        if proc is not None:
            stop_peer(proc)
        if example is not None and example[0].poll() is None:
            example[0].kill()
            example[1].join(10)
    result["seconds"] = round(time.perf_counter() - t_start, 1)
    print(f"rtmp/18: the peer exited 0; phase took {result['seconds']} s "
          f"{tag}")
    print("rtmp " + json.dumps(result))
    return result


# -- phase 19: the native runtime -----------------------------------------------

NATIVE19_S = 60          # the phase's budget, checked at its end
PRESS_S_19 = 1.0         # each 16-connection Echo press
PRESS_CONNS_19 = 16
GRACE_MS_19 = 3000       # the peer's graceful_shutdown_timeout_ms
WORKERS_19 = 2
WORKER_FACTORY_19 = "brpc_tpu_torch.rpc.shm_worker:card_landing_services"
SINK_SIZES_19 = (8 << 10, 2 << 20, 8 << 20)  # kind-8 records to the workers
STOP_CODES_19 = {0, errors.ELIMIT, errors.EFAILEDSOCKET, errors.ECLOSE,
                 errno.ECONNREFUSED, errno.ECONNRESET, errno.EPIPE}


class FabricStore(TensorStoreService):
    """Phase 19's store: a push lands on this process's card straight from
    its lane (ring: from the page-locked fabric segment, a lease released
    once the copy is done) before it is answered."""

    def __init__(self):
        super().__init__()
        self.pushes = 0

    @rpc_method(wire.TensorPushRequest, wire.TensorPushResponse)
    def Push(self, cntl, request, response, done):
        meta = getattr(cntl, "_rpc_meta", None)
        if meta is None or not meta.tensors:
            cntl.set_failed(errors.EREQUEST, "no tensors in request")
            done()
            return
        arrays, seq = dt.receive_tensors(meta, cntl.request_attachment,
                                         device="cuda")
        with self._lock:
            self._store[request.name] = arrays
        self.pushes += 1
        response.ok = True
        response.ack_seq = seq or 0
        done()


class Control19(Service):
    """The phase 19 peer's control: JSON ops in an EchoRequest's message,
    the answer as JSON in the response's."""

    SERVICE_NAME = "Control19"

    def __init__(self, store: FabricStore):
        self.store = store
        self.srv = None
        self.stop_at = None
        self.stopper = None

    def state(self) -> dict:
        from brpc_tpu_torch import native

        gc.collect()
        mount = self.srv.native_mount
        st = {"fabric": dt.fabric_state(), "lanes": dt.lane_counters(),
              "pushes": self.store.pushes,
              "memory_allocated": torch.cuda.memory_allocated(),
              "workers": mount.shm_worker_pids() if mount else [],
              "io_uring": bool(mount.io_uring) if mount else None}
        st["spans"] = (native.res_live_bytes("shm.span")
                       if native.available() else 0)
        return st

    @rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Op(self, cntl, request, response, done):
        from brpc_tpu_torch import native
        from brpc_tpu_torch.rpc.shm_worker import checksum

        op = json.loads(request.message)
        out = {}
        if op["op"] == "state":
            out = self.state()
        elif op["op"] == "drop":
            with self.store._lock:
                self.store._store.clear()
            torch.cuda.synchronize()
            out = self.state()
        elif op["op"] == "push_workers":
            gen = torch.Generator().manual_seed(op["seed"])
            for i, n in enumerate(op["sizes"]):
                data = torch.randint(0, 256, (n,), dtype=torch.uint8,
                                     generator=gen)
                out[str(op["tag"] + i)] = [n] + checksum(data)
                check(native.shm_push_tensor(data.numpy(), op["tag"] + i)
                      == 0, "19d: the workers' rings are full")
        elif op["op"] == "stop":
            self.stop_at = time.monotonic()
            self.stopper = threading.Thread(target=self.srv.stop, daemon=True)
            self.stopper.start()
        elif op["op"] == "native":  # phase 20: a call of this peer's library
            out = {"result": getattr(native, op["fn"])(*op.get("args", []))}
        elif op["op"] == "watch":  # phase 20: in flight and draining, sampled
            self.watch = {"inflight_max": 0, "draining": False}
            threading.Thread(target=self._watch, args=(op["s"],),
                             daemon=True).start()
        elif op["op"] == "watched":
            out = self.watch
        response.message = json.dumps(out)
        done()

    watch = None

    def _watch(self, seconds: float):
        from brpc_tpu_torch import native

        end = time.monotonic() + seconds
        while time.monotonic() < end:
            w = self.watch
            w["inflight_max"] = max(w["inflight_max"],
                                    native.rpc_server_inflight())
            w["draining"] = w["draining"] or native.server_draining()
            time.sleep(0.002)


def peer19_main(argv) -> int:
    """The phase 19 peer: TensorStore (FabricStore), SmokeEcho and
    Control19, on the card, with the fabric armed. ``--native`` serves on
    the native runtime, ``--workers N`` with N shm workers whose sink
    lands records on the card, ``--builtin-echo`` with the native
    EchoService.Echo."""
    if not torch.cuda.is_available():
        print("chip_smoke --peer19: CUDA is not available", file=sys.stderr)
        return 2
    from brpc_tpu_torch import native

    workers = int(argv[argv.index("--workers") + 1]) if "--workers" in argv else 0
    store = FabricStore()
    ctl = Control19(store)
    opts = dict(num_threads=PEER_THREADS, use_native_runtime="--native" in argv,
                native_builtin_echo="--builtin-echo" in argv,
                graceful_shutdown_timeout_ms=GRACE_MS_19)
    if workers:
        opts.update(py_workers=workers, py_worker_factory=WORKER_FACTORY_19)
    srv = Server(ServerOptions(**opts))
    ctl.srv = srv
    for svc in (store, SmokeEcho(), ctl):
        check(srv.add_service(svc) == 0, "peer19 add_service")
    check(srv.start("127.0.0.1:0") == 0, "peer19 server start")
    print(f"peer ready {srv.listen_endpoint.port} "
          f"{dt.fabric_state()['name'] or '-'}", flush=True)
    quit_ = threading.Event()
    threading.Thread(target=lambda: (sys.stdin.readline(), quit_.set()),
                     daemon=True).start()
    while srv.is_running and not quit_.wait(0.05):
        pass
    pids = srv.native_mount.shm_worker_pids() if srv.native_mount else []
    t0 = time.monotonic()
    if ctl.stopper is not None:
        ctl.stopper.join(60)  # the stop asked for, under load
    else:
        srv.stop()
    stop_s = time.monotonic() - (ctl.stop_at or t0)
    with store._lock:
        store._store.clear()
    st = ctl.state()
    st["stop_s"] = stop_s
    st["pid"] = os.getpid()
    st["worker_pids_before"] = pids
    st["segments"] = sorted(glob.glob(f"{SHM_DIR}/brpc_tpu_torch_lane_"
                                      f"{os.getpid()}_*"))
    st["watch"] = ctl.watch
    print("peer state " + json.dumps(st), flush=True)
    return 0


def spawn_peer19(*flags):
    """A phase 19 peer with the fabric armed (no BRPC_TPU_FABRIC=0), or
    with it off (``--no-fabric``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("BRPC_TPU_FABRIC", None)
    if "--no-fabric" in flags:
        env["BRPC_TPU_FABRIC"] = "0"
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--peer19", *flags],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=here,
        env=env)


def stop_peer19(proc) -> dict:
    """Close the peer's stdin (or it stopped itself); its final state."""
    try:
        proc.stdin.close()
    except OSError:
        pass
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError("chip_smoke: a phase 19 peer did not stop")
    out = proc.stdout.read()
    lines = [ln for ln in out.splitlines() if ln.startswith("peer state ")]
    check(proc.returncode == 0 and lines,
          f"19: the peer exited with code {proc.returncode}")
    return json.loads(lines[-1][len("peer state "):])


def ctl19(ch: Channel, op: str, **kw) -> dict:
    cntl = Controller()
    cntl.timeout_ms = 60000
    resp = wire.EchoResponse()
    ch.call_method("Control19.Op", cntl, wire.EchoRequest(
        message=json.dumps({"op": op, **kw})), resp)
    check(not cntl.failed(), f"19 control {op}: {cntl.error_text}")
    return json.loads(resp.message)


def native_build_19(tag: str) -> dict:
    """19a: the port's native library from brpc_tpu_torch/native/src."""
    from brpc_tpu_torch import native
    from brpc_tpu_torch.native import build

    gxx = subprocess.run([build.compiler(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.splitlines()[0]
    t0 = time.perf_counter()
    lib = native.library_path()
    took = time.perf_counter() - t0
    native.load()
    print(f"native/19a: {gxx}; library {os.path.relpath(lib)} built from "
          f"brpc_tpu_torch/native/src in {took:.1f} s (one g++ -c per file, "
          f"{os.cpu_count()} at once) {tag}")
    return {"gxx": gxx, "build_s": round(took, 1)}


def ring_rounds_19(endpoint: str, shm_endpoint: str, ch: Channel, gen,
                   shm_ms: dict, tag: str):
    """19b: push + pull + ACK rounds by the ring lane at phase 6's sizes,
    each in turn with the same round to a peer alike but for its fabric,
    which is off (the shm lane), both landing on their card; every byte
    equal, ``ring`` moving by the first peer's pushes and ``shm`` by the
    second's, ``wire`` not. Each round's time is split: the sender's lane
    fill (``DeviceEndpoint._fill_lane``: the copies into the peer's
    segment or this process's send arena), the rest of the push (the RPC
    and the peer's landing on its card) and the pull with its ACK."""
    dev = torch.device("cuda")
    clients = {"ring": TensorClient(make_device_channel(endpoint)),
               "shm": TensorClient(make_device_channel(shm_endpoint))}
    payloads = [(label, x) for label, x in cross_payloads(gen)
                if not label.startswith("64MiB")]
    out = {}
    fills = []
    fill_lane = dt.DeviceEndpoint._fill_lane

    def timed_fill(self, *args):
        t = time.perf_counter()
        try:
            return fill_lane(self, *args)
        finally:
            fills.append(time.perf_counter() - t)

    dt.DeviceEndpoint._fill_lane = timed_fill
    try:
        for label, x in payloads:
            times = {"ring": [], "shm": []}
            split = {lane: {"fill": [], "push_rest": [], "pull": []}
                     for lane in times}
            for r in range(XROUNDS):
                for lane in ("ring", "shm") if r % 2 == 0 else ("shm", "ring"):
                    client = clients[lane]
                    lanes0 = dt.lane_counters()
                    fills.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cntl, resp = client.push(label, [x])
                    t1 = time.perf_counter()
                    check(not cntl.failed() and resp.ok and len(fills) == 1,
                          f"19b {label} {lane} push: {cntl.error_text}")
                    pcntl, got = client.pull(label, device=dev)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    times[lane].append(t2 - t0)
                    split[lane]["fill"].append(fills[0])
                    split[lane]["push_rest"].append(t1 - t0 - fills[0])
                    split[lane]["pull"].append(t2 - t1)
                    check(not pcntl.failed() and got is not None,
                          f"19b {label} {lane} pull: {pcntl.error_text}")
                    lanes = dt.lane_counters()
                    other = "shm" if lane == "ring" else "ring"
                    check(lanes[lane] == lanes0[lane] + 1
                          and lanes[other] == lanes0[other]
                          and lanes["wire"] == lanes0["wire"],
                          f"19b {label}: the {lane} push took another lane: "
                          f"{lanes0} -> {lanes}")
                    fabric = cntl._current_sock.app_state.peer_info["fabric"]
                    check(cntl.request_attachment.empty()
                          and bool(fabric) == (lane == "ring"),
                          f"19b {label} {lane}: payload bytes on the RPC "
                          f"wire, or the peer's fabric {fabric!r}")
                    check(got[0].dtype == x.dtype
                          and torch.equal(u8(got[0]), u8(x)),
                          f"19b {label} {lane}: bytes differ")
            out[label] = {"median_ms": _ms(times["ring"]),
                          "p99_ms": _p99(times["ring"]),
                          "shm_fabric_off_median_ms": _ms(times["shm"]),
                          "shm_fabric_off_p99_ms": _p99(times["shm"]),
                          "shm_median_ms": round(
                              shm_ms[f"shm/{label}"] * 1e3, 3),
                          "split_median_ms": {
                              lane: {k: _ms(v) for k, v in parts.items()}
                              for lane, parts in split.items()}}
    finally:
        dt.DeviceEndpoint._fill_lane = fill_lane
        for client in clients.values():
            client.channel.close()
    st = ctl19(ch, "drop")
    check(st["fabric"]["held_records"] == 0 and st["fabric"]["live_leases"] == 0
          and st["spans"] == 0,
          f"19b: the peer's fabric is not at rest: {st['fabric']}, "
          f"{st['spans']} B of arena spans held")
    check(st["fabric"]["pinned"], "19b: the peer's fabric is not page-locked")
    print("native/19b: push + pull + ACK x" + str(XROUNDS) + " by the ring "
          "lane, each in turn with the same round by shm to a peer whose "
          "fabric is off, both landing on the card, bytes equal: " + "; ".join(
              f"{k} ring median {v['median_ms']} ms p99 {v['p99_ms']} ms, "
              f"shm median {v['shm_fabric_off_median_ms']} ms p99 "
              f"{v['shm_fabric_off_p99_ms']} ms (phase 6's shm median "
              f"{v['shm_median_ms']} ms); median fill / rest of the push / "
              f"pull ms: ring " + " / ".join(
                  str(t) for t in v["split_median_ms"]["ring"].values())
              + ", shm " + " / ".join(
                  str(t) for t in v["split_median_ms"]["shm"].values())
              for k, v in out.items())
          + f"; the ring peer's fabric at rest, page-locked {tag}")
    return out


def echo_press_19(port: int, seconds: float = PRESS_S_19) -> dict:
    """Echo over tpu_std from PRESS_CONNS_19 threads, a connection each,
    one call at a time: qps, p50 and p99 in microseconds."""
    stop = time.monotonic() + seconds
    lat, errs = [], []

    def one(k):
        ch = Channel()
        check(ch.init(f"127.0.0.1:{port}") == 0, "19c press channel")
        try:
            while time.monotonic() < stop:
                cntl = Controller()
                cntl.timeout_ms = 5000
                t0 = time.perf_counter()
                ch.call_method("EchoService.Echo", cntl,
                               wire.EchoRequest(message=f"p{k}"),
                               wire.EchoResponse())
                lat.append(time.perf_counter() - t0)
                if cntl.failed():
                    errs.append(cntl.error_code)
        finally:
            ch.close()

    t0 = time.perf_counter()
    _run_threads([lambda k=k: one(k) for k in range(PRESS_CONNS_19)],
                 "19c press")
    took = time.perf_counter() - t0
    check(lat and not errs, f"19c press: errors {errs[:5]}")
    lat.sort()
    return {"qps": round(len(lat) / took, 1),
            "p50_us": round(lat[len(lat) // 2] * 1e6, 1),
            "p99_us": round(_p99(lat) * 1e3, 1), "calls": len(lat)}


RING_CLIENT_19 = r"""
import json, os, sys, torch
sys.path.insert(0, os.getcwd())
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.tensor_service import TensorClient, make_device_channel
gen = torch.Generator(device="cuda").manual_seed(19)
x = torch.randn((4, 512, 2048), dtype=torch.bfloat16, device="cuda",
                generator=gen)
pushes = int(sys.argv[1])
port = int(sys.stdin.readline())  # started early: CUDA is up by now
client = TensorClient(make_device_channel(f"127.0.0.1:{port}"))
lanes0 = dt.lane_counters()
ok = []
for i in range(pushes):
    cntl, resp = client.push("ring19c", [x])
    pc, got = client.pull("ring19c", device="cuda")
    ok.append(not cntl.failed() and resp.ok and not pc.failed()
              and cntl.request_attachment.empty()
              and torch.equal(got[0].view(torch.uint8), x.view(torch.uint8)))
lanes = dt.lane_counters()
client.channel.close()
print(json.dumps({"ok": ok, "lanes": {k: lanes[k] - lanes0[k] for k in lanes}}))
"""


def spawn_ring_client_19(pushes: int = 4):
    """19c's pusher (and 20c's): a process of its own (a process pushes by
    ring to one segment), told the native peer's port on its stdin."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", RING_CLIENT_19, str(pushes)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=here)


def native_serve_19(n1: int, n2: int, ctl1: Channel, ring_client,
                    press_a: dict, std_press: dict, tag: str) -> dict:
    """19c: TensorStore on the native runtime by ring (from 19c's pusher)
    and by wire; Echo under 16 connections on its Python lane and on the
    native echo; /status over the native HTTP lane."""
    dev = torch.device("cuda")
    out, err = ring_client.communicate(f"{n1}\n", timeout=120)
    check(ring_client.returncode == 0, f"19c ring client: {err[-2000:]}")
    ring = json.loads(out.strip().splitlines()[-1])
    check(all(ring["ok"]) and ring["lanes"]["ring"] == 4
          and ring["lanes"]["shm"] == 0 and ring["lanes"]["wire"] == 0,
          f"19c: ring pushes into the native peer: {ring}")
    plain = Channel()
    check(plain.init(f"127.0.0.1:{n1}") == 0, "19c plain channel")
    try:
        client = TensorClient(plain)
        x = torch.arange(1 << 20, dtype=torch.int32, device=dev)
        wire0 = dt.lane_counters()["wire"]
        cntl, resp = client.push("wire19c", [x])
        check(not cntl.failed() and resp.ok, f"19c wire push: {cntl.error_text}")
        check(dt.lane_counters()["wire"] == wire0 + 1, "19c: not the wire lane")
        pc, got = client.pull("wire19c", device=dev)
        check(not pc.failed() and torch.equal(got[0], x),
              "19c: the wire push came back changed")
    finally:
        plain.close()
    st = ctl19(ctl1, "state")
    check(st["pushes"] >= 5 and st["memory_allocated"] > 0,
          f"19c: the native peer landed {st['pushes']} pushes on its card")
    presses = {"native_python_lane": echo_press_19(n1),
               "native_builtin_echo": echo_press_19(n2)}
    code, _, status, _ = http_get(n2, "/status")
    check(code == 200 and b"EchoService" in status,
          "19c: /status over the native HTTP lane")
    io_uring = ctl19(ctl1, "state")["io_uring"]
    std = std_press["unthrottled"]
    print("native/19c: the native runtime served by "
          + ("io_uring" if io_uring else "epoll (io_uring refused)")
          + f"; 4 pushes of the activations by ring from another process and "
          f"one 4 MiB push by wire landed on its card bit-equal; Echo, 16 "
          f"connections: " + "; ".join(
              f"{k} {v['qps']} qps p50 {v['p50_us']} us p99 {v['p99_us']} us"
              for k, v in {**presses, "python_listener": press_a}.items())
          + f"; phase 14's rpc_press (4 threads, one channel) on the Python "
          f"server {std['qps']} qps avg {std['avg_us']} us; /status "
          f"answered over the native HTTP lane {tag}")
    return {"ring_client": ring["lanes"], "io_uring": io_uring,
            "press": {**presses, "python_listener": press_a}}


def native_workers_19(n1: int, ctl1: Channel, tag: str) -> dict:
    """19d: kind-8 records land on the card in the worker processes, with
    the sender's checksums; one HTTP and one gRPC call through them."""
    st = ctl19(ctl1, "state")
    pids = st["workers"]
    check(len(pids) == WORKERS_19, f"19d: workers {pids}")
    sent = ctl19(ctl1, "push_workers", seed=19, sizes=list(SINK_SIZES_19),
                 tag=1900)
    gch = Channel(ChannelOptions(protocol=GRPC))
    check(gch.init(f"127.0.0.1:{n1}") == 0, "19d grpc channel")
    try:
        states, landed = {}, {}
        end = time.monotonic() + 30
        while time.monotonic() < end:
            cntl = Controller()
            cntl.timeout_ms = 10000
            resp = wire.EchoResponse()
            gch.call_method("WorkerSink.State", cntl, wire.EchoRequest(), resp)
            check(not cntl.failed(), f"19d gRPC: {cntl.error_text}")
            w = json.loads(resp.message)
            states[w["pid"]] = w
            landed = {}
            for s in states.values():
                landed.update(s["landed"])
            if set(states) == set(pids) and set(landed) == set(sent):
                break
            time.sleep(0.05)
    finally:
        gch.close()
    check(set(states) == set(pids), f"19d: gRPC reached {set(states)} of {pids}")
    for t, (n, *sums) in sent.items():
        got = landed.get(t)
        check(got is not None and got[0] == n and got[1] == "cuda"
              and got[2:] == sums,
              f"19d: record {t} landed as {got}, sent {[n] + sums}")
    drops = [s["drops"] for s in states.values()]
    check(drops == [0] * len(drops),
          f"19d: shm_tensor_sink_unregistered_drops {drops}")
    status, _, body, _ = http_get(
        n1, "/EchoService/Echo", method="POST", body='{"message": "w"}',
        headers={"Content-Type": "application/json"})
    who = json.loads(body)["message"].split("@")
    check(status == 200 and int(who[1]) in pids,
          f"19d: HTTP answered by {who}, not a worker of {pids}")
    print(f"native/19d: {WORKERS_19} shm workers (pids {pids}); records of "
          f"{list(SINK_SIZES_19)} B landed on the card in the workers with "
          f"the sender's checksums; unregistered drops {drops}; HTTP and "
          f"gRPC answered by workers {tag}")
    return {"workers": pids, "records": len(sent)}


class _Keep19:
    """A ResponseMerger keeping its sub-channel's response bytes."""

    body = b""

    def merge(self, main_response, sub_response) -> int:
        self.body = sub_response.SerializeToString()
        main_response.MergeFrom(sub_response)
        return 0


def native_cluster_19(n1: int, n2: int, tag: str) -> dict:
    """19f: a NativeCluster (rr) over the two native peers against the
    Python ParallelChannel and PartitionChannel to the same peers, and
    host_parallel_call through a MeshChannel."""
    import torch.distributed as dist

    from brpc_tpu_torch.parallel.mesh_channel import MeshChannel
    from brpc_tpu_torch.parallel.world import RankMesh
    from brpc_tpu_torch.rpc import ParallelChannel, PartitionChannel
    from brpc_tpu_torch.rpc.native_cluster import NativeCluster

    # the native cluster keeps its backends in endpoint order
    eps = sorted([f"127.0.0.1:{n1}", f"127.0.0.1:{n2}"])
    nodes = [(ep, 1, f"{i}/2") for i, ep in enumerate(eps)]
    req = wire.EchoRequest(message="fan19")
    payload = req.SerializeToString()
    with NativeCluster(lb="rr", connect_timeout_ms=2000) as c:
        c.update(nodes)
        rc, par, err, failed = c.parallel_call("EchoService.Echo", payload,
                                               timeout_ms=10000)
        check(rc == 0 and failed == 0, f"19f parallel_call: {rc} {err}")
        rc, part, err, failed = c.partition_call(
            "EchoService.Echo", payload, timeout_ms=10000, partitions=2)
        check(rc == 0 and failed == 0, f"19f partition_call: {rc} {err}")
        with pysocket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free}",
                                world_size=1, rank=0)
        try:
            mc = MeshChannel(RankMesh(MeshSpec()), "dp").attach_host_cluster(c)
            rc, host, err, failed = mc.host_parallel_call(
                "EchoService.Echo", payload, timeout_ms=10000)
        finally:
            dist.destroy_process_group()
        check(rc == 0 and host == par, f"19f host_parallel_call: {rc} {err}")
    bodies = {}
    for name, make in (
            ("parallel", lambda ms: _py_parallel(eps, ms)),
            ("partition", lambda ms: _py_partition(eps, ms))):
        mergers = [_Keep19(), _Keep19()]
        ch = make(mergers)
        try:
            cntl = Controller()
            cntl.timeout_ms = 10000
            ch.call_method("EchoService.Echo", cntl, req, wire.EchoResponse())
            check(not cntl.failed(), f"19f Python {name}: {cntl.error_text}")
        finally:
            ch.stop()
        bodies[name] = b"".join(m.body for m in mergers)
    check(bodies["parallel"] == par and bodies["partition"] == part,
          "19f: the native bodies differ from the Python channels'")
    print(f"native/19f: NativeCluster rr over the two native peers: "
          f"parallel_call and partition_call bodies ({len(par)} B, "
          f"{len(part)} B) equal the Python ParallelChannel's and "
          f"PartitionChannel's; MeshChannel.host_parallel_call the same "
          f"{tag}")
    return {"parallel_bytes": len(par), "partition_bytes": len(part)}


def _py_parallel(eps, mergers):
    from brpc_tpu_torch.rpc import ParallelChannel

    pc = ParallelChannel()
    for ep, m in zip(eps, mergers):
        ch = Channel()
        check(ch.init(ep) == 0, "19f channel")
        pc.add_channel(ch, None, m)
    pc.stop = lambda: [c.close() for c, _, _ in pc._subs]
    return pc


def _py_partition(eps, mergers):
    from brpc_tpu_torch.rpc import PartitionChannel

    pc = PartitionChannel()
    check(pc.init(2, "list://" + ",".join(f"{ep} {i}/2" for i, ep in
                                          enumerate(eps))) == 0,
          "19f partition init")
    pc._subs = [(c, None, m) for (c, _, _), m in zip(pc._subs, mergers)]
    return pc


def graceful_stop_19(n1: int, ctl1: Channel, tag: str) -> dict:
    """19e: the native peer stops under load from 16 pushing connections;
    every call answered or refused with the reference's codes."""
    dev = torch.device("cuda")
    x = torch.randn((1 << 16,), device=dev)
    codes, go = [], threading.Event()

    def pusher(k):
        ch = Channel()
        check(ch.init(f"127.0.0.1:{n1}") == 0, "19e channel")
        client = TensorClient(ch)
        go.wait(30)
        try:
            for _ in range(10000):
                cntl, _ = client.push(f"stop{k}", [x], timeout_ms=10000)
                codes.append(cntl.error_code)
                if cntl.failed():
                    return
        finally:
            ch.close()

    threads = [threading.Thread(target=pusher, args=(k,), daemon=True)
               for k in range(16)]
    for t in threads:
        t.start()
    go.set()
    _wait(lambda: codes.count(0) >= 32, 30, "19e: the pushers under way")
    ctl19(ctl1, "stop")
    for t in threads:
        t.join(60)
    check(not any(t.is_alive() for t in threads), "19e: a pusher hangs")
    hist = {c: codes.count(c) for c in sorted(set(codes))}
    check(set(hist) <= STOP_CODES_19 and hist.get(0, 0) >= 32,
          f"19e: calls ended with {hist}")
    return hist


def phase_native(tag: str, gen, lanes: dict, std_press: dict) -> dict:
    """19: the native runtime (its build, the ring lane, a native server
    with shm workers, a graceful stop, the native cluster)."""
    t_start = time.perf_counter()
    # the peers start CUDA while this process builds the library (they
    # wait on its lock, then load the same build)
    procs = {"a": spawn_peer19(),
             "s": spawn_peer19("--no-fabric"),
             "n1": spawn_peer19("--native", "--workers", str(WORKERS_19)),
             "n2": spawn_peer19("--native", "--builtin-echo"),
             "ring_client": spawn_ring_client_19()}
    chans = {}
    finals = {}
    result = {}
    try:
        result["build"] = native_build_19(tag)
        ports = {k: await_peer(p)[0] for k, p in procs.items()
                 if k != "ring_client"}
        for k, port in ports.items():
            chans[k] = Channel()
            check(chans[k].init(f"127.0.0.1:{port}") == 0, "19 control channel")
        result["ring"] = ring_rounds_19(f"127.0.0.1:{ports['a']}",
                                        f"127.0.0.1:{ports['s']}", chans["a"],
                                        gen, lanes, tag)
        finals["s"] = stop_peer19(procs.pop("s"))
        press_a = echo_press_19(ports["a"])
        finals["a"] = stop_peer19(procs.pop("a"))
        result["serve"] = native_serve_19(ports["n1"], ports["n2"],
                                          chans["n1"],
                                          procs.pop("ring_client"), press_a,
                                          std_press, tag)
        result["workers"] = native_workers_19(ports["n1"], chans["n1"], tag)
        result["cluster"] = native_cluster_19(ports["n1"], ports["n2"], tag)
        result["stop"] = graceful_stop_19(ports["n1"], chans["n1"], tag)
        finals["n1"] = stop_peer19(procs.pop("n1"))
        finals["n2"] = stop_peer19(procs.pop("n2"))
    finally:
        for ch in chans.values():
            ch.close()
        for p in procs.values():
            p.kill()
            p.wait()
            # a killed peer cannot unlink its segment
            for seg in glob.glob(f"{SHM_DIR}/brpc_tpu_torch_lane_{p.pid}_*"):
                os.unlink(seg)
    check(not finals["n1"]["segments"],
          f"19e: the stopped peer's segments {finals['n1']['segments']}")
    for k, st in finals.items():
        check(st["fabric"]["held_records"] == 0
              and st["fabric"]["live_leases"] == 0 and st["spans"] == 0
              and not st["workers"], f"19e: peer {k} left {st}")
        for pid in st["worker_pids_before"]:
            check(not os.path.exists(f"/proc/{pid}"),
                  f"19e: worker {pid} of peer {k} is still alive")
        left = glob.glob(f"{SHM_DIR}/brpc_tpu_torch_lane_{st['pid']}_*")
        check(not left, f"19e: peer {k} left {left} after its exit")
    n1 = finals["n1"]
    result["stop"] = {"codes": result["stop"], "stop_s": round(n1["stop_s"], 3)}
    took = time.perf_counter() - t_start
    print(f"native/19e: the native peer stopped under 16 pushing connections "
          f"in {n1['stop_s']:.3f} s (graceful_shutdown_timeout_ms "
          f"{GRACE_MS_19}): calls ended with {result['stop']['codes']}; "
          f"no lease, record, arena span, worker or segment left in any "
          f"peer, each exited 0; phase took {took:.1f} s {tag}")
    check(took < NATIVE19_S, f"19: the phase took {took:.1f} s")
    result["seconds"] = round(took, 1)
    print("native " + json.dumps(result))
    return result


# -- phase 20: the native runtime's observability and client lanes ---------------

NATIVE20_S = 60          # the phase's budget, checked at its end
BENCH_S_20 = 2.0         # each rpc_client_bench
BENCH_CONNS_20, BENCH_FIBERS_20 = 16, 32
RING_PUSHES_20 = 8       # the activations, by ring, from another process
MIX_20 = 12              # rounds of tpu_std + HTTP + gRPC during the capture
LIMIT_20, PRESS_20 = 4, 32
FAULT_SPEC_20 = "seed=7;write:err=EPIPE:p=0.25"
FAULT_CALLS_20 = 40
EXAMPLES_20 = {"native_client": [], "native_protocol_clients": [],
               "usercode_workers": [], "io_uring_echo": ["--seconds", "0.5"]}

def spawn_phase20():
    """Phase 20's processes, started beside phase 19's so that their CUDA
    start overlaps the library's build: a native peer (Python lane), a
    native peer with the builtin echo, and the ring pusher."""
    return {"a": spawn_peer19("--native"),
            "b": spawn_peer19("--native", "--builtin-echo"),
            "pusher": spawn_ring_client_19(RING_PUSHES_20)}


def nat20(ch: Channel, fn: str, *args):
    """A call of the peer's own native library, through its control."""
    return ctl19(ch, "native", fn=fn, args=list(args))["result"]


def _echo_bytes(msg: str, **kw) -> bytes:
    return wire.EchoRequest(message=msg, **kw).SerializeToString()


def _echo_of(body: bytes) -> str:
    m = wire.EchoResponse()
    m.ParseFromString(body)
    return m.message


def _acalls_20(port: int, reqs, timeout_ms: int = 10000) -> list:
    """Each request body as an async EchoService.Echo on a native
    connection of its own; the codes in order."""
    from brpc_tpu_torch import native

    chans = [native.channel_open("127.0.0.1", port, connect_timeout_ms=5000)
             for _ in reqs]
    codes, ev, lock = {}, threading.Event(), threading.Lock()

    def make(i):
        def done(code, resp):
            with lock:
                codes[i] = code
                if len(codes) == len(reqs):
                    ev.set()
        return done

    try:
        for i, body in enumerate(reqs):
            check(native.channel_acall(chans[i], "EchoService", "Echo", body,
                                       make(i), timeout_ms=timeout_ms) == 0,
                  "20: channel_acall")
        check(ev.wait(60), "20: async calls answered")
    finally:
        for c in chans:
            native.channel_close(c)
    return [codes[i] for i in range(len(reqs))]


def native_clients_20(pa: int, pb: int, tag: str) -> dict:
    """20a: this process's native clients against both peers."""
    from brpc_tpu_torch import native

    out = {}
    ch = native.channel_open("127.0.0.1", pb, connect_timeout_ms=5000)
    try:
        rc, body, err = native.channel_call(ch, "EchoService", "Echo",
                                            _echo_bytes("sync20"),
                                            timeout_ms=5000)
        check(rc == 0 and _echo_of(body) == "sync20", f"20a sync: {rc} {err}")
        got, ev = [], threading.Event()
        check(native.channel_acall(ch, "EchoService", "Echo",
                                   _echo_bytes("async20"),
                                   lambda c, r: (got.append((c, r)), ev.set()),
                                   timeout_ms=5000) == 0, "20a acall")
        check(ev.wait(10) and got[0][0] == 0 and _echo_of(got[0][1])
              == "async20", f"20a async: {got}")
    finally:
        native.channel_close(ch)
    ch = native.channel_open("127.0.0.1", pa, connect_timeout_ms=5000)
    try:
        t0 = time.perf_counter()
        rc, _, err = native.channel_call(
            ch, "EchoService", "Echo", _echo_bytes("stall", sleep_us=600000),
            timeout_ms=150)
        out["deadline_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        check(rc == errors.ERPCTIMEDOUT, f"20a deadline: {rc} {err}")
    finally:
        native.channel_close(ch)
    h = native.channel_open_http("127.0.0.1", pa, connect_timeout_ms=5000)
    g = native.channel_open_grpc("127.0.0.1", pa, connect_timeout_ms=5000)
    try:
        code, body = native.http_call(h, "GET", "/status", timeout_ms=10000)
        check(code == 200 and b"EchoService" in body, f"20a GET /status {code}")
        code, body = native.http_call(
            h, "POST", "/EchoService/Echo", body=b'{"message": "http20"}',
            headers="Content-Type: application/json\r\n", timeout_ms=10000)
        check(code == 200 and json.loads(body)["message"] == "http20",
              f"20a POST: {code} {body[:200]}")
        st, body, msg = native.grpc_call(g, "/EchoService/Echo",
                                         _echo_bytes("grpc20"),
                                         timeout_ms=10000)
        check(st == 0 and _echo_of(body) == "grpc20", f"20a gRPC: {st} {msg}")
    finally:
        native.channel_close(h)
        native.channel_close(g)
    print(f"native/20a: this process's native clients: sync and async Echo, "
          f"a 150 ms deadline answered 1008 after {out['deadline_ms']} ms, "
          f"HTTP GET /status and a JSON POST, gRPC Echo, every body right "
          f"{tag}")
    return out


def spawn_examples_20() -> dict:
    here = os.path.dirname(os.path.abspath(__file__))
    return {name: subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; from brpc_tpu_torch.examples import {name}; "
         f"sys.exit({name}.main({argv!r}))"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=here)
        for name, argv in EXAMPLES_20.items()}


def finish_examples_20(procs: dict, tag: str) -> dict:
    """20a: the four native examples exited 0 with their last line."""
    last = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        check(p.returncode == 0, f"20a example {name}: {p.returncode} "
                                 f"{err[-2000:]}")
        last[name] = out.strip().splitlines()[-1]
    check(last["native_client"] == "OK" and last["native_protocol_clients"]
          == "ok" and last["usercode_workers"] == "ok", f"20a: {last}")
    print(f"native/20a: native_client, native_protocol_clients, "
          f"usercode_workers and io_uring_echo exited 0 "
          f"(io_uring_echo: {last['io_uring_echo']!r}) {tag}")
    return last


def bench_20(pa: int, pb: int, ctlb: Channel, press19: dict, tag: str) -> dict:
    """20b: Echo from C++ (rpc_client_bench) against the native Python lane
    and the native echo, beside 19c's rate from 16 Python connections; the
    peer's counters moved by the requests the bench counted."""
    from brpc_tpu_torch import native

    def bench(port):
        return native.rpc_client_bench("127.0.0.1", port, BENCH_CONNS_20,
                                       BENCH_FIBERS_20, BENCH_S_20, 16)

    out = {"native_python_lane": bench(pa)}
    before = nat20(ctlb, "stats_counters")
    out["native_builtin_echo"] = bench(pb)
    after = nat20(ctlb, "stats_counters")
    n = out["native_builtin_echo"]["requests"]
    moved = {k: after[k] - before[k] for k in ("nat_tpu_std_msgs_in",
                                               "nat_tpu_std_responses_out")}
    # tpu_std messages in: the bench's and the control call that read the
    # counters after it; natively answered: the bench's alone
    check(n > 0 and moved == {"nat_tpu_std_msgs_in": n + 1,
                              "nat_tpu_std_responses_out": n},
          f"20c: the peer counted {moved}, the bench {n}")
    res = device_performance.native_bulk(8)
    check(res.get("bytes", 0) > 0, "20b: the native bulk lane moved nothing")
    py = {k: press19[k]["qps"] for k in ("native_python_lane",
                                         "native_builtin_echo")}
    print(f"native/20b: Echo from C++ ({BENCH_CONNS_20} connections x "
          f"{BENCH_FIBERS_20} fibers, 16 B, {BENCH_S_20} s): native Python "
          f"lane {out['native_python_lane']['qps']:.1f} qps, native echo "
          f"{out['native_builtin_echo']['qps']:.1f} qps; 19c from 16 Python "
          f"connections: {py['native_python_lane']} and "
          f"{py['native_builtin_echo']} qps; native bulk lane at 8 MiB "
          f"{res['GBps']:.3f} GB/s {tag}")
    out.update(counted=moved, bulk=res, python_19c=py)
    return out


def _page(port: int, path: str) -> str:
    status, _, body, _ = http_get(port, path)
    check(status == 200, f"20: {path} answered {status}")
    return body.decode()


def _page_at_least(port: int, path: str, pattern: str, want: int) -> int:
    """The number the page shows, once it reached ``want`` (the console
    reads snapshots kept 0.25 s: the first read may predate the calls)."""
    end, reads = time.monotonic() + 20, 0
    while True:
        m = re.search(pattern, _page(port, path), re.M)
        reads += 1
        if m and int(m[1]) >= want:
            return int(m[1])
        check(reads < 3 or time.monotonic() < end,
              f"20c: {path} shows {m and m[1]}, want >= {want}")
        time.sleep(0.1)


def counts_20(pa: int, pb: int, ctla: Channel, ctlb: Channel, pusher,
              tag: str) -> dict:
    """20c: ring pushes onto the card under C++ load, and the peer's
    counters, pages, spans and native profiles against that traffic."""
    from brpc_tpu_torch import native

    pushes0 = ctl19(ctla, "state")["pushes"]
    load = {}
    loader = threading.Thread(target=lambda: load.update(
        native.rpc_client_bench("127.0.0.1", pb, BENCH_CONNS_20,
                                BENCH_FIBERS_20, 4.0, 16)), daemon=True)
    loader.start()
    pages = {}
    profiler = threading.Thread(target=lambda: pages.update(
        {p: _page(pb, p) for p in ("/hotspots/native?seconds=1",
                                   "/hotspots/contention?seconds=1",
                                   "/heap/native?seconds=0.5",
                                   "/heap/native",
                                   "/growth/native?seconds=0.5")}),
        daemon=True)
    profiler.start()
    out, err = pusher.communicate(f"{pa}\n", timeout=120)
    check(pusher.returncode == 0, f"20c ring pusher: {err[-2000:]}")
    ring = json.loads(out.strip().splitlines()[-1])
    loader.join(60)
    profiler.join(60)
    check(all(ring["ok"]) and len(ring["ok"]) == RING_PUSHES_20
          and ring["lanes"]["ring"] == RING_PUSHES_20
          and ring["lanes"]["shm"] == ring["lanes"]["wire"] == 0,
          f"20c: ring pushes {ring}")
    st = ctl19(ctla, "state")
    check(st["pushes"] - pushes0 == RING_PUSHES_20
          and st["fabric"]["held_records"] == 0
          and st["fabric"]["live_leases"] == 0,
          f"20c: the peer counted {st['pushes'] - pushes0} pushes, "
          f"fabric {st['fabric']}")
    uring = nat20(ctla, "ring_counters")
    check(load.get("requests", 0) > 0, "20c: the load ran")
    # the counters on the pages, moved by what the clients counted
    snap = nat20(ctlb, "stats_counters")
    n_vars = _page_at_least(pb, "/vars/nat_tpu_std_msgs_in",
                            r"^nat_tpu_std_msgs_in : (\d+)$",
                            snap["nat_tpu_std_msgs_in"])
    n_prom = _page_at_least(pb, "/brpc_metrics",
                            r'^nat_method_count\{lane="echo",'
                            r'method="EchoService\.Echo"\} (\d+)$',
                            snap["nat_tpu_std_responses_out"])
    status = _page(pb, "/status")
    check("native runtime:" in status and "tpu_std: in=" in status,
          "20c: /status without its native section")
    # one native /connections row per client connection
    rows0 = len(nat20(ctlb, "conn_snapshot"))
    chans = [native.channel_open("127.0.0.1", pb, connect_timeout_ms=5000)
             for _ in range(5)]
    try:
        for c in chans:
            check(native.channel_call(c, "EchoService", "Echo", b"",
                                      timeout_ms=5000)[0] == 0, "20c echo")
        conns = _page(pb, "/connections")
        srv_rows = [ln for ln in conns.splitlines() if "|srv   |" in ln]
        rows1 = len(nat20(ctlb, "conn_snapshot"))
    finally:
        for c in chans:
            native.channel_close(c)
    check(rows1 - rows0 == 5 and len(srv_rows) >= 5,
          f"20c: /connections rows {rows0} -> {rows1} for 5 connections")
    # a call under trace_scope: caller span -> client span -> server span
    trace_id, parent = 0x20C0FFEE, 0x2002
    native.stats_enable_spans(1)
    ch = native.channel_open("127.0.0.1", pb, connect_timeout_ms=5000)
    try:
        with native.trace_scope(trace_id, parent):
            rc = native.channel_call(ch, "EchoService", "Echo",
                                     _echo_bytes("traced"), timeout_ms=5000)[0]
    finally:
        native.channel_close(ch)
        native.stats_enable_spans(0)
    mine = [s for s in rpcz.find_trace(trace_id) if s.kind == "client"]
    check(rc == 0 and len(mine) == 1 and mine[0].parent_span_id == parent,
          f"20c: the client span {[(s.kind, s.parent_span_id) for s in mine]}")
    rpcz_page = _page(pb, f"/rpcz?trace_id={trace_id:x}")
    check(f"parent={mine[0].span_id:016x} [server] EchoService.Echo"
          in rpcz_page and "native parse done" in rpcz_page
          and "native response queued" in rpcz_page,
          f"20c: /rpcz?trace_id without the native server span under the "
          f"client span {mine[0].span_id:016x}: {rpcz_page[:500]}")
    # the native profiles under load
    hot = pages["/hotspots/native?seconds=1"]
    m = re.match(r"# nat_prof: (\d+) samples", hot)
    check(m and int(m[1]) > 0 and ("nat_" in hot or "brpc_tpu::" in hot),
          f"20c: /hotspots/native {hot[:300]}")
    cont = pages["/hotspots/contention?seconds=1"]
    check(cont.startswith("# native lock contention")
          and "# python wait-frame profile" in cont,
          f"20c: /hotspots/contention {cont[:300]}")
    heap = re.search(r"# nat_res heap: (\d+) sites, (\d+) bytes live",
                     pages["/heap/native"])
    growth = re.search(r"# nat_res growth: (\d+) growing sites, (-?\d+) "
                       r"bytes grown", pages["/growth/native?seconds=0.5"])
    check(heap and int(heap[1]) > 0 and int(heap[2]) > 0 and growth,
          f"20c: /heap/native {pages['/heap/native'][:300]} /growth/native "
          f"{pages['/growth/native?seconds=0.5'][:300]}")
    out = {"ring_pushes": RING_PUSHES_20, "peer_pushes": st["pushes"] - pushes0,
           "io_uring_completions": uring, "load_qps": load["qps"],
           "vars": n_vars, "metrics_echo_row": n_prom,
           "conn_rows": [rows0, rows1], "samples": int(m[1]),
           "heap_sites": int(heap[1]), "heap_bytes": int(heap[2]),
           "growth_sites": int(growth[1])}
    print(f"native/20c: {RING_PUSHES_20} ring pushes of the activations "
          f"landed on the peer's card bit-equal under C++ load "
          f"({load['qps']:.1f} qps on the other peer), counted by the peer "
          f"({out['peer_pushes']}; io_uring completions {uring}, epoll "
          f"serving where 0); /vars nat_tpu_std_msgs_in {n_vars} and "
          f"/brpc_metrics' EchoService.Echo row {n_prom} against the "
          f"peer's counters; /status's native section; /connections rows "
          f"{rows0} -> {rows1} for 5 connections; a traced call's native "
          f"server span under its client span under {parent:#x}; "
          f"/hotspots/native {out['samples']} samples with native frames, "
          f"the native lock section, /heap/native {out['heap_sites']} sites "
          f"{out['heap_bytes']} B, /growth/native {out['growth_sites']} "
          f"growing sites {tag}")
    return out


def capture_20(pa: int, ctla: Channel, tag: str) -> dict:
    """20d: the peer's native recorder for 2 s under a tpu_std, HTTP, gRPC
    and push mix, replayed by ``rpc_replay --native``."""
    from brpc_tpu_torch import native

    directory = tempfile.mkdtemp(prefix="chip_smoke_native_dump_")
    page = {}
    window = threading.Thread(target=lambda: page.update(body=_page(
        pa, f"/rpc_dump?seconds=2&dir={directory}")), daemon=True)
    window.start()
    _wait(lambda: nat20(ctla, "dump_running"), 10, "20d: the capture window")
    chans = (native.channel_open("127.0.0.1", pa, connect_timeout_ms=5000),
             native.channel_open_http("127.0.0.1", pa,
                                      connect_timeout_ms=5000),
             native.channel_open_grpc("127.0.0.1", pa,
                                      connect_timeout_ms=5000))
    plain = Channel()
    check(plain.init(f"127.0.0.1:{pa}") == 0, "20d plain channel")
    try:
        ch, h, g = chans
        for i in range(MIX_20):
            check(native.channel_call(ch, "EchoService", "Echo",
                                      _echo_bytes(f"m{i}"),
                                      timeout_ms=5000)[0] == 0, "20d tpu_std")
            check(native.http_call(h, "POST", "/EchoService/Echo",
                                   body=b'{"message": "h"}',
                                   headers="Content-Type: application/json"
                                           "\r\n", timeout_ms=5000)[0] == 200,
                  "20d HTTP")
            check(native.grpc_call(g, "/EchoService/Echo", _echo_bytes("g"),
                                   timeout_ms=5000)[0] == 0, "20d gRPC")
        client = TensorClient(plain)
        x = torch.arange(1 << 14, dtype=torch.int32, device="cuda")
        for i in range(2):  # by wire: the tensors ride the attachment
            cntl, resp = client.push(f"dump20.{i}", [x])
            check(not cntl.failed() and resp.ok, "20d push")
    finally:
        for c in chans:
            native.channel_close(c)
        plain.close()
    window.join(30)
    st = nat20(ctla, "dump_status")
    files = sorted(glob.glob(os.path.join(directory, "*.rio")))
    check(not st["running"] and st["written"] > 0 and files
          and "native recorder: stopped" in page.get("body", ""),
          f"20d: the window {st} {files}")
    res = native.replay_run("127.0.0.1", pa, directory, concurrency=4,
                            timeout_ms=5000)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = rpc_replay.main(["--dir", directory, "--server",
                                f"127.0.0.1:{pa}", "--native",
                                "--concurrency", "4"])
    check(res["loaded"] == st["written"] and res["ok"] >= 3 * MIX_20
          and res["ok"] + res["failed"] + res["skipped"] == res["loaded"],
          f"20d: replay {res} of {st}")
    shutil.rmtree(directory, ignore_errors=True)
    out = {"captured": st["written"], "samples": st["samples"],
           "oversize": st["oversize"], "drops": st["drops"],
           "replay": {k: res[k] for k in ("loaded", "ok", "failed",
                                          "skipped")},
           "tool_exit": code, "tool": buf.getvalue().strip()}
    print(f"native/20d: /rpc_dump?seconds=2 captured {st['written']} records "
          f"(samples {st['samples']}, oversize {st['oversize']}, drops "
          f"{st['drops']}) from {MIX_20} rounds of tpu_std, HTTP and gRPC "
          f"and 2 wire pushes; replayed natively: loaded {res['loaded']}, "
          f"ok {res['ok']}, failed {res['failed']} (a push's tensors are not "
          f"recorded, queue C #16), skipped {res['skipped']}; rpc_replay "
          f"--native exited {code}: {out['tool']} {tag}")
    return out


def server_calls_20(pa: int, ctla: Channel, tag: str) -> dict:
    """20e: the limiter, a second port, a seeded fault spec."""
    from brpc_tpu_torch import native

    out = {}
    nat20(ctla, "rpc_server_limiter", f"constant:{LIMIT_20}")
    ctl19(ctla, "watch", s=10)
    codes = _acalls_20(pa, [_echo_bytes("lim", sleep_us=200000)] * PRESS_20)
    watched = ctl19(ctla, "watched")
    out["limit"] = nat20(ctla, "rpc_server_limit")
    nat20(ctla, "rpc_server_limiter", "")
    hist = {c: codes.count(c) for c in sorted(set(codes))}
    check(out["limit"] == LIMIT_20 and set(hist) == {0, errors.ELIMIT}
          and hist[0] >= LIMIT_20 and watched["inflight_max"] <= LIMIT_20,
          f"20e: limit {out['limit']}, codes {hist}, in flight at most "
          f"{watched['inflight_max']}")
    out.update(codes=hist, inflight_max=watched["inflight_max"])
    # a second port: a push onto the card, then refused once removed
    p2 = nat20(ctla, "rpc_server_add_port", "127.0.0.1", 0)
    plain = Channel()
    check(plain.init(f"127.0.0.1:{p2}") == 0, "20e second port channel")
    try:
        client = TensorClient(plain)
        x = torch.randn((1 << 18,), device="cuda")
        cntl, resp = client.push("port20", [x])
        pc, got = client.pull("port20", device="cuda")
        check(not cntl.failed() and resp.ok and not pc.failed()
              and torch.equal(got[0], x), "20e: a push to the second port")
    finally:
        plain.close()
    check(nat20(ctla, "rpc_server_remove_port", p2) == 0, "20e remove_port")
    try:
        c = native.channel_open("127.0.0.1", p2, connect_timeout_ms=1000)
        refused = native.channel_call(c, "EchoService", "Echo", b"",
                                      timeout_ms=1000)[0] != 0
        native.channel_close(c)
    except RuntimeError:
        refused = True
    check(refused, "20e: the removed port still serves new connections")
    # a seeded fault spec on this process's writes: faults = failed calls
    before = native.fault_injected()
    check(native.fault_configure(FAULT_SPEC_20) == 0, "20e fault spec")
    ch = native.channel_open("127.0.0.1", pa, connect_timeout_ms=5000)
    try:
        fcodes = [native.channel_call(ch, "EchoService", "Echo",
                                      _echo_bytes("f"), timeout_ms=5000)[0]
                  for _ in range(FAULT_CALLS_20)]
    finally:
        native.fault_configure("")
        native.channel_close(ch)
    injected = native.fault_injected() - before
    failed = sum(1 for c in fcodes if c != 0)
    check(injected == failed > 0, f"20e: {injected} faults, {failed} failed "
                                  f"calls {fcodes}")
    out.update(second_port=p2, faults=injected, failed_calls=failed)
    print(f"native/20e: limiter constant:{LIMIT_20} under {PRESS_20} calls: "
          f"codes {hist}, in flight at most {watched['inflight_max']}; a "
          f"second port took a push onto the card and refused connections "
          f"once removed; {FAULT_SPEC_20!r} over {FAULT_CALLS_20} calls: "
          f"{injected} faults injected, {failed} calls failed {tag}")
    return out


def phase_native_clients(tag: str, procs: dict, native19: dict) -> dict:
    """20: the native runtime's observability and client lanes against two
    native peers started beside phase 19's."""
    t_start = time.perf_counter()
    examples = spawn_examples_20()
    chans, finals, result = {}, {}, {}
    try:
        ports = {k: await_peer(procs[k])[0] for k in ("a", "b")}
        for k, port in ports.items():
            chans[k] = Channel()
            check(chans[k].init(f"127.0.0.1:{port}") == 0, "20 control channel")
        pa, pb = ports["a"], ports["b"]
        result["clients"] = native_clients_20(pa, pb, tag)
        result["bench"] = bench_20(pa, pb, chans["b"],
                                   native19["serve"]["press"], tag)
        result["counts"] = counts_20(pa, pb, chans["a"], chans["b"],
                                     procs.pop("pusher"), tag)
        result["capture"] = capture_20(pa, chans["a"], tag)
        result["server"] = server_calls_20(pa, chans["a"], tag)
        result["examples"] = finish_examples_20(examples, tag)
        # the graceful stop under a call in flight: draining while it runs
        ctl19(chans["a"], "watch", s=10)
        slow = threading.Thread(target=lambda: result.update(
            stop_call=_acalls_20(pa, [_echo_bytes("s", sleep_us=300000)])),
            daemon=True)
        slow.start()
        time.sleep(0.1)
        ctl19(chans["a"], "stop")
        slow.join(30)
        finals["a"] = stop_peer19(procs.pop("a"))
        finals["b"] = stop_peer19(procs.pop("b"))
    finally:
        for ch in chans.values():
            ch.close()
        for p in list(procs.values()) + list(examples.values()):
            if p.poll() is None:
                p.kill()
                p.wait()
            for seg in glob.glob(f"{SHM_DIR}/brpc_tpu_torch_lane_{p.pid}_*"):
                os.unlink(seg)
    check(finals["a"]["watch"]["draining"] and result["stop_call"] == [0],
          f"20e: draining {finals['a']['watch']}, the call in flight "
          f"{result['stop_call']}")
    for k, st in finals.items():
        check(st["fabric"]["held_records"] == 0
              and st["fabric"]["live_leases"] == 0 and st["spans"] == 0
              and not st["workers"], f"20e: peer {k} left {st}")
        left = glob.glob(f"{SHM_DIR}/brpc_tpu_torch_lane_{st['pid']}_*")
        check(not left, f"20e: peer {k} left {left} after its exit")
    took = time.perf_counter() - t_start
    print(f"native/20e: server_draining() true during the graceful stop, the "
          f"call in flight answered 0; no lease, record, arena span, worker "
          f"or segment left, each peer exited 0; phase took {took:.1f} s "
          f"{tag}")
    check(took < NATIVE20_S, f"20: the phase took {took:.1f} s")
    result["seconds"] = round(took, 1)
    print("native20 " + json.dumps(result))
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = card_name_and_limit()
    tag = f"[{card}]"
    print(card)  # as nvidia-smi gives it: name, power limit

    # phases 1-18 measure the shm lane between this process and its peers:
    # the descriptor-ring fabric stays off in both until phase 19
    os.environ["BRPC_TPU_FABRIC"] = "0"
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
    lanes = phase_cross_process(tag, gen)
    phase_train(tag)
    naming = phase_naming(tag, gen)
    phase_serve(tag, gen, naming)
    phase_streams(tag, gen)
    phase_trace(tokens, tag)
    phase_console(tag, gen)
    phase_tracing(tag, gen, naming)
    examples = phase_examples(tag, gen)
    wire_8mib = 2 * BATCH * SEQ * BIG.d_model * 2 / lanes["wire/8MiB-act"]
    grpc = phase_grpc(tag, gen, wire_8mib / 1e6, examples["press"])
    legacy = phase_legacy(tag, gen, wire_8mib / 1e6, grpc, examples["press"])
    phase_tls(tag, gen, lanes["wire/8MiB-act"], legacy["sequential"])
    phase_rtmp(tag, gen, lanes["wire/8MiB-act"])
    procs20 = spawn_phase20()  # their CUDA start overlaps 19's build
    try:
        native19 = phase_native(tag, gen, lanes, examples["press"])
        phase_native_clients(tag, procs20, native19)
    finally:
        for p in procs20.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    print("kernels: none ported - brpc_tpu has no Pallas kernel "
          "(no pallas_call in its sources); its device work is XLA-lowered "
          "jnp/lax, which the port runs as torch ops")
    print(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--peer"]:
        sys.exit(peer_main(tls=sys.argv[2:] == ["--tls"]))
    if sys.argv[1:2] == ["--peer19"]:
        sys.exit(peer19_main(sys.argv[2:]))
    sys.exit(main())
