"""The rank mesh and the spawn harness: how the port runs SPMD code.

JAX drives one global array over N devices from one controller, and a
collective names a mesh axis. torch runs one process per rank, and a
collective names a process group. So the port has two pieces the reference
does not need:

* ``RankMesh`` — this rank's coordinates on the five axes of a
  ``MeshSpec`` (row-major over ``MeshSpec.AXIS_NAMES``, as the reference's
  ``make_mesh`` reshapes its device list) and one process group for each
  axis set the model reduces over (``GROUP_AXES``). Every rank creates
  every group in the same order, as ``dist.new_group`` requires.
* ``run_ranks`` — starts one process per rank, joins them with a deadline
  and returns their results in rank order. On the card it runs NCCL with
  one card per rank; with ``device="cpu"`` it runs gloo. A rank's
  exception, a rank that dies, and a world that outlives its deadline all
  raise in the caller, and no rank outlives the call.
"""
from __future__ import annotations

import datetime
import itertools
import pickle
import queue
import time
import traceback
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.tensor.config import MeshSpec

AXIS_NAMES = MeshSpec.AXIS_NAMES
# the axis sets the SPMD model reduces over: each axis, and dp+sp for the
# loss and the gradient merge
GROUP_AXES = (("dp",), ("pp",), ("tp",), ("sp",), ("ep",), ("dp", "sp"))
DEFAULT_DEADLINE_S = 300.0
# after a rank fails, how long the others get to report their own failure
FAILURE_GRACE_S = 2.0


def _canonical_axes(axes) -> Tuple[str, ...]:
    """An axis name or a sequence of them, as a tuple in mesh order."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(names) - set(AXIS_NAMES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    return tuple(a for a in AXIS_NAMES if a in names)


def _rank_sets(sizes: Sequence[int], axes: Tuple[str, ...]):
    """The ranks of each group of ``axes``: one tuple per coordinate of the
    other axes, in row-major order; inside a tuple, row-major over
    ``axes``, which is ascending rank order (a group's own rank order)."""
    moving = [AXIS_NAMES.index(a) for a in axes]
    fixed = [i for i in range(len(AXIS_NAMES)) if i not in moving]
    for base in itertools.product(*(range(sizes[i]) for i in fixed)):
        ranks = []
        for idx in itertools.product(*(range(sizes[i]) for i in moving)):
            coord = [0] * len(AXIS_NAMES)
            for i, c in zip(fixed, base):
                coord[i] = c
            for i, c in zip(moving, idx):
                coord[i] = c
            ranks.append(int(np.ravel_multi_index(coord, sizes)))
        yield tuple(ranks)


class RankMesh:
    """This rank's place on the five-axis mesh of ``spec``.

    Must be built by every rank of an initialised world whose size is
    ``spec.n_devices``, in the same order relative to other groups. A
    group that spans the world is the world's own group; a group of this
    rank alone is ``None`` and the collective verbs move nothing over it
    (a psum over one participant is the identity)."""

    def __init__(self, spec: MeshSpec):
        world = dist.get_world_size()
        if spec.n_devices != world:
            raise ValueError(f"mesh {spec.shape} needs {spec.n_devices} "
                             f"ranks, the world has {world}")
        self.spec = spec
        self.rank = dist.get_rank()
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        sizes = tuple(spec.shape[a] for a in AXIS_NAMES)
        self.coords = {a: int(c) for a, c in
                       zip(AXIS_NAMES, np.unravel_index(self.rank, sizes))}
        self._groups = {}
        made = {}
        for axes in GROUP_AXES:
            for ranks in _rank_sets(sizes, axes):
                if ranks not in made:
                    if len(ranks) == world:
                        made[ranks] = dist.group.WORLD
                    elif len(ranks) == 1:
                        made[ranks] = None
                    else:
                        made[ranks] = dist.new_group(list(ranks))
                if self.rank in ranks:
                    self._groups[axes] = (made[ranks], ranks)

    def size(self, axes) -> int:
        n = 1
        for a in _canonical_axes(axes):
            n *= self.spec.shape[a]
        return n

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axes):
        return self._groups[_canonical_axes(axes)][0]

    def global_rank(self, axis: str, index: int) -> int:
        """The world rank of participant ``index`` on this rank's ``axis``."""
        return self._groups[_canonical_axes(axis)][1][index]


def run_ranks(fn: Callable, world_size: int, args: tuple = (),
              device: DeviceLike = None,
              deadline_s: float = DEFAULT_DEADLINE_S) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` ranks, one process each,
    and return the results in rank order. ``fn`` and ``args`` are pickled
    (``fn`` by its import path) and the child imports ``fn``'s module, so
    that module must not import what the ranks should not load.

    On the card (the default): NCCL, rank r on card r; raises when there
    are fewer cards than ranks. With ``device="cpu"``: gloo, one thread
    per rank."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if have < world_size:
            raise RuntimeError(f"{world_size} ranks need {world_size} cards "
                               f"(one per rank); the host has {have}")
        return launch(fn, args, "nccl",
                      [f"cuda:{r}" for r in range(world_size)], deadline_s)
    return launch(fn, args, "gloo", ["cpu"] * world_size, deadline_s)


def launch(fn: Callable, args: tuple, backend: str, devices: Sequence[str],
           deadline_s: float) -> list:
    """``run_ranks`` with the backend and each rank's device given."""
    world = len(devices)
    deadline = time.monotonic() + deadline_s
    timeout = datetime.timedelta(seconds=deadline_s)
    # The parent holds the rendezvous store, so its port is never raced,
    # and hands the work over through it: a process's start-up pipe
    # carries only small arguments, so starting a rank never blocks.
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          wait_for_workers=False, timeout=timeout)
    store.set("brpc_tpu_torch/work", pickle.dumps((fn, args)))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(backend, devices[r], r, world, store.port,
                               deadline_s, results))
             for r in range(world)]
    out, failures, dead_since = {}, {}, {}
    grace_end = None
    try:
        for p in procs:
            p.start()
        while len(out) + len(failures) < world:
            now = time.monotonic()
            if grace_end is not None and now > grace_end:
                break  # the other ranks' fate follows from the failure
            if now > deadline:
                missing = [r for r in range(world)
                           if r not in out and r not in failures]
                raise TimeoutError(f"ranks {missing} of {world} gave no "
                                   f"result by the {deadline_s:g} s deadline")
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r in out or r in failures or p.exitcode is None:
                        continue
                    # a rank flushes its result before it exits
                    dead_since.setdefault(r, now)
                    if now - dead_since[r] > 1.0:
                        failures[r] = (f"exited with code {p.exitcode} "
                                       f"without a result")
                continue
            if ok:
                out[rank] = value
            else:
                failures[rank] = value
            if failures and grace_end is None:
                grace_end = time.monotonic() + FAILURE_GRACE_S
        if failures:
            raise RuntimeError("\n".join(
                f"rank {r} of {world} ({backend}) failed:\n{text}"
                for r, text in sorted(failures.items())))
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} still running at the "
                               f"{deadline_s:g} s deadline")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()


def _rank_main(backend, device, rank, world, port, deadline_s, results):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # one core per rank, not all per rank
        timeout = datetime.timedelta(seconds=deadline_s)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=timeout)
        # written by the parent that started us, never by another host
        fn, args = pickle.loads(store.get("brpc_tpu_torch/work"))
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=timeout)
        try:
            value = fn(dev, *args)
        except Exception:
            # reported before the group goes down, so that this cause
            # reaches the parent ahead of the peers' broken connections
            results.put((rank, False, traceback.format_exc()))
            return
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the boundary of the rank: the parent raises it
        results.put((rank, False, traceback.format_exc()))


def tensors_to_numpy(tree):
    """A tree of NamedTuples, dicts, lists and tuples with its tensors as
    numpy arrays (bfloat16 as float32): a rank's result crosses to the
    parent as plain numpy, never as shared tensor storage."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: tensors_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tensors_to_numpy(v) for v in tree]
        return type(tree)(*items) if hasattr(type(tree), "_fields") \
            else type(tree)(items)
    return tree

