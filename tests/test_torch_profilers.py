"""The card trace of the port (``builtin.profilers.cuda_trace``), on the CPU.

* ``cuda_trace(device="cpu", seconds=0.1)`` returns a zip whose Chrome
  trace holds an op that another thread ran inside the window.
* The window is clamped to 0.1-30 s, read through a patched sleep.
* The single-CPU guard gives the reference's text in both packages and
  returns before any profiler starts; ``BRPC_TPU_FORCE_TPU_TRACE``
  overrides it.
* A trace asked for while one runs is refused with the reference's
  "profiler trace failed" text.
* Without CUDA, ``cuda_trace()`` raises: it never traces the CPU in
  place of the card.

No test starts ``jax.profiler``; every wait has a deadline.
"""
import io
import json
import threading
import time
import types
import zipfile

import jax
import pytest
import torch

from brpc_tpu.builtin import profilers as ref_profilers
from brpc_tpu_torch.builtin import profilers

WAIT_S = 3.0


def _trace_of(body: bytes) -> dict:
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        (name,) = zf.namelist()
        assert name.endswith(".pt.trace.json")
        return json.loads(zf.read(name))


def _sleeps(monkeypatch, during=None):
    """Patch the module's clock: its sleep records the seconds asked for
    and runs ``during`` instead of sleeping."""
    asked = []

    def sleep(s):
        asked.append(s)
        if during is not None:
            during()

    monkeypatch.setattr(profilers, "time",
                        types.SimpleNamespace(sleep=sleep))
    return asked


def _no_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(jax.profiler, "trace", refuse)


def test_cpu_trace_holds_an_op_of_another_thread(monkeypatch):
    a = torch.ones(64, 64)

    def another_thread_works():
        t = threading.Thread(target=lambda: torch.mm(a, a))
        t.start()
        t.join(WAIT_S)
        assert not t.is_alive()
        time.sleep(0.1)

    monkeypatch.delenv("BRPC_TPU_FORCE_TPU_TRACE", raising=False)
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 2)
    asked = _sleeps(monkeypatch, another_thread_works)
    ctype, body = profilers.cuda_trace(seconds=0.1, device="cpu")
    assert ctype == "application/zip" and asked == [0.1]
    events = _trace_of(body)["traceEvents"]
    (window,) = [e for e in events if e.get("cat") == "Trace"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm, sorted({e.get("name") for e in events})
    assert all(window["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= window["ts"] + window["dur"] for e in mm)


@pytest.mark.parametrize("seconds, window", [(0, 0.1), (0.5, 0.5),
                                             (1e6, 30.0)])
def test_window_is_clamped(monkeypatch, seconds, window):
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 2)
    asked = _sleeps(monkeypatch)
    ctype, _ = profilers.cuda_trace(seconds=seconds, device="cpu")
    assert ctype == "application/zip" and asked == [window]


def test_single_cpu_guard_twin(monkeypatch):
    monkeypatch.delenv("BRPC_TPU_FORCE_TPU_TRACE", raising=False)
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 1)
    _no_profiler(monkeypatch)
    got = profilers.cuda_trace(1.0, device="cpu")
    assert got == ref_profilers.tpu_trace(1.0)
    assert got[0] == "text/plain" and "single-cpu host" in got[1]


def test_force_overrides_the_guard(monkeypatch):
    monkeypatch.setenv("BRPC_TPU_FORCE_TPU_TRACE", "1")
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 1)
    _sleeps(monkeypatch)
    ctype, body = profilers.cuda_trace(0.1, device="cpu")
    assert ctype == "application/zip" and _trace_of(body)["traceEvents"]


def test_a_second_trace_is_refused(monkeypatch):
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 2)
    inside, release = threading.Event(), threading.Event()
    _sleeps(monkeypatch, lambda: (inside.set(), release.wait(WAIT_S)))
    first = []
    t = threading.Thread(
        target=lambda: first.append(profilers.cuda_trace(0.1, device="cpu")))
    t.start()
    try:
        assert inside.wait(WAIT_S)
        ctype, text = profilers.cuda_trace(0.1, device="cpu")
        assert ctype == "text/plain"
        assert text.startswith("profiler trace failed: ")
    finally:
        release.set()
        t.join(WAIT_S)
    assert not t.is_alive() and first[0][0] == "application/zip"


def test_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(profilers.os, "cpu_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _no_profiler(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profilers.cuda_trace()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profilers.cuda_trace(0.1, device="cuda")
