"""rpc_dump — sampled recording of outgoing requests, for replay.

Port of brpc_tpu/rpc/rpc_dump.py (brpc's rpc_dump.h). With ``rpc_dump``
on, one request in ``rpc_dump_sample_every`` is appended, as serialized
before compression, to a recordio file under ``rpc_dump_dir`` (one file
per process, opened at the first record); the meta holds the service,
the method, the log id and the time. ``tools/rpc_replay.py`` (or a port
``Channel`` given each payload as bytes) sends them again.

What is recorded is the request message only: the tensors of a
``TensorStore.Push`` ride the meta and the attachment, so its record
holds the few bytes of the tensor's name, and its replay fails with
EREQUEST "no tensors in request", as in the reference (ROADMAP queue C
#16).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.recordio import RecordWriter

flags.define_bool("rpc_dump", False, "sample and dump outgoing requests")
flags.define_string("rpc_dump_dir", "./rpc_dump", "directory for dump files")
flags.define_int("rpc_dump_sample_every", 1,
                 "dump 1 of every N requests")

_writer: Optional[RecordWriter] = None
_writer_lock = threading.Lock()
_counter = [0]


def _get_writer() -> Optional[RecordWriter]:
    global _writer
    if _writer is None:
        with _writer_lock:
            if _writer is None:
                d = flags.get_flag("rpc_dump_dir")
                try:
                    os.makedirs(d, exist_ok=True)
                    path = os.path.join(
                        d, f"rpc_dump.{os.getpid()}.{int(time.time())}.rio")
                    _writer = RecordWriter(path)
                except OSError:
                    return None
    return _writer


def maybe_dump_request(method_full_name: str, payload: bytes, log_id: int = 0):
    """Called as each call starts; nothing to do unless ``rpc_dump``."""
    if not flags.get_flag("rpc_dump"):
        return
    every = max(1, flags.get_flag("rpc_dump_sample_every"))
    with _writer_lock:
        _counter[0] += 1
        if _counter[0] % every:
            return
    w = _get_writer()
    if w is None:
        return
    service, _, method = method_full_name.rpartition(".")
    with _writer_lock:
        w.write({"service": service, "method": method, "log_id": log_id,
                 "ts": time.time()}, payload)
        w.flush()


def reset_for_tests():
    """Close the file; the next record opens a new one."""
    global _writer
    with _writer_lock:
        if _writer is not None:
            _writer.close()
            _writer = None
        _counter[0] = 0
