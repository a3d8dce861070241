"""Builds the port's native library from ``brpc_tpu_torch/native/src``.

The library is compiled at first use, with the flags of the reference's
Makefile, into ``brpc_tpu_torch/build/native/<digest>/``, where the digest
covers the compiler, the flags and every source and header byte: a changed
source builds anew, an unchanged one is loaded as it is. Each ``.cpp`` is
compiled by its own ``g++ -c`` (at a lower priority), as many at once as
the host has cores, and the objects are linked into one shared object. A file lock makes
concurrent processes (test workers, the smoke's peers) build once and share
the result, and the library appears in its directory by an atomic rename,
whole or not at all. A failed build raises with the tail of the compiler's
errors; nothing prebuilt is ever picked up.

``CXX`` names the compiler (default ``g++``), as for the Makefile.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_ROOT = _PKG / "build"
LIB_NAME = "libbrpc_tpu_torch_native.so"
# the Makefile's REQFLAGS and OPTFLAGS (frame pointers stay on: the native
# profiler unwinds them), and its LDLIBS
CXXFLAGS = ["-std=c++17", "-fPIC", "-pthread", "-O2", "-g",
            "-fno-omit-frame-pointer"]
LDLIBS = ["-ldl", "-lrt"]
BUILD_TIMEOUT_S = 600
ERROR_TAIL = 4000  # bytes of the compiler's stderr a failure carries


class BuildError(RuntimeError):
    pass


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _digest(cxx: str, flags: Sequence[str], files: Iterable[Path]) -> str:
    h = hashlib.sha256()
    h.update(" ".join([cxx, *flags, *LDLIBS]).encode())
    for f in sorted(files):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _niced() -> List[str]:
    """The build yields the cores to whatever else runs (a server, tests
    with deadlines) while it compiles."""
    nice = shutil.which("nice")
    return [nice, "-n", "10"] if nice else []


def _compile(cxx: str, flags: Sequence[str], src: Path, obj: Path) -> str:
    """'' on success, else the command and the tail of its stderr."""
    cmd = [*_niced(), cxx, *flags, "-c", str(src), "-o", str(obj)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if r.returncode != 0:
        return f"{' '.join(cmd)} (exit {r.returncode}):\n{r.stderr[-ERROR_TAIL:]}"
    return ""


def build_library(src_dir: Path = SOURCE_DIR,
                  sources: Optional[List[str]] = None,
                  out_root: Path = BUILD_ROOT / "native",
                  extra_flags: Sequence[str] = (),
                  lib_name: str = LIB_NAME) -> Path:
    """Build (or find built) the shared object of ``sources`` (file names
    in ``src_dir``; default every ``.cpp`` there), its headers being every
    ``.h`` in ``src_dir``. Returns the library's path."""
    src_dir = Path(src_dir)
    names = sorted(sources) if sources is not None else sorted(
        p.name for p in src_dir.glob("*.cpp"))
    srcs = [src_dir / n for n in names]
    headers = sorted(src_dir.glob("*.h"))
    cxx = compiler()
    flags = [*CXXFLAGS, *extra_flags]
    out_dir = Path(out_root) / _digest(cxx, flags, srcs + headers)
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        work = Path(tempfile.mkdtemp(prefix="objs.", dir=out_dir))
        try:
            objs = [work / (s.stem + ".o") for s in srcs]
            jobs = max(1, min(len(srcs), os.cpu_count() or 1))
            with ThreadPoolExecutor(jobs) as pool:
                errors = [e for e in pool.map(
                    lambda so: _compile(cxx, flags, *so), zip(srcs, objs))
                    if e]
            if errors:
                raise BuildError(f"native build failed in {src_dir}:\n"
                                 + "\n".join(errors)[-ERROR_TAIL:])
            tmp = work / lib_name
            cmd = [cxx, *flags, "-shared", "-o", str(tmp),
                   *map(str, objs), *LDLIBS]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise BuildError(f"native link failed: {e}") from e
            if r.returncode != 0:
                raise BuildError(f"native link failed ({' '.join(cmd)}):\n"
                                 f"{r.stderr[-ERROR_TAIL:]}")
            os.replace(tmp, lib)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return lib
