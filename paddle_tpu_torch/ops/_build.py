"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and
loaded with ``ctypes``.  Nothing is built when a module is imported:
the first CUDA call of a kernel builds every source (one ``nvcc`` per
source, all started together) into ``paddle_tpu_torch/_build/``, keyed
by a hash of the source and the flags, so an unchanged source is never
rebuilt.  A failed build raises with nvcc's output; there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library",
           "register", "build_log"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source function that declares the C entry points' argtypes/restype
_declarers: Dict[str, Callable[[ctypes.CDLL], None]] = {}
# per-source nvcc output of the builds this process ran (ptxas register /
# shared-memory / spill report), for chip_smoke.py to print
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel, and
    load them all.  Returns the seconds spent (0.0 when every library
    was already loaded)."""
    with _lock:
        t0 = time.perf_counter()
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        todo = [(s, _target(s)) for s in srcs
                if s.stem not in _libs and not _target(s).exists()]
        if todo:
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                build_log[src.stem] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src.name} "
                                  f"(exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)   # atomic: a reader never sees half
            if failed:
                raise RuntimeError("\n".join(failed))
        for src in srcs:
            if src.stem not in _libs:
                lib = ctypes.CDLL(str(_target(src)))
                if src.stem in _declarers:
                    _declarers[src.stem](lib)
                _libs[src.stem] = lib
        return time.perf_counter() - t0 if todo else 0.0


def register(name: str, declare: Callable[[ctypes.CDLL], None]) -> None:
    """Record how to declare the C entry points of ``csrc/<name>.cu``
    (``argtypes``: ``c_void_p`` for pointers and the stream, ``c_int``
    for ints); applied when the library loads."""
    with _lock:
        _declarers[name] = declare
        if name in _libs:
            declare(_libs[name])


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs.get(name)
        if lib is None:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    return lib
