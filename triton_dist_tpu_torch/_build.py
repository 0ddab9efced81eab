"""Build and bind the port's CUDA kernels: ``nvcc`` turns each source under
``csrc/`` into a shared library with a plain C interface, loaded with
``ctypes``.

Each source builds at first use, all sources at once (one ``nvcc`` process
each), into ``build/`` beside this file — a directory ``.gitignore`` lists.
The library name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
build. Nothing here runs at import time: the
CPU tests import every module of the port on a machine without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception, so a launch the card
refuses (too many threads, too much shared memory) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("gemm", "flash_decode", "flash_verify", "dist", "group_gemm", "ring", "a2a")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels build from source at first use"
        )
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _compile(name: str) -> str:
    out = _target(name)
    if out.exists():
        return ""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stderr


def build_all() -> dict[str, str]:
    """Compile every kernel source not built yet, one ``nvcc`` each, all
    started together. Returns each source's ``-Xptxas -v`` report
    (registers, shared memory, spills; empty when already built)."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            futures = {name: pool.submit(_compile, name) for name in SOURCES}
            return {name: f.result() for name, f in futures.items()}


def library(name: str, prototypes: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from `prototypes` and ``restype`` int for each entry
    point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            lib.tdt_error_string.argtypes = [ctypes.c_int]
            lib.tdt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in prototypes.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tdt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on `t`'s device, as the kernels take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
