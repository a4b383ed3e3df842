"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface.  At first use in a
process, :func:`library` compiles them with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the sources and flags so an edited source rebuilds and
an unchanged one is reused, and loads the shared library with ``ctypes``.
Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.

The port runs from a checkout (``PYTHONPATH=src``), not from an installed
copy: the paths below assume the ``src/repro_torch/kernels`` layout, and
``pyproject.toml`` leaves ``repro_torch`` out of the wheel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from repro_torch.core import runtime as runtime_lib
from repro_torch.core.errors import KernelError

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sbm_sweep.cu",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry points of csrc/sbm_sweep.cu: name -> argument types (all return
# the int value of cudaGetLastError()).  Pointers and the stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit C ints.
SIGNATURES = {
    "sbm_block_sums": (_P, _P, _LL, _I, _P),
    "sbm_emission": (_P, _P, _P, _P, _LL, _I, _P),
    "sbm_delta_bitmasks": (_P, _P, _P, _P, _P, _LL, _I, _I, _P),
    "sbm_emit_pairs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                       _I, _LL, _P),
}

_lock = threading.Lock()
_state = {"lib": None, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: pathlib.Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use in this process."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        missing = [str(s) for s in SOURCES if not s.is_file()]
        if missing or CSRC.parents[2].name != "src":
            raise KernelError(
                f"kernel sources not found in a checkout ({missing or CSRC}); "
                "run the port from the repository with PYTHONPATH=src")
        target = BUILD_DIR / f"sbm_sweep_{_digest()}.so"
        log = _compile(target) if not target.exists() else ""
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state.update(lib=lib, log=log)
        runtime_lib.record_kernel_build()
        return lib


def build_log() -> str:
    """nvcc's output of this process's build (``-Xptxas -v`` resource
    usage per kernel); empty when the library was already built."""
    return _state["log"]


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelError` when a launch returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
