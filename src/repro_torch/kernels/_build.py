"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface.  At first use in a
process, :func:`library` compiles them with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``):
one ``nvcc`` per source, all started together, then one link into a shared
library named by a hash of the sources and flags (an edited source
rebuilds, an unchanged one is reused), loaded with ``ctypes``.
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
from repro_torch.core.errors import KernelError, ValidationError

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "sbm_sweep.cu", CSRC / "bitmatch.cu",
           CSRC / "flash_attention.cu", CSRC / "flash_attention_wgmma.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> argument types (all return the int
# value of cudaGetLastError()).  Pointers and the stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit C ints.
SIGNATURES = {
    "sbm_block_sums": (_P, _P, _LL, _I, _P),
    "sbm_emission": (_P, _P, _P, _P, _LL, _I, _P),
    "sbm_delta_bitmasks": (_P, _P, _P, _P, _P, _LL, _I, _I, _P),
    "sbm_emit_pairs": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                       _I, _I, _LL, _P),
    "sbm_emit_pairs_placement": (_I, _I, _I),
    "sbm_emit_pairs_max_block": (_I, _I),
    "sbm_delta_scan": (_P, _P, _P, _I, _I, _P),
    "bitmatch_words": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _I, _P),
    "flash_attention_fwd_wgmma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F,
                                  _P),
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


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    outs = [(cmd, *proc.communicate(), proc.returncode) for cmd, proc in procs]
    for cmd, out, err, rc in outs:
        if rc != 0:
            raise KernelError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for _, out, err, _ in outs)


def _spawn(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _compile(target: pathlib.Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    log = _run([_spawn([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
                for src, obj in zip(SOURCES, objs)])
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log += _run([_spawn([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])])
    os.replace(tmp, target)
    for obj in objs:
        obj.unlink()
    return log


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
        target = BUILD_DIR / f"kernels_{_digest()}.so"
        log_file = target.with_suffix(".ptxas.log")
        if target.exists():
            log = log_file.read_text() if log_file.exists() else ""
        else:
            log = _compile(target)
            log_file.write_text(log)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state.update(lib=lib, log=log)
        runtime_lib.record_kernel_build()
        return lib


def build_log() -> str:
    """nvcc's output for the loaded library (``-Xptxas -v`` resource usage
    per kernel), kept beside it as ``kernels_<hash>.ptxas.log``; empty when
    a library built elsewhere has no log."""
    return _state["log"]


def on_card(*tensors: torch.Tensor, dtype: torch.dtype) -> bool:
    """The wrappers' input rule: one device, ``dtype``, contiguous.  True
    for CUDA tensors (launch the kernel), False for CPU tensors (take the
    plain version); raises :class:`ValidationError` otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValidationError(f"tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise ValidationError(f"expected {dtype} tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValidationError("kernel inputs must be contiguous")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValidationError(f"no kernel for device {dev}")


def check(rc: int, name: str) -> None:
    """Raise :class:`KernelError` when a launch returned a CUDA error."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
