"""Wrappers of the hand-written CUDA kernels of the parallel SBM sweep.

Four kernels (``csrc/sbm_sweep.cu``), each the port of one Pallas TPU
kernel of the JAX package's ``repro/kernels/sbm_sweep.py``:

* :func:`block_sums` — ``block_sums_kernel`` (pass A), replaces
  ``_block_sums_kernel``;
* :func:`emission` — ``emission_kernel`` (pass B), replaces
  ``_emission_kernel``;
* :func:`delta_bitmasks` — ``delta_bitmask_kernel``, replaces
  ``_delta_bitmask_kernel``;
* :func:`emit_pairs` — ``emit_pairs_kernel`` (pass C), replaces
  ``_emission_pairs_kernel``.

What bounds each on an H100, and its measured time, is in ``PERF.md`` and
in the kernel source's comments.  Each wrapper:

* takes the plain version of :mod:`repro_torch.kernels.ref` only when its
  tensors lie on the CPU;
* for CUDA tensors builds the library on first use, launches its kernel on
  the current stream, raises :class:`KernelError` if the launch returned a
  CUDA error, and adds one to its ``launches`` count;
* raises :class:`ValidationError` for any other device, a wrong dtype,
  shape or a non-contiguous tensor.

Outputs and scratch are allocated here with ``torch.empty``; the kernels
allocate nothing and never synchronise.
"""
from __future__ import annotations

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_lib


def _on_card(*tensors: torch.Tensor) -> bool:
    return _build.on_card(*tensors, dtype=torch.int32)


def _blocks(total: int, block_size: int) -> int:
    if block_size <= 0 or total % block_size:
        raise ValidationError(f"total={total} not a multiple of "
                              f"block_size={block_size}")
    return total // block_size


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def block_sums(deltas: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Pass A: (4, total) int32 indicator streams → (num_blocks, 4) int32
    per-segment sums."""
    if deltas.ndim != 2 or deltas.shape[0] != 4:
        raise ValidationError(f"deltas must be (4, total), got "
                              f"{tuple(deltas.shape)}")
    total = deltas.shape[1]
    nb = _blocks(total, block_size)
    if not _on_card(deltas):
        return ref_lib.ref_block_sums(deltas, block_size=block_size)
    sums = torch.empty((nb, 4), dtype=torch.int32, device=deltas.device)
    lib = _build.library()
    rc = lib.sbm_block_sums(_ptr(deltas), _ptr(sums), total, block_size,
                            _build.stream_handle(deltas.device))
    _build.check(rc, "sbm_block_sums")
    block_sums.launches += 1
    return sums


def emission(deltas: torch.Tensor, offsets: torch.Tensor, *,
             block_size: int):
    """Pass B: per-segment scans + the exclusive carry ``offsets``
    (num_blocks, 4) int32 → per-endpoint emission counts (total,) int32 and
    per-segment emission totals (num_blocks,) int64."""
    if deltas.ndim != 2 or deltas.shape[0] != 4:
        raise ValidationError(f"deltas must be (4, total), got "
                              f"{tuple(deltas.shape)}")
    total = deltas.shape[1]
    nb = _blocks(total, block_size)
    if offsets.shape != (nb, 4):
        raise ValidationError(f"offsets must be ({nb}, 4), got "
                              f"{tuple(offsets.shape)}")
    if not _on_card(deltas, offsets):
        return ref_lib.ref_emission(deltas, offsets, block_size=block_size)
    emit = torch.empty(total, dtype=torch.int32, device=deltas.device)
    seg = torch.empty(nb, dtype=torch.int64, device=deltas.device)
    lib = _build.library()
    rc = lib.sbm_emission(_ptr(deltas), _ptr(offsets), _ptr(emit), _ptr(seg),
                          total, block_size,
                          _build.stream_handle(deltas.device))
    _build.check(rc, "sbm_emission")
    emission.launches += 1
    return emit, seg


def sweep_count(deltas: torch.Tensor, *, block_size: int = 2048):
    """The counting sweep: pass A, the exclusive master scan over the
    (num_blocks, 4) sums (paper Fig. 5 step 2, plain torch), pass B.

    Returns (emission counts (total,) int32, per-segment emission totals
    (num_blocks,) int64, K as a 0-d int64 tensor).  K is exact beyond 2³¹:
    the JAX package's behaviour under x64.
    """
    sums = block_sums(deltas, block_size=block_size)
    offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
    emit, seg = emission(deltas, offsets, block_size=block_size)
    return emit, seg, seg.sum(dtype=torch.int64)


def delta_bitmasks(owner: torch.Tensor, is_upper: torch.Tensor,
                   valid: torch.Tensor, *, num_words: int, block_size: int):
    """Per-segment Add/Del bitmasks of the extent type selected by ``valid``.

    Inputs are (total,) int32 records of the sorted stream.  Returns
    (add, del): (num_blocks, num_words) int32 words — Algorithm 6's
    Sadd[p]/Sdel[p] (or Uadd/Udel).
    """
    total = owner.shape[0]
    nb = _blocks(total, block_size)
    if not (owner.shape == is_upper.shape == valid.shape == (total,)) \
            or num_words < 1:
        raise ValidationError("owner/is_upper/valid must be (total,) and "
                              "num_words >= 1")
    if not _on_card(owner, is_upper, valid):
        return ref_lib.ref_delta_bitmasks(owner, is_upper, valid,
                                          num_words=num_words,
                                          block_size=block_size)
    add = torch.empty((nb, num_words), dtype=torch.int32, device=owner.device)
    rem = torch.empty_like(add)
    lib = _build.library()
    rc = lib.sbm_delta_bitmasks(_ptr(owner), _ptr(is_upper), _ptr(valid),
                                _ptr(add), _ptr(rem), total, block_size,
                                num_words, _build.stream_handle(owner.device))
    _build.check(rc, "sbm_delta_bitmasks")
    delta_bitmasks.launches += 1
    return add, rem


def emit_pairs(owner: torch.Tensor, is_upper: torch.Tensor,
               is_sub: torch.Tensor, valid: torch.Tensor,
               sub_active0: torch.Tensor, upd_active0: torch.Tensor, *,
               block_size: int, cap: int):
    """Pass C: per-segment pair emission from the active sets entering
    each segment (``sub_active0``/``upd_active0``: (num_blocks, W) int32
    words).  ``owner`` must be clipped to >= 0, padding marked valid=0.

    Returns (out_i, out_j): (num_blocks, cap) int32, each segment's pairs
    at slots [0, segment emission total), −1 elsewhere.
    """
    total = owner.shape[0]
    nb = _blocks(total, block_size)
    if not (owner.shape == is_upper.shape == is_sub.shape == valid.shape
            == (total,)) or sub_active0.ndim != 2 or upd_active0.ndim != 2 \
            or sub_active0.shape[0] != nb or upd_active0.shape[0] != nb \
            or cap < 1:
        raise ValidationError("pass C expects (total,) records, "
                              "(num_blocks, W) active sets and cap >= 1")
    if not _on_card(owner, is_upper, is_sub, valid, sub_active0, upd_active0):
        return ref_lib.ref_emit_pairs(owner, is_upper, is_sub, valid,
                                      sub_active0, upd_active0,
                                      block_size=block_size, cap=cap)
    dev = owner.device
    ws, wu = sub_active0.shape[1], upd_active0.shape[1]
    sub_mask = torch.empty_like(sub_active0)     # live active sets (scratch)
    upd_mask = torch.empty_like(upd_active0)
    out_i = torch.empty((nb, cap), dtype=torch.int32, device=dev)
    out_j = torch.empty_like(out_i)
    lib = _build.library()
    rc = lib.sbm_emit_pairs(_ptr(owner), _ptr(is_upper), _ptr(is_sub),
                            _ptr(valid), _ptr(sub_active0), _ptr(upd_active0),
                            _ptr(sub_mask), _ptr(upd_mask), _ptr(out_i),
                            _ptr(out_j), total, block_size, ws, wu, cap,
                            _build.stream_handle(dev))
    _build.check(rc, "sbm_emit_pairs")
    emit_pairs.launches += 1
    return out_i, out_j


block_sums.launches = 0
emission.launches = 0
delta_bitmasks.launches = 0
emit_pairs.launches = 0

#: the four kernel wrappers, in pipeline order
KERNEL_WRAPPERS = (block_sums, emission, delta_bitmasks, emit_pairs)
