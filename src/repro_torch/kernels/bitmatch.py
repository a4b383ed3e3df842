"""Wrapper of the hand-written CUDA kernel for the d-dim bit-matrix AND.

:func:`bitmatch` launches ``bitmatch_kernel`` (``csrc/bitmatch.cu``), the
port of the Pallas TPU kernel ``_bitmatch_kernel`` of the JAX package's
``repro/kernels/bitmatch.py``: every subscription row against every update,
the d closed-interval overlap tests AND-reduced and packed into
``ceil(m/32)`` words per row, plus the row popcounts.  The (n, m) mask never
exists in device memory.  Like the sweep wrappers it:

* takes the plain version (:func:`repro_torch.kernels.ref.ref_bitmatrix`)
  only when its tensors lie on the CPU;
* for CUDA tensors builds the library on first use, launches on the current
  stream, raises :class:`KernelError` if the launch returned a CUDA error,
  and adds one to its ``launches`` count;
* raises :class:`ValidationError` for any other device, a wrong dtype or
  shape, a non-contiguous tensor, or d = 0 on the card.

The kernel is specialised for d = 1..4 (every bound of a lane's rows in
registers); for d >= 5 it takes d at run time and works the dimensions in
chunks of four, so its shared memory does not grow with d and any d runs.
Each lane owns subscription rows and builds their words bit by bit from
update bounds staged in shared memory (``csrc/bitmatch.cu``'s header).

:func:`bitmatrix_kernel` and :func:`sbm_bitmatrix_kernel` mirror the JAX
package's ``bitmatrix_pallas`` and ``sbm_bitmatrix_kernel``.  Unlike the
Pallas form, which pads the update axis with ``[+inf, -inf]`` sentinels, no
bit past m is ever set, so an unbounded subscription counts exactly m.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import ddim as ddim_lib
from repro_torch.core.enumerate import _empty_result
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_lib


def bitmatch(s_lo: torch.Tensor, s_hi: torch.Tensor, u_lo: torch.Tensor,
             u_hi: torch.Tensor):
    """(d, n) subscription and (d, m) update bounds, float32 → (words
    (n, ceil(m/32)) int32 carrying the uint32 pattern, row popcounts (n,)
    int32)."""
    if s_lo.ndim != 2 or s_hi.shape != s_lo.shape or u_lo.ndim != 2 \
            or u_hi.shape != u_lo.shape or u_lo.shape[0] != s_lo.shape[0]:
        raise ValidationError(
            f"bounds must be (d, n) and (d, m): got {tuple(s_lo.shape)}, "
            f"{tuple(s_hi.shape)}, {tuple(u_lo.shape)}, {tuple(u_hi.shape)}")
    d, n = s_lo.shape
    m = u_lo.shape[1]
    if not _build.on_card(s_lo, s_hi, u_lo, u_hi, dtype=torch.float32):
        return ref_lib.ref_bitmatrix(s_lo, s_hi, u_lo, u_hi)
    if d < 1:
        raise ValidationError("the bit-matrix kernel needs d >= 1")
    num_words = max(-(-m // 32), 1)
    dev = s_lo.device
    if n == 0 or m == 0:
        return (torch.zeros((n, num_words), dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
    words = torch.empty((n, num_words), dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.library()
    rc = lib.bitmatch_words(s_lo.data_ptr(), s_hi.data_ptr(), u_lo.data_ptr(),
                            u_hi.data_ptr(), words.data_ptr(),
                            counts.data_ptr(), d, n, m, num_words,
                            _build.stream_handle(dev))
    _build.check(rc, "bitmatch_words")
    bitmatch.launches += 1
    return words, counts


def _rows(e: Extents) -> Tuple[torch.Tensor, torch.Tensor]:
    lo, hi = ddim_lib._dim_rows(e)
    return lo.contiguous(), hi.contiguous()


def bitmatrix_kernel(subs: Extents, upds: Extents):
    """(words, row_counts, k_total) — the counterpart of the JAX package's
    ``bitmatrix_pallas``.  ``words`` equals
    :func:`repro_torch.core.ddim.bitmatrix_words`; ``row_counts`` are the
    per-subscription d-dim match counts (int32); ``k_total`` is their exact
    int64 sum — no second pass over the word matrix."""
    words, counts = bitmatch(*_rows(subs), *_rows(upds))
    return words, counts, counts.sum(dtype=torch.int64)


def sbm_bitmatrix_kernel(subs: Extents, upds: Extents, *, max_pairs: int):
    """d-dim (pairs, count) with the kernel-packed bit matrix as the engine.

    ``max_pairs`` bounds only the final d-dim K; pairs come in row-major
    order (subscription id, then update id), padded with (−1, −1); the
    count is exact past the buffer.
    """
    if subs.size == 0 or upds.size == 0:
        return _empty_result(max_pairs, subs.lo.device)
    words, _counts, k_total = bitmatrix_kernel(subs, upds)
    return ddim_lib.pairs_from_bitmatrix(words, m=upds.size,
                                         max_pairs=max_pairs, count=k_total)


bitmatch.launches = 0

#: the kernel wrappers of this module
KERNEL_WRAPPERS = (bitmatch,)
