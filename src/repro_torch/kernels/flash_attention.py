"""Wrapper of the hand-written CUDA kernels for block-sparse flash attention.

:func:`flash_attention_kernel` launches ``flash_attention_fwd``
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``_flash_kernel`` of the JAX package's ``repro/kernels/flash_attention.py``:
the forward pass over a per-query-block KV schedule (``kv_index`` /
``kv_count``, from :func:`repro_torch.kernels.ops.build_block_structure`),
with GQA, causal and sliding-window masks, logit softcap, packed-document
segments and ``q_offset``; online softmax with a float32 accumulator.
``block_q`` / ``block_k`` are the schedule's units, not the kernel's tile.
The dtype and head width decide the kernel (:func:`flash_route`), one
launch in every case:

* bfloat16, D = 64, 128 or 256: a built instance on the tensor cores
  (``mma.sync`` bf16 -> f32, P rounded to bf16 before P·V).
* bfloat16, any other D up to 256: zero-padded to the next instance on the
  way in and cut back on the way out (:func:`_pad_head_dim`), which is
  exact: a zero column adds 0 to every q·k score and its output column is
  dropped.
* bfloat16 from 257 to ``RT_MAX_HEAD_DIM``: ``flash_attention_fwd_wide_kernel``
  on the same tensor cores with the width at run time; it pads D to a
  multiple of 64 inside the kernel and splits O by columns over a grid axis
  (chunks of at most 256), so the wrapper neither pads, copies nor slices.
* float32 at any D up to ``RT_MAX_HEAD_DIM``:
  ``flash_attention_fwd_f32_kernel``, FFMA only (no TF32; p kept float32), the width at run time: 64-row q
  tiles, 4 x 4 register score tiles fed by 16-byte shared loads, Q/K and V
  streamed in chunks through a cp.async ring (shared memory independent
  of D), O's 64-column groups in registers (above 512 split over two
  blocks of the grid).

Above ``RT_MAX_HEAD_DIM`` the wrapper raises :class:`ValidationError`: the
port's domain, which its tests pin (the wide bf16 kernel's tiles must fit a
block's shared memory).

Under autograd, :class:`FlashAttentionFunction` runs this launch as its
forward, on every route, and as its backward the VJP of the differentiable
plain-torch twin of the JAX package's ``blockwise_attention``, recomputed
from the saved q, k and v in float32 over the same schedule
(:mod:`repro_torch.kernels.flash_vjp`); the Pallas kernel has no backward
either, so no backward kernel is ported.

Like the other wrappers it:

* takes the plain version (:func:`repro_torch.kernels.ref.ref_flash_attention`)
  only when its tensors lie on the CPU;
* for CUDA tensors builds the library on first use, uploads the schedule
  (checked on the host, so no launch waits for the card), launches on the
  current stream, raises :class:`KernelError` if the launch returned a CUDA error,
  and adds one to its ``launches`` count;
* raises :class:`ValidationError` for any other device, mixed devices, a
  wrong dtype or shape, a non-contiguous tensor, a schedule that is not on
  the CPU or has an entry out of range, or (on the card) a head width
  above ``RT_MAX_HEAD_DIM``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.kernels import _build
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.flash_vjp import flash_attention_vjp

HEAD_DIMS_ON_CARD = (64, 128, 256)     # the bf16 tensor-core instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: ``kRtMaxD`` of ``csrc/flash_attention.cu``: the widest head the port
#: takes in either dtype (the wide bf16 kernel's shared memory would hold
#: up to 640; the float32 kernel's does not grow with D)
RT_MAX_HEAD_DIM = 593


def flash_route(d: int, dtype: torch.dtype) -> tuple:
    """(route, width): the kernel that serves head width ``d`` of ``dtype``
    on the card and the width it runs at.  ``"instance"`` (bf16 at 64, 128,
    256), ``"padded"`` (bf16 at any other width up to 256, zero-padded to
    the next instance), ``"wide"`` (bf16 from 257, the tensor-core kernel
    with the width at run time) or ``"runtime"`` (float32 at any width, the
    float32 register-tile kernel); up to ``RT_MAX_HEAD_DIM``, above which it
    raises :class:`ValidationError`."""
    if d > RT_MAX_HEAD_DIM:
        raise ValidationError(
            f"the flash kernel takes head_dim up to {RT_MAX_HEAD_DIM} (the "
            f"port's domain: the wide bf16 kernel's tiles must fit a block's "
            f"shared memory), got {d}")
    if dtype != torch.bfloat16:
        return "runtime", d
    if d > HEAD_DIMS_ON_CARD[-1]:
        return "wide", d
    width = min(w for w in HEAD_DIMS_ON_CARD if w >= d)
    return ("instance" if width == d else "padded"), width


def _pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  d_pad: int):
    """q, k, v zero-padded along D to ``d_pad``.  The caller fixes the
    softmax scale from the true width before padding and keeps
    ``out[..., :d]``."""
    pad = (0, d_pad - q.shape[-1])
    return (torch.nn.functional.pad(q, pad), torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad))


def _check(q, k, v, kv_index, kv_count, q_segments, kv_segments,
           block_q: int, block_k: int) -> bool:
    """Shapes, dtypes and one device; True when the tensors are on the card."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValidationError(
            f"q must be (B, H, Sq, D) and k, v (B, Hkv, Skv, D): got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValidationError(f"k/v {tuple(k.shape)} do not fit q "
                              f"{tuple(q.shape)} (H a multiple of Hkv)")
    if block_q <= 0 or block_k <= 0 or sq % block_q or skv % block_k:
        raise ValidationError(f"Sq={sq} / Skv={skv} must be multiples of "
                              f"block_q={block_q} / block_k={block_k}")
    nq = sq // block_q
    if kv_index.ndim != 2 or kv_index.shape[0] != nq \
            or tuple(kv_count.shape) != (nq,):
        raise ValidationError(
            f"schedule must be kv_index (nq, max_nk), kv_count (nq,) with "
            f"nq={nq}: got {tuple(kv_index.shape)}, {tuple(kv_count.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValidationError(f"q/k/v must be float32 or bfloat16, got "
                              f"{q.dtype}")
    on_card = _build.on_card(q, k, v, dtype=q.dtype)
    # the schedule lives on the host, as Pallas' scalar-prefetch operands
    # do, so its range check (an entry out of range would read past k and
    # v) never waits for the card
    if _build.on_card(kv_index, kv_count, dtype=torch.int32):
        raise ValidationError("kv_index / kv_count must be CPU tensors: "
                              "the wrapper uploads them")
    if bool(((kv_index < 0) | (kv_index >= skv // block_k)).any()
            | ((kv_count < 0) | (kv_count > kv_index.shape[1])).any()):
        raise ValidationError(f"schedule entries out of range: kv_index "
                              f"must lie in [0, {skv // block_k}), kv_count "
                              f"in [0, {kv_index.shape[1]}]")
    if (q_segments is None) != (kv_segments is None):
        raise ValidationError("pass both q_segments and kv_segments or neither")
    if q_segments is not None:
        if tuple(q_segments.shape) != (b, sq) \
                or tuple(kv_segments.shape) != (b, skv):
            raise ValidationError(
                f"segments must be (B, Sq) and (B, Skv): got "
                f"{tuple(q_segments.shape)}, {tuple(kv_segments.shape)}")
        _build.on_card(q_segments, kv_segments, dtype=torch.int32)
        if q_segments.device != q.device:
            raise ValidationError(f"tensors on {q.device} and "
                                  f"{q_segments.device}")
    return on_card


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_index: torch.Tensor, kv_count: torch.Tensor,
                           q_segments: Optional[torch.Tensor] = None,
                           kv_segments: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           block_q: int = 128, block_k: int = 128,
                           q_offset: int = 0) -> torch.Tensor:
    """Raw kernel entry — most callers use
    :func:`repro_torch.kernels.ops.flash_attention`.

    q (B, H, Sq, D), k/v (B, Hkv, Skv, D), float32 or bfloat16; kv_index
    (Sq/block_q, max_nk) and kv_count (Sq/block_q,) int32 CPU tensors;
    segments (B, Sq) / (B, Skv) int32 or both None.  ``q_offset``: the
    absolute position of q[.., 0, ..] in the KV window.  Returns
    (B, H, Sq, D) in q's dtype.
    """
    on_card = _check(q, k, v, kv_index, kv_count, q_segments, kv_segments,
                     block_q, block_k)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)        # from the true width, before padding
    if not on_card:
        return ref_lib.ref_flash_attention(
            q, k, v, kv_index, kv_count, q_segments, kv_segments, scale=scale,
            causal=causal, window=window, softcap=softcap, block_q=block_q,
            block_k=block_k, q_offset=q_offset)
    route, d_pad = flash_route(d, q.dtype)
    if route == "padded":
        q, k, v = _pad_head_dim(q, k, v, d_pad)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :d]
    use_segments = q_segments is not None
    lib = _build.library()
    # pageable → device, stream-ordered: the host does not wait for the card
    kv_index = kv_index.to(q.device, non_blocking=True)
    kv_count = kv_count.to(q.device, non_blocking=True)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_index.data_ptr(),
        kv_count.data_ptr(),
        q_segments.data_ptr() if use_segments else None,
        kv_segments.data_ptr() if use_segments else None,
        out.data_ptr(), b, h, hkv, sq, skv, d_pad, kv_index.shape[1],
        block_q, block_k, q_offset, float(scale), int(causal),
        -1 if window is None else int(window),
        0.0 if softcap is None else float(softcap),
        _DTYPE_CODES[q.dtype], _build.stream_handle(q.device))
    _build.check(rc, "flash_attention_fwd")
    flash_attention_kernel.launches += 1
    return out if d_pad == d else out[..., :d].contiguous()


flash_attention_kernel.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """:func:`flash_attention_kernel` under autograd.

    ``apply(q, k, v, kv_index, kv_count, q_segments, kv_segments, scale,
    causal, window, softcap, block_q, block_k, q_offset)``: the forward is
    the wrapper's call (the kernel launch for CUDA tensors, on whichever
    route :func:`flash_route` picks; the plain version for CPU ones), the
    backward :func:`repro_torch.kernels.flash_vjp.flash_attention_vjp`,
    which recomputes the attention from the saved q, k, v and the schedule
    (no forward activations are kept).  Gradients flow to q, k and v only.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_index, kv_count, q_segments, kv_segments,
                scale, causal, window, softcap, block_q, block_k, q_offset):
        opts = dict(scale=scale, causal=causal, window=window,
                    softcap=softcap, block_q=block_q, block_k=block_k,
                    q_offset=q_offset)
        out = flash_attention_kernel(q, k, v, kv_index, kv_count, q_segments,
                                     kv_segments, **opts)
        ctx.save_for_backward(q, k, v, q_segments, kv_segments)
        ctx.schedule = (kv_index, kv_count)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_segments, kv_segments = ctx.saved_tensors
        dq, dk, dv = flash_attention_vjp(q, k, v, dout, *ctx.schedule,
                                         q_segments, kv_segments, **ctx.opts)
        return (dq, dk, dv) + (None,) * 11

#: the kernel wrappers of this module
KERNEL_WRAPPERS = (flash_attention_kernel,)
