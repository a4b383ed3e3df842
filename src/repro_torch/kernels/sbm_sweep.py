"""Wrappers of the hand-written CUDA kernels of the parallel SBM sweep.

Four kernels (``csrc/sbm_sweep.cu``), each the port of one Pallas TPU
kernel of the JAX package's ``repro/kernels/sbm_sweep.py``:

* :func:`block_sums` — ``block_sums_kernel`` (pass A), replaces
  ``_block_sums_kernel``;
* :func:`emission` — ``emission_kernel`` (pass B), replaces
  ``_emission_kernel``;
* :func:`delta_bitmasks` — ``delta_bitmask_kernel``, replaces
  ``_delta_bitmask_kernel``: not the Pallas kernel's serial replay of each
  segment, but its outcome in closed form (per owner, its last record
  decides Add, an upper after an upper or after nothing sets Del): each
  block sorts its segment's records by (owner, position) in shared memory
  (a stable radix sort on the owner) and every thread decides its records
  from their neighbours.  Any records are taken, with the Pallas
  semantics; owners >= 32·num_words are ignored; segments up to
  :data:`BITMASK_MAX_BLOCK` records;
* :func:`emit_pairs` — ``emit_pairs_kernel`` (pass C), replaces
  ``_emission_pairs_kernel``: not the Pallas kernel's serial replay of each
  segment, but counts, slot bases and every single-pair emission in
  closed form across the block, then one warp per extent type replaying
  only its own set for the emissions of two or more pairs.  The closed
  forms hold on the streams ``ops`` builds; a block whose records break
  them (the kernel checks every toggle) replays its segment again with the
  Pallas kernel's set/clear semantics, so any records give the Pallas
  kernel's arrays (see :func:`emit_pairs`).

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
allocate nothing and never synchronise, and no wrapper waits for its
kernel.
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


#: ``kBitmaskMaxBlock`` of ``csrc/sbm_sweep.cu``: the largest segment whose
#: two sort buffers (12 bytes a record) fit a block's shared memory
BITMASK_MAX_BLOCK = 16384


def delta_bitmasks(owner: torch.Tensor, is_upper: torch.Tensor,
                   valid: torch.Tensor, *, num_words: int, block_size: int):
    """Per-segment Add/Del bitmasks of the extent type selected by ``valid``.

    Inputs are (total,) int32 records, any contents: the Pallas kernel's
    replay (a lower sets Add; an upper clears Add if set there, else sets
    Del) over each segment's valid records, owners clamped at 0; owners
    >= 32·num_words are ignored.  Returns (add, del): (num_blocks,
    num_words) int32 words — Algorithm 6's Sadd[p]/Sdel[p] (or Uadd/Udel).
    On the card ``block_size`` may be at most :data:`BITMASK_MAX_BLOCK`.
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
    if block_size > BITMASK_MAX_BLOCK:
        raise ValidationError(
            f"the delta-bitmask kernel takes segments of up to "
            f"{BITMASK_MAX_BLOCK} records (its sort buffers must fit a "
            f"block's shared memory), got block_size={block_size}")
    add = torch.empty((nb, num_words), dtype=torch.int32, device=owner.device)
    rem = torch.empty_like(add)
    lib = _build.library()
    rc = lib.sbm_delta_bitmasks(_ptr(owner), _ptr(is_upper), _ptr(valid),
                                _ptr(add), _ptr(rem), total, block_size,
                                num_words, _build.stream_handle(owner.device))
    _build.check(rc, "sbm_delta_bitmasks")
    delta_bitmasks.launches += 1
    return add, rem


def emit_pairs_placement(block_size: int, ws: int, wu: int) -> str:
    """Where the pass-C kernel keeps its live masks on the current card
    for these sizes: ``"shared"`` (shared memory) or ``"global"`` (the
    block's rows of the global scratch); builds the library."""
    place = _build.library().sbm_emit_pairs_placement(block_size, ws, wu)
    if place < 0:
        raise ValidationError(f"pass C: the lists of block_size="
                              f"{block_size} do not fit a block's shared "
                              "memory")
    return "shared" if place else "global"


def emit_pairs_max_block(ws: int, wu: int) -> int:
    """The largest segment (records) the pass-C kernel takes on the current
    card with ``ws`` / ``wu`` words a side: its six per-record lists must
    fit a block's shared memory beside the stages and the mask summaries
    (about 9,267 records at the main path's W); builds the library."""
    return int(_build.library().sbm_emit_pairs_max_block(ws, wu))


def emit_pairs(owner: torch.Tensor, is_upper: torch.Tensor,
               is_sub: torch.Tensor, valid: torch.Tensor,
               sub_active0: torch.Tensor, upd_active0: torch.Tensor, *,
               block_size: int, cap: int):
    """Pass C: per-segment pair emission from the active sets entering
    each segment (``sub_active0``/``upd_active0``: (num_blocks, W) int32
    words).  ``owner`` must be clipped to >= 0 and lie below 32·W of its
    side, padding marked valid=0; on the card ``block_size`` may be at
    most :func:`emit_pairs_max_block` of these W.  Any records are taken,
    as by the Pallas kernel: at an upper endpoint the counterpart set is
    emitted, then a lower sets and an upper clears its own bit.  On the
    card the fast path derives every slot base in closed form, which
    holds where every lower finds its bit clear and every upper finds it
    set (a sorted stream with the exact entering sets, as ``ops`` builds
    them); a block where one does not replays its segment exactly
    instead.  The launch does not
    wait: ``emit_pairs.general_blocks`` is then a (1,) int32 tensor on the
    card that counts the blocks of the last launch that took the replay
    (read it after a sync).

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
    if cap >= 2 ** 31:
        raise ValidationError(f"pass C's slots are int32, as the Pallas "
                              f"kernel's: cap={cap} must be < 2**31")
    dev = owner.device
    ws, wu = sub_active0.shape[1], upd_active0.shape[1]
    most = emit_pairs_max_block(ws, wu)
    if block_size > most:
        raise ValidationError(
            f"the pass-C kernel takes segments of up to {most} records at "
            f"W = {ws}/{wu} (its per-record lists must fit a block's shared "
            f"memory), got block_size={block_size}")
    sub_mask = torch.empty_like(sub_active0)     # live active sets (scratch)
    upd_mask = torch.empty_like(upd_active0)
    out_i = torch.empty((nb, cap), dtype=torch.int32, device=dev)
    out_j = torch.empty_like(out_i)
    general = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.library()
    rc = lib.sbm_emit_pairs(_ptr(owner), _ptr(is_upper), _ptr(is_sub),
                            _ptr(valid), _ptr(sub_active0), _ptr(upd_active0),
                            _ptr(sub_mask), _ptr(upd_mask), _ptr(out_i),
                            _ptr(out_j), _ptr(general), total, block_size, ws,
                            wu, cap, _build.stream_handle(dev))
    _build.check(rc, "sbm_emit_pairs")
    emit_pairs.launches += 1
    emit_pairs.general_blocks = general
    return out_i, out_j


block_sums.launches = 0
emission.launches = 0
delta_bitmasks.launches = 0
emit_pairs.launches = 0
emit_pairs.general_blocks = None

#: the four kernel wrappers, in pipeline order
KERNEL_WRAPPERS = (block_sums, emission, delta_bitmasks, emit_pairs)
