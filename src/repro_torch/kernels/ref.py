"""Plain PyTorch versions of the four sweep kernels (the correctness contract).

Each ``ref_*`` function computes exactly what its CUDA kernel in
:mod:`repro_torch.kernels.sbm_sweep` computes, with straightforward tensor
code: the wrappers there use them for CPU tensors, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  All results are
integers or bit words, so every comparison is exact.

Bitmask words are int32 tensors carrying the uint32 bit pattern (see
:mod:`repro_torch.core.prefix`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prefix import words_from_values


def ref_block_sums(deltas: torch.Tensor, *, block_size: int) -> torch.Tensor:
    """Pass A: (4, total) int32 indicator streams → (num_blocks, 4) int32
    per-segment sums."""
    nb = deltas.shape[1] // block_size
    return deltas.reshape(4, nb, block_size).sum(dim=-1, dtype=torch.int32) \
        .t().contiguous()


def ref_emission(deltas: torch.Tensor, offsets: torch.Tensor, *,
                 block_size: int):
    """Pass B: per-segment inclusive cumsums + the exclusive carry
    ``offsets`` (num_blocks, 4) → per-endpoint emission counts (total,)
    int32 and per-segment emission totals (num_blocks,) int64."""
    nb = deltas.shape[1] // block_size
    d = deltas.reshape(4, nb, block_size)
    c = torch.cumsum(d, dim=-1, dtype=torch.int32) + offsets.t()[:, :, None]
    sub_up, upd_up = d[1], d[3]
    active_sub_before = c[0] - (c[1] - sub_up)
    active_upd_before = c[2] - (c[3] - upd_up)
    emit = sub_up * active_upd_before + upd_up * active_sub_before
    return emit.reshape(-1), emit.sum(dim=-1, dtype=torch.int64)


def ref_sweep_count(deltas: torch.Tensor):
    """Oracle of passes A + B together: monolithic cumsums over the stream.
    Returns (emission counts (total,) int32, K as a 0-d int64 tensor)."""
    c = torch.cumsum(deltas, dim=-1, dtype=torch.int32)
    sub_up, upd_up = deltas[1], deltas[3]
    active_sub_before = c[0] - (c[1] - sub_up)
    active_upd_before = c[2] - (c[3] - upd_up)
    emit = sub_up * active_upd_before + upd_up * active_sub_before
    return emit, emit.sum(dtype=torch.int64)


def ref_delta_bitmasks(owner: torch.Tensor, is_upper: torch.Tensor,
                       valid: torch.Tensor, *, num_words: int,
                       block_size: int):
    """Per-segment Add/Del bitmask words of one extent type, vectorized.

    Algorithm 6's invariant read directly: an extent whose lower and upper
    endpoints fall in different segments is in Add of its lower's segment
    and in Del of its upper's; one with both in the same segment is in
    neither.  Returns (add, del) as (num_blocks, num_words) int32 words.
    Fit for full sizes on the card; :func:`ref_delta_bitmasks_replay` is
    the sequential replay it is checked against on the CPU.
    """
    dev = owner.device
    total = owner.shape[0]
    nb = total // block_size
    slots = num_words * 32
    o = owner.clamp(min=0).to(torch.int64)
    seg = torch.arange(total, device=dev) // block_size
    sel = valid != 0
    up = is_upper != 0

    def segment_of(which):
        out = torch.full((slots + 1,), -1, dtype=torch.int64, device=dev)
        out.scatter_(0, torch.where(which, o, slots), torch.where(which, seg, -1))
        return out[:slots]

    lo_seg = segment_of(sel & ~up)
    up_seg = segment_of(sel & up)
    ids = torch.arange(slots, device=dev)
    word = ids // 32
    bit = torch.ones_like(ids) << (ids % 32)

    def words(which, seg_of):
        flat = torch.zeros(nb * num_words + 1, dtype=torch.int64, device=dev)
        flat.index_add_(0, torch.where(which, seg_of * num_words + word,
                                       nb * num_words),
                        torch.where(which, bit, 0))
        return words_from_values(flat[:-1]).reshape(nb, num_words)

    return (words((lo_seg >= 0) & (lo_seg != up_seg), lo_seg),
            words((up_seg >= 0) & (up_seg != lo_seg), up_seg))


def ref_delta_bitmasks_replay(owner, is_upper, valid, *, num_words: int,
                              block_size: int):
    """Sequential replay of each segment (Algorithm 6 lines 1-17 verbatim);
    returns (add, del) as ``np.uint32`` arrays.  Host-only, small sizes."""
    owner = _host(owner)
    is_upper = _host(is_upper)
    valid = _host(valid)
    nb = owner.shape[0] // block_size
    add = np.zeros((nb, num_words), np.uint32)
    rem = np.zeros((nb, num_words), np.uint32)
    for p in range(nb):
        a, d = set(), set()
        for t in range(p * block_size, (p + 1) * block_size):
            if not valid[t]:
                continue
            o = int(owner[t])
            if not is_upper[t]:
                a.add(o)
            elif o in a:
                a.discard(o)
            else:
                d.add(o)
        for o in a:
            add[p, o // 32] |= np.uint32(1) << np.uint32(o % 32)
        for o in d:
            rem[p, o // 32] |= np.uint32(1) << np.uint32(o % 32)
    return add, rem


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _members(words: np.ndarray) -> set:
    """Set-bit indices of one row of uint32 words (pack_bits layout)."""
    bits = np.unpackbits(words.astype("<u4").view(np.uint8), bitorder="little")
    return set(np.flatnonzero(bits).tolist())


def ref_emit_pairs(owner, is_upper, is_sub, valid, sub_active0, upd_active0,
                   *, block_size: int, cap: int):
    """Pass C by replay: each segment's sweep with explicit active sets.

    At every upper endpoint the counterpart's active set is emitted in
    ascending id order at slots ``ptr, ptr + 1, …`` (writes at slots
    >= ``cap`` are dropped, ``ptr`` still advances), then the endpoint
    opens or closes its own extent.  Returns (out_i, out_j):
    (num_blocks, cap) int32, −1 padded, on the inputs' device — the same
    arrays as the CUDA kernel and the JAX package's Pallas kernel.  A
    Python loop: fit for small and reduced sizes only.
    """
    dev = owner.device
    ow, up, sb, va = (_host(x).tolist() for x in (owner, is_upper, is_sub,
                                                    valid))
    s0 = _host(sub_active0).view(np.uint32)
    u0 = _host(upd_active0).view(np.uint32)
    nb = len(ow) // block_size
    out_i = np.full((nb, cap), -1, np.int32)
    out_j = np.full((nb, cap), -1, np.int32)
    for p in range(nb):
        sets = {True: _members(s0[p]), False: _members(u0[p])}
        ptr = 0
        for t in range(p * block_size, (p + 1) * block_size):
            if not va[t]:
                continue
            o, side = ow[t], bool(sb[t])
            if up[t]:
                for k, c in enumerate(sorted(sets[not side])):
                    if ptr + k < cap:
                        out_i[p, ptr + k], out_j[p, ptr + k] = \
                            (o, c) if side else (c, o)
                ptr += len(sets[not side])
                sets[side].discard(o)
            else:
                sets[side].add(o)
    return torch.from_numpy(out_i).to(dev), torch.from_numpy(out_j).to(dev)
