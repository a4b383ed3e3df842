"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

Each ``ref_*`` function computes exactly what its CUDA kernel in
:mod:`repro_torch.kernels.sbm_sweep`, :mod:`repro_torch.kernels.bitmatch`
or :mod:`repro_torch.kernels.flash_attention` computes, with straightforward
tensor code: the wrappers there use them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
The sweep and bit-matrix results are integers or bit words (the bit-matrix
from the same float32 comparisons), so those comparisons are exact; the
attention outputs are floats, compared within a stated tolerance.
:func:`ref_attention` is the dense-mask oracle of the attention kernel (no
block schedule), as in the JAX package's ``repro/kernels/ref.py``.

Bitmask words are int32 tensors carrying the uint32 bit pattern (see
:mod:`repro_torch.core.prefix`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.prefix import pack_bits, popcount32, words_from_values

# mask elements per row block of ref_bitmatrix: pack_bits widens them to
# int64, so a block's temporaries stay near 128 MiB at any m
_BITMATRIX_BLOCK_ELEMS = 16 * 1024 * 1024


def ref_bitmatrix(s_lo: torch.Tensor, s_hi: torch.Tensor, u_lo: torch.Tensor,
                  u_hi: torch.Tensor, *, row_block: int = 0):
    """The d-dim bit-matrix AND: (d, n) / (d, m) float32 bounds →
    (words (n, ceil(m/32)) int32 in ``pack_bits`` layout, row popcounts
    (n,) int32).

    Bit ``j % 32`` of word ``(i, j // 32)`` is set iff the closed intervals
    of subscription i and update j overlap in every dimension; bits at
    j >= m stay 0.  Runs over blocks of ``row_block`` rows (default: about
    16M mask elements each), so the (n, m) mask never exists whole.
    """
    d, n = s_lo.shape
    m = u_lo.shape[1]
    num_words = max(-(-m // 32), 1)
    words = torch.zeros((n, num_words), dtype=torch.int32, device=s_lo.device)
    counts = torch.zeros(n, dtype=torch.int32, device=s_lo.device)
    if n == 0 or m == 0:
        return words, counts
    step = row_block or max(1, _BITMATRIX_BLOCK_ELEMS // m)
    for start in range(0, n, step):
        rows = slice(start, min(start + step, n))
        mask = None
        for k in range(d):
            hit = (s_lo[k, rows, None] <= u_hi[k, None, :]) \
                & (u_lo[k, None, :] <= s_hi[k, rows, None])
            mask = hit if mask is None else mask & hit
        block = pack_bits(mask)
        words[rows] = block
        counts[rows] = popcount32(block).sum(dim=1, dtype=torch.int32)
    return words, counts


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

    The Pallas kernel's replay (a lower sets Add; an upper clears Add if
    its bit is set there, else sets Del) in closed form, on any records:
    order each segment's valid records by (owner, position); then an
    owner is in Add iff its last record is a lower, and in Del iff one of
    its uppers has an upper or nothing as the owner's record before it.
    Owners are clamped at 0 first; owners >= 32·num_words are ignored.
    Returns (add, del) as (num_blocks, num_words) int32 words.  Fit for
    full sizes on the card; :func:`ref_delta_bitmasks_replay` is the
    sequential replay it is checked against on the CPU.
    """
    dev = owner.device
    nb = owner.shape[0] // block_size
    slots = num_words * 32
    o = owner.clamp(min=0).to(torch.int64)
    pos = torch.nonzero((valid != 0) & (o < slots)).squeeze(1)
    key = (pos // block_size) * slots + o[pos]
    order = torch.argsort(key, stable=True)
    key = key[order]
    up = is_upper[pos[order]] != 0
    same_next = torch.zeros_like(up)
    same_next[:-1] = key[1:] == key[:-1]
    prev_lower = torch.zeros_like(up)   # the owner's record before: a lower
    prev_lower[1:] = (key[1:] == key[:-1]) & ~up[:-1]

    def words(keys):
        seg, ids = keys // slots, keys % slots
        flat = torch.zeros(nb * num_words, dtype=torch.int64, device=dev)
        flat.index_add_(0, seg * num_words + ids // 32,
                        torch.ones_like(ids) << (ids % 32))
        return words_from_values(flat).reshape(nb, num_words)

    return (words(key[~up & ~same_next]),
            words(torch.unique_consecutive(key[up & ~prev_lower])))


def ref_delta_bitmasks_replay(owner, is_upper, valid, *, num_words: int,
                              block_size: int):
    """Sequential replay of each segment (Algorithm 6 lines 1-17 verbatim,
    the Pallas kernel's set/clear semantics; owners clamped at 0, owners
    >= 32·num_words ignored); returns (add, del) as ``np.uint32`` arrays.
    Host-only, small sizes."""
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
            o = max(int(owner[t]), 0)
            if o >= 32 * num_words:
                continue
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


#: the kinds of :func:`off_contract_records`
OFF_CONTRACT_KINDS = ("lower_twice", "upper_twice", "upper_before_lower",
                      "dropped_lower", "lower_in_two_segments")


def off_contract_records(kind: str, owner: torch.Tensor,
                         is_upper: torch.Tensor, valid: torch.Tensor, *,
                         block_size: int):
    """One extent type's records of a sorted stream pushed outside its
    contract (each extent's lower, then its upper, once each), per segment
    at its first valid lower (or upper, for ``upper_twice``):

    * ``lower_twice`` / ``upper_twice``: that record again in place of the
      record after it;
    * ``upper_before_lower``: that lower made an upper, and a lower of its
      owner in place of the segment's last record;
    * ``dropped_lower``: that lower made invalid;
    * ``lower_in_two_segments``: the previous segment's first lower in place
      of the segment's first record.

    Returns new (owner, is_upper, valid) int32 tensors on the inputs'
    device; vectorized, fit for full sizes on the card."""
    owner, is_upper, valid = (x.clone() for x in (owner, is_upper, valid))
    total = owner.shape[0]
    nb = total // block_size
    t = torch.arange(total, device=owner.device)
    start = torch.arange(nb, device=owner.device) * block_size
    pick = (valid != 0) & ((is_upper != 0) if kind == "upper_twice"
                           else (is_upper == 0))
    first = torch.where(pick, t, total).reshape(nb, block_size).amin(dim=1)
    has = first < total
    at = first[has]
    if kind in ("lower_twice", "upper_twice"):
        at = at[at + 1 < start[has] + block_size]
        for x in (owner, is_upper, valid):
            x[at + 1] = x[at]
    elif kind == "upper_before_lower":
        last = start[has] + block_size - 1
        keep = last != at
        at, last = at[keep], last[keep]
        is_upper[at] = 1
        owner[last], is_upper[last], valid[last] = owner[at], 0, 1
    elif kind == "dropped_lower":
        valid[at] = 0
    elif kind == "lower_in_two_segments":
        src = first[:-1]
        keep = src < total
        dst = start[1:][keep]
        owner[dst], is_upper[dst], valid[dst] = owner[src[keep]], 0, 1
    else:
        raise ValidationError(f"unknown kind {kind!r}: {OFF_CONTRACT_KINDS}")
    return owner, is_upper, valid


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


def ref_emit_pairs_lists(owner, is_upper, is_sub, valid, sub_active0,
                         upd_active0, *, block_size: int, cap: int):
    """Pass C by the membership rule of the CUDA kernel's list path.

    For each segment and side T, every extent that can be active in it is
    one entry (id, open, close): a member of T's entering set with open =
    -1, a lower of side T with open = its position in the segment; close
    is the position of the extent's upper in the segment, else
    ``block_size``.  At an upper of the other side at position i the
    counterpart set is the entries with open < i < close, in ascending id
    order, written at the slot base that the closed form gives (T's
    entering popcount plus T's lowers before i minus T's uppers before i,
    summed over the uppers before).

    The rule holds where each owner's records on a side, after its
    entering bit, are one of: entering; entering, upper; lower; lower,
    upper — and each set's size equals its closed-form count, and owners
    lie below 32·W of their side.  A segment that breaks it is flagged
    and takes :func:`ref_emit_pairs`' replay, as the kernel's general
    path does.  Returns (out_i, out_j, off_contract): the arrays of
    :func:`ref_emit_pairs` and a (num_blocks,) bool tensor.  A Python
    loop: fit for small sizes only.
    """
    dev = owner.device
    ow, up, sb, va = (_host(x).tolist() for x in (owner, is_upper, is_sub,
                                                    valid))
    words = {True: _host(sub_active0).view(np.uint32),
             False: _host(upd_active0).view(np.uint32)}
    nb = len(ow) // block_size
    out_i = np.full((nb, cap), -1, np.int32)
    out_j = np.full((nb, cap), -1, np.int32)
    flagged = np.zeros(nb, bool)
    for p in range(nb):
        seg = range(p * block_size, (p + 1) * block_size)
        runs = {side: {o: ["entering"] for o in _members(words[side][p])}
                for side in (True, False)}
        entries = {side: {o: [-1, block_size] for o in runs[side]}
                   for side in (True, False)}
        bad = False
        for t in seg:
            if not va[t]:
                continue
            side, i = bool(sb[t]), t - p * block_size
            bad |= not 0 <= ow[t] < 32 * words[side].shape[1]
            runs[side].setdefault(ow[t], []).append(
                "upper" if up[t] else "lower")
            if up[t]:
                entries[side].setdefault(ow[t], [None, None])[1] = i
            else:
                entries[side][ow[t]] = [i, block_size]
        bad |= any(run not in (["entering"], ["entering", "upper"],
                               ["lower"], ["lower", "upper"])
                   for side in runs for run in runs[side].values())
        live = {side: len(_members(words[side][p])) for side in words}
        slot = 0
        for t in seg:
            if bad:
                break
            if not va[t]:
                continue
            side, i, o = bool(sb[t]), t - p * block_size, ow[t]
            if up[t]:
                members = sorted(k for k, (a, b) in entries[not side].items()
                                 if a < i < b)
                bad |= len(members) != live[not side]
                for k, c in enumerate(members):
                    if slot + k < cap:
                        out_i[p, slot + k], out_j[p, slot + k] = \
                            (o, c) if side else (c, o)
                slot += live[not side]
            live[side] += -1 if up[t] else 1
        if bad:
            flagged[p] = True
            rows = slice(p * block_size, (p + 1) * block_size)
            ri, rj = ref_emit_pairs(
                *(x[rows] for x in (owner, is_upper, is_sub, valid)),
                sub_active0[p:p + 1], upd_active0[p:p + 1],
                block_size=block_size, cap=cap)
            out_i[p], out_j[p] = ri[0].cpu().numpy(), rj[0].cpu().numpy()
    return (torch.from_numpy(out_i).to(dev), torch.from_numpy(out_j).to(dev),
            torch.from_numpy(flagged).to(dev))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

NEG_INF = -1.0e30   # finite mask value: keeps exp() well-defined on dead rows


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_segments: Optional[torch.Tensor] = None,
                  kv_segments: Optional[torch.Tensor] = None,
                  block_mask: Optional[torch.Tensor] = None,
                  block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Dense-mask attention oracle (f32 softmax), GQA by head repetition.

    q (B, H, Sq, D), k/v (B, Hkv, Skv, D); q is right-aligned in the KV
    window (row r sits at position ``Skv - Sq + r``); ``block_mask``
    (nq, nk) bool restricts the token mask to whole blocks; rows with no
    live key come out as zeros.  Output in q's dtype.
    """
    _, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = (torch.arange(sq, device=q.device) + (skv - sq))[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    if block_mask is not None:
        token_bm = torch.as_tensor(block_mask, device=q.device) \
            .repeat_interleave(block_q, dim=0) \
            .repeat_interleave(block_k, dim=1)[:sq, :skv]
        mask &= token_bm
    mask = mask[None, None]
    if q_segments is not None:
        seg = q_segments[:, :, None] == kv_segments[:, None, :]
        mask = mask & seg[:, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_index, kv_count,
                        q_segments: Optional[torch.Tensor] = None,
                        kv_segments: Optional[torch.Tensor] = None, *,
                        scale: float, causal: bool, window: Optional[int],
                        softcap: Optional[float], block_q: int, block_k: int,
                        q_offset: int) -> torch.Tensor:
    """The block-sparse flash forward by replay of its online softmax.

    For each query block i, only the KV blocks ``kv_index[i, :kv_count[i]]``
    are visited, in order; each one updates the running max ``m``, sum
    ``l`` and accumulator (all float32, q/k/v cast to float32 before both
    products) exactly as the kernel does: softcap before masking, masked
    scores at −1e30 and masked probabilities forced to 0, output
    ``acc / (l if l > 0 else 1)`` in q's dtype.  Positions: query row r at
    ``q_offset + r``, key column c at c; segments (B, S) int32 restrict to
    equal ids.  The answer depends on the schedule: a block left out of it
    is never seen, whatever the token mask says.
    """
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    dev = q.device
    index = _host(kv_index)
    count = _host(kv_count).tolist()
    q5 = q.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    rows = torch.arange(block_q, device=dev)[:, None]
    cols = torch.arange(block_k, device=dev)[None, :]
    for i in range(sq // block_q):
        qs = slice(i * block_q, (i + 1) * block_q)
        qb = q5[:, :, :, qs]                                  # (b,kv,g,bq,d)
        m = torch.full((b, hkv, g, block_q), NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, block_q), device=dev)
        acc = torch.zeros((b, hkv, g, block_q, d), device=dev)
        q_pos = q_offset + i * block_q + rows
        for t in range(count[i]):
            kb = int(index[i, t])
            ks = slice(kb * block_k, (kb + 1) * block_k)
            s = torch.einsum("bkgqd,bksd->bkgqs", qb, kf[:, :, ks]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            k_pos = kb * block_k + cols
            mask = torch.ones((block_q, block_k), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
            mask = mask.expand(b, block_q, block_k)
            if q_segments is not None:
                mask = mask & (q_segments[:, qs, None]
                               == kv_segments[:, None, ks])
            mask = mask[:, None, None]                        # (b,1,1,bq,bk)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vf[:, :, ks])
            m = m_new
        out[:, :, :, qs] = acc / torch.where(l > 0, l, 1.0)[..., None]
    return out.reshape(b, h, sq, d).to(q.dtype)
