#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Print the card (``nvidia-smi``), build the kernels from
   ``src/repro_torch/kernels/csrc`` (the four sweep kernels and the
   bit-matrix AND; one nvcc per source, in parallel) and print the build
   time.
2. Kernel parity at full size on the paper-§5 uniform workloads
   (L = 1e6): n = m = 1e6 at α = 1 and n = m = 1e5 at α = 100.  Passes A
   and B (at both segment sizes the main path launches them with: 2048
   for counting, 4096 for enumeration) and the delta-bitmask kernel equal
   their plain versions exactly;
   pass C equals its plain replay at a reduced size (printed); at full
   size the pass-C engine's pair set equals the rank-table
   ``sbm_enumerate``'s and its count equals K; K equals the sequential
   sweep's count.
3. The main path: ``repro_torch.api.DDMService(device="cuda")`` at
   n = m = 1e5 regions (α = 1): bulk register, flush, match_count, pairs,
   then churn flushes of b = 1, 100, 1000 and 10000 moves whose
   ``BatchDelta``s must equal a ``device="cpu"`` twin's, and ``pairs()``
   after the churn must equal a fresh rebuild.  The kernels' launch counts
   are zeroed just before and read just after; each must be > 0.
4. Each sweep kernel at the main path's shapes: held against its plain
   version again, then timed (device time per launch) beside the plain
   version and the least time the card could take (bytes over the
   published HBM rate).
5. The bit-matrix AND kernel against its plain version and the numpy brute
   force: the shapes of ``tests/test_kernels_bitmatch.py``, an unbounded
   ``[-inf, +inf]²`` subscription against m = 5, and empty sides.
6. The bit-matrix at full size on tall-thin workloads (wide dim 0):
   (a) n = m = 32768, d = 2, α = 10 and (b) n = m = 1e5, d = 3, α = 100.
   Words, row counts and K equal the plain version's (run over row
   blocks); K equals the selective sweep's count; in (a) the kernel
   engine's pair set equals the selective sweep's, and
   ``enumerate_matches_ddim_planned(method="bitmatrix")`` runs on the
   kernel (launch count zeroed before, > 0 after).
7. The d-dim service path: ``DDMService(dims=2, device="cuda")`` at
   n = m = 1e5 tall-thin regions (α = 1), the same steps and churn as
   phase 3 (moved regions keep the tall-thin shape) against a
   ``device="cpu"`` twin; the regime ``sweep_dim1`` and the ``device``
   rematch must show in ``stats()``, and the four sweep kernels' launch
   counts, zeroed before, must all be > 0.
8. The bit-matrix kernel timed at cell (a) beside its plain version and its
   bound (the larger of bytes over the HBM rate and compares over the
   float32 rate).

The last lines are the ``{"kernels": [...]}`` record, the launch counts,
the phase timings, the card line, and ``{"ok": true, "device": {...}}``.
Data come from a fixed seed.  Exits 2 without a result when no CUDA device
is present or the script stands outside the repository.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
LENGTH = 1.0e6                 # routing space side L (paper §5)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# H100 SXM float32 outside the tensor cores, NVIDIA data sheet: the rate
# the bit-matrix compares are held to
FP32_OPS_PER_S = 67e12
FULL = ((1_000_000, 1.0), (100_000, 100.0))   # (n = m, alpha)
REDUCED_N = 20_000             # pass C against its Python replay
MAIN_N = 100_000               # the service's regions per side
CHURN = (("sub", 1), ("upd", 100), ("sub", 1000), ("upd", 10_000))
BITMATCH_SHAPES = ((1, 33, 40), (2, 64, 70), (2, 37, 130), (3, 96, 257))
BITMATCH_FULL = (("a", 32_768, 2, 10.0), ("b", 100_000, 3, 100.0))
DDIM_N = 100_000               # the d-dim service's regions per side
REPLACES = {
    "block_sums": "src/repro/kernels/sbm_sweep.py:54",
    "emission": "src/repro/kernels/sbm_sweep.py:63",
    "delta_bitmasks": "src/repro/kernels/sbm_sweep.py:126",
    "emit_pairs": "src/repro/kernels/sbm_sweep.py:205",
    "bitmatch": "src/repro/kernels/bitmatch.py:40",
}
SOURCES = dict.fromkeys(
    ("block_sums", "emission", "delta_bitmasks", "emit_pairs"),
    "src/repro_torch/kernels/csrc/sbm_sweep.cu")
SOURCES["bitmatch"] = "src/repro_torch/kernels/csrc/bitmatch.cu"
DEVICE = "cuda"


class SmokeFailure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the repository root (src/repro_torch "
              "missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    print(card, flush=True)
    smoke = Smoke(torch)
    smoke.build()
    for n, alpha in FULL:
        smoke.full_size(n, alpha)
    smoke.main_path()
    smoke.kernels_at_main_shapes()
    smoke.bitmatch_battery()
    for cell, n, d, alpha in BITMATCH_FULL:
        smoke.bitmatch_full(cell, n, d, alpha)
    smoke.ddim_service()
    smoke.bitmatch_timing()
    smoke.report(card)
    return 0


class Smoke:
    def __init__(self, torch):
        from repro_torch.core import runtime
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import bitmatch as B
        from repro_torch.kernels import sbm_sweep as K

        self.torch = torch
        self.K, self.B, self.ref, self.ops, self._build = K, B, ref, ops, _build
        self.round_up_pow2 = runtime.round_up_pow2
        self.dev = torch.device(DEVICE)
        self.err = {w.__name__: 0
                    for w in K.KERNEL_WRAPPERS + B.KERNEL_WRAPPERS}
        self.phase_ms = {}
        self.launches = {}
        self.rows = {}
        self.timing_source = {}

    # -- helpers ---------------------------------------------------------
    def workload(self, n: int, alpha: float, seed: int):
        from repro_torch.core import make_uniform_workload

        g = self.torch.Generator().manual_seed(seed)
        return make_uniform_workload(n, n, alpha, length=LENGTH, generator=g,
                                     device=self.dev)

    def same(self, name: str, got, want, what: str) -> None:
        """Exact equality of kernel and plain outputs; records max |diff|."""
        torch = self.torch
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f"{what}: shape/dtype {g.shape}/{g.dtype} vs "
                    f"{w.shape}/{w.dtype}")
            diff = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
            self.err[name] = max(self.err[name], diff)
            require(diff == 0, f"{what}: kernel != plain (max |diff| {diff})")

    def stream(self, subs, upds, block_size: int):
        from repro_torch.core.sweep import (_indicator_deltas, _pad_stream,
                                            encode_endpoints)

        torch = self.torch
        ep = _pad_stream(encode_endpoints(subs, upds), block_size)
        return ep, torch.stack(_indicator_deltas(ep)).contiguous()

    def pass_inputs(self, subs, upds):
        """Every kernel's inputs for one workload, as the entry points in
        repro_torch.kernels.ops build them."""
        from repro_torch.core import prefix

        torch, K = self.torch, self.K
        n, m = subs.size, upds.size
        ep, deltas = self.stream(subs, upds, self.ops.COUNT_BLOCK)
        ep4, deltas4 = self.stream(subs, upds, self.ops.ENUMERATE_BLOCK)
        up = ep4.is_upper.to(torch.int32)
        real = ep4.owner >= 0
        vs, vu = (ep4.is_sub & real).to(torch.int32), \
            (~ep4.is_sub & real).to(torch.int32)
        ws, wu = -(-n // 32), -(-m // 32)
        _, seg, k = K.sweep_count(deltas4, block_size=self.ops.ENUMERATE_BLOCK)
        sa, sd = K.delta_bitmasks(ep4.owner, up, vs, num_words=ws,
                                  block_size=self.ops.ENUMERATE_BLOCK)
        ua, ud = K.delta_bitmasks(ep4.owner, up, vu, num_words=wu,
                                  block_size=self.ops.ENUMERATE_BLOCK)
        return {
            "deltas": deltas, "deltas4": deltas4, "ep4": ep4, "up": up,
            "vs": vs, "vu": vu,
            "ws": ws, "wu": wu, "cap": max(int(seg.max()), 1), "k": int(k),
            "c_args": (ep4.owner.clamp(min=0), up, ep4.is_sub.to(torch.int32),
                       real.to(torch.int32), prefix.delta_scan_exclusive(sa, sd),
                       prefix.delta_scan_exclusive(ua, ud)),
        }

    def check_counting(self, deltas, what, bs):
        K, ref = self.K, self.ref
        what = f"{what} block {bs}"
        sums = K.block_sums(deltas, block_size=bs)
        self.same("block_sums", [sums], [ref.ref_block_sums(deltas,
                                                            block_size=bs)],
                  f"pass A {what}")
        offsets = self.torch.cumsum(sums, dim=0, dtype=self.torch.int32) - sums
        got = K.emission(deltas, offsets, block_size=bs)
        self.same("emission", got, ref.ref_emission(deltas, offsets,
                                                    block_size=bs),
                  f"pass B {what}")
        return int(got[1].sum())

    def check_bitmasks(self, x, what):
        K, ref, bs = self.K, self.ref, self.ops.ENUMERATE_BLOCK
        for valid, words in ((x["vs"], x["ws"]), (x["vu"], x["wu"])):
            got = K.delta_bitmasks(x["ep4"].owner, x["up"], valid,
                                   num_words=words, block_size=bs)
            want = ref.ref_delta_bitmasks(x["ep4"].owner, x["up"], valid,
                                          num_words=words, block_size=bs)
            self.same("delta_bitmasks", got, want, f"delta bitmasks {what}")

    def check_pass_c(self, x, what):
        bs = self.ops.ENUMERATE_BLOCK
        got = self.K.emit_pairs(*x["c_args"], block_size=bs, cap=x["cap"])
        t0 = time.perf_counter()
        want = self.ref.ref_emit_pairs(*x["c_args"], block_size=bs,
                                       cap=x["cap"])
        self.torch.cuda.synchronize()
        self.same("emit_pairs", got, want, f"pass C {what}")
        return (time.perf_counter() - t0) * 1e3

    def pair_keys(self, pairs, m):
        keep = pairs[:, 0] >= 0
        key = pairs[keep, 0].to(self.torch.int64) * m + pairs[keep, 1]
        return self.torch.sort(key).values

    @staticmethod
    def pair_set(pairs) -> set:
        return {(i, j) for i, j in pairs.cpu().tolist() if i >= 0}

    @staticmethod
    def dim_rows(e):
        """(d, n) contiguous bounds of extents (1-d promoted to one row)."""
        lo, hi = (e.lo, e.hi) if e.lo.ndim == 2 else (e.lo[None], e.hi[None])
        return lo.contiguous(), hi.contiguous()

    def timed(self, name, fn):
        """Run ``fn`` once to completion on the card; record its ms."""
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.phase_ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    # -- phases ----------------------------------------------------------
    def build(self):
        t0 = time.perf_counter()
        self._build.library()
        secs = time.perf_counter() - t0
        print(f"build: {secs:.3f} s (nvcc sm_90a + ctypes load)", flush=True)
        log = self._build.build_log()
        if log:
            # nvcc -Xptxas -v: registers, spills and shared memory per kernel
            (self._build.BUILD_DIR / "ptxas.log").write_text(log)
            for line in log.splitlines():
                if "Compiling entry function" in line or "Used" in line:
                    print("  " + line.split("info    :")[-1].strip())
        self.phase_ms["build"] = secs * 1e3

    def full_size(self, n: int, alpha: float):
        from repro_torch.core import sbm_enumerate, sequential_sbm_count_numpy

        torch = self.torch
        tag = f"n=m={n} alpha={alpha:g}"
        subs, upds = self.workload(n, alpha, SEED)
        x = self.pass_inputs(subs, upds)
        k = self.check_counting(x["deltas"], tag, self.ops.COUNT_BLOCK)
        k4 = self.check_counting(x["deltas4"], tag, self.ops.ENUMERATE_BLOCK)
        self.check_bitmasks(x, tag)
        t0 = time.perf_counter()
        k_seq = sequential_sbm_count_numpy(subs, upds)
        require(k == k4 == k_seq == x["k"],
                f"{tag}: K {k} (count block) / {k4}, {x['k']} (enumerate "
                f"block) != sequential {k_seq}")
        seq_s = time.perf_counter() - t0
        max_pairs = self.round_up_pow2(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs, count = self.ops.sbm_enumerate_kernel(subs, upds,
                                                     max_pairs=max_pairs)
        torch.cuda.synchronize()
        engine_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain, plain_count = sbm_enumerate(subs, upds, max_pairs=max_pairs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(int(count) == k == int(plain_count),
                f"{tag}: pass-C engine count {int(count)} != K {k}")
        require(torch.equal(self.pair_keys(pairs, n),
                            self.pair_keys(plain, n)),
                f"{tag}: pass-C engine pair set != sbm_enumerate pair set")
        small_s, small_u = self.workload(REDUCED_N, alpha, SEED + 1)
        replay_ms = self.check_pass_c(self.pass_inputs(small_s, small_u),
                                      f"n=m={REDUCED_N} alpha={alpha:g}")
        print(f"full size {tag}: K={k} exact (sequential sweep {seq_s:.1f} s); "
              f"passes A/B and delta bitmasks == plain; pass-C engine "
              f"{engine_ms:.1f} ms, pair set == sbm_enumerate "
              f"({plain_ms:.1f} ms); pass C == "
              f"replay at n=m={REDUCED_N} (replay {replay_ms:.0f} ms)",
              flush=True)
        self.phase_ms[f"enumerate_kernel {tag}"] = engine_ms
        self.phase_ms[f"sbm_enumerate (plain) {tag}"] = plain_ms

    def drive_service(self, tag, dims, subs, upds, move_bounds, rng):
        """Bulk register, flush, match_count, pairs, then the CHURN flushes
        on a ``DEVICE`` service and a ``device="cpu"`` twin: every
        BatchDelta must be equal, pairs() after churn equal to a fresh
        rebuild.  The sweep kernels' launch counts are zeroed just before
        and read just after.  Returns (service, pairs, regimes, launches)."""
        import numpy as np
        from repro_torch.api import DDMService

        torch, K = self.torch, self.K
        twin = DDMService(dims=dims, device="cpu")
        block = (lambda x: x.numpy()) if dims == 1 else (lambda x: x.T.numpy())
        bounds = {"sub": (block(subs.lo), block(subs.hi)),
                  "upd": (block(upds.lo), block(upds.hi))}
        for w in K.KERNEL_WRAPPERS:
            w.launches = 0
        torch.cuda.synchronize()
        svc = DDMService(dims=dims, device=DEVICE)
        rids = {}
        for side, (lo, hi) in bounds.items():
            rids[side] = self.timed(f"{tag}register {side}",
                                    lambda: svc.register(side, lo, hi))
            require(np.array_equal(rids[side], twin.register(side, lo, hi)),
                    f"{tag}register: rids differ from the cpu twin")
        delta = self.timed(f"{tag}flush bulk", svc.flush)
        require(delta == twin.flush(), f"{tag}bulk flush: BatchDelta != cpu twin")
        k = self.timed(f"{tag}match_count", svc.match_count)
        require(k == len(delta.added), f"{tag}match_count {k} != |pairs| "
                f"{len(delta.added)}")
        pairs = self.timed(f"{tag}pairs (rebuild)", svc.pairs)
        require(pairs == delta.added, f"{tag}pairs() != the bulk flush's delta")
        for side, b in CHURN:
            moved = rng.choice(rids[side], size=b, replace=False)
            lo, hi = move_bounds(b)
            svc.move(side, moved, lo, hi)
            twin.move(side, moved, lo, hi)
            delta = self.timed(f"{tag}flush b={b}", svc.flush)
            require(delta == twin.flush(),
                    f"{tag}churn b={b}: BatchDelta != cpu twin")
            pairs = (pairs - delta.removed) | delta.added
        regimes = svc.stats()["by_regime"]
        require(regimes.get("device", 0) > 0,
                f"{tag}the device rematch regime never ran: {regimes}")
        cached = svc.pairs()
        require(cached == pairs, f"{tag}delta-composed pairs != the service cache")
        svc.invalidate_cache()
        rebuilt = self.timed(f"{tag}pairs (rebuild after churn)", svc.pairs)
        require(rebuilt == cached, f"{tag}pairs() after churn != a fresh rebuild")
        require(svc.match_count() == len(rebuilt), f"{tag}match_count != |pairs|")
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in K.KERNEL_WRAPPERS}
        require(all(v > 0 for v in launches.values()),
                f"{tag}a kernel was not launched on the path: {launches}")
        return svc, rebuilt, svc.stats()["by_regime"], launches

    def main_path(self):
        import numpy as np
        from repro_torch.core import make_uniform_workload

        g = self.torch.Generator().manual_seed(SEED + 2)
        subs, upds = make_uniform_workload(MAIN_N, MAIN_N, 1.0, length=LENGTH,
                                           generator=g, device="cpu")
        rng = np.random.default_rng(SEED + 3)
        seg_len = 1.0 * LENGTH / (2 * MAIN_N)

        def move_bounds(b):
            lo = rng.uniform(0.0, LENGTH - seg_len, size=b).astype(np.float32)
            return lo, lo + np.float32(seg_len)

        svc, rebuilt, regimes, self.launches = self.drive_service(
            "", 1, subs, upds, move_bounds, rng)
        self.main_live = (svc._subs.compact(svc._subs.live_ids(), self.dev),
                          svc._upds.compact(svc._upds.live_ids(), self.dev))
        print(f"main path: n=m={MAIN_N}, K={len(rebuilt)}, churn "
              f"{[b for _, b in CHURN]} deltas == cpu twin, pairs == rebuild, "
              f"regimes {regimes}", flush=True)

    def time_ms(self, fn, reps: int, kernel: str = "") -> float:
        """Per-call time: the kernel's own device time from the profiler
        when it records one, else CUDA events around ``reps`` calls."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        if kernel:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            for evt in prof.key_averages():
                dev_us = getattr(evt, "device_time_total", 0.0)
                if kernel in evt.key and evt.count and dev_us > 0:
                    self.timing_source[kernel] = "profiler"
                    return dev_us / evt.count / 1e3
            self.timing_source[kernel] = "cuda events"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def kernels_at_main_shapes(self):
        torch, K, ref = self.torch, self.K, self.ref
        self.timing_source = {}
        subs, upds = self.main_live
        x = self.pass_inputs(subs, upds)
        tag = "main-path shapes"
        self.check_counting(x["deltas"], tag, self.ops.COUNT_BLOCK)
        self.check_counting(x["deltas4"], tag, self.ops.ENUMERATE_BLOCK)
        self.check_bitmasks(x, tag)
        plain_c_ms = self.check_pass_c(x, tag)
        bsc, bse = self.ops.COUNT_BLOCK, self.ops.ENUMERATE_BLOCK
        d = x["deltas"]
        total, total4 = d.shape[1], x["ep4"].owner.shape[0]
        nbc, nbe = total // bsc, total4 // bse
        sums = K.block_sums(d, block_size=bsc)
        offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
        owner, up, vs = x["ep4"].owner, x["up"], x["vs"]
        c_args, cap = x["c_args"], x["cap"]
        blocked = d.view(4, nbc, bsc)
        # one library call computes pass A's sums, in (4, num_blocks) layout
        library = {"block_sums": lambda: torch.sum(blocked, dim=-1,
                                                    dtype=torch.int32)}
        rows = {
            "block_sums": (
                lambda: K.block_sums(d, block_size=bsc),
                lambda: ref.ref_block_sums(d, block_size=bsc),
                16 * total + 16 * nbc, "block_sums_kernel", 50),
            "emission": (
                lambda: K.emission(d, offsets, block_size=bsc),
                lambda: ref.ref_emission(d, offsets, block_size=bsc),
                16 * total + 16 * nbc + 4 * total + 8 * nbc,
                "emission_kernel", 50),
            "delta_bitmasks": (
                lambda: K.delta_bitmasks(owner, up, vs, num_words=x["ws"],
                                         block_size=bse),
                lambda: ref.ref_delta_bitmasks(owner, up, vs,
                                               num_words=x["ws"],
                                               block_size=bse),
                12 * total4 + 8 * nbe * x["ws"], "delta_bitmask_kernel", 20),
            "emit_pairs": (
                lambda: K.emit_pairs(*c_args, block_size=bse, cap=cap),
                None,
                16 * total4 + 4 * nbe * (x["ws"] + x["wu"]) + 8 * nbe * cap,
                "emit_pairs_kernel", 5),
        }
        for name, (kern, plain, nbytes, kname, reps) in rows.items():
            ms = self.time_ms(kern, reps, kname)
            plain_ms = plain_c_ms if plain is None else self.time_ms(plain,
                                                                     reps)
            self.rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": self.launches[name],
                "max_abs_err": self.err[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": (self.time_ms(library[name], reps)
                               if name in library else None),
            }
        print(f"kernel timing at {tag}: total={total} (count, block {bsc}), "
              f"{total4} (enumerate, block {bse}), cap={cap}, "
              f"sources {self.timing_source}", flush=True)

    # -- the d-dim slice: bit-matrix AND and the d > 1 service ------------
    def bitmatch_battery(self):
        """Kernel == plain == numpy brute force on small and edge shapes."""
        import numpy as np
        from repro_torch.core import Extents, brute_force_pairs_numpy, ddim

        torch = self.torch
        rng = np.random.default_rng(SEED + 4)
        cases = []
        for d, n, m in BITMATCH_SHAPES:
            arrs = []
            for size in (n, m):
                lo = rng.uniform(0, 40, (d, size)).astype(np.float32)
                arrs += [lo, lo + rng.uniform(0, 20, (d, size))
                         .astype(np.float32)]
            cases.append((f"d={d} n={n} m={m}", arrs, None))
        inf = np.float32(np.inf)
        u = np.arange(10, dtype=np.float32).reshape(2, 5)
        cases.append(("unbounded [-inf, inf]^2 vs m=5",
                      [np.full((2, 1), -inf, np.float32),
                       np.full((2, 1), inf, np.float32), u, u + 1], 5))
        none, some = np.zeros((2, 0), np.float32), np.ones((2, 3), np.float32)
        cases.append(("empty subs", [none, none, some, some + 1], 0))
        cases.append(("empty upds", [some, some + 1, none, none], 0))
        for what, arrs, k_want in cases:
            s_lo, s_hi, u_lo, u_hi = (torch.from_numpy(a).to(self.dev)
                                      for a in arrs)
            got = self.B.bitmatch(s_lo, s_hi, u_lo, u_hi)
            self.same("bitmatch", got, self.ref.ref_bitmatrix(s_lo, s_hi, u_lo,
                                                              u_hi),
                      f"bitmatch {what}")
            truth = brute_force_pairs_numpy(Extents(s_lo, s_hi),
                                            Extents(u_lo, u_hi))
            pairs, count = ddim.pairs_from_bitmatrix(
                got[0], m=u_lo.shape[1], max_pairs=max(len(truth), 1),
                count=got[1].sum(dtype=torch.int64))
            require(self.pair_set(pairs) == truth and int(count) == len(truth)
                    and (k_want is None or k_want == len(truth)),
                    f"bitmatch {what}: {int(count)} pairs, brute force "
                    f"{len(truth)}")
        print(f"bitmatch battery: {len(cases)} cases, kernel == plain == "
              f"brute force", flush=True)

    def bitmatch_full(self, cell: str, n: int, d: int, alpha: float):
        """Cell (a) or (b): kernel == plain over row blocks; K == the
        selective sweep's count; in (a) the pair sets and the bitmatrix
        path's launches."""
        from repro_torch.core import ddim, make_tall_thin_workload

        torch, B = self.torch, self.B
        tag = f"bitmatch ({cell}) n=m={n} d={d} alpha={alpha:g}"
        g = torch.Generator().manual_seed(SEED + 5)
        subs, upds = make_tall_thin_workload(n, n, alpha, length=LENGTH, d=d,
                                             wide_dim=0, generator=g,
                                             device=self.dev)
        torch.cuda.synchronize()
        words, counts, k = self.timed(f"{tag} kernel (cold)",
                                      lambda: B.bitmatrix_kernel(subs, upds))
        want = self.timed(f"{tag} plain",
                          lambda: self.ref.ref_bitmatrix(*self.dim_rows(subs),
                                                         *self.dim_rows(upds)))
        self.same("bitmatch", (words, counts), want, tag)
        k = int(k)
        sweep_pairs, count, stats = self.timed(
            f"{tag} selective sweep (plain engine)",
            lambda: ddim.enumerate_matches_ddim_planned(subs, upds,
                                                        method="sweep"))
        require(int(count) == k, f"{tag}: K {k} != selective sweep "
                f"{int(count)}")
        line = (f"{tag}: K={k} == selective sweep ({stats.regime}); "
                f"words {tuple(words.shape)} == plain")
        # warm times: the kernel's device time, the selective sweep's
        # (CUDA events, plain engine) — launches outside any counted run
        self.phase_ms[f"{tag} kernel device"] = self.time_ms(
            lambda: B.bitmatrix_kernel(subs, upds), 5, "bitmatch_kernel")
        self.phase_ms[f"{tag} selective sweep warm"] = self.time_ms(
            lambda: ddim.enumerate_matches_ddim_planned(subs, upds,
                                                        method="sweep"), 3)
        if cell == "a":
            pairs, bcount = B.sbm_bitmatrix_kernel(subs, upds,
                                                   max_pairs=stats.capacity)
            require(int(bcount) == k and torch.equal(
                self.pair_keys(pairs, n), self.pair_keys(sweep_pairs, n)),
                f"{tag}: kernel engine pair set != the selective sweep's")
            B.bitmatch.launches = 0
            torch.cuda.synchronize()
            _, c2, st = self.timed(
                f"{tag} bitmatrix planned",
                lambda: ddim.enumerate_matches_ddim_planned(
                    subs, upds, method="bitmatrix"))
            self.launches["bitmatch"] = B.bitmatch.launches
            require(B.bitmatch.launches > 0 and int(c2) == k
                    and st.regime == "bitmatrix" and st.retries == 0,
                    f"{tag}: bitmatrix path launches "
                    f"{B.bitmatch.launches}, K {int(c2)}, {st.regime}")
            self.bitmatch_inputs = (*self.dim_rows(subs), *self.dim_rows(upds))
            line += (f"; pair set == selective sweep's; bitmatrix path "
                     f"launches {B.bitmatch.launches}")
        print(line, flush=True)

    def ddim_service(self):
        """The d-dim service path at n = m = DDIM_N tall-thin (α = 1)."""
        import numpy as np
        from repro_torch.core import make_tall_thin_workload

        g = self.torch.Generator().manual_seed(SEED + 6)
        subs, upds = make_tall_thin_workload(DDIM_N, DDIM_N, 1.0,
                                             length=LENGTH, d=2, wide_dim=0,
                                             generator=g, device="cpu")
        rng = np.random.default_rng(SEED + 7)
        seg_len = 1.0 * LENGTH / (2 * DDIM_N)

        def move_bounds(b):     # wide in dim 0, thin in dim 1
            wide = rng.uniform(0.0, 0.02 * LENGTH, size=b).astype(np.float32)
            thin = rng.uniform(0.0, LENGTH - seg_len, size=b).astype(np.float32)
            return (np.stack([wide, thin], axis=1),
                    np.stack([wide + np.float32(0.98 * LENGTH),
                              thin + np.float32(seg_len)], axis=1))

        _, rebuilt, regimes, self.ddim_launches = self.drive_service(
            "ddim ", 2, subs, upds, move_bounds, rng)
        require(regimes.get("sweep_dim1", 0) > 0,
                f"ddim: the rebuild did not generate on dim 1: {regimes}")
        print(f"d-dim service path: d=2 n=m={DDIM_N} tall-thin, "
              f"K={len(rebuilt)}, churn {[b for _, b in CHURN]} deltas == cpu "
              f"twin, pairs == rebuild, regimes {regimes}, launches "
              f"{self.ddim_launches}", flush=True)

    def bitmatch_timing(self):
        """The bit-matrix kernel at cell (a): device time, plain time, bound."""
        args = self.bitmatch_inputs                 # s_lo, s_hi, u_lo, u_hi
        self.same("bitmatch", self.B.bitmatch(*args),
                  self.ref.ref_bitmatrix(*args), "bitmatch at cell (a)")
        d, n = args[0].shape
        m = args[2].shape[1]
        num_words = -(-m // 32)
        nbytes = 4 * n * num_words + 4 * n + 8 * d * (n + m)
        ops = 2 * d * n * m
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        self.rows["bitmatch"] = {
            "name": "bitmatch", "route": "cuda", "source": SOURCES["bitmatch"],
            "replaces": REPLACES["bitmatch"],
            "launches": self.launches["bitmatch"],
            "max_abs_err": self.err["bitmatch"],
            "ms": self.time_ms(lambda: self.B.bitmatch(*args), 20,
                               "bitmatch_kernel"),
            "plain_ms": self.time_ms(lambda: self.ref.ref_bitmatrix(*args), 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        }
        print(f"bitmatch timing at cell (a): d={d} n={n} m={m}, {nbytes} "
              f"bytes ({bytes_ms:.4f} ms at HBM rate), {ops} compares "
              f"({ops_ms:.4f} ms at {FP32_OPS_PER_S:.3g}/s), source "
              f"{self.timing_source.get('bitmatch_kernel')}", flush=True)

    def report(self, card: str):
        torch = self.torch
        print(json.dumps({"kernels": list(self.rows.values())}))
        print("launches on the main path (bitmatch: the bitmatrix path at "
              "cell (a)): " + json.dumps(self.launches))
        print("launches on the d-dim service path: "
              + json.dumps(self.ddim_launches))
        print("timings_ms: " + json.dumps(
            {k: round(v, 3) for k, v in self.phase_ms.items()}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
