// Hand-written CUDA kernels for block-sparse flash attention, forward (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of the JAX package's
// repro/kernels/flash_attention.py (src/repro/kernels/flash_attention.py:33,
// entry flash_attention_kernel :96).  It computes the same function, not the
// same block layout:
//
//   out[b, h, r] = sum_c p[r, c] v[b, h / G, c] / l[r],   G = H / Hkv,
//
// over the key columns c of the KV blocks that the schedule lists for the
// query block of row r (kv_index[i, 0 .. kv_count[i])), with
//   s = scale * q.k        (exact products of the inputs, float32 sums),
//   s = softcap * tanh(s / softcap)               when softcap > 0,
//   s masked where not (causal: c <= pos; window: c > pos - window;
//       segments: qseg == kseg), pos = q_offset + r,
// an online softmax whose running max m, sum l and accumulator are float32,
// masked probabilities forced to 0 (a fully masked tile ahead of a live one
// must not leave exp(0) = 1 behind), and out = acc / (l > 0 ? l : 1) in
// q's dtype (round to nearest even).  Head width D is 64, 128 or 256 for
// the bfloat16 specialisations below, any D from 1 to kRtMaxD = 593 for the
// run-time-width kernel.
//
// block_q / block_k are the schedule's units (512 at full width, 32 in the
// reduced configs), not a kernel's tile: a 512-row q block and a 512 x 512
// score tile do not fit one SM.  Each block of threads takes one q tile (64
// rows bf16, 32 run-time width) of one (batch, head), reads its q block's row of kv_index /
// kv_count itself (this replaces the Pallas scalar prefetch), and walks
// each scheduled KV block in K/V sub-tiles; rows past a block are zero and
// masked, so 32-blocks run too.  A sub-tile whose every pair is masked by
// causality or the window is skipped: its update is the identity (alpha =
// 1, p = 0), so skipping it changes no bit of the result.
//
// Two kernels:
//
// * bfloat16 at D = 64, 128, 256 (flash_attention_fwd_bf16_kernel, the
//   serving path; the wrapper zero-pads other bf16 widths up to 256): tensor
//   cores.  One warpgroup of 128 threads per 64-row q tile; warp w owns q
//   rows 16w .. 16w + 15.
//     - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> f32 with the
//       accumulators in registers (O: 16 x D per warp, D / 2 floats a
//       thread).
//     - Q, K and V stay bf16 in shared memory in an XOR-swizzled layout
//       (16-byte chunk c of row r at chunk c ^ (r & 7)): the eight row
//       addresses of one ldmatrix phase fall in eight different bank groups,
//       for ldmatrix (Q, K) and ldmatrix.trans (V) alike.
//     - K/V sub-tiles arrive by cp.async into a two-stage ring: sub-tile
//       t + 1 loads while t computes.  Rows past the KV block zero-fill.
//     - Q is copied to shared memory once per tile.  At D = 128 its
//       fragments are loaded into registers once per tile; at D = 64 those
//       16 registers would cost the fourth resident block of an SM (128
//       registers a thread), and at D = 256 they would take 64 beside the
//       128 of O, so there the fragment is re-read per k-step.  The KV
//       sub-tile is 64 rows (32 at D = 256, where O fills the registers).
//     - Softmax in registers: softcap (tanhf), the masks from absolute
//       positions and segment ids, the row max by two xor-shuffles among the
//       four lanes that share an accumulator row, taken on the raw scores
//       with scale * log2(e) folded into the exponent's FMA; 2^x by
//       ex2.approx.ftz (relative error about 2^-22).  l sums the float32 p;
//       p is rounded to bf16 in registers and used directly as the A
//       operand of P V (an m16n8 accumulator pair has the layout of an
//       m16n8k16 A fragment): nothing goes through shared memory.  That
//       rounding is the one change of numerics against the float32 plain
//       version: |p~ - p| <= 2^-9 p, so |out~ - out| <= 2^-9 max|v| before
//       the output's own rounding.
//     - Grid (B * H, q tiles) with the last q tile first: under a causal
//       schedule the longest tiles start first.
//   Shared memory (64 * D + 2 stages * 2 * rows * D) * 2 bytes: 40,960 at
//   D = 64, 81,920 at 128, 98,304 at 256.
//
// * float32 at every D, and bfloat16 above 256
//   (flash_attention_fwd_rt_kernel<T>, T float or bf16; the float32 path is
//   the test path, and no config of the repo has D > 256): D at run time,
//   scalar float32 FMA on the CUDA cores over 32-row q tiles and 32-row K/V
//   sub-tiles, inputs widened to float32 in shared memory, p kept float32
//   for P V (as the Pallas kernel does).  256 threads as a 16 x 16 grid;
//   the 16 threads of a row share a half-warp, so row max and sum are
//   shuffles; each thread owns two q rows' scores in two key columns and a
//   slice of their output columns (c = tx mod 16, at most kRtCols = 38 a
//   row) in registers, so no accumulator row has to fit one thread.  Q and
//   K rows at the odd stride D | 1 (16 threads reading 16 rows at one
//   column hit 16 banks).  Shared memory
//   (2 * 32 * (D | 1) + 32 * D + 32 * 33) * 4 bytes: 201,088 at D = 512;
//   D = 593 is the largest that fits 232,448 (the wrapper's
//   RT_MAX_HEAD_DIM copies kRtMaxD).  Written to be right, not fast: a
//   shared-memory load per FMA.
//
// Bound at smollm-360m's prefill shapes (B = 4, H = 15, Hkv = 5, S = 2048,
// D = 64, 512-blocks; live causal (q, k) pairs S(S+1)/2 = 2,098,176 per
// (b, h)): 4 * D * pairs * B * H = 32.2 GFLOP, 0.033 ms at the bf16
// tensor-core rate (989 TFLOP/s); about 42 MB of q, k, v and out, 0.013 ms
// at 3.35 TB/s.  The bf16 kernel is bound by operations.  mma.sync reaches
// only part of the wgmma rate, every warp reads the whole K/V sub-tile from
// shared memory (1/8 byte per FMA: at most half the tensor-core rate), and
// a warp's softmax does not overlap its own products; wgmma with TMA and
// ping-pong warpgroups are later work.
//
// Built without --use_fast_math: the run-time-width kernel's expf and both
// kernels' tanhf are the accurate library functions.  The C entry point
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_index;
  const int* kv_count;
  const int* q_seg;   // null: no segments
  const int* kv_seg;
  void* out;
  int H, Hkv, Sq, Skv, max_nk, block_q, block_k, q_offset;
  float scale;
  int causal;
  int window;         // < 0: no window
  float softcap;      // <= 0: no softcap
};

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor cores, cp.async ring, swizzled shared memory
// ---------------------------------------------------------------------------

constexpr int kRows = 64;        // q rows per tile: 4 warps x 16
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kStages = 2;       // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// K/V rows per sub-tile
template <int D>
constexpr int kKvRows = D == 256 ? 32 : 64;

template <int D>
constexpr int bf16_smem_bytes() {
  return (kRows * D + kStages * 2 * kKvRows<D> * D) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (relative error about 2^-22; results below 2^-126 flush
// to 0), for x <= 0 here
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half), RNE
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy `rows` rows (the rest of the R-row tile zero-filled) of a row-major
// (., D) bf16 matrix into a swizzled shared tile: 16-byte chunk c of row r
// lands at chunk c ^ (r & 7).  All 128 threads take part.
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int tid) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = 0; i < R * C / kTcThreads; ++i) {
    const int e = tid + i * kTcThreads;
    const int r = e / C, c = e % C;
    const bool live = r < rows;
    cp_async16(smem_addr(dst + (r * C + (c ^ (r & 7))) * 8),
               src + (long long)(live ? r : 0) * D + c * 8, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_fwd_bf16_kernel(const Params p) {
  constexpr int N = kKvRows<D>;     // K/V rows per sub-tile
  constexpr int C = D / 8;          // 16-byte chunks per row
  constexpr int kSteps = D / 16;    // k-steps of S = Q K^T
  constexpr int kNt = N / 8;        // 8-column tiles of S
  constexpr int kDt = D / 8;        // 8-column tiles of O
  // Q's fragments live in registers only at D = 128: at 64 those 16
  // registers would cost the fourth block on an SM, at 256 there is no room
  constexpr bool kQInRegs = D == 128;
  static_assert(kNt * 4 <= 32, "the dead-score mask is one 32-bit word");
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);    // kRows x D
  bf16* sKV = sQ + kRows * D;                      // stage s: K, then V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3, sw = lane & 7;
  const int tiles = (p.block_q + kRows - 1) / kRows;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int qblk = tile / tiles;
  const int q_lo = qblk * p.block_q + (tile % tiles) * kRows;
  const int q_hi = min(q_lo + kRows, (qblk + 1) * p.block_q);
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int hk = h / (p.H / p.Hkv);

  const bf16* q = (const bf16*)p.q + ((long long)b * p.H + h) * p.Sq * D;
  const bf16* k = (const bf16*)p.k + ((long long)b * p.Hkv + hk) * p.Skv * D;
  const bf16* v = (const bf16*)p.v + ((long long)b * p.Hkv + hk) * p.Skv * D;

  // this thread's accumulator rows: warp * 16 + g (r = 0) and + 8 (r = 1)
  int qpos[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + warp * 16 + g + 8 * r;
    qpos[r] = p.q_offset + row;
    qseg[r] = (p.q_seg != nullptr && row < q_hi)
                  ? p.q_seg[(long long)b * p.Sq + row] : 0;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kDt][4];
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const int count = p.kv_count[qblk];
  const int* index = p.kv_index + (long long)qblk * p.max_nk;
  const int tile_qmin = p.q_offset + q_lo, tile_qmax = p.q_offset + q_hi - 1;
  const int subs = (p.block_k + N - 1) / N;
  // the schedule's sub-tiles in order (the t-th KV block's sub-th N rows);
  // seek() moves to the next one that causality and the window leave live
  int t = 0, sub = 0;
  auto seek = [&](int& k_lo, int& k_hi) {
    for (; t < count; ++t, sub = 0) {
      const int kb = __ldg(index + t);
      for (; sub < subs; ++sub) {
        k_lo = kb * p.block_k + sub * N;
        k_hi = min(k_lo + N, (kb + 1) * p.block_k);
        if (p.causal && k_lo > tile_qmax) continue;
        if (p.window >= 0 && k_hi - 1 <= tile_qmin - p.window) continue;
        ++sub;
        return true;
      }
    }
    return false;
  };
  auto load_kv = [&](int k_lo, int k_hi, int stage) {
    bf16* dk = sKV + stage * 2 * N * D;
    load_tile<D, N>(dk, k + (long long)k_lo * D, k_hi - k_lo, tid);
    load_tile<D, N>(dk + N * D, v + (long long)k_lo * D, k_hi - k_lo, tid);
  };

  // ldmatrix row addresses: Q (A operand) rows warp*16 + (lane & 15),
  // chunk + (lane >> 4); K (B, non-transposed) rows + (lane & 7) +
  // 8 (lane >> 4), chunk + ((lane >> 3) & 1); V (B, transposed) rows +
  // (lane & 7) + 8 ((lane >> 3) & 1), chunk + (lane >> 4).  Each row's low
  // three bits are lane & 7, its swizzle.
  const int q_row = warp * 16 + (lane & 15), q_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_chunk = lane >> 4;
  auto q_addr = [&](int kk) {
    return smem_addr(sQ + (q_row * C + ((2 * kk + q_chunk) ^ sw)) * 8);
  };

  // scores in log2 units: x = s * mult; with a softcap s is first replaced
  // by cap * log2(e) * tanh(s * scale / cap) and mult = 1
  const bool capped = p.softcap > 0.0f;
  const float mult = capped ? 1.0f : p.scale * kLog2e;
  const float cap_l2 = p.softcap * kLog2e;
  const float scale_cap = capped ? p.scale / p.softcap : 0.0f;
  uint32_t qf[kQInRegs ? kSteps : 1][4];
  int cur_lo = 0, cur_hi = 0, nxt_lo = 0, nxt_hi = 0;
  bool live = seek(cur_lo, cur_hi);
  if (live) {
    load_tile<D, kRows>(sQ, q + (long long)q_lo * D, q_hi - q_lo, tid);
    load_kv(cur_lo, cur_hi, 0);
    cp_async_commit();
  }
  for (int stage = 0, first = 1; live; stage ^= 1, first = 0) {
    const bool more = seek(nxt_lo, nxt_hi);
    if (more) {
      load_kv(nxt_lo, nxt_hi, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this sub-tile (and Q) visible to every warp
    const bf16* cK = sKV + stage * 2 * N * D;
    const bf16* cV = cK + N * D;
    if constexpr (kQInRegs) {
      if (first) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(q_addr(kk), qf[kk]);
      }
    }

    // S = Q K^T: 16 x N per warp
    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t af[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
      } else {
        ldmatrix_x4(q_addr(kk), af);
      }
#pragma unroll
      for (int n2 = 0; n2 < kNt / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(smem_addr(cK + ((n2 * 16 + k_row) * C +
                                    ((2 * kk + k_chunk) ^ sw)) * 8),
                    bk);
        mma_bf16(s[2 * n2], af, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], af, bk[2], bk[3]);
      }
    }

    // softcap, masks, online softmax.  s[n][e] is row g + 8 (e >> 1),
    // column k_lo + 8n + 2 tig + (e & 1); bit 4n + e of dead marks it
    // masked.
    const int k_lo = cur_lo, k_hi = cur_hi;
    const bool masked = k_hi - k_lo < N ||
                        (p.causal && k_hi - 1 > tile_qmin) ||
                        (p.window >= 0 && k_lo <= tile_qmax - p.window) ||
                        p.q_seg != nullptr;
    if (capped) {
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = cap_l2 * tanhf(s[n][e] * scale_cap);
    }
    uint32_t dead = 0;
    if (masked) {
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k_lo + 8 * n + 2 * tig + c;
          const bool kin = kpos < k_hi;
          const int kseg = (p.kv_seg != nullptr && kin)
                               ? p.kv_seg[(long long)b * p.Skv + kpos] : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bool ok = kin;
            if (p.causal) ok = ok && kpos <= qpos[r];
            if (p.window >= 0) ok = ok && kpos > qpos[r] - p.window;
            if (p.q_seg != nullptr) ok = ok && qseg[r] == kseg;
            if (!ok) dead |= 1u << (4 * n + 2 * r + c);
          }
        }
    }
    // row max over the live scores; the four lanes of a row are 4g .. 4g + 3
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!((dead >> (4 * n + 2 * r + c)) & 1u))
            mx = fmaxf(mx, s[n][2 * r + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every score of the row dead so far: m stays kNegInf, alpha = 1
      const float m_new = fmaxf(m[r], mx * mult);
      alpha[r] = exp2_sfu(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];   // this lane's share; summed over the row at the end
    }
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = (dead >> (4 * n + e)) & 1u
                             ? 0.0f
                             : exp2_sfu(fmaf(s[n][e], mult, -m[e >> 1]));
        l[e >> 1] += pr;
        s[n][e] = pr;
      }

    // O += P V: P's accumulator pairs are the A fragments, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < kDt / 2; ++d2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(smem_addr(cV + ((kk * 16 + v_row) * C +
                                          ((2 * d2 + v_chunk) ^ sw)) * 8),
                          bv);
        mma_bf16(acc[2 * d2], pf, bv[0], bv[1]);
        mma_bf16(acc[2 * d2 + 1], pf, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its reload
    cur_lo = nxt_lo;
    cur_hi = nxt_hi;
    live = more;
  }

  bf16* out = (bf16*)p.out + ((long long)b * p.H + h) * p.Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float safe = l[r] > 0.0f ? l[r] : 1.0f;
    const int row = q_lo + warp * 16 + g + 8 * r;
    if (row >= q_hi) continue;
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * D + 8 * dt +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[dt][2 * r] / safe,
                                acc[dt][2 * r + 1] / safe);
  }
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, int nq, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_bf16_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bf16_smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)nq * ((p.block_q + kRows - 1) / kRows);
  if (tiles > 65535 || (long long)B * p.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid(B * p.H, (unsigned)tiles);
  kernel<<<grid, kTcThreads, bf16_smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 at any width, bf16 above 256: the width at run time, float32
// arithmetic
// ---------------------------------------------------------------------------

constexpr int kRtRows = 32;       // q rows per tile and k rows per sub-tile
constexpr int kRtThreads = 256;   // a 16 x 16 grid
// the largest D whose tiles fit a block's 232,448 bytes (rt_smem_bytes)
constexpr int kRtMaxD = 593;
constexpr int kRtCols = (kRtMaxD + 15) / 16;  // output columns a thread owns

// Q and K rows at an odd stride: 16 threads reading 16 rows at one column
// hit 16 banks
__host__ __device__ inline int rt_ld(int D) { return D | 1; }

__host__ __device__ inline size_t rt_smem_bytes(int D) {
  return (size_t)(2 * kRtRows * rt_ld(D) + kRtRows * D +
                  kRtRows * (kRtRows + 1)) * sizeof(float);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Scalar float32 flash attention with D a run-time value: 32-row q tiles and 32-row K/V sub-tiles, widened to float32 in shared
// memory.  Thread (ty, tx) owns scores (ty + 16 i, tx + 16 j), i, j < 2, and
// output columns tx + 16 c of rows ty and ty + 16: a slice of D in
// registers (at most kRtCols per row), so no thread holds a whole row.  p
// stays float32 for P V, as in the Pallas kernel.
template <typename T>
__global__ void __launch_bounds__(kRtThreads)
flash_attention_fwd_rt_kernel(const Params p, int D) {
  extern __shared__ float smem[];
  const int ld = rt_ld(D);
  float* sQ = smem;                        // kRtRows x ld
  float* sK = sQ + kRtRows * ld;           // kRtRows x ld
  float* sV = sK + kRtRows * ld;           // kRtRows x D
  float* sP = sV + kRtRows * D;            // kRtRows x (kRtRows + 1)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tiles = (p.block_q + kRtRows - 1) / kRtRows;
  const int qblk = blockIdx.x / tiles;
  const int q_lo = qblk * p.block_q + (blockIdx.x % tiles) * kRtRows;
  const int q_hi = min(q_lo + kRtRows, (qblk + 1) * p.block_q);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const long long qkv_d = D;

  const T* q = (const T*)p.q + ((long long)b * p.H + h) * p.Sq * qkv_d;
  const T* k = (const T*)p.k + ((long long)b * p.Hkv + hk) * p.Skv * qkv_d;
  const T* v = (const T*)p.v + ((long long)b * p.Hkv + hk) * p.Skv * qkv_d;

  for (int e = threadIdx.x; e < kRtRows * D; e += kRtThreads) {
    const int r = e / D, c = e % D;
    sQ[r * ld + c] =
        q_lo + r < q_hi ? widen(q[(long long)(q_lo + r) * qkv_d + c]) : 0.0f;
  }

  const int ncols = (D - tx + 15) / 16;   // this thread's output columns
  int qpos[2], qseg[2];
  float m[2], l[2], acc[2][kRtCols];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_lo + ty + 16 * i;
    qpos[i] = p.q_offset + row;
    qseg[i] = (p.q_seg != nullptr && row < q_hi)
                  ? p.q_seg[(long long)b * p.Sq + row] : 0;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kRtCols; ++c) acc[i][c] = 0.0f;
  }

  const int count = p.kv_count[qblk];
  const int* index = p.kv_index + (long long)qblk * p.max_nk;
  const int tile_qmin = p.q_offset + q_lo, tile_qmax = p.q_offset + q_hi - 1;
  const int subs = (p.block_k + kRtRows - 1) / kRtRows;
  for (int t = 0; t < count; ++t) {
    const int kb = index[t];
    const int kb_end = (kb + 1) * p.block_k;
    for (int sub = 0; sub < subs; ++sub) {
      const int k_lo = kb * p.block_k + sub * kRtRows;
      const int k_hi = min(k_lo + kRtRows, kb_end);
      if (p.causal && k_lo > tile_qmax) continue;
      if (p.window >= 0 && k_hi - 1 <= tile_qmin - p.window) continue;
      __syncthreads();  // the previous sub-tile's reads of sK, sV, sP are done
      for (int e = threadIdx.x; e < kRtRows * D; e += kRtThreads) {
        const int r = e / D, c = e % D;
        const bool live = k_lo + r < k_hi;
        const long long off = (long long)(k_lo + r) * qkv_d + c;
        sK[r * ld + c] = live ? widen(k[off]) : 0.0f;
        sV[r * D + c] = live ? widen(v[off]) : 0.0f;
      }
      __syncthreads();

      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a0 = sQ[ty * ld + d], a1 = sQ[(ty + 16) * ld + d];
        const float b0 = sK[tx * ld + d], b1 = sK[(tx + 16) * ld + d];
        s[0][0] = fmaf(a0, b0, s[0][0]);
        s[0][1] = fmaf(a0, b1, s[0][1]);
        s[1][0] = fmaf(a1, b0, s[1][0]);
        s[1][1] = fmaf(a1, b1, s[1][1]);
      }

      int kpos[2], kseg[2];
      bool kin[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kpos[j] = k_lo + tx + 16 * j;
        kin[j] = kpos[j] < k_hi;
        kseg[j] = (p.kv_seg != nullptr && kin[j])
                      ? p.kv_seg[(long long)b * p.Skv + kpos[j]] : 0;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        bool live[2];
        float tmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[i][j] * p.scale;
          if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
          bool ok = kin[j];
          if (p.causal) ok = ok && kpos[j] <= qpos[i];
          if (p.window >= 0) ok = ok && kpos[j] > qpos[i] - p.window;
          if (p.q_seg != nullptr) ok = ok && qseg[i] == kseg[j];
          s[i][j] = ok ? x : kNegInf;
          live[j] = ok;
          tmax = fmaxf(tmax, s[i][j]);
        }
        // the 16 threads of a row are one half-warp
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[i], tmax);
        const float alpha = expf(m[i] - m_new);
        float rsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pr = live[j] ? expf(s[i][j] - m_new) : 0.0f;
          sP[(ty + 16 * i) * (kRtRows + 1) + tx + 16 * j] = pr;
          rsum += pr;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        l[i] = l[i] * alpha + rsum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kRtCols; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 2
      for (int kk = 0; kk < kRtRows; ++kk) {
        const float p0 = sP[ty * (kRtRows + 1) + kk];
        const float p1 = sP[(ty + 16) * (kRtRows + 1) + kk];
        const float* vrow = sV + kk * D + tx;
#pragma unroll
        for (int c = 0; c < kRtCols; ++c) {
          if (c < ncols) {
            const float vv = vrow[16 * c];
            acc[0][c] = fmaf(p0, vv, acc[0][c]);
            acc[1][c] = fmaf(p1, vv, acc[1][c]);
          }
        }
      }
    }
  }

  T* out = (T*)p.out + ((long long)b * p.H + h) * p.Sq * qkv_d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_lo + ty + 16 * i;
    if (row >= q_hi) continue;
    const float safe = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < kRtCols; ++c)
      if (c < ncols)
        narrow(out + (long long)row * qkv_d + tx + 16 * c, acc[i][c] / safe);
  }
}

template <typename T>
cudaError_t launch_rt(const Params& p, int B, int nq, int D,
                      cudaStream_t stream) {
  if (D < 1 || D > kRtMaxD) return cudaErrorInvalidValue;
  auto kernel = flash_attention_fwd_rt_kernel<T>;
  const size_t smem = rt_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nq * ((p.block_q + kRtRows - 1) / kRtRows), p.H, B);
  kernel<<<grid, kRtThreads, smem, stream>>>(p, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k / v (B, Hkv, Skv, D) of one dtype (0 float32,
// 1 bfloat16), contiguous; D in 1 .. kRtMaxD for float32, in {64, 128,
// 256} or 257 .. kRtMaxD for bfloat16;
// kv_index (Sq / block_q, max_nk) and kv_count (Sq / block_q) int32; q_seg
// (B, Sq) / kv_seg (B, Skv) int32 or both null; out like q.  window < 0:
// none; softcap <= 0: none.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const int* kv_index, const int* kv_count,
                        const int* q_seg, const int* kv_seg, void* out, int B,
                        int H, int Hkv, int Sq, int Skv, int D, int max_nk,
                        int block_q, int block_k, int q_offset, float scale,
                        int causal, int window, float softcap, int dtype,
                        void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H % Hkv != 0 || block_q <= 0 || block_k <= 0 ||
      Sq % block_q != 0 || Skv % block_k != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, kv_index, kv_count, q_seg, kv_seg, out, H, Hkv, Sq,
                 Skv, max_nk, block_q, block_k, q_offset, scale, causal,
                 window, softcap};
  const int nq = Sq / block_q;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_rt<float>(p, B, nq, D, s);
  } else if (dtype == 1 && D > 256) {
    err = launch_rt<__nv_bfloat16>(p, B, nq, D, s);
  } else if (dtype == 1) {
    if (D == 64) err = launch_bf16<64>(p, B, nq, s);
    if (D == 128) err = launch_bf16<128>(p, B, nq, s);
    if (D == 256) err = launch_bf16<256>(p, B, nq, s);
  }
  return (int)err;
}

}  // extern "C"
