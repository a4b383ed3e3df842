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
// the bfloat16 specialisations below, 257 to kRtMaxD = 593 for the wide
// bfloat16 kernel, any D from 1 to kRtMaxD for the float32 kernel.
//
// block_q / block_k are the schedule's units (512 at full width, 32 in the
// reduced configs), not a kernel's tile: a 512-row q block and a 512 x 512
// score tile do not fit one SM.  Each block of threads takes one q tile (64
// rows) of one (batch, head), reads its q block's row of
// kv_index / kv_count itself (this replaces the Pallas scalar prefetch), and
// walks each scheduled KV block in K/V sub-tiles; rows past a block are zero
// and masked, so 32-blocks run too.  A sub-tile whose every pair is masked
// by causality or the window is skipped: its update is the identity (alpha
// = 1, p = 0), so skipping it changes no bit of the result.
//
// Three kernels:
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
// * bfloat16 at D = 257 .. kRtMaxD (flash_attention_fwd_wide_kernel): the
//   same machinery and numerics (p rounded to bf16 before P V, so the same
//   2^-9 max|v| bound), the width at run time.  O of 16 rows x D cannot stay
//   in one warp's registers (D / 2 floats a thread: 256 at D = 512), so a
//   block of two warpgroups (256 threads) takes a 64-row q tile and splits
//   both products between them:
//     - D is padded inside the kernel to Dp, the next multiple of 64
//       (zero-filled cp.async: a zero column adds 0 to every score; the
//       swizzle needs a multiple of 8 chunks a row).  The wrapper neither
//       pads nor copies nor slices.
//     - O is cut into nc column chunks of cw <= 256 (a multiple of 16):
//       nc = 2 up to Dp = 512, one chunk a warpgroup, so each thread holds
//       the D = 256 instance's 128 floats of O; nc = 4 above (Dp 576, 640),
//       on two blocks of the grid, which then both compute Q K^T.
//     - Q K^T's reduction is split: each warpgroup runs half of the k-steps
//       (groups of four, 64 columns) over the shared Q tile and K sub-tile,
//       the two warps that own the same 16 rows swap their partial S
//       through shared memory (2 KB a warp, a named barrier of 64 threads)
//       and both add them in one order, so S, m and l are bit-identical in
//       both warpgroups.  At Dp <= 512 no product is computed twice.
//     - K sub-tiles of 32 rows at the padded width and V sub-tiles at the
//       block's 2 cw columns share one two-stage cp.async ring, loaded once
//       for both warpgroups; each warpgroup accumulates P V for its chunk.
//     - Rows of width D not a multiple of 8 (or q, k, v, out not 16-byte
//       aligned) are staged by element loads instead of cp.async, and the
//       output is stored element by element there.
//     - Grid (B * H * nc / 2, q tiles), the last q tile first.
//   Shared memory (64 Dp + 2 stages * 32 (Dp + 8 vs)) * 2 + 16,384 bytes,
//   vs = 2 cw / 8 chunks rounded up to 8: 139,264 at D = 320, 212,992 at
//   512, 221,184 at 593 (Dp = 640): one block (8 warps) an SM.
//
// * float32 at every D (flash_attention_fwd_f32_kernel; the model twin and
//   every float32-compute config): FFMA on the CUDA cores only (no TF32,
//   p kept float32 for P V, as the Pallas kernel does), D at run time.  A
//   block of 256 threads takes a 64-row q tile; each thread holds a 4 x 4
//   register tile of every 64 x 64 score tile (fed by 16-byte shared
//   loads: 8 FFMA per LDS.128 in Q K^T, 16 per two in P V) and O's 4 rows
//   x 4 columns of each 64-column group (at most 8 groups, 128 floats; D >
//   512 splits the groups over two blocks on the grid, which both compute
//   Q K^T).  Q/K in 32-wide d chunks and V in 64-column chunks stream
//   through a three-stage cp.async ring, so shared memory is 72,704 bytes
//   at every D.  Bound by operations: 4 D FFMA-flops per live pair at the
//   67 TFLOP/s float32 rate.
//
// Bound at smollm-360m's prefill shapes (B = 4, H = 15, Hkv = 5, S = 2048,
// D = 64, 512-blocks; live causal (q, k) pairs S(S+1)/2 = 2,098,176 per
// (b, h)): 4 * D * pairs * B * H = 32.2 GFLOP, 0.033 ms at the bf16
// tensor-core rate (989 TFLOP/s); about 42 MB of q, k, v and out, 0.013 ms
// at 3.35 TB/s.  The bf16 kernels are bound by operations.  mma.sync
// reaches only part of the wgmma rate, every warp reads the whole K/V
// sub-tile from shared memory (1/8 byte per FMA: at most half the
// tensor-core rate), and a warp's softmax does not overlap its own
// products; wgmma with TMA and ping-pong warpgroups are later work.  The
// wide kernel also re-reads its Q fragment per k-step (three ldmatrix feed
// four products in Q K^T) and holds one block an SM.
//
// Built without --use_fast_math: the float32 kernel's expf and every
// kernel's tanhf are the accurate library functions.  The C entry point
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
// bfloat16 at D = 257 .. kRtMaxD: the same machinery, the width at run time;
// two warpgroups a block split Q K^T's reduction and O's columns
// ---------------------------------------------------------------------------

// the largest D the port takes, for the wide and the float32 kernels (the
// domain its tests pin; the wide kernel's shared memory would hold D <= 640)
constexpr int kRtMaxD = 593;
constexpr int kWideKvRows = 32;              // K/V rows per sub-tile
constexpr int kWideCols = 256;               // the most O columns a warpgroup holds
constexpr int kWideThreads = 2 * kTcThreads; // two warpgroups

using bf16 = __nv_bfloat16;

// The helpers below hold the instance kernel's schedule walk and softmax for
// the wide kernel.  The instance kernel keeps its own inline copy: built
// from these helpers it used fewer registers at D = 256 (248, not 254) and
// ran 1-2.5 % slower at gemma2-2b's and smollm-360m's prefill shapes
// (measured on an H100).

// The q tile of a block: rows [lo, hi) of q block qblk, positions and
// segment ids of this thread's two accumulator rows (warp * 16 + g and
// + 8), and the schedule's sub-tiles of N K/V rows that causality and the
// window leave live, in order (the t-th KV block's sub-th N rows).
struct QTile {
  const Params& p;
  int lo, hi, qblk, qmin, qmax, count, subs, t = 0, sub = 0, n;
  const int* index;
  int pos[2], seg[2];

  __device__ QTile(const Params& p_, int tile, int b, int warp, int g, int n_)
      : p(p_), n(n_) {
    const int tiles = (p.block_q + kRows - 1) / kRows;
    qblk = tile / tiles;
    lo = qblk * p.block_q + (tile % tiles) * kRows;
    hi = min(lo + kRows, (qblk + 1) * p.block_q);
    qmin = p.q_offset + lo;
    qmax = p.q_offset + hi - 1;
    count = p.kv_count[qblk];
    index = p.kv_index + (long long)qblk * p.max_nk;
    subs = (p.block_k + n - 1) / n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lo + warp * 16 + g + 8 * r;
      pos[r] = p.q_offset + row;
      seg[r] = (p.q_seg != nullptr && row < hi)
                   ? p.q_seg[(long long)b * p.Sq + row] : 0;
    }
  }

  // moves to the next live sub-tile [k_lo, k_hi); false past the last
  __device__ bool seek(int& k_lo, int& k_hi) {
    for (; t < count; ++t, sub = 0) {
      const int kb = __ldg(index + t);
      for (; sub < subs; ++sub) {
        k_lo = kb * p.block_k + sub * n;
        k_hi = min(k_lo + n, (kb + 1) * p.block_k);
        if (p.causal && k_lo > qmax) continue;
        if (p.window >= 0 && k_hi - 1 <= qmin - p.window) continue;
        ++sub;
        return true;
      }
    }
    return false;
  }

  // some pair of the sub-tile may be masked (or a row is past the block)
  __device__ bool masked(int k_lo, int k_hi) const {
    return k_hi - k_lo < n || (p.causal && k_hi - 1 > qmin) ||
           (p.window >= 0 && k_lo <= qmax - p.window) || p.q_seg != nullptr;
  }
};

// Scores in log2 units: x = s * mult; with a softcap s is first replaced by
// cap * log2(e) * tanh(s * scale / cap) and mult = 1.
struct ScoreMap {
  bool capped;
  float mult, cap_l2, scale_cap;
  __device__ explicit ScoreMap(const Params& p)
      : capped(p.softcap > 0.0f),
        mult(p.softcap > 0.0f ? 1.0f : p.scale * kLog2e),
        cap_l2(p.softcap * kLog2e),
        scale_cap(p.softcap > 0.0f ? p.scale / p.softcap : 0.0f) {}
};

// Softcap, masks and the online softmax of one warp's 16 x 8 kNt score tile
// of KV rows [k_lo, k_hi).  s[n][e] is row g + 8 (e >> 1), column k_lo +
// 8n + 2 tig + (e & 1).  On return s holds p, m and l have moved on, and the
// accumulator rows (acc[.][2r], acc[.][2r + 1] of row r) are rescaled.
template <int kNt, int kDt>
__device__ __forceinline__ void softmax_tile(float (&s)[kNt][4],
                                             float (&acc)[kDt][4],
                                             float (&m)[2], float (&l)[2],
                                             const QTile& q, const ScoreMap& f,
                                             int b, int k_lo, int k_hi,
                                             int tig) {
  static_assert(kNt * 4 <= 32, "the dead-score mask is one 32-bit word");
  const Params& p = q.p;
  if (f.capped) {
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = f.cap_l2 * tanhf(s[n][e] * f.scale_cap);
  }
  // bit 4n + e of dead marks s[n][e] masked
  uint32_t dead = 0;
  if (q.masked(k_lo, k_hi)) {
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
          if (p.causal) ok = ok && kpos <= q.pos[r];
          if (p.window >= 0) ok = ok && kpos > q.pos[r] - p.window;
          if (p.q_seg != nullptr) ok = ok && q.seg[r] == kseg;
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
    const float m_new = fmaxf(m[r], mx * f.mult);
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
                           : exp2_sfu(fmaf(s[n][e], f.mult, -m[e >> 1]));
      l[e >> 1] += pr;
      s[n][e] = pr;
    }
}

// P's accumulator pairs of k-step kk as an A fragment, rounded to bf16
template <int kNt>
__device__ __forceinline__ void p_fragment(const float (&s)[kNt][4], int kk,
                                           uint32_t (&pf)[4]) {
  pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// D padded to Dp (a multiple of 64); O cut into nc = 2 (Dp <= 512) or 4
// chunks of cw columns (a multiple of 16), two a block: the grid's nc / 2
// blocks of one q tile each keep V's columns [2 cw j, 2 cw (j + 1)) in
// shared memory, vs 16-byte chunks a row (a multiple of 8, so the swizzle
// stays inside the row).
struct WideShape {
  int dp, nc, cw, vs;
  __host__ __device__ explicit WideShape(int D)
      : dp((D + 63) / 64 * 64),
        nc(dp <= 2 * kWideCols ? 2 : 4),
        cw(((dp + nc - 1) / nc + 15) / 16 * 16),
        vs((2 * cw / 8 + 7) / 8 * 8) {}
  // Q, the two-stage K and V rings, the partial scores exchanged
  __host__ __device__ size_t smem_bytes() const {
    return (size_t)(kRows * dp + kStages * kWideKvRows * (dp + 8 * vs)) * 2 +
           (size_t)2 * kRows * kWideKvRows * 4;
  }
};

// Copy rows [0, rows) (the rest of the R-row tile zero) of the 16-byte
// chunks [c0 / 8, c0 / 8 + n8) of a row-major (., D) bf16 matrix into a
// swizzled shared tile of s8 chunks a row (chunk c of row r at c ^ (r & 7));
// columns at or past D are zero.  aligned (D a multiple of 8, rows 16-byte
// aligned): cp.async, zero-filled past D; else element loads, stored to
// shared memory at once.  All kWideThreads threads take part, each stepping
// its (row, chunk) without a division.
__device__ __forceinline__ void load_wide(bf16* dst, const bf16* src, int R,
                                          int rows, int c0, int n8, int s8,
                                          int D, bool aligned, int tid) {
  const int dr = kWideThreads / n8, dc = kWideThreads % n8;
  for (int r = tid / n8, c = tid % n8; r < R;
       r += dr + (c + dc >= n8), c = c + dc >= n8 ? c + dc - n8 : c + dc) {
    const int col = c0 + 8 * c;
    bf16* d = dst + (r * s8 + (c ^ (r & 7))) * 8;
    if (aligned) {
      const bool live = r < rows && col < D;
      cp_async16(smem_addr(d), src + (live ? (long long)r * D + col : 0),
                 live);
    } else {
      const unsigned short* row =
          reinterpret_cast<const unsigned short*>(src) + (long long)r * D;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c2 = col + 2 * i;
        const uint32_t lo = r < rows && c2 < D ? row[c2] : 0u;
        const uint32_t hi = r < rows && c2 + 1 < D ? row[c2 + 1] : 0u;
        w[i] = lo | hi << 16;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// barrier of the `count` threads that use barrier `id` (1 .. 15)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Block (bh * nc / 2 + j, q tile): warpgroup wg (warps 4 wg .. 4 wg + 3)
// owns O chunk 2 j + wg; warp wq = warp mod 4 owns q rows 16 wq .. + 15 in
// both warpgroups.  Per sub-tile each warp computes its rows' partial
// S = Q K^T over its warpgroup's half of the k-steps, the two warps of a
// row group swap partials through shared memory (a named barrier of 64
// threads) and both add them in one order, so S, m and l are bit-identical
// in both; each then accumulates P V for its own chunk.
__global__ void __launch_bounds__(kWideThreads)
flash_attention_fwd_wide_kernel(const Params p, int D, int aligned) {
  constexpr int N = kWideKvRows;    // K/V rows per sub-tile
  constexpr int kNt = N / 8;        // 8-column tiles of S
  constexpr int kDt = kWideCols / 8;  // 8-column tiles of O (at most)
  const WideShape ws(D);
  const int C = ws.dp / 8;          // 16-byte chunks of a Q or K row
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);    // kRows x Dp
  bf16* sK = sQ + kRows * ws.dp;                   // stage s: N x Dp
  bf16* sV = sK + kStages * N * ws.dp;             // stage s: N x 8 vs
  float* sS = reinterpret_cast<float*>(sV + kStages * N * 8 * ws.vs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3, sw = lane & 7;
  const int pair = blockIdx.x % (ws.nc / 2), bh = blockIdx.x / (ws.nc / 2);
  const int vc0 = 2 * pair * ws.cw;                // V's first column here
  const int vcols = min(2 * ws.cw, ws.dp - vc0);
  const int c0 = wg * ws.cw;                       // O chunk, from vc0
  const int ncols = min(ws.cw, vcols - c0);
  // this warpgroup's 4-k-step groups of Q K^T
  const int groups = ws.dp / 64;
  const int k8_lo = wg * groups / 2, k8_hi = (wg + 1) * groups / 2;
  const int h = bh % p.H, b = bh / p.H;
  const int hk = h / (p.H / p.Hkv);
  QTile qt(p, gridDim.y - 1 - blockIdx.y, b, wq, g, N);

  const bf16* q = (const bf16*)p.q + ((long long)b * p.H + h) * p.Sq * D;
  const bf16* k = (const bf16*)p.k + ((long long)b * p.Hkv + hk) * p.Skv * D;
  const bf16* v = (const bf16*)p.v + ((long long)b * p.Hkv + hk) * p.Skv * D;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kDt][4];
#pragma unroll
  for (int dt = 0; dt < kDt; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  const bool vec = aligned != 0;
  auto load_kv = [&](int k_lo, int k_hi, int stage) {
    load_wide(sK + stage * N * ws.dp, k + (long long)k_lo * D, N, k_hi - k_lo,
              0, C, C, D, vec, tid);
    load_wide(sV + stage * N * 8 * ws.vs, v + (long long)k_lo * D, N,
              k_hi - k_lo, vc0, vcols / 8, ws.vs, D, vec, tid);
  };

  // ldmatrix row addresses as in flash_attention_fwd_bf16_kernel; a group
  // of four k-steps spans 8 chunks (128 bytes), so within it the swizzled
  // chunk of k-step i is 8 k8 + ((2 i + chunk) ^ sw)
  const int q_row = wq * 16 + (lane & 15), q_chunk = lane >> 4;
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_chunk = lane >> 4;
  const uint32_t qa = smem_addr(sQ + q_row * C * 8);
  // this lane's 16 partial scores, lane-major: the partner warp's lane
  // holds the same (row, column) elements
  float* part_mine = sS + ((wg * 4 + wq) * 16) * 32 + lane;
  float* part_other = sS + (((wg ^ 1) * 4 + wq) * 16) * 32 + lane;

  const ScoreMap f(p);
  int cur_lo = 0, cur_hi = 0, nxt_lo = 0, nxt_hi = 0;
  bool live = qt.seek(cur_lo, cur_hi);
  if (live) {
    load_wide(sQ, q + (long long)qt.lo * D, kRows, qt.hi - qt.lo, 0, C, C, D,
              vec, tid);
    load_kv(cur_lo, cur_hi, 0);
    cp_async_commit();
  }
  for (int stage = 0; live; stage ^= 1) {
    const bool more = qt.seek(nxt_lo, nxt_hi);
    if (more) {
      load_kv(nxt_lo, nxt_hi, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // this sub-tile (and Q) visible to every warp
    const bf16* cK = sK + stage * N * ws.dp;
    const bf16* cV = sV + stage * N * 8 * ws.vs;

    // partial S = Q K^T over this warpgroup's k-steps: 16 x N per warp,
    // the Q fragment re-read per k-step (O fills the registers)
    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const uint32_t ka = smem_addr(cK + k_row * C * 8);
#pragma unroll 4
    for (int k8 = k8_lo; k8 < k8_hi; ++k8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t af[4];
        ldmatrix_x4(qa + k8 * 128 + (((2 * i + q_chunk) ^ sw) << 4), af);
#pragma unroll
        for (int n2 = 0; n2 < kNt / 2; ++n2) {
          uint32_t bk[4];
          ldmatrix_x4(ka + n2 * 256 * C + k8 * 128 +
                          (((2 * i + k_chunk) ^ sw) << 4),
                      bk);
          mma_bf16(s[2 * n2], af, bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], af, bk[2], bk[3]);
        }
      }
    }
    // S = partial of warpgroup 0 + partial of warpgroup 1, in that order
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part_mine[(4 * n + e) * 32] = s[n][e];
    named_barrier(1 + wq, 64);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float other = part_other[(4 * n + e) * 32];
        s[n][e] = wg == 0 ? s[n][e] + other : other + s[n][e];
      }

    softmax_tile(s, acc, m, l, qt, f, b, cur_lo, cur_hi, tig);

    // O[:, chunk] += P V[:, chunk]
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t pf[4];
      p_fragment<kNt>(s, kk, pf);
#pragma unroll
      for (int d2 = 0; d2 < kDt / 2; ++d2) {
        if (16 * d2 < ncols) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              smem_addr(cV + ((kk * 16 + v_row) * ws.vs +
                              ((c0 / 8 + 2 * d2 + v_chunk) ^ sw)) * 8),
              bv);
          mma_bf16(acc[2 * d2], pf, bv[0], bv[1]);
          mma_bf16(acc[2 * d2 + 1], pf, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage (and the
                       // partials) before their reuse
    cur_lo = nxt_lo;
    cur_hi = nxt_hi;
    live = more;
  }

  bf16* out = (bf16*)p.out + ((long long)b * p.H + h) * p.Sq * D;
  const int oc0 = vc0 + c0;   // this chunk's first output column
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float safe = l[r] > 0.0f ? l[r] : 1.0f;
    const int row = qt.lo + wq * 16 + g + 8 * r;
    if (row >= qt.hi) continue;
    bf16* orow = out + (long long)row * D;
#pragma unroll
    for (int dt = 0; dt < kDt; ++dt) {
      const int col = oc0 + 8 * dt + 2 * tig;
      if (8 * dt >= ncols || col >= D) continue;
      const float a0 = acc[dt][2 * r] / safe, a1 = acc[dt][2 * r + 1] / safe;
      if (vec) {          // D a multiple of 8: col + 1 < D, 4-byte aligned
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(a0, a1);
      } else {
        orow[col] = __float2bfloat16_rn(a0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16_rn(a1);
      }
    }
  }
}

cudaError_t launch_wide(const Params& p, int B, int nq, int D, bool aligned,
                        cudaStream_t stream) {
  if (D <= 256 || D > kRtMaxD) return cudaErrorInvalidValue;
  const WideShape ws(D);
  const size_t smem = ws.smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)nq * ((p.block_q + kRows - 1) / kRows);
  const long long blocks = (long long)B * p.H * (ws.nc / 2);
  if (tiles > 65535 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  flash_attention_fwd_wide_kernel<<<grid, kWideThreads, smem, stream>>>(
      p, D, aligned ? 1 : 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 at any width: register micro-tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;      // q rows per tile
constexpr int kF32Keys = 64;      // K/V rows per sub-tile
constexpr int kF32Threads = 256;  // a 16 x 16 grid of 4 x 4 score tiles
constexpr int kF32Dk = 32;        // d values per Q/K chunk
constexpr int kF32Ld = kF32Dk + 4;      // Q/K chunk row stride (floats)
constexpr int kF32Vc = 64;        // V columns per chunk (one O column group)
constexpr int kF32PLd = kF32Rows + 4;   // P^T row stride (floats)
// a ring stage: one Q and one K chunk, or one V chunk (64 x 64 floats)
constexpr int kF32Stage = 2 * kF32Rows * kF32Ld;
constexpr int kF32Stages = 3;
// O column groups a block holds: 4 rows x 4 columns x 8 = 128 floats a
// thread; wider heads split their groups over a grid axis, each block
// computing Q K^T in full.  (Two halves of a 512-thread block, each adding
// a partial Q K^T over half the d values, gained 2 % at D = 512 and moved
// the result 3e-5 from the plain version there: past FLASH_TOL.)
constexpr int kF32MaxGroups = 8;
constexpr size_t kF32SmemBytes =
    (size_t)(kF32Stages * kF32Stage + kF32Keys * kF32PLd) * sizeof(float);
static_assert(kF32Keys * kF32Vc <= kF32Stage, "a V chunk fits a stage");

// 4 bytes global -> shared, asynchronous; zero-filled when !live
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 4 : 0));
}

// The schedule's K/V sub-tiles of kF32Keys rows that causality and the
// window leave live for the q tile whose positions are [qmin, qmax], in
// order: the sub-th sub-tile of the t-th scheduled KV block, keys [lo, hi).
struct F32Walk {
  int t = 0, sub = 0, lo = 0, hi = 0;

  // settle on the first live sub-tile at or after (t, sub); false at the end
  __device__ __forceinline__ bool settle(const Params& p, const int* index,
                                         int count, int qmin, int qmax) {
    const int subs = (p.block_k + kF32Keys - 1) / kF32Keys;
    for (; t < count; ++t, sub = 0) {
      const int kb = index[t];
      const int kb_end = (kb + 1) * p.block_k;
      for (; sub < subs; ++sub) {
        lo = kb * p.block_k + sub * kF32Keys;
        hi = min(lo + kF32Keys, kb_end);
        if (p.causal && lo > qmax) continue;
        if (p.window >= 0 && hi - 1 <= qmin - p.window) continue;
        return true;
      }
    }
    return false;
  }
};

// Float32 flash attention, FFMA only, D at run time (the q tile's O column
// groups a compile-time bound CG).  Block: 256 threads, one 64-row q tile of
// one (batch, head) and, for heads above 8 groups of 64 columns, one chunk
// of O's columns (blockIdx.y % nchunk).  Thread (ty, tx) = (tid / 16, tid %
// 16) owns rows 4 ty + i and keys tx + 16 j (i, j < 4) of each 64 x 64 score
// tile, and O's columns col0 + 64 c + 4 tx + e (c < ncg, e < 4) of its rows.
//
// Per live K/V sub-tile a sequence of jobs runs through a three-stage
// cp.async ring (two jobs in flight while one computes, one barrier a job):
// ceil(D / 32) Q/K chunks (64 rows x 32 d of each, row-major at stride 36),
// then ncg V chunks (64 keys x 64 columns).  A Q/K chunk adds to the 4 x 4
// scores: per 4 d values, 4 LDS.128 of K (keys tx + 16 j: eight
// consecutive rows at stride 36 floats fall in eight bank groups) and 4 of
// Q (two addresses a warp, broadcast) feed 64 FFMA.  Then the online
// softmax in registers (the row's 16 threads are one half-warp), P^T to
// shared memory as one STS.128 per key (4 rows), and per V chunk and key
// one LDS.128 of P (4 rows) and one of V (4 columns) feed 16 FFMA.
//
// q is reloaded per sub-tile with K, chunk by chunk, so shared memory does
// not grow with D (72,704 bytes).  Rows and pieces past the tile, the KV
// block or D zero-fill.  16-byte copies when vec (D % 4 == 0 and q, k, v,
// out 16-byte aligned), else 4-byte copies; indices by shifts and masks.
// Sums run over d and over keys in increasing order, as the scalar kernel
// before this one did; expf and tanhf are the accurate library functions.
template <int CG>
__global__ void __launch_bounds__(kF32Threads, CG <= 2 ? 2 : 1)
flash_attention_fwd_f32_kernel(const Params p, int D, int gpc, int nchunk,
                               int tiles, int vec) {
  // the d loop unrolled in full only where the registers allow it
  constexpr int kDdUnroll = CG == 1 ? kF32Dk / 4 : 2;
  extern __shared__ __align__(16) float f32_smem[];
  float* sP = f32_smem + kF32Stages * kF32Stage;   // P^T: kF32Keys x kF32PLd

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int tile = tiles - 1 - (blockIdx.z * gridDim.y + blockIdx.y);
  if (tile < 0) return;
  const int chunk = blockIdx.x % nchunk;
  const int bh = blockIdx.x / nchunk;
  const int h = bh % p.H, b = bh / p.H;
  const int hk = h / (p.H / p.Hkv);
  const int per_block = (p.block_q + kF32Rows - 1) / kF32Rows;
  const int qblk = tile / per_block;
  const int q_lo = qblk * p.block_q + (tile % per_block) * kF32Rows;
  const int q_hi = min(q_lo + kF32Rows, (qblk + 1) * p.block_q);
  const int qmin = p.q_offset + q_lo, qmax = p.q_offset + q_hi - 1;
  const int col0 = chunk * gpc * kF32Vc;
  const int ncg = min(gpc, (D - col0 + kF32Vc - 1) / kF32Vc);
  const int ns = (D + kF32Dk - 1) / kF32Dk;
  const long long ld = D;

  const float* q = (const float*)p.q + ((long long)b * p.H + h) * p.Sq * ld;
  const float* k =
      (const float*)p.k + ((long long)b * p.Hkv + hk) * p.Skv * ld;
  const float* v =
      (const float*)p.v + ((long long)b * p.Hkv + hk) * p.Skv * ld;
  const int count = p.kv_count[qblk];
  const int* index = p.kv_index + (long long)qblk * p.max_nk;

  // -- the producer: the job sequence, two jobs ahead of the consumer ------
  F32Walk lw;
  bool l_live = lw.settle(p, index, count, qmin, qmax);
  int lj = 0;
  auto issue = [&](float* st) {
    if (!l_live) return;
    if (lj < ns) {                       // Q/K chunk lj: d in [32 lj, +32)
      float* sQ = st;
      float* sK = st + kF32Rows * kF32Ld;
      const int d0 = lj * kF32Dk;
      if (vec) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {    // 64 rows x 8 pieces of 4 floats
          const int e = tid + u * kF32Threads;
          const int r = e >> 3, c = (e & 7) << 2, d = d0 + c;
          const bool okq = q_lo + r < q_hi && d < D;
          const bool okk = lw.lo + r < lw.hi && d < D;
          cp_async16(smem_addr(sQ + r * kF32Ld + c),
                     okq ? q + (q_lo + r) * ld + d : q, okq);
          cp_async16(smem_addr(sK + r * kF32Ld + c),
                     okk ? k + (lw.lo + r) * ld + d : k, okk);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {    // 64 rows x 32 floats
          const int e = tid + u * kF32Threads;
          const int r = e >> 5, c = e & 31, d = d0 + c;
          const bool okq = q_lo + r < q_hi && d < D;
          const bool okk = lw.lo + r < lw.hi && d < D;
          cp_async4(smem_addr(sQ + r * kF32Ld + c),
                    okq ? q + (q_lo + r) * ld + d : q, okq);
          cp_async4(smem_addr(sK + r * kF32Ld + c),
                    okk ? k + (lw.lo + r) * ld + d : k, okk);
        }
      }
    } else {                             // V chunk: 64 keys x 64 columns
      const int c0 = col0 + (lj - ns) * kF32Vc;
      if (vec) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {    // 64 rows x 16 pieces of 4 floats
          const int e = tid + u * kF32Threads;
          const int r = e >> 4, c = (e & 15) << 2, col = c0 + c;
          const bool ok = lw.lo + r < lw.hi && col < D;
          cp_async16(smem_addr(st + r * kF32Vc + c),
                     ok ? v + (lw.lo + r) * ld + col : v, ok);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 16; ++u) {   // 64 rows x 64 floats
          const int e = tid + u * kF32Threads;
          const int r = e >> 6, c = e & 63, col = c0 + c;
          const bool ok = lw.lo + r < lw.hi && col < D;
          cp_async4(smem_addr(st + r * kF32Vc + c),
                    ok ? v + (lw.lo + r) * ld + col : v, ok);
        }
      }
    }
    if (++lj == ns + ncg) {
      lj = 0;
      ++lw.sub;
      l_live = lw.settle(p, index, count, qmin, qmax);
    }
  };

  // -- the consumer ---------------------------------------------------------
  int slot = 0;                          // the stage of the next job
  issue(f32_smem);
  cp_async_commit();
  issue(f32_smem + kF32Stage);
  cp_async_commit();
  // wait for the next job's copies, free the stage two jobs back, refill it
  auto step = [&]() -> const float* {
    cp_async_wait<1>();
    __syncthreads();
    const int fill = slot == 0 ? 2 : slot - 1;
    issue(f32_smem + fill * kF32Stage);
    cp_async_commit();
    const float* st = f32_smem + slot * kF32Stage;
    slot = slot == 2 ? 0 : slot + 1;
    return st;
  };

  int qseg[4];
  float m[4], l[4], acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + 4 * ty + i;
    qseg[i] = (p.q_seg != nullptr && row < q_hi)
                  ? p.q_seg[(long long)b * p.Sq + row] : 0;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CG; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  F32Walk w;
  for (bool live = w.settle(p, index, count, qmin, qmax); live;
       ++w.sub, live = w.settle(p, index, count, qmin, qmax)) {
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int jd = 0; jd < ns; ++jd) {
      const float* sQ = step();
      const float* sK = sQ + kF32Rows * kF32Ld;
#pragma unroll kDdUnroll
      for (int dd = 0; dd < kF32Dk; dd += 4) {
        float4 kv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              sK + (tx + 16 * j) * kF32Ld + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              sQ + (4 * ty + i) * kF32Ld + dd);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
    }

    // online softmax over this sub-tile's 64 keys; P^T to shared memory
    int kpos[4], kseg[4];
    bool kin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kpos[j] = w.lo + tx + 16 * j;
      kin[j] = kpos[j] < w.hi;
      kseg[j] = (p.kv_seg != nullptr && kin[j])
                    ? p.kv_seg[(long long)b * p.Skv + kpos[j]] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qmin + 4 * ty + i;
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        ok[j] = kin[j];
        if (p.causal) ok[j] = ok[j] && kpos[j] <= qpos;
        if (p.window >= 0) ok[j] = ok[j] && kpos[j] > qpos - p.window;
        if (p.q_seg != nullptr) ok[j] = ok[j] && qseg[i] == kseg[j];
        s[i][j] = ok[j] ? x : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      // every score of the row dead so far: m stays kNegInf, alpha = 1
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rsum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CG; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    // key tx + 16 j, rows 4 ty .. 4 ty + 3: eight consecutive keys of a
    // quarter-warp at stride 68 floats fall in eight bank groups
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(sP + (tx + 16 * j) * kF32PLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // O += P V, one 64-column group per job (the barrier of the first job
    // also publishes P)
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      if (c < ncg) {
        const float* sV = step();
#pragma unroll 8
        for (int kk = 0; kk < kF32Keys; ++kk) {
          const float4 pv =
              *reinterpret_cast<const float4*>(sP + kk * kF32PLd + 4 * ty);
          const float4 vv =
              *reinterpret_cast<const float4*>(sV + kk * kF32Vc + 4 * tx);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pr[i], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr[i], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr[i], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr[i], vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = (float*)p.out + ((long long)b * p.H + h) * p.Sq * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + 4 * ty + i;
    if (row >= q_hi) continue;
    const float safe = l[i] > 0.0f ? l[i] : 1.0f;
    float* orow = out + row * ld;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const int col = col0 + c * kF32Vc + 4 * tx;
      if (c >= ncg || col >= D) continue;
      if (vec) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][c][0] / safe, acc[i][c][1] / safe,
                        acc[i][c][2] / safe, acc[i][c][3] / safe);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) orow[col + e] = acc[i][c][e] / safe;
      }
    }
  }
}

template <int CG>
cudaError_t launch_f32_groups(const Params& p, int B, int tiles, int D,
                              int gpc, int nchunk, bool vec,
                              cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_f32_kernel<CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32SmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * p.H * nchunk;
  const int ty = tiles < 65535 ? tiles : 65535;
  const int tz = (tiles + ty - 1) / ty;
  if (blocks > 0x7fffffffLL || tz > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)ty, (unsigned)tz);
  flash_attention_fwd_f32_kernel<CG><<<grid, kF32Threads, kF32SmemBytes,
                                       stream>>>(p, D, gpc, nchunk, tiles,
                                                 vec ? 1 : 0);
  return cudaGetLastError();
}

// O's column groups of 64: up to kF32MaxGroups a block (D <= 512), else
// split evenly over nchunk blocks on the grid; an instance per bound on the
// groups (1, 2, 4, 8: O's registers set how many blocks share an SM), the
// run-time count ncg <= the bound inside.
cudaError_t launch_f32(const Params& p, int B, int nq, int D, bool vec,
                       cudaStream_t stream) {
  if (D < 1 || D > kRtMaxD) return cudaErrorInvalidValue;
  const int groups = (D + kF32Vc - 1) / kF32Vc;
  const int nchunk = (groups + kF32MaxGroups - 1) / kF32MaxGroups;
  const int gpc = (groups + nchunk - 1) / nchunk;
  const long long tiles =
      (long long)nq * ((p.block_q + kF32Rows - 1) / kF32Rows);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (gpc <= 1)
    return launch_f32_groups<1>(p, B, (int)tiles, D, gpc, nchunk, vec, stream);
  if (gpc <= 2)
    return launch_f32_groups<2>(p, B, (int)tiles, D, gpc, nchunk, vec, stream);
  if (gpc <= 4)
    return launch_f32_groups<4>(p, B, (int)tiles, D, gpc, nchunk, vec, stream);
  return launch_f32_groups<8>(p, B, (int)tiles, D, gpc, nchunk, vec, stream);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
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
    const bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                     aligned16(v) && aligned16(out);
    err = launch_f32(p, B, nq, D, vec, s);
  } else if (dtype == 1 && D > 256) {
    const bool aligned = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                         aligned16(v) && aligned16(out);
    err = launch_wide(p, B, nq, D, aligned, s);
  } else if (dtype == 1) {
    if (D == 64) err = launch_bf16<64>(p, B, nq, s);
    if (D == 128) err = launch_bf16<128>(p, B, nq, s);
    if (D == 256) err = launch_bf16<256>(p, B, nq, s);
  }
  return (int)err;
}

}  // extern "C"
