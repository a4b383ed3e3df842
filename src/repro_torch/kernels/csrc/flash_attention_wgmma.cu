// Hand-written CUDA kernel for block-sparse flash attention, forward, at
// head width 96 in bfloat16 (sm_90a): wgmma and TMA.
//
// Replaces the Pallas TPU kernel _flash_kernel of the JAX package's
// repro/kernels/flash_attention.py (src/repro/kernels/flash_attention.py:33,
// call :165) at D = 96 (phi-3-vision-4.2b's 32 heads of 96).  It computes
// what flash_attention_fwd_bf16_kernel (csrc/flash_attention.cu) computes,
// with the same Params and numerics:
//
//   out[b, h, r] = sum_c p[r, c] v[b, h / G, c] / l[r],   G = H / Hkv,
//
// over the key columns c of the KV blocks that the schedule lists for the
// query block of row r (kv_index[i, 0 .. kv_count[i])); s = scale * q.k in
// float32 sums of exact products, softcap * tanh(s / softcap) when softcap
// > 0, masked where not (causal: c <= pos; window: c > pos - window;
// segments equal), pos = q_offset + r; an online softmax in float32 whose
// masked probabilities are 0; p rounded to bf16 before P V (|p~ - p| <=
// 2^-9 p, so |out~ - out| <= 2^-9 max|v| before the output's own
// rounding); out = acc / (l > 0 ? l : 1), rounded to nearest even.
//
// Before it the wrapper zero-padded D = 96 to the D = 128 instance: a third
// more tensor work on zeros, three copies in and one out.  The PR-14 kernel
// cannot take 96 itself: its swizzle (16-byte chunk c of row r at c ^ (r &
// 7)) needs 8 chunks a row, and a 96-wide row has 12.
//
// Design (the hopper-kernels guide, section 1):
//
// * A block takes a 128-row q tile of one (batch, head): 384 threads, one
//   producer warpgroup and two consumer warpgroups of 64 q rows each.
//   setmaxnreg hands the producer's registers to the consumers at run time
//   (24 / 240 a thread); ptxas still allocates the consumer code within the
//   launch bound's 168, which it fits without spills (-Xptxas -v), so a
//   form with one producer warp and no setmaxnreg runs as fast.  Grid
//   (B * H, q tiles), the last q tile first: under a causal
//   schedule the longest tiles start first.  A q block shorter than 128
//   rows (block_q = 32 or 64) gets a tile of its own whose rows past the
//   block are neither computed nor stored (a consumer warpgroup with no
//   row of the block only keeps the ring moving).
// * Layout.  A 96-wide bf16 row is 192 bytes, which no swizzle span
//   covers (128 bytes at most).  Every tile (Q, K, V) is three panels of
//   32 columns, each rows x 64 bytes in the 64-byte swizzle (16-byte chunk
//   c of row r at c ^ ((r >> 1) & 3); an 8-row core matrix of 16-byte
//   chunks falls in 8 distinct bank groups).  TMA writes each panel with
//   one box of 32 columns x 128 rows (CU_TENSOR_MAP_SWIZZLE_64B); the
//   wgmma descriptors read the same swizzle.
// * S = Q K^T: wgmma m64n128k16, A (Q) and B (K) K-major in shared
//   memory, six k-steps of 16 (two a panel), float32 in registers.
// * O += P V: wgmma m64n96k16 with P from registers (the accumulator's
//   pairs rounded to bf16 are the A fragments) and V as the transposed
//   (MN-major) B operand: the three 32-column panels are the three swizzle
//   atoms along N, one descriptor a k-step (leading byte offset = a panel).
//   Eight k-steps cover 128 K/V rows.
// * K/V tiles of 128 rows arrive by TMA into a three-stage ring, each stage
//   completed on an mbarrier (full: the producer's expect_tx and the TMA
//   bytes) and released on another (empty: an arrival from every consumer
//   thread).  Rows past the tensor's end are zero-filled by TMA; rows past
//   the scheduled KV block but inside the tensor are read and masked (p =
//   0), so they must be finite, as every row of a model's K/V is.
// * The producer and both consumers walk the same schedule: the sub-tiles
//   of 128 K/V rows that causality and the window leave live for the
//   block's q tile.  A consumer warpgroup skips the products of a sub-tile
//   that masks all of its own 64 rows (the identity: alpha = 1, p = 0).
// * Softmax in registers as the PR-14 kernel: softcap (tanhf), masks from
//   absolute positions and segment ids, the row max by two xor-shuffles
//   among the four lanes of an accumulator row, 2^x by ex2.approx.ftz with
//   scale * log2(e) folded into its FMA.
//   Shared memory: Q 24,576 B + 3 stages x 49,152 B + barriers + 1,024 B
//   of alignment slack = 173,120 B: one block (12 warps) an SM.
//
// Bound at phi-3-vision's prefill shapes (B = 4, H = Hkv = 32, S = 2048,
// causal 512-blocks): 4 D flop per live (q, k) pair, S (S + 1) / 2 pairs a
// (b, h): 103.1 GFLOP, 0.1043 ms at 989 TFLOP/s; 201 MB of q, k, v and
// out, 0.0601 ms at 3.35 TB/s: bound by operations.  Within a consumer
// warpgroup the softmax does not overlap its own products (the two
// warpgroups of a block overlap each other).  Measured on an H100, it runs
// at about a quarter of the tensor-core rate, and neither the softmax, nor
// a third of the K/V loads, nor one of the two products accounts for most
// of the time: taken out one at a time (in throwaway variants) each moved
// it by a few percent.  So did each of four redesigns: S of one sub-tile
// issued with P V of the last one and ping-pong between the warpgroups on
// named barriers; 64-row K/V sub-tiles; three consumer warpgroups on 192
// q rows; a grid that runs the q tiles of one head side by side.
//
// The C entry point flash_attention_fwd_wgmma builds the three TMA
// descriptors on the host (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint: no link against libcuda), launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (or the error of a descriptor it could not build).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

constexpr int kD = 96;
constexpr int kPanelCols = 32;                 // 64 bytes: one swizzle span
constexpr int kPanels = kD / kPanelCols;       // 3
constexpr int kPanelRow = kPanelCols * 2;      // bytes of a panel row
constexpr int kQTile = 128;                    // q rows a block
constexpr int kWgRows = 64;                    // q rows a consumer warpgroup
constexpr int kKv = 128;                       // K/V rows a stage
constexpr int kStages = 3;
constexpr int kThreads = 384;                  // producer + two consumers
constexpr int kNt = kKv / 8;                   // 8-column tiles of S
constexpr int kDt = kD / 8;                    // 8-column tiles of O
constexpr int kQBytes = kQTile * kD * 2;       // 24,576
constexpr int kKvBytes = kKv * kD * 2;         // 24,576: K or V of a stage
constexpr int kStageBytes = 2 * kKvBytes;      // 49,152
constexpr int kBarBytes = 64;
constexpr int kSmemBytes =
    1024 + kQBytes + kStages * kStageBytes + kBarBytes;   // 173,120

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that lasts
// about 10 s (2^34 cycles) traps: a broken schedule or descriptor becomes a
// CUDA error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > (1LL << 34)) {
      __trap();
    }
  }
}

// ---- TMA ------------------------------------------------------------------

// one box of the 3-D map (columns, rows, heads) at (c0, c1, c2) into shared
// memory at dst, its bytes counted on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// A shared-memory matrix descriptor in the 64-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 2.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16, K-major in shared memory) *
// B (128 x 16, bf16, K-major in shared memory); d[j][e] as mma.sync's C
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4], uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 96, f32) += A (64 x 16, bf16, in registers as mma.sync's A
// fragment) * B (16 x 96, bf16, MN-major in shared memory: transposed)
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[12][4],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two floats -> one register of two bf16 (lo in the low half), RNE
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the SFU (relative error about 2^-22; results below 2^-126 flush
// to 0), for x <= 0 here
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The schedule's sub-tiles of kKv K/V rows in order (the t-th KV block's
// sub-th kKv rows) that causality and the window leave live for the q
// positions [qmin, qmax]; the producer and the consumers walk it alike.
struct KvWalk {
  const Params& p;
  const int* index;
  int count, subs, qmin, qmax, t = 0, sub = 0;

  __device__ KvWalk(const Params& p_, int qblk, int qmin_, int qmax_)
      : p(p_), qmin(qmin_), qmax(qmax_) {
    count = p.kv_count[qblk];
    index = p.kv_index + (long long)qblk * p.max_nk;
    subs = (p.block_k + kKv - 1) / kKv;
  }

  // moves to the next live sub-tile [k_lo, k_hi); false past the last
  __device__ bool seek(int& k_lo, int& k_hi) {
    for (; t < count; ++t, sub = 0) {
      const int kb = __ldg(index + t);
      for (; sub < subs; ++sub) {
        k_lo = kb * p.block_k + sub * kKv;
        k_hi = min(k_lo + kKv, (kb + 1) * p.block_k);
        if (p.causal && k_lo > qmax) continue;
        if (p.window >= 0 && k_hi - 1 <= qmin - p.window) continue;
        ++sub;
        return true;
      }
    }
    return false;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_d96_kernel(const Params p,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_raw[];
  // panels in the 64-byte swizzle repeat every 512 bytes: align the base
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                  // 3 panels of kQTile rows
  const uint32_t sRing = sQ + kQBytes;       // stage s: K panels, V panels
  const uint32_t bars = sRing + kStages * kStageBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u + 8u * s; };
  auto empty = [&](int s) { return bars + 8u + 8u * (kStages + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles = (p.block_q + kQTile - 1) / kQTile;
  const int tile = gridDim.y - 1 - blockIdx.y;   // longest causal tiles first
  const int qblk = tile / tiles;
  const int q_lo = qblk * p.block_q + (tile % tiles) * kQTile;
  const int q_hi = min(q_lo + kQTile, (qblk + 1) * p.block_q);
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int hk = h / (p.H / p.Hkv);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      KvWalk walk(p, qblk, p.q_offset + q_lo, p.q_offset + q_hi - 1);
      int k_lo = 0, k_hi = 0;
      bool live = walk.seek(k_lo, k_hi);
      if (live) {
        mbar_expect_tx(q_full, kQBytes);
        for (int c = 0; c < kPanels; ++c)
          tma_load(sQ + c * kQTile * kPanelRow, &tq, c * kPanelCols, q_lo,
                   b * p.H + h, q_full);
      }
      for (int i = 0; live; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageBytes);
        const uint32_t sK = sRing + s * kStageBytes, sV = sK + kKvBytes;
        for (int c = 0; c < kPanels; ++c) {
          tma_load(sK + c * kKv * kPanelRow, &tk, c * kPanelCols, k_lo,
                   b * p.Hkv + hk, full(s));
          tma_load(sV + c * kKv * kPanelRow, &tv, c * kPanelCols, k_lo,
                   b * p.Hkv + hk, full(s));
        }
        live = walk.seek(k_lo, k_hi);
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1, wtid = tid & 127;
    const int warp = wtid >> 5, lane = wtid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int wg_lo = q_lo + cw * kWgRows;
    const bool wg_live = wg_lo < q_hi;
    const int wg_qmin = p.q_offset + wg_lo;
    const int wg_qmax = p.q_offset + min(wg_lo + kWgRows, q_hi) - 1;

    // this thread's accumulator rows: warp * 16 + g (r = 0) and + 8 (r = 1)
    int qpos[2], qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg_lo + warp * 16 + g + 8 * r;
      qpos[r] = p.q_offset + row;
      qseg[r] = (p.q_seg != nullptr && row < q_hi)
                    ? p.q_seg[(long long)b * p.Sq + row] : 0;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    float o[kDt][4];
#pragma unroll
    for (int j = 0; j < kDt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

    // scores in log2 units: x = s * mult; with a softcap s is first
    // replaced by cap * log2(e) * tanh(s * scale / cap) and mult = 1
    const bool capped = p.softcap > 0.0f;
    const float mult = capped ? 1.0f : p.scale * kLog2e;
    const float cap_l2 = p.softcap * kLog2e;
    const float scale_cap = capped ? p.scale / p.softcap : 0.0f;

    // this warpgroup's Q rows in each panel: 64 rows x 64 bytes further
    const uint32_t sQw = sQ + cw * kWgRows * kPanelRow;
    KvWalk walk(p, qblk, p.q_offset + q_lo, p.q_offset + q_hi - 1);
    int k_lo = 0, k_hi = 0;
    bool live = walk.seek(k_lo, k_hi);
    if (live) mbar_wait(q_full, 0);
    for (int i = 0; live; ++i) {
      const int s = i % kStages;
      mbar_wait(full(s), (i / kStages) & 1);
      const uint32_t sK = sRing + s * kStageBytes, sV = sK + kKvBytes;
      const bool skip = !wg_live || (p.causal && k_lo > wg_qmax) ||
                        (p.window >= 0 && k_hi - 1 <= wg_qmin - p.window);
      if (!skip) {
        // S = Q K^T: six k-steps of 16, two in each 32-column panel
        float sc[kNt][4];
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks) {
          const uint32_t off = (ks & 1) * 32u;   // bytes into the panel row
          const uint64_t da = desc_sw64(
              sQw + (ks >> 1) * kQTile * kPanelRow + off, 16, 8 * kPanelRow);
          const uint64_t db = desc_sw64(
              sK + (ks >> 1) * kKv * kPanelRow + off, 16, 8 * kPanelRow);
          wgmma_m64n128k16_ss(sc, da, db, ks > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // softcap, masks, online softmax.  sc[n][e] is row g + 8 (e >> 1)
        // of the warp's 16, column k_lo + 8n + 2 tig + (e & 1); a masked
        // score becomes -inf, so its p is 0 and it never sets the max
        const bool masked = k_hi - k_lo < kKv ||
                            (p.causal && k_hi - 1 > wg_qmin) ||
                            (p.window >= 0 && k_lo <= wg_qmax - p.window) ||
                            p.q_seg != nullptr;
        if (capped) {
#pragma unroll
          for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[n][e] = cap_l2 * tanhf(sc[n][e] * scale_cap);
        }
        if (masked) {
#pragma unroll
          for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kpos = k_lo + 8 * n + 2 * tig + c;
              const bool kin = kpos < k_hi;
              const int kseg = (p.kv_seg != nullptr && kin)
                                   ? p.kv_seg[(long long)b * p.Skv + kpos]
                                   : 0;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                bool ok = kin;
                if (p.causal) ok = ok && kpos <= qpos[r];
                if (p.window >= 0) ok = ok && kpos > qpos[r] - p.window;
                if (p.q_seg != nullptr) ok = ok && qseg[r] == kseg;
                if (!ok) sc[n][2 * r + c] = -INFINITY;
              }
            }
        }
        // row max; the four lanes of a row are 4g .. 4g + 3
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < kNt; ++n)
            mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // every score of the row dead so far: m stays kNegInf, alpha = 1
          const float m_new = fmaxf(m[r], mx * mult);
          alpha[r] = exp2_sfu(m[r] - m_new);
          m[r] = m_new;
          l[r] *= alpha[r];   // this lane's share; summed over the row last
        }
#pragma unroll
        for (int j = 0; j < kDt; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
        // p, 0 where dead
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pr =
                sc[n][e] == -INFINITY
                    ? 0.0f
                    : exp2_sfu(fmaf(sc[n][e], mult, -m[e >> 1]));
            l[e >> 1] += pr;
            sc[n][e] = pr;
          }
        // P's accumulator pairs of k-step kk are its A fragment (bf16)
        uint32_t pf[kKv / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKv / 16; ++kk) {
          pf[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pf[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pf[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pf[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        }

        // O += P V: V's three panels are the three 32-column swizzle atoms
        // along N (leading byte offset: one panel); 16 rows a k-step
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKv / 16; ++kk)
          wgmma_m64n96k16_rs(
              o, pf[kk],
              desc_sw64(sV + kk * 16 * kPanelRow, kKv * kPanelRow,
                        8 * kPanelRow));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(empty(s));
      live = walk.seek(k_lo, k_hi);
    }

    __nv_bfloat16* out =
        (__nv_bfloat16*)p.out + ((long long)b * p.H + h) * p.Sq * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float safe = l[r] > 0.0f ? l[r] : 1.0f;
      const int row = wg_lo + warp * 16 + g + 8 * r;
      if (row >= q_hi) continue;
#pragma unroll
      for (int j = 0; j < kDt; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * kD +
                                           8 * j + 2 * tig) =
            __floats2bfloat162_rn(o[j][2 * r] / safe, o[j][2 * r + 1] / safe);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// (heads, rows, 96) bf16, row-major: boxes of 32 columns x box_rows rows in
// the 64-byte swizzle; rows past `rows` read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, long long heads,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2,
                                 (cuuint64_t)rows * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kPanelCols, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// q (B, H, Sq, 96), k / v (B, Hkv, Skv, 96) bfloat16, contiguous and
// 16-byte aligned (TMA); kv_index (Sq / block_q, max_nk) and kv_count
// (Sq / block_q) int32; q_seg (B, Sq) / kv_seg (B, Skv) int32 or both null;
// out like q.  window < 0: none; softcap <= 0: none.  The arguments of
// flash_attention_fwd (csrc/flash_attention.cu) less the dtype.
int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              const int* kv_index, const int* kv_count,
                              const int* q_seg, const int* kv_seg, void* out,
                              int B, int H, int Hkv, int Sq, int Skv, int D,
                              int max_nk, int block_q, int block_k,
                              int q_offset, float scale, int causal,
                              int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaGetLastError();
  if (D != kD || Hkv <= 0 || H % Hkv != 0 || block_q <= 0 || block_k <= 0 ||
      Sq % block_q != 0 || Skv % block_k != 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const Params p{q, k, v, kv_index, kv_count, q_seg, kv_seg, out, H, Hkv, Sq,
                 Skv, max_nk, block_q, block_k, q_offset, scale, causal,
                 window, softcap};
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, Sq, (long long)B * H, kQTile) ||
      !make_map(&tk, k, Skv, (long long)B * Hkv, kKv) ||
      !make_map(&tv, v, Skv, (long long)B * Hkv, kKv))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)(Sq / block_q) * ((block_q + kQTile - 1) / kQTile);
  if (tiles > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_d96_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (unsigned)tiles);
  flash_attention_fwd_d96_kernel<<<grid, kThreads, kSmemBytes,
                                   (cudaStream_t)stream>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

}  // extern "C"
