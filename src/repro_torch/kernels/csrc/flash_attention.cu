// Hand-written CUDA kernel for block-sparse flash attention, forward (sm_90a).
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
//   s = scale * q.k        (q, k, v cast to float32 before both products),
//   s = softcap * tanh(s / softcap)               when softcap > 0,
//   s = -1e30 where masked (causal: c <= pos; window: c > pos - window;
//       segments: qseg == kseg), pos = q_offset + r,
// an online softmax whose running max m, sum l and accumulator are float32,
// masked probabilities forced to 0 (a fully masked tile ahead of a live one
// must not leave exp(0) = 1 behind), and out = acc / (l > 0 ? l : 1) in
// q's dtype (float32 or bfloat16, round to nearest even).
//
// block_q / block_k are the schedule's units (512 at full width, 32 in the
// reduced configs), not this kernel's tile: a 512 x 64 float32 q block and
// a 512 x 512 score tile do not fit one SM.  Design:
//   * one thread block of 256 threads per (64-row q tile, head, batch); it
//     reads its q block's row of kv_index / kv_count itself (this replaces
//     the Pallas scalar prefetch);
//   * it walks each scheduled KV block in 64-row K/V sub-tiles staged in
//     shared memory as float32 (rows past the block are zero and masked);
//   * thread (ty, tx) of a 16 x 16 grid owns score rows ty + 16i and columns
//     tx + 16j (i, j < 4), and accumulator columns tx + 16c (c < D / 16);
//     the 16 threads of a row sit in one half-warp, so the row max and row
//     sum are shuffle reductions and each thread keeps m and l of its rows
//     in registers;
//   * masks are built from absolute positions and the segment ids;
//   * a sub-tile whose every pair is masked by causality or the window is
//     skipped: its update is the identity (alpha = 1, p = 0), so skipping
//     it changes no bit of the result;
//   * shared rows are padded to D + 1 floats, so the 16 threads of a
//     half-warp reading 16 different K rows hit 16 different banks.
//
// Bound at the slice's full-width shapes (prefill of 4 prompts x 2048
// tokens of smollm-360m: B = 4, H = 15, Hkv = 5, D = 64, 512-blocks; the
// causal schedule visits 10 of 16 blocks, whose live (q, k) pairs number
// S(S+1)/2 = 2,098,176 per (b, h)): 4 * D * pairs * B * H = 32.2 GFLOP,
// 0.033 ms at the bf16 tensor-core rate (989 TFLOP/s) and 0.48 ms at the
// float32 rate outside the tensor cores (67 TFLOP/s); about 42 MB of q, k,
// v and out, 0.013 ms at 3.35 TB/s.
// This kernel computes in float32 on the CUDA cores, so the float32 rate is
// its own ceiling; wgmma, TMA and a bf16 P.V product are later work.
//
// Built without --use_fast_math: expf and tanhf stay exact to the ulp.
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // q rows and k rows per tile
constexpr int kThreads = 256;    // a 16 x 16 grid
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_bytes() {
  return (2 * kTile * (D + 1) + kTile * D + kTile * (kTile + 1)) *
         (int)sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const Params p) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                       // kTile x (D + 1)
  float* sK = sQ + kTile * (D + 1);       // kTile x (D + 1)
  float* sV = sK + kTile * (D + 1);       // kTile x D
  float* sP = sV + kTile * D;             // kTile x (kTile + 1)

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tiles = (p.block_q + kTile - 1) / kTile;
  const int qblk = blockIdx.x / tiles;
  const int q_lo = qblk * p.block_q + (blockIdx.x % tiles) * kTile;
  const int q_hi = min(q_lo + kTile, (qblk + 1) * p.block_q);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);

  const T* q = (const T*)p.q + ((long long)b * p.H + h) * p.Sq * D;
  const T* k = (const T*)p.k + ((long long)b * p.Hkv + hk) * p.Skv * D;
  const T* v = (const T*)p.v + ((long long)b * p.Hkv + hk) * p.Skv * D;

  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sQ[r * (D + 1) + c] =
        q_lo + r < q_hi ? to_f32(q[(long long)(q_lo + r) * D + c]) : 0.0f;
  }

  int qpos[4], qseg[4];
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    qpos[i] = p.q_offset + row;
    qseg[i] = (p.q_seg != nullptr && row < q_hi)
                  ? p.q_seg[(long long)b * p.Sq + row] : 0;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int count = p.kv_count[qblk];
  const int* index = p.kv_index + (long long)qblk * p.max_nk;
  const int tile_qmin = p.q_offset + q_lo, tile_qmax = p.q_offset + q_hi - 1;
  const int subs = (p.block_k + kTile - 1) / kTile;
  for (int t = 0; t < count; ++t) {
    const int kb = index[t];
    const int kb_end = (kb + 1) * p.block_k;
    for (int sub = 0; sub < subs; ++sub) {
      const int k_lo = kb * p.block_k + sub * kTile;
      const int k_hi = min(k_lo + kTile, kb_end);
      if (p.causal && k_lo > tile_qmax) continue;
      if (p.window >= 0 && k_hi - 1 <= tile_qmin - p.window) continue;
      __syncthreads();  // the previous sub-tile's reads of sK, sV, sP are done
      for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
        const int r = e / D, c = e % D;
        const bool live = k_lo + r < k_hi;
        const long long off = (long long)(k_lo + r) * D + c;
        sK[r * (D + 1) + c] = live ? to_f32(k[off]) : 0.0f;
        sV[r * D + c] = live ? to_f32(v[off]) : 0.0f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }

      int kpos[4], kseg[4];
      bool kin[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kpos[j] = k_lo + tx + 16 * j;
        kin[j] = kpos[j] < k_hi;
        kseg[j] = (p.kv_seg != nullptr && kin[j])
                      ? p.kv_seg[(long long)b * p.Skv + kpos[j]] : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool live[4];
        float tmax = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
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
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m[i], tmax);
        const float alpha = expf(m[i] - m_new);
        float rsum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = live[j] ? expf(s[i][j] - m_new) : 0.0f;
          sP[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = pr;
          rsum += pr;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
        l[i] = l[i] * alpha + rsum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kTile; ++kk) {
        float pr[4], vv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = sP[(ty + 16 * i) * (kTile + 1) + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
      }
    }
  }

  T* out = (T*)p.out + ((long long)b * p.H + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    if (row >= q_hi) continue;
    const float safe = l[i] > 0.0f ? l[i] : 1.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(out + (long long)row * D + tx + 16 * c, acc[i][c] / safe);
  }
}

template <int D, typename T>
cudaError_t launch(const Params& p, int B, int nq, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<D, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid(nq * ((p.block_q + kTile - 1) / kTile), p.H, B);
  kernel<<<grid, kThreads, smem_bytes<D>(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, Sq, D), k / v (B, Hkv, Skv, D) of one dtype (0 float32,
// 1 bfloat16), contiguous; kv_index (Sq / block_q, max_nk) and kv_count
// (Sq / block_q) int32; q_seg (B, Sq) / kv_seg (B, Skv) int32 or both null;
// out like q.  window < 0: none; softcap <= 0: none.
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
  if (D == 64 && dtype == 0) err = launch<64, float>(p, B, nq, s);
  if (D == 64 && dtype == 1) err = launch<64, __nv_bfloat16>(p, B, nq, s);
  if (D == 128 && dtype == 0) err = launch<128, float>(p, B, nq, s);
  if (D == 128 && dtype == 1) err = launch<128, __nv_bfloat16>(p, B, nq, s);
  return (int)err;
}

}  // extern "C"
