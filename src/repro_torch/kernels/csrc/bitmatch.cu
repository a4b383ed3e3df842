// Hand-written CUDA kernel for the d-dimensional bit-matrix AND (sm_90a).
//
// Replaces the Pallas TPU kernel _bitmatch_kernel of the JAX package's
// repro/kernels/bitmatch.py (src/repro/kernels/bitmatch.py:40).  For every
// subscription row i and word w it computes
//
//   words[i, w]   bit b set iff update j = 32w + b < m overlaps row i in
//                 every dimension k < d (closed intervals:
//                 s_lo[k,i] <= u_hi[k,j] && u_lo[k,j] <= s_hi[k,i]);
//   row_counts[i] the popcount of row i (int32: at most m).
//
// Layout: bounds are (d, n) and (d, m) float32, row-major; words are
// (n, num_words) uint32 in the pack_bits layout (bit j % 32 of word j / 32).
//
// What bounds it: n*m*d*2 float compares against 4*n*num_words bytes of
// output, so at the main shapes the compares, not memory, set its least
// time.  The design keeps every operand in registers and spends no
// instruction on packing:
//   * one warp owns kRowsPerWarp subscription rows, their d bounds held in
//     registers for the whole run;
//   * lane l tests update 32w + l against each row, and __ballot_sync turns
//     the 32 votes into the word directly in pack_bits layout; lanes past m
//     vote 0, so no padded sentinel can set a bit (the Pallas form pads the
//     update axis to 128 with [+inf, -inf] sentinels, which an unbounded
//     subscription [-inf, +inf] overlaps);
//   * each update's bounds are read once per warp (coalesced, from L1/L2:
//     the (d, m) arrays are a few MB) and tested against all the warp's
//     rows;
//   * a warp gathers 32 consecutive words of a row, one per lane, and
//     stores them with one coalesced 128-byte store; one warp owns a whole
//     row, so the row's popcount needs no atomics.
// d is a template parameter (1..4), so the compare loops unroll.  For
// d >= 5 bitmatch_kernel_rt takes d at run time: the same warp layout,
// ballots and stores, with the block's rows' (d, 32) bounds staged in
// dynamic shared memory (every lane of a warp reads one address, a
// broadcast) instead of registers, and the compare loop running over k
// at run time.  Built without --use_fast_math: comparisons must not flush
// denormals.
//
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;

template <int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitmatch_kernel(const float* __restrict__ s_lo, const float* __restrict__ s_hi,
                const float* __restrict__ u_lo, const float* __restrict__ u_hi,
                unsigned* __restrict__ words, int* __restrict__ row_counts,
                int n, int m, int num_words) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      ((long long)blockIdx.x * kWarpsPerBlock + warp) * kRowsPerWarp;

  // The warp's rows; rows past n are [+inf, -inf] and never match.
  float lo[kRowsPerWarp][D], hi[kRowsPerWarp][D];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + r;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      lo[r][k] = row < n ? s_lo[(long long)k * n + row] : __int_as_float(0x7f800000);
      hi[r][k] = row < n ? s_hi[(long long)k * n + row] : __int_as_float(0xff800000);
    }
  }

  int count[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) count[r] = 0;

  for (int w0 = 0; w0 < num_words; w0 += 32) {
    const int nw = min(32, num_words - w0);  // the same in every lane
    unsigned mine[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) mine[r] = 0u;
    for (int ww = 0; ww < nw; ++ww) {
      const long long j = (long long)(w0 + ww) * 32 + lane;
      const bool live = j < m;
      float ul[D], uh[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        ul[k] = live ? u_lo[(long long)k * m + j] : 0.0f;
        uh[k] = live ? u_hi[(long long)k * m + j] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        bool hit = live;
#pragma unroll
        for (int k = 0; k < D; ++k)
          hit = hit & (lo[r][k] <= uh[k]) & (ul[k] <= hi[r][k]);
        const unsigned word = __ballot_sync(0xffffffffu, hit);
        if (lane == ww) mine[r] = word;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long row = row0 + r;
      if (row < n && lane < nw)
        words[row * num_words + w0 + lane] = mine[r];
      count[r] += __popc(mine[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    int c = count[r];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xffffffffu, c, s);
    const long long row = row0 + r;
    if (lane == 0 && row < n) row_counts[row] = c;
  }
}

// d >= 5: the block's rows' bounds in dynamic shared memory, laid out
// [lo | hi][k][kRowsPerBlock], 2 * d * kRowsPerBlock floats.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bitmatch_kernel_rt(const float* __restrict__ s_lo,
                   const float* __restrict__ s_hi,
                   const float* __restrict__ u_lo,
                   const float* __restrict__ u_hi,
                   unsigned* __restrict__ words, int* __restrict__ row_counts,
                   int d, int n, int m, int num_words) {
  extern __shared__ float bounds[];
  float* lo = bounds;
  float* hi = bounds + d * kRowsPerBlock;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long block_row0 = (long long)blockIdx.x * kRowsPerBlock;
  // rows past n are [+inf, -inf] and never match
  for (int e = threadIdx.x; e < d * kRowsPerBlock; e += blockDim.x) {
    const int k = e / kRowsPerBlock;
    const long long row = block_row0 + e % kRowsPerBlock;
    lo[e] = row < n ? s_lo[(long long)k * n + row] : __int_as_float(0x7f800000);
    hi[e] = row < n ? s_hi[(long long)k * n + row] : __int_as_float(0xff800000);
  }
  __syncthreads();
  const int r0 = warp * kRowsPerWarp;     // the warp's rows in the block
  const long long row0 = block_row0 + r0;

  int count[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) count[r] = 0;

  for (int w0 = 0; w0 < num_words; w0 += 32) {
    const int nw = min(32, num_words - w0);  // the same in every lane
    unsigned mine[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) mine[r] = 0u;
    for (int ww = 0; ww < nw; ++ww) {
      const long long j = (long long)(w0 + ww) * 32 + lane;
      const bool live = j < m;
      bool hit[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) hit[r] = live;
      for (int k = 0; k < d; ++k) {
        const float ul = live ? u_lo[(long long)k * m + j] : 0.0f;
        const float uh = live ? u_hi[(long long)k * m + j] : 0.0f;
        const float* lk = lo + k * kRowsPerBlock + r0;
        const float* hk = hi + k * kRowsPerBlock + r0;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          hit[r] = hit[r] & (lk[r] <= uh) & (ul <= hk[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const unsigned word = __ballot_sync(0xffffffffu, hit[r]);
        if (lane == ww) mine[r] = word;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long row = row0 + r;
      if (row < n && lane < nw)
        words[row * num_words + w0 + lane] = mine[r];
      count[r] += __popc(mine[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    int c = count[r];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) c += __shfl_down_sync(0xffffffffu, c, s);
    const long long row = row0 + r;
    if (lane == 0 && row < n) row_counts[row] = c;
  }
}

template <int D>
void launch(const float* s_lo, const float* s_hi, const float* u_lo,
            const float* u_hi, unsigned* words, int* row_counts, int n, int m,
            int num_words, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
  bitmatch_kernel<D><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words);
}

}  // namespace

extern "C" {

int bitmatch_words(const float* s_lo, const float* s_hi, const float* u_lo,
                   const float* u_hi, unsigned* words, int* row_counts, int d,
                   int n, int m, int num_words, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 1: launch<1>(s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words, s); break;
    case 2: launch<2>(s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words, s); break;
    case 3: launch<3>(s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words, s); break;
    case 4: launch<4>(s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words, s); break;
    default: {
      if (d < 1) return (int)cudaErrorInvalidValue;
      const size_t smem = (size_t)2 * d * kRowsPerBlock * sizeof(float);
      const cudaError_t err = cudaFuncSetAttribute(
          bitmatch_kernel_rt, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      const unsigned blocks = (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
      bitmatch_kernel_rt<<<blocks, kWarpsPerBlock * 32, smem, s>>>(
          s_lo, s_hi, u_lo, u_hi, words, row_counts, d, n, m, num_words);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
