// Hand-written CUDA kernels for the d-dimensional bit-matrix AND (sm_90a).
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
// output, so the compares, not memory, set its least time.  A compare is an
// FSETP; the floor is the instruction count.  The design spends about
// 2d + 1 instructions per (row, update) pair and lane, and keeps everything
// else off that path:
//
//   * Each lane owns its own subscription rows (kRowsPerLane = 4 of them,
//     each the next lane's row kThreads rows further), their bounds in
//     registers.  The rows of one lane are independent chains; no ballot,
//     no select.
//   * Update bounds arrive in shared memory in stages of 128 updates (four
//     output words), double-buffered with 4-byte cp.async (any m, any
//     alignment; past m zero-filled): the next stage's copy overlaps this
//     stage's compares.  Every lane reads the same update at the same
//     time, a broadcast, four updates of one bound per 16-byte load.
//   * A row's word starts as the mask of the live updates (bits past m are
//     0, so no padded sentinel can set one: the Pallas form pads the update
//     axis with [+inf, -inf], which an unbounded subscription overlaps);
//     each update then clears its bit where some compare fails: per pair
//     and lane 2d FSETPs chained through one predicate and one predicated
//     AND with an immediate mask (the 32 updates of a word fully unrolled).
//   * The four words of a stage rotate through registers, so the word loop
//     stays rolled.  With num_words a multiple of 4 a row's four words
//     leave as one aligned 16-byte store; otherwise through the warp's
//     tile in shared memory, one store instruction writing four
//     consecutive words of each of 8 rows instead of one word of each of
//     32 (cell (b) has num_words = 3125).
//   * The grid is (row tiles, update chunks): a block takes a run of
//     stages, enough blocks to fill about four waves of the card, so
//     short n still spreads over every SM.  Row popcounts are summed per
//     lane and added with one atomic per row and block (or stored, with
//     one chunk).
//   * Registers are capped by the launch bounds so that 4 (d <= 2) or 2
//     (d = 3, 4) blocks stay resident, without spills: in trials four rows
//     a lane with more warps beat eight rows a lane with fewer.
//
// d = 1..4: bitmatch_kernel<D>, all of a row's bounds in registers for the
// whole run.  d >= 5: bitmatch_kernel_rt, d at run time: the dimensions
// go in chunks of four (the last one 1..4), each a stage of its own in the
// ring, the row bounds of the chunk loaded into registers (L1/L2 hits)
// and the words ANDed chunk by chunk; shared memory does not grow with d,
// so any d is taken.
//
// Built without --use_fast_math: comparisons must not flush denormals.
// The C entry point launches on the caller's stream, does not synchronise,
// allocates nothing (it zeroes row_counts when several blocks add to a
// row), and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStageUpdates = 128;                  // one per thread
constexpr int kStageWords = kStageUpdates / 32;     // 4
constexpr int kMaxChunk = 4;                        // dimensions per stage
constexpr int kRowsPerLane = 4;
template <int D>
constexpr int kMinBlocks = D <= 2 ? 4 : 2;

// one stage of update bounds: [lo | hi][dimension of the chunk][update]
typedef float Tile[2][kMaxChunk][kStageUpdates];

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy dimensions [k0, k0 + kc) of updates [j0, j0 + kStageUpdates) into
// `t`, thread u taking update j0 + u; updates past m are zero-filled (their
// bits are cleared by the live mask).
__device__ __forceinline__ void stage_updates(Tile& t, const float* u_lo,
                                              const float* u_hi, int k0,
                                              int kc, long long j0, int m) {
  const int u = threadIdx.x;
  const long long j = j0 + u;
  const bool live = j < m;
  for (int k = 0; k < kc; ++k) {
    const long long off = live ? (long long)(k0 + k) * m + j : 0;
    cp_async4(&t[0][k][u], u_lo + off, live);
    cp_async4(&t[1][k][u], u_hi + off, live);
  }
}

// Bounds of the lane's rows in dimensions [k0, k0 + KC); rows past n are
// never stored.
template <int KC, int R>
__device__ __forceinline__ void load_rows(float (&lo)[R][KC],
                                          float (&hi)[R][KC],
                                          const float* __restrict__ s_lo,
                                          const float* __restrict__ s_hi,
                                          int k0, int n, long long row0) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + (long long)r * kThreads;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const long long off = (long long)(k0 + k) * n + row;
      lo[r][k] = row < n ? s_lo[off] : 0.0f;
      hi[r][k] = row < n ? s_hi[off] : 0.0f;
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Clear, in each row's word w[r], the bit of every update u0 .. u0 + 31 of
// the tile that misses the row in one of the chunk's KC dimensions.
template <int KC, int R>
__device__ __forceinline__ void and_word(unsigned (&w)[R],
                                         const float (&lo)[R][KC],
                                         const float (&hi)[R][KC],
                                         const Tile& t, int u0) {
#pragma unroll
  for (int q = 0; q < 32; q += 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 ul[KC], uh[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        ul[k] = *reinterpret_cast<const float4*>(&t[0][k][u0 + q + 4 * h]);
        uh[k] = *reinterpret_cast<const float4*>(&t[1][k][u0 + q + 4 * h]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned keep = ~(1u << (q + 4 * h + e));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          bool hit = true;
#pragma unroll
          for (int k = 0; k < KC; ++k)
            hit = hit & (lo[r][k] <= lane_of(uh[k], e)) &
                  (lane_of(ul[k], e) <= hi[r][k]);
          if (!hit) w[r] &= keep;
        }
      }
    }
  }
}

// The stage's four words of every row, ANDed with one chunk of dimensions.
// acc[0] is taken, worked and pushed to the back, so after the loop acc is
// in order again: a rolled loop with register-held words.
template <int KC, int R>
__device__ __forceinline__ void and_stage(unsigned (&acc)[kStageWords][R],
                                          const float (&lo)[R][KC],
                                          const float (&hi)[R][KC],
                                          const Tile& t) {
#pragma unroll 1
  for (int g = 0; g < kStageWords; ++g) {
    unsigned cur[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cur[r] = acc[0][r];
    and_word<KC, R>(cur, lo, hi, t, 32 * g);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i + 1 < kStageWords; ++i) acc[i][r] = acc[i + 1][r];
      acc[kStageWords - 1][r] = cur[r];
    }
  }
}

// Bits of word w that stand for updates below m.
__device__ __forceinline__ unsigned live_bits(long long w, int m) {
  const long long j0 = w * 32;
  if (j0 + 32 <= m) return 0xffffffffu;
  if (j0 >= m) return 0u;
  return (1u << (unsigned)(m - j0)) - 1u;
}

template <int R>
__device__ __forceinline__ void init_stage(unsigned (&acc)[kStageWords][R],
                                           long long w_first, int m) {
#pragma unroll
  for (int g = 0; g < kStageWords; ++g) {
    const unsigned bits = live_bits(w_first + g, m);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[g][r] = bits;
  }
}

// A warp's staging area for the stage's words: [word][row of the warp],
// columns padded by 8 so both the writes (a row a lane) and the reads (4
// words of 8 rows) fall in 32 banks.
template <int R>
constexpr int kOutCol = 32 * R + 8;

// The stage's words of the lane's rows to device memory, and their
// popcounts to count.  With num_words a multiple of 4 a row's 4 words are
// one aligned 16-byte store; otherwise they go through the warp's tile
// `wtile` so that one store instruction writes 4 consecutive words of each
// of 8 rows (16-byte runs) instead of one word of each of 32.
template <int R>
__device__ __forceinline__ void store_stage(
    const unsigned (&acc)[kStageWords][R], unsigned* __restrict__ words,
    int num_words, int n, long long row0, long long w_first,
    int (&count)[R], unsigned* wtile) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < kStageWords; ++g) count[r] += __popc(acc[g][r]);
  if ((num_words & 3) == 0 && w_first + 4 <= num_words) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + (long long)r * kThreads;
      if (row < n)
        *reinterpret_cast<uint4*>(words + row * num_words + w_first) =
            make_uint4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < kStageWords; ++g)
      wtile[g * kOutCol<R> + r * 32 + lane] = acc[g][r];
  __syncwarp();
  const int g = lane & 3;
  const long long warp_row0 = row0 - lane;   // the warp's first row
  if (w_first + g < num_words) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int local = 8 * i + (lane >> 2);
        const long long row = warp_row0 + (long long)r * kThreads + local;
        if (row < n)
          words[row * num_words + w_first + g] =
              wtile[g * kOutCol<R> + r * 32 + local];
      }
  }
  __syncwarp();   // the next stage rewrites the tile
}

template <int R>
__device__ __forceinline__ void finish_counts(const int (&count)[R],
                                              int* __restrict__ row_counts,
                                              int n, long long row0) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    if (row >= n) continue;
    if (gridDim.y == 1) row_counts[row] = count[r];
    else atomicAdd(row_counts + row, count[r]);
  }
}

// d = 1..4: the lane's rows' D bounds in registers for the whole run; one
// ring stage per 128 updates.
template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
bitmatch_kernel(const float* __restrict__ s_lo, const float* __restrict__ s_hi,
                const float* __restrict__ u_lo, const float* __restrict__ u_hi,
                unsigned* __restrict__ words, int* __restrict__ row_counts,
                int n, int m, int num_words, int stages_per_block) {
  constexpr int R = kRowsPerLane;
  __shared__ __align__(16) Tile tile[2];
  __shared__ unsigned out_tile[kThreads / 32][kStageWords * kOutCol<R>];
  const long long row0 = (long long)blockIdx.x * kThreads * R + threadIdx.x;
  const int stages = (num_words + kStageWords - 1) / kStageWords;
  const int s_begin = blockIdx.y * stages_per_block;
  const int s_end = min(stages, s_begin + stages_per_block);

  float lo[R][D], hi[R][D];
  load_rows<D, R>(lo, hi, s_lo, s_hi, 0, n, row0);
  int count[R];
#pragma unroll
  for (int r = 0; r < R; ++r) count[r] = 0;
  unsigned acc[kStageWords][R];

  stage_updates(tile[0], u_lo, u_hi, 0, D, (long long)s_begin * kStageUpdates,
                m);
  cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int buf = (s - s_begin) & 1;
    if (s + 1 < s_end)
      stage_updates(tile[buf ^ 1], u_lo, u_hi, 0, D,
                    (long long)(s + 1) * kStageUpdates, m);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const long long w_first = (long long)s * kStageWords;
    init_stage<R>(acc, w_first, m);
    and_stage<D, R>(acc, lo, hi, tile[buf]);
    store_stage<R>(acc, words, num_words, n, row0, w_first, count,
                   out_tile[threadIdx.x >> 5]);
    __syncthreads();   // every lane is done with tile[buf] before its reload
  }
  finish_counts<R>(count, row_counts, n, row0);
}

template <int KC>
__device__ __forceinline__ void chunk_rt(
    unsigned (&acc)[kStageWords][kRowsPerLane], const Tile& t,
    const float* __restrict__ s_lo, const float* __restrict__ s_hi, int k0,
    int n, long long row0) {
  float lo[kRowsPerLane][KC], hi[kRowsPerLane][KC];
  load_rows<KC, kRowsPerLane>(lo, hi, s_lo, s_hi, k0, n, row0);
  and_stage<KC, kRowsPerLane>(acc, lo, hi, t);
}

// d >= 5: ring items are (stage, chunk of up to four dimensions); a
// stage's words are stored after its last chunk.
__global__ void __launch_bounds__(kThreads)
bitmatch_kernel_rt(const float* __restrict__ s_lo,
                   const float* __restrict__ s_hi,
                   const float* __restrict__ u_lo,
                   const float* __restrict__ u_hi,
                   unsigned* __restrict__ words, int* __restrict__ row_counts,
                   int d, int n, int m, int num_words, int stages_per_block) {
  constexpr int R = kRowsPerLane;
  __shared__ __align__(16) Tile tile[2];
  __shared__ unsigned out_tile[kThreads / 32][kStageWords * kOutCol<R>];
  const long long row0 = (long long)blockIdx.x * kThreads * R + threadIdx.x;
  const int stages = (num_words + kStageWords - 1) / kStageWords;
  const int nkc = (d + kMaxChunk - 1) / kMaxChunk;
  const int s_begin = blockIdx.y * stages_per_block;
  const int s_end = min(stages, s_begin + stages_per_block);
  const long long it_begin = (long long)s_begin * nkc;
  const long long it_end = (long long)s_end * nkc;

  int count[R];
#pragma unroll
  for (int r = 0; r < R; ++r) count[r] = 0;
  unsigned acc[kStageWords][R];

  stage_updates(tile[0], u_lo, u_hi, 0, kMaxChunk,
                (long long)s_begin * kStageUpdates, m);
  cp_async_commit();
  for (long long it = it_begin; it < it_end; ++it) {
    const int buf = (int)((it - it_begin) & 1);
    const int s = (int)(it / nkc), kc = (int)(it % nkc);
    if (it + 1 < it_end) {
      const int s1 = (int)((it + 1) / nkc), k1 = (int)((it + 1) % nkc);
      stage_updates(tile[buf ^ 1], u_lo, u_hi, k1 * kMaxChunk,
                    min(kMaxChunk, d - k1 * kMaxChunk),
                    (long long)s1 * kStageUpdates, m);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const long long w_first = (long long)s * kStageWords;
    if (kc == 0) init_stage<R>(acc, w_first, m);
    const int k0 = kc * kMaxChunk;
    switch (min(kMaxChunk, d - k0)) {
      case 1: chunk_rt<1>(acc, tile[buf], s_lo, s_hi, k0, n, row0); break;
      case 2: chunk_rt<2>(acc, tile[buf], s_lo, s_hi, k0, n, row0); break;
      case 3: chunk_rt<3>(acc, tile[buf], s_lo, s_hi, k0, n, row0); break;
      default: chunk_rt<4>(acc, tile[buf], s_lo, s_hi, k0, n, row0); break;
    }
    if (kc == nkc - 1)
      store_stage<R>(acc, words, num_words, n, row0, w_first, count,
                     out_tile[threadIdx.x >> 5]);
    __syncthreads();   // every lane is done with tile[buf] before its reload
  }
  finish_counts<R>(count, row_counts, n, row0);
}

// Stages per block: about four waves of blocks over the card (a ragged
// last wave then costs at most a quarter), at most 65,535 chunks.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long row_tiles, int stages,
                     int* per_block, int* chunks) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long want = 4LL * sms * (occ > 0 ? occ : 1);
  long long per = (row_tiles * stages + want - 1) / want;
  per = per < 1 ? 1 : per;
  const long long least = (stages + 65534LL) / 65535LL;
  per = per < least ? least : per;
  *per_block = (int)per;
  *chunks = (int)((stages + per - 1) / per);
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int rows_per_block, int* row_counts, int n,
                   int num_words, cudaStream_t stream, Args... args) {
  const long long row_tiles = (n + (long long)rows_per_block - 1) /
                              rows_per_block;
  const int stages = (num_words + kStageWords - 1) / kStageWords;
  int per = 0, chunks = 0;
  cudaError_t err = grid_for(kernel, row_tiles, stages, &per, &chunks);
  if (err != cudaSuccess) return err;
  if (row_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (chunks > 1) {   // the blocks of a row add their counts
    err = cudaMemsetAsync(row_counts, 0, (size_t)n * sizeof(int), stream);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)row_tiles, (unsigned)chunks), kThreads, 0,
           stream>>>(args..., per);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bitmatch_words(const float* s_lo, const float* s_hi, const float* u_lo,
                   const float* u_hi, unsigned* words, int* row_counts, int d,
                   int n, int m, int num_words, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  if (d < 1 || num_words < (m + 31) / 32) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (d) {
    case 1:
      err = launch(bitmatch_kernel<1>, kThreads * kRowsPerLane,
                   row_counts, n, num_words, s,
                   s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words);
      break;
    case 2:
      err = launch(bitmatch_kernel<2>, kThreads * kRowsPerLane,
                   row_counts, n, num_words, s,
                   s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words);
      break;
    case 3:
      err = launch(bitmatch_kernel<3>, kThreads * kRowsPerLane,
                   row_counts, n, num_words, s,
                   s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words);
      break;
    case 4:
      err = launch(bitmatch_kernel<4>, kThreads * kRowsPerLane,
                   row_counts, n, num_words, s,
                   s_lo, s_hi, u_lo, u_hi, words, row_counts, n, m, num_words);
      break;
    default:
      err = launch(bitmatch_kernel_rt, kThreads * kRowsPerLane, row_counts,
                   n, num_words, s, s_lo, s_hi, u_lo, u_hi, words, row_counts,
                   d, n, m, num_words);
  }
  return (int)err;
}

}  // extern "C"
