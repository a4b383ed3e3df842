// Hand-written CUDA kernels for the parallel SBM sweep (sm_90a).
//
// Four kernels, each replacing one Pallas TPU kernel of the JAX package's
// repro/kernels/sbm_sweep.py.  Every kernel gives one CUDA block one
// segment of the sorted endpoint stream: on the TPU the grid runs the
// segments in order on one core, here the blocks run in parallel and in no
// order, so nothing is carried from one block to the next inside a kernel.
// Cross-segment carries are computed between launches by the wrapper.
//
//   sbm_block_sums      pass A   replaces _block_sums_kernel
//   sbm_emission        pass B   replaces _emission_kernel
//   sbm_delta_bitmasks           replaces _delta_bitmask_kernel
//   sbm_emit_pairs      pass C   replaces _emission_pairs_kernel
//
// Each C entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// Bitmask words are uint32 with bit k of word w standing for extent
// 32*w + k (the JAX package's pack_bits layout).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// Exclusive prefix of `v` over the block (blockDim.x a multiple of 32);
// `*total` receives the block total.  `scratch` holds 33 ints of shared
// memory.  Every thread of the block must call it; it ends with a barrier,
// so `scratch` may be reused right after.
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int inc = warp_inclusive_scan(v);
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? scratch[lane] : 0;
    const int winc = warp_inclusive_scan(w);
    if (lane < nwarps) scratch[lane] = winc - w;
    if (lane == nwarps - 1) scratch[32] = winc;
  }
  __syncthreads();
  const int out = scratch[warp] + inc - v;
  *total = scratch[32];
  __syncthreads();
  return out;
}

__device__ long long block_sum_ll(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  long long total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < nwarps; ++w) total += scratch[w];
  __syncthreads();
  return total;  // valid in thread 0 only
}

// Pass A — per-segment sums of the four ±1 indicator streams.
// deltas: (4, total) int32 rows [sub_lo, sub_up, upd_lo, upd_up];
// sums: (num_blocks, 4) int32.  Memory-bound: 16 B read per endpoint.
__global__ void block_sums_kernel(const int* __restrict__ deltas,
                                  int* __restrict__ sums, long long total,
                                  int block_size) {
  __shared__ int scratch[33];
  const long long base = (long long)blockIdx.x * block_size;
  int acc[4] = {0, 0, 0, 0};
  for (int i = threadIdx.x; i < block_size; i += blockDim.x) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[s] += deltas[s * total + base + i];
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int tot;
    block_exclusive_scan(acc[s], &tot, scratch);
    if (threadIdx.x == 0) sums[blockIdx.x * 4 + s] = tot;
  }
}

// Pass B — per-segment inclusive scans of the four streams plus the
// exclusive cross-segment carry `offsets` (num_blocks, 4), giving the
// per-endpoint emission count
//   sub_up * active_upd_before + upd_up * active_sub_before
// (int32: at most max(n, m)) and the segment's emission total in int64.
// Each thread scans a contiguous chunk; a block scan of the chunk totals
// links the chunks.  Memory-bound: 16 B read + 4 B written per endpoint.
__global__ void emission_kernel(const int* __restrict__ deltas,
                                const int* __restrict__ offsets,
                                int* __restrict__ emit,
                                long long* __restrict__ block_emit,
                                long long total, int block_size) {
  __shared__ int scratch[33];
  __shared__ long long red[32];
  const long long base = (long long)blockIdx.x * block_size;
  const int chunk = (block_size + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * chunk, block_size);
  const int hi = min(lo + chunk, block_size);
  int run[4] = {0, 0, 0, 0};
  for (int i = lo; i < hi; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) run[s] += deltas[s * total + base + i];
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    int tot;
    run[s] = block_exclusive_scan(run[s], &tot, scratch) +
             offsets[blockIdx.x * 4 + s];
  }
  long long mine = 0;
  for (int i = lo; i < hi; ++i) {
    const long long g = base + i;
    const int sub_lo = deltas[g];
    const int sub_up = deltas[total + g];
    const int upd_lo = deltas[2 * total + g];
    const int upd_up = deltas[3 * total + g];
    run[0] += sub_lo;
    run[1] += sub_up;
    run[2] += upd_lo;
    run[3] += upd_up;
    const int active_sub_before = run[0] - (run[1] - sub_up);
    const int active_upd_before = run[2] - (run[3] - upd_up);
    const int e = sub_up * active_upd_before + upd_up * active_sub_before;
    emit[g] = e;
    mine += e;
  }
  const long long seg = block_sum_ll(mine, red);
  if (threadIdx.x == 0) block_emit[blockIdx.x] = seg;
}

// Algorithm 6 lines 1-17 for one extent type: the Add/Del bitmask words of
// each segment.  The block zeroes its two rows of words, then one thread
// replays the segment in order (lower: Add |= bit; upper: clear the bit in
// Add if set there, else Del |= bit).  The rows live in global memory: at
// n = 1e6 one row is 125 KB and the pair exceeds a block's shared memory.
// Bound: the sequential read-modify-write chain of one thread per segment.
__global__ void delta_bitmask_kernel(const int* __restrict__ owner,
                                     const int* __restrict__ is_upper,
                                     const int* __restrict__ valid,
                                     unsigned* __restrict__ add,
                                     unsigned* __restrict__ del,
                                     int block_size, int num_words) {
  const size_t row = (size_t)blockIdx.x * num_words;
  for (int w = threadIdx.x; w < num_words; w += blockDim.x) {
    add[row + w] = 0u;
    del[row + w] = 0u;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const long long base = (long long)blockIdx.x * block_size;
  for (int t = 0; t < block_size; ++t) {
    const long long g = base + t;
    if (!valid[g]) continue;
    const int o = max(owner[g], 0);
    const unsigned bit = 1u << (o & 31);
    const size_t w = row + (o >> 5);
    if (!is_upper[g]) {
      add[w] |= bit;
    } else if (add[w] & bit) {
      add[w] &= ~bit;
    } else {
      del[w] |= bit;
    }
  }
}

// Pass C — pair emission.  The block copies the active sets entering its
// segment into its own rows of `sub_mask`/`upd_mask` (global scratch) and
// replays the segment in order.  At each upper endpoint the block's
// threads walk the counterpart mask together: each thread takes a
// contiguous run of words, a block scan of the runs' popcounts gives each
// set bit its slot ptr + rank, and the bits are written in ascending id
// order — the same slots as the Pallas kernel, so the (num_blocks, cap)
// arrays are equal element for element.  Thread 0 then opens or closes
// the endpoint's own bit.  The block keeps each mask's popcount and skips
// the walk of an empty counterpart set.  Bound: the walk reads
// ceil(count/32) words per upper endpoint whatever the active-set size.
__global__ void emit_pairs_kernel(const int* __restrict__ owner,
                                  const int* __restrict__ is_upper,
                                  const int* __restrict__ is_sub,
                                  const int* __restrict__ valid,
                                  const unsigned* __restrict__ sub0,
                                  const unsigned* __restrict__ upd0,
                                  unsigned* sub_mask, unsigned* upd_mask,
                                  int* __restrict__ out_i,
                                  int* __restrict__ out_j, int block_size,
                                  int ws, int wu, long long cap) {
  __shared__ int scratch[33];
  __shared__ int active[2];  // popcounts of [sub_mask, upd_mask]
  const size_t p = blockIdx.x;
  unsigned* smask = sub_mask + p * ws;
  unsigned* umask = upd_mask + p * wu;
  int* oi = out_i + p * cap;
  int* oj = out_j + p * cap;
  for (long long s = threadIdx.x; s < cap; s += blockDim.x) {
    oi[s] = -1;
    oj[s] = -1;
  }
  int cs = 0, cu = 0;
  for (int w = threadIdx.x; w < ws; w += blockDim.x) {
    const unsigned x = sub0[p * ws + w];
    smask[w] = x;
    cs += __popc(x);
  }
  for (int w = threadIdx.x; w < wu; w += blockDim.x) {
    const unsigned x = upd0[p * wu + w];
    umask[w] = x;
    cu += __popc(x);
  }
  int tot;
  block_exclusive_scan(cs, &tot, scratch);
  if (threadIdx.x == 0) active[0] = tot;
  block_exclusive_scan(cu, &tot, scratch);
  if (threadIdx.x == 0) active[1] = tot;
  __syncthreads();

  long long ptr = 0;
  const long long base = (long long)p * block_size;
  for (int t = 0; t < block_size; ++t) {
    const long long g = base + t;
    if (!valid[g]) continue;  // the same record for every thread
    const int o = owner[g];
    const bool up = is_upper[g] != 0;
    const bool sb = is_sub[g] != 0;
    if (up && active[sb ? 1 : 0] > 0) {
      const unsigned* mask = sb ? umask : smask;
      const int nw = sb ? wu : ws;
      const int chunk = (nw + blockDim.x - 1) / blockDim.x;
      const int w0 = min((int)threadIdx.x * chunk, nw);
      const int w1 = min(w0 + chunk, nw);
      int mine = 0;
      for (int w = w0; w < w1; ++w) mine += __popc(mask[w]);
      int total;
      long long dest = ptr + block_exclusive_scan(mine, &total, scratch);
      for (int w = w0; w < w1 && dest < cap; ++w) {
        unsigned x = mask[w];
        while (x != 0u && dest < cap) {
          const int c = w * 32 + (__ffs(x) - 1);
          x &= x - 1u;
          oi[dest] = sb ? o : c;
          oj[dest] = sb ? c : o;
          ++dest;
        }
      }
      ptr += total;
    }
    if (threadIdx.x == 0) {
      unsigned* own = sb ? smask : umask;
      const unsigned bit = 1u << (o & 31);
      const unsigned old = own[o >> 5];
      const unsigned now = up ? (old & ~bit) : (old | bit);
      own[o >> 5] = now;
      if (now != old) active[sb ? 0 : 1] += up ? -1 : 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int sbm_block_sums(const int* deltas, int* sums, long long total,
                   int block_size, void* stream) {
  const long long blocks = total / block_size;
  if (blocks > 0)
    block_sums_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(deltas, sums, total,
                                                block_size);
  return (int)cudaGetLastError();
}

int sbm_emission(const int* deltas, const int* offsets, int* emit,
                 long long* block_emit, long long total, int block_size,
                 void* stream) {
  const long long blocks = total / block_size;
  if (blocks > 0)
    emission_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        deltas, offsets, emit, block_emit, total, block_size);
  return (int)cudaGetLastError();
}

int sbm_delta_bitmasks(const int* owner, const int* is_upper,
                       const int* valid, unsigned* add, unsigned* del,
                       long long total, int block_size, int num_words,
                       void* stream) {
  const long long blocks = total / block_size;
  if (blocks > 0)
    delta_bitmask_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
        owner, is_upper, valid, add, del, block_size, num_words);
  return (int)cudaGetLastError();
}

int sbm_emit_pairs(const int* owner, const int* is_upper, const int* is_sub,
                   const int* valid, const unsigned* sub0,
                   const unsigned* upd0, unsigned* sub_mask,
                   unsigned* upd_mask, int* out_i, int* out_j,
                   long long total, int block_size, int ws, int wu,
                   long long cap, void* stream) {
  const long long blocks = total / block_size;
  if (blocks > 0)
    emit_pairs_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        owner, is_upper, is_sub, valid, sub0, upd0, sub_mask, upd_mask,
        out_i, out_j, block_size, ws, wu, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
