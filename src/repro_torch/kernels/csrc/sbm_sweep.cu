// Hand-written CUDA kernels for the parallel SBM sweep (sm_90a).
//
// Four kernels replace the Pallas TPU kernels of the JAX package's
// repro/kernels/sbm_sweep.py; each gives one CUDA block one segment of the
// sorted endpoint stream: on the TPU the grid runs the segments in order
// on one core, here the blocks run in parallel and in no order, so nothing
// is carried from one block to the next inside a kernel.  Cross-segment
// carries are computed between launches: the counting sweep's by the
// wrapper, the active sets entering each segment by a fifth kernel, the
// monoid scan of the delta words (one launch an extent type).
//
//   sbm_block_sums      pass A   replaces _block_sums_kernel
//   sbm_emission        pass B   replaces _emission_kernel
//   sbm_delta_bitmasks           replaces _delta_bitmask_kernel
//   sbm_emit_pairs      pass C   replaces _emission_pairs_kernel
//   (sbm_emit_pairs_placement says where pass C keeps its masks)
//   sbm_delta_scan               Algorithm 6's exclusive scan of the delta
//                                words (lax.associative_scan in the JAX
//                                package, no Pallas kernel)
//
// Each C entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
// Bitmask words are uint32 with bit k of word w standing for extent
// 32*w + k (the JAX package's pack_bits layout).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Xor {
  __device__ unsigned operator()(unsigned a, unsigned b) const { return a ^ b; }
};

template <typename T, typename Op = Add>
__device__ __forceinline__ T warp_inclusive_scan(T v, Op op = Op()) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, y);
  }
  return v;
}

// Exclusive prefix of `v` over the block under `op` (+ or ^, identity 0;
// blockDim.x a multiple of 32); `*total` receives the block total.
// `scratch` holds 33 T of shared memory.  Every thread of the block must
// call it; it ends with a barrier, so `scratch` may be reused right after.
template <typename T, typename Op = Add>
__device__ T block_exclusive_scan(T v, T* total, T* scratch, Op op = Op()) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const T inc = warp_inclusive_scan(v, op);
  T excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0;
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < nwarps ? scratch[lane] : T(0);
    const T winc = warp_inclusive_scan(w, op);
    T wexcl = __shfl_up_sync(0xffffffffu, winc, 1);
    if (lane == 0) wexcl = 0;
    if (lane < nwarps) scratch[lane] = wexcl;
    if (lane == nwarps - 1) scratch[32] = winc;
  }
  __syncthreads();
  const T out = op(scratch[warp], excl);
  *total = scratch[32];
  __syncthreads();
  return out;
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
// Memory-bound: 16 B read + 4 B written per endpoint, so each delta is read
// once, coalesced, and stays in registers.  A block takes one segment and
// each thread V consecutive endpoints of each of the four streams: V = 4
// (one 16-byte load a stream, a warp covers 128 endpoints, the emission
// stored as one int4) when the block size is a multiple of 4 and the rows
// and `emit` are 16-byte aligned, else V = 1 (the scalar path: coalesced
// 4-byte loads).  The streams are scanned by warp shuffles, the warp totals
// by one block scan in shared memory (double-buffered, so one barrier per
// tile of V * blockDim.x endpoints; blockDim.x = ceil(block_size / V) up to
// 1024), plus the `offsets` carry; the int64 total is a warp reduction,
// then a block one.
constexpr int kEmitMaxThreads = 1024;

struct EmissionArgs {
  const int* deltas;       // (4, total)
  const int* offsets;      // (num_blocks, 4)
  int* emit;               // (total,)
  long long* block_emit;   // (num_blocks,)
  long long total;
  int block_size;
};

template <int V>
__device__ void emission_segment(const EmissionArgs& a) {
  __shared__ int warp_tot[2][4][32];
  __shared__ long long red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long seg = blockIdx.x;
  int carry[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) carry[s] = __ldg(a.offsets + seg * 4 + s);
  long long tot = 0;
  for (int base = 0, buf = 0; base < a.block_size;
       base += V * blockDim.x, buf ^= 1) {
    const int i0 = base + V * threadIdx.x;
    const bool active = i0 < a.block_size;   // V divides block_size
    const long long g = seg * a.block_size + i0;
    int d[4][V] = {};
    if (active) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int* row = a.deltas + s * a.total + g;
        if constexpr (V == 4) {
          const int4 t = __ldg(reinterpret_cast<const int4*>(row));
          d[s][0] = t.x;
          d[s][1] = t.y;
          d[s][2] = t.z;
          d[s][3] = t.w;
        } else {
          d[s][0] = __ldg(row);
        }
      }
    }
    // run: the inclusive prefix before this thread's first endpoint
    int mine[4], run[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      mine[s] = 0;
#pragma unroll
      for (int i = 0; i < V; ++i) mine[s] += d[s][i];
      run[s] = warp_inclusive_scan(mine[s]);
      if (lane == 31) warp_tot[buf][s][warp] = run[s];
      run[s] -= mine[s];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int w = warp_inclusive_scan(lane < nwarps ? warp_tot[buf][s][lane]
                                                      : 0);
      const int before = __shfl_sync(0xffffffffu, w, (warp + 31) & 31);
      run[s] += carry[s] + (warp > 0 ? before : 0);
      carry[s] += __shfl_sync(0xffffffffu, w, nwarps - 1);
    }
    if (!active) continue;
    int e[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int s = 0; s < 4; ++s) run[s] += d[s][i];
      const int active_sub_before = run[0] - (run[1] - d[1][i]);
      const int active_upd_before = run[2] - (run[3] - d[3][i]);
      e[i] = d[1][i] * active_upd_before + d[3][i] * active_sub_before;
      tot += e[i];
    }
    if constexpr (V == 4)
      *reinterpret_cast<int4*>(a.emit + g) = make_int4(e[0], e[1], e[2], e[3]);
    else
      a.emit[g] = e[0];
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) tot += __shfl_down_sync(0xffffffffu, tot, k);
  if (lane == 0) red[warp] = tot;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < nwarps ? red[lane] : 0;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) t += __shfl_down_sync(0xffffffffu, t, k);
    if (lane == 0) a.block_emit[seg] = t;
  }
}

__global__ void __launch_bounds__(kEmitMaxThreads)
emission_kernel(const EmissionArgs a, int vec) {
  if (vec) emission_segment<4>(a);
  else     emission_segment<1>(a);
}

// Algorithm 6 lines 1-17 for one extent type: the Add/Del bitmask words of
// each segment.  Replaces _delta_bitmask_kernel, whose replay of a segment
// in order (lower: Add |= bit; upper: clear the bit in Add if set there,
// else Del |= bit) is, per owner, a function of that owner's records in
// the segment alone: in position order, an owner is in Add iff its last
// record is a lower, and in Del iff one of its uppers follows an upper of
// it or nothing.  So the block sorts the segment's records by (owner,
// position) and every thread decides its records from their neighbours;
// no step waits on a previous record's outcome.
//
//   1. All threads zero the block's two rows (16-byte stores).  Each warp
//      takes a contiguous span of the segment, loads it coalesced twice
//      (the second time from cache) and writes the valid records whose
//      clamped owner lies below 32 * num_words, in position order, to
//      shared memory: the owner (int) and position << 1 | is_upper
//      (16 bits).  Other records write nothing, so no owner id reaches
//      outside the block's rows.
//   2. A stable LSD radix sort on the owner, 8 bits a pass, as many passes
//      as the owner ids have bytes (3 at n = 1e5 and 1e6): in each pass
//      each warp ranks the records of its span by digit (__match_any_sync
//      peers, per-warp counters), one block scan over (digit, warp) gives
//      every warp's offset per digit, and the warps scatter into the other
//      buffer.  Stability keeps position order within an owner, so no
//      position bits are sorted and the sort keys stay 32-bit.
//   3. Each thread takes records of the sorted run: a lower that is its
//      owner's last record sets its bit in Add, an upper whose predecessor
//      is not a lower of its owner sets its bit in Del, by atomicOr on the
//      zeroed rows (ordered after the zero stores by the sort's barriers;
//      Del's repeats are idempotent).
//
// Shared memory: 12 bytes a record (two buffers of owner and position) and
// 16 KB of counters, so segments up to kBitmaskMaxBlock = 16,384 records;
// the C entry point refuses larger ones.  Bound: at large num_words the
// rows' zero stores (n = m = 1e6: 250 KB a block); else the sort's chain of
// shared-memory steps and barriers (the main path's 98 blocks fill less
// than one wave).
constexpr int kBitmaskThreads = 512;
constexpr int kBitmaskWarps = kBitmaskThreads / 32;
constexpr int kBitmaskMaxBlock = 16384;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
// radix counters, (digit, warp) order; each thread scans kPerThread of them
constexpr int kCounters = kDigits * kBitmaskWarps;
constexpr int kPerThread = kCounters / kBitmaskThreads;

// Zero the n words at p with 16-byte stores between a scalar head and tail.
__device__ __forceinline__ void zero_words(unsigned* p, int n) {
  const int head =
      min(n, (int)(((16u - ((unsigned)(size_t)p & 15u)) & 15u) >> 2));
  const int vec = (n - head) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = 0u;
  for (int i = threadIdx.x; i < vec; i += blockDim.x)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = head + 4 * vec + threadIdx.x; i < n; i += blockDim.x)
    p[i] = 0u;
}

// This warp's span of [0, n): whole rounds of 32, in warp order.
__device__ __forceinline__ void warp_span(int n, int* lo, int* hi) {
  const int span =
      (n + 32 * kBitmaskWarps - 1) / (32 * kBitmaskWarps) * 32;
  *lo = min((int)(threadIdx.x >> 5) * span, n);
  *hi = min(*lo + span, n);
}

// One stable pass of the radix sort: records [0, n) of (so, sv) to
// (dst_o, dst_v) by the digit of the owner at `shift`.
__device__ void radix_pass(const int* so, const unsigned short* sv,
                           int* dst_o, unsigned short* dst_v, int n,
                           int shift, int* cnt, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kCounters; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  int lo, hi;
  warp_span(n, &lo, &hi);
  // the warp's count per digit; a digit's lowest lane adds its peers
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int d = i < hi ? (so[i] >> shift) & (kDigits - 1) : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (i < hi && (peers & below) == 0) cnt[d * kBitmaskWarps + warp] +=
        __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int run = 0, mine[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    mine[k] = run;
    run += cnt[threadIdx.x * kPerThread + k];
  }
  int total;
  const int at = block_exclusive_scan(run, &total, scratch);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    cnt[threadIdx.x * kPerThread + k] = at + mine[k];
  __syncthreads();
  // scatter in order: the warp's next slot per digit plus the rank among
  // this round's peers
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int o = i < hi ? so[i] : 0;
    const unsigned short v = i < hi ? sv[i] : 0;
    const int d = i < hi ? (o >> shift) & (kDigits - 1) : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int slot = i < hi ? cnt[d * kBitmaskWarps + warp] : 0;
    __syncwarp();
    if (i < hi) {
      dst_o[slot + __popc(peers & below)] = o;
      dst_v[slot + __popc(peers & below)] = v;
      if ((peers & below) == 0)
        cnt[d * kBitmaskWarps + warp] = slot + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBitmaskThreads)
delta_bitmask_kernel(const int* __restrict__ owner,
                     const int* __restrict__ is_upper,
                     const int* __restrict__ valid, unsigned* __restrict__ add,
                     unsigned* __restrict__ del, int block_size,
                     int num_words, int passes) {
  // two buffers of block_size owners, then two of block_size positions
  extern __shared__ __align__(16) unsigned char bitmask_smem[];
  __shared__ int cnt[kCounters];
  __shared__ int scratch[33];
  __shared__ int warp_kept[kBitmaskWarps];
  int* so = reinterpret_cast<int*>(bitmask_smem);
  int* to = so + block_size;
  unsigned short* sv = reinterpret_cast<unsigned short*>(to + block_size);
  unsigned short* tv = sv + block_size;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const size_t row = (size_t)blockIdx.x * num_words;
  const long long seg0 = (long long)blockIdx.x * block_size;
  const long long owners = 32LL * num_words;
  zero_words(add + row, num_words);
  zero_words(del + row, num_words);

  // step 1: the kept records in position order (loads issued together,
  // none waiting on another)
  int lo, hi;
  warp_span(block_size, &lo, &hi);
  int kept = 0;
#pragma unroll 4
  for (int base = lo; base < hi; base += 32) {
    const long long g = seg0 + base + lane;
    bool keep = false;
    if (base + lane < hi)
      keep = (valid[g] != 0) & (max(owner[g], 0) < owners);
    kept += __popc(__ballot_sync(0xffffffffu, keep));
  }
  if (lane == 0) warp_kept[warp] = kept;
  __syncthreads();
  int n = 0, at = 0;
  for (int w = 0; w < kBitmaskWarps; ++w) {
    at += w < warp ? warp_kept[w] : 0;
    n += warp_kept[w];
  }
#pragma unroll 4
  for (int base = lo; base < hi; base += 32) {
    const int t = base + lane;
    const long long g = seg0 + t;
    int o = 0, up = 0;
    bool keep = false;
    if (t < hi) {
      o = max(owner[g], 0);
      up = is_upper[g] != 0;
      keep = (valid[g] != 0) & (o < owners);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      so[at + __popc(ballot & below)] = o;
      sv[at + __popc(ballot & below)] = (unsigned short)(t << 1 | up);
    }
    at += __popc(ballot);
  }
  __syncthreads();

  // step 2: stable radix sort by owner, the result back in (so, sv)
  for (int p = 0; p < passes; ++p) {
    radix_pass(so, sv, to, tv, n, p * kDigitBits, cnt, scratch);
    int* x = so;
    so = to;
    to = x;
    unsigned short* y = sv;
    sv = tv;
    tv = y;
  }

  // step 3: decide each record from its neighbours in (owner, position)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int o = so[i];
    const unsigned bit = 1u << (o & 31);
    const size_t w = row + (o >> 5);
    if (sv[i] & 1u) {
      if (i == 0 || so[i - 1] != o || (sv[i - 1] & 1u)) atomicOr(del + w, bit);
    } else if (i + 1 == n || so[i + 1] != o) {
      atomicOr(add + w, bit);
    }
  }
}

// Pass C — pair emission.  Replaces _emission_pairs_kernel.
//
// The Pallas kernel replays each segment in order: an endpoint opens or
// closes its own extent, an upper endpoint emits the counterpart set as it
// stands.  On this card such a chain is bound by the latency of its steps
// (each a dependent shared-memory access and a dozen instructions of one
// warp), not by bytes: a segment's outputs are a few KB.  So
// the design takes what it can off the chain and shortens the rest:
//
//   1. Everything that has a closed form is computed by all threads in
//      parallel before any replay.  At an upper endpoint the counterpart
//      set's popcount is the popcount entering the segment plus the
//      counterpart lowers before it in the segment minus the counterpart
//      uppers before it (each extent's lower precedes its upper in the
//      sorted stream): block scans of those ±1 indicators give every
//      emission count (the same count as pass B's emission_kernel), a scan
//      of the counts every upper's slot base, and their sum the segment's
//      total.  The XOR of the set's member ids has the same form (XOR in
//      at a lower, XOR out at an upper), so where the count is 1 the XOR
//      scan is the one member and that pair is written right there.
//   2. Only emissions of two or more pairs need the set itself, and the
//      two sets are independent: the subscription set changes only at
//      subscription endpoints and is read only at update uppers, and the
//      other way round.  So warp 0 replays the subscription set and warp 1
//      the update set, in parallel, each from a list built in step 1 that
//      holds, in stream order, a toggle for each endpoint of its own type
//      and an emission for each counterpart upper with a count >= 2.
//   3. A run of toggles between two emissions commutes (a lower's bit is
//      clear, an upper's set: each toggle flips one bit), so the warp
//      applies up to 32 of them at once with shared-memory atomics.
//      Each set keeps its mask words and two levels of summary: bit b of
//      summary word s is set iff mask word 32 s + b is nonzero, bit b of
//      top word t iff summary word 32 t + b is (one warp load covers the
//      top level up to n = 2^20); after the flips each lane rewrites the
//      summary bit of its word, then the top bit.  An emission walks the
//      summaries down to the nonzero mask words, lists them, reads them
//      32 at a time (one a lane) and gives each set bit its slot: the base
//      plus its rank in ascending id order from a warp prefix of popcounts
//      (six independent ballots).  That is the Pallas kernel's order, so
//      the (num_blocks, cap) arrays are equal element for element.  Steps
//      are ordered by __syncwarp.
//
// The masks live in shared memory when both fit beside the lists and
// summaries (kSharedMasks; at n = m = 1e5, 2 x 12.5 KB); otherwise in the
// block's rows of the global scratch sub_mask / upd_mask (at n = m = 1e6,
// 2 x 125 KB), read past L1 (the atomics land in L2), with the summaries
// still in shared memory so only nonzero words are read.  The C entry
// point chooses.  Slots are int32, as in the Pallas kernel: the entry
// point takes cap < 2^31.
//
// The closed forms and the XOR toggles hold only where the Pallas
// kernel's set and clear are flips: a sorted stream (each extent's lower
// before its upper) and entering sets that agree with it, as ops builds
// them.  The kernel checks that as it goes, at no cost to the chain beyond
// a match and a compare per toggle run: a toggle that finds its bit the
// wrong way, or a negative count.  Where every toggle is a flip the
// replayed sets are the Pallas kernel's at every step, so the check is
// exact.  A block that fails it then takes the general path (4): the
// Pallas semantics for any records.
//
//   4. The block restores its live masks and summaries from the entering
//      sets, refills its (1, cap) row of out_i / out_j with -1 (no other
//      block writes there), and warp 0 replays the segment in stream
//      order: at an upper it emits the counterpart set in ascending id
//      order at the running slot (emit_set; slots >= cap dropped) and
//      advances it by the set's popcount, kept as a running count; then
//      the endpoint sets (lower) or clears (upper) its own bit.  One warp,
//      one record at a time: only exact, not fast.  *general counts the
//      blocks that took it; nothing waits for it.

// static shared memory of emit_pairs_kernel, kept out of the dynamic budget
constexpr int kPassCStaticSmem = 1024;
// a replay warp's list of the nonzero mask words under one top word
constexpr int kStage = 32 * 32;

__host__ __device__ inline int words_over(int bits) { return (bits + 31) / 32; }

// Dynamic shared memory of pass C: two lists of block_size entries (id,
// count, slot base; int each), the two replay warps' stages, the two
// summary levels of both sets, and the masks when kSharedMasks.
__host__ __device__ inline size_t pass_c_smem(int block_size, int ws, int wu,
                                              bool shared_masks) {
  const size_t words = 6 * (size_t)block_size + 2 * kStage + words_over(ws) +
                       words_over(words_over(ws)) + words_over(wu) +
                       words_over(words_over(wu)) +
                       (shared_masks ? (size_t)ws + wu : 0);
  return words * 4;
}

// One live active set: its mask words and the two summary levels.
struct ActiveSet {
  unsigned* mask;
  unsigned* sum;   // bit b of word s: mask word 32 s + b is nonzero
  unsigned* top;   // bit b of word t: sum word 32 t + b is nonzero
  int nsum, ntop;
};

template <bool kShared>
__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  return kShared ? *p : __ldcg(p);
}

// The XOR of the ids 32 w + b of the set bits b of word x of index w.
__device__ __forceinline__ unsigned word_xor(unsigned x, int w) {
  unsigned bits = 0u;
  const unsigned sel[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u, 0xFF00FF00u,
                           0xFFFF0000u};
#pragma unroll
  for (int j = 0; j < 5; ++j) bits |= (unsigned)(__popc(x & sel[j]) & 1) << j;
  return (__popc(x) & 1 ? (unsigned)w << 5 : 0u) ^ bits;
}

// Exclusive prefix over the warp and warp total of v in [0, 63]: six
// independent ballots instead of five dependent shuffles.
__device__ __forceinline__ int warp_prefix_small(int v, int* total) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int excl = 0, tot = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const unsigned bits = __ballot_sync(0xffffffffu, (v >> b) & 1);
    excl += __popc(bits & below) << b;
    tot += __popc(bits) << b;
  }
  *total = tot;
  return excl;
}

// Warp-cooperative: the members of `a` at slots base, base + 1, ... in
// ascending id order, `count` in all; slots >= cap are dropped.  (i, j)
// is (member, o) for the subscription set, (o, member) for the update set.
// Per nonzero top word, the nonzero mask words under its 32 summary words
// are listed in `stage` (the warp's kStage ints) in ascending order, then
// read 32 at a time, one a lane: a dense set costs a round per 32 words,
// not per summary word.
template <bool kShared>
__device__ __forceinline__ void emit_set(const ActiveSet& a, bool subs, int o,
                                         int base, int count, int cap,
                                         int* oi, int* oj, int* stage) {
  const int lane = threadIdx.x & 31;
  int dest0 = base;  // the next free slot, the same in every lane
  const int stop = (int)min((long long)base + count, (long long)cap);
  for (int t0 = 0; t0 < a.ntop && dest0 < stop; t0 += 32) {
    const unsigned tw = t0 + lane < a.ntop ? a.top[t0 + lane] : 0u;
    unsigned tops = __ballot_sync(0xffffffffu, tw != 0u);
    while (tops != 0u && dest0 < stop) {
      const int tl = __ffs(tops) - 1;
      tops &= tops - 1u;
      const unsigned tbits = __shfl_sync(0xffffffffu, tw, tl);
      const int si = (t0 + tl) * 32 + lane;
      const unsigned sw = (tbits >> lane) & 1u ? a.sum[si] : 0u;
      int nwords;
      int at = warp_prefix_small(__popc(sw), &nwords);
      for (unsigned y = sw; y != 0u; y &= y - 1u)
        stage[at++] = si * 32 + (__ffs(y) - 1);
      __syncwarp();
      for (int r = 0; r < nwords && dest0 < stop; r += 32) {
        const int w = r + lane < nwords ? stage[r + lane] : -1;
        const unsigned x = w >= 0 ? load_word<kShared>(a.mask + w) : 0u;
        int total;
        int dest = dest0 + warp_prefix_small(__popc(x), &total);
        for (unsigned y = x; y != 0u && dest < cap; y &= y - 1u, ++dest) {
          const int id = w * 32 + (__ffs(y) - 1);
          oi[dest] = subs ? id : o;
          oj[dest] = subs ? o : id;
        }
        dest0 += total;
      }
      __syncwarp();   // the next top word rewrites the stage
    }
  }
}

// Warp-cooperative: flip the bits of ids[0 .. run) (run <= 32; lane l
// takes ids[l], an upper where kinds[l] < 0) and bring both summary
// levels up to date.  Returns, per lane, whether its toggle broke the
// contract that makes a flip a set or a clear: a lower must find its bit
// clear, an upper set.  The bit before a lane's toggle is the word's bit
// after the run, undone by the parity of the run's toggles of that id and
// redone by those of the lanes before it (the run is in stream order).
template <bool kShared>
__device__ __forceinline__ bool toggle_run(const ActiveSet& a, const int* ids,
                                           const int* kinds, int run) {
  const int lane = threadIdx.x & 31;
  const bool mine = lane < run;
  const int o = mine ? ids[lane] : 0;
  const bool up = mine && kinds[lane] < 0;
  const int w = o >> 5, s = o >> 10;
  const unsigned peers = __match_any_sync(0xffffffffu, mine ? o : -1 - lane);
  if (mine) atomicXor(a.mask + w, 1u << (o & 31));
  if (!kShared) __threadfence_block();
  __syncwarp();
  bool broken = false;
  if (mine) {
    const unsigned x = load_word<kShared>(a.mask + w);
    const unsigned below = (1u << lane) - 1u;
    const unsigned was =
        ((x >> (o & 31)) ^ __popc(peers) ^ __popc(peers & below)) & 1u;
    broken = was != (up ? 1u : 0u);
    const unsigned bit = 1u << (w & 31);
    if (x != 0u) atomicOr(a.sum + s, bit);
    else atomicAnd(a.sum + s, ~bit);
  }
  __syncwarp();
  if (mine) {
    const unsigned bit = 1u << (s & 31);
    if (a.sum[s] != 0u) atomicOr(a.top + (s >> 5), bit);
    else atomicAnd(a.top + (s >> 5), ~bit);
  }
  __syncwarp();
  return broken;
}

// Warp-cooperative, lane 0 writes: set (a lower) or clear (an upper) bit
// o of `a` and bring both summary levels up to date.  Returns, in every
// lane, the change of the set's popcount (-1, 0 or +1).
template <bool kShared>
__device__ __forceinline__ int set_or_clear(const ActiveSet& a, int o,
                                            bool up) {
  int change = 0;
  if ((threadIdx.x & 31) == 0) {
    const int w = o >> 5, s = o >> 10;
    const unsigned bit = 1u << (o & 31);
    const unsigned was = up ? atomicAnd(a.mask + w, ~bit)
                            : atomicOr(a.mask + w, bit);
    const unsigned now = up ? was & ~bit : was | bit;
    change = (int)__popc(now) - (int)__popc(was);
    if (now != 0u) atomicOr(a.sum + s, 1u << (w & 31));
    else atomicAnd(a.sum + s, ~(1u << (w & 31)));
    if (a.sum[s] != 0u) atomicOr(a.top + (s >> 5), 1u << (s & 31));
    else atomicAnd(a.top + (s >> 5), ~(1u << (s & 31)));
    if (!kShared) __threadfence_block();
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, change, 0);
}

// Both summary levels of `a` from its mask words (all warps; a barrier
// must separate build_sum from build_top).
__device__ __forceinline__ void build_sum(const ActiveSet& a, int nw) {
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < a.nsum; s += blockDim.x >> 5) {
    const int w = s * 32 + lane;
    const unsigned b = __ballot_sync(0xffffffffu, w < nw && a.mask[w] != 0u);
    if (lane == 0) a.sum[s] = b;
  }
}

__device__ __forceinline__ void build_top(const ActiveSet& a) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < a.ntop; t += blockDim.x >> 5) {
    const int s = t * 32 + lane;
    const unsigned b = __ballot_sync(0xffffffffu, s < a.nsum && a.sum[s] != 0u);
    if (lane == 0) a.top[t] = b;
  }
}

template <bool kSharedMasks>
__global__ void __launch_bounds__(kThreads)
emit_pairs_kernel(const int* __restrict__ owner,
                  const int* __restrict__ is_upper,
                  const int* __restrict__ is_sub,
                  const int* __restrict__ valid,
                  const unsigned* __restrict__ sub0,
                  const unsigned* __restrict__ upd0, unsigned* sub_scratch,
                  unsigned* upd_scratch, int* __restrict__ out_i,
                  int* __restrict__ out_j, int* __restrict__ general,
                  int block_size, int ws, int wu, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[33];
  __shared__ unsigned scratch_x[33];
  __shared__ long long scratch_ll[33];
  __shared__ int list_len[2];
  __shared__ int fill_from;
  __shared__ int off_contract;   // a toggle or a count broke the contract
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t p = blockIdx.x;
  // list L (0: the subscription set's, 1: the update set's) at
  // [L * block_size, L * block_size + list_len[L])
  int* e_id = reinterpret_cast<int*>(smem);
  int* e_count = e_id + 2 * block_size;   // toggles: 0 lower, -1 upper
  int* e_base = e_count + 2 * block_size;
  ActiveSet sset, uset;
  sset.nsum = words_over(ws);
  sset.ntop = words_over(sset.nsum);
  uset.nsum = words_over(wu);
  uset.ntop = words_over(uset.nsum);
  int* stage = e_base + 2 * block_size;   // kStage ints per replay warp
  sset.sum = reinterpret_cast<unsigned*>(stage + 2 * kStage);
  sset.top = sset.sum + sset.nsum;
  uset.sum = sset.top + sset.ntop;
  uset.top = uset.sum + uset.nsum;
  if (kSharedMasks) {
    sset.mask = uset.top + uset.ntop;
    uset.mask = sset.mask + ws;
  } else {
    sset.mask = sub_scratch + p * ws;
    uset.mask = upd_scratch + p * wu;
  }
  int* oi = out_i + p * cap;
  int* oj = out_j + p * cap;

  // the live masks; popcount and id XOR of the sets entering the segment
  int cs = 0, cu = 0;
  unsigned xs = 0u, xu = 0u;
  for (int w = tid; w < ws; w += blockDim.x) {
    const unsigned x = sub0[p * ws + w];
    sset.mask[w] = x;
    cs += __popc(x);
    xs ^= word_xor(x, w);
  }
  for (int w = tid; w < wu; w += blockDim.x) {
    const unsigned x = upd0[p * wu + w];
    uset.mask[w] = x;
    cu += __popc(x);
    xu ^= word_xor(x, w);
  }
  int cs0, cu0;
  unsigned xs0, xu0;
  if (tid == 0) off_contract = 0;
  block_exclusive_scan(cs, &cs0, scratch);   // its barriers publish the masks
  block_exclusive_scan(cu, &cu0, scratch);
  block_exclusive_scan(xs, &xs0, scratch_x, Xor());
  block_exclusive_scan(xu, &xu0, scratch_x, Xor());
  build_sum(sset, ws);
  build_sum(uset, wu);

  // step 1: each thread a contiguous chunk of the segment's records
  const long long seg0 = (long long)p * block_size;
  const int chunk = (block_size + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * chunk, block_size);
  const int hi = min(lo + chunk, block_size);
  int ds = 0, du = 0;
  xs = xu = 0u;
  for (int i = lo; i < hi; ++i) {
    const long long g = seg0 + i;
    if (!valid[g]) continue;
    const int d = is_upper[g] ? -1 : 1;
    if (is_sub[g]) { ds += d; xs ^= owner[g]; }
    else           { du += d; xu ^= owner[g]; }
  }
  int tot;
  unsigned xtot;
  const int as0 = block_exclusive_scan(ds, &tot, scratch) + cs0;
  const int au0 = block_exclusive_scan(du, &tot, scratch) + cu0;
  const unsigned xs1 = block_exclusive_scan(xs, &xtot, scratch_x, Xor()) ^ xs0;
  const unsigned xu1 = block_exclusive_scan(xu, &xtot, scratch_x, Xor()) ^ xu0;
  build_top(sset);   // the scans' barriers published the summaries
  build_top(uset);
  // entries per list and the sum of counts of the chunk
  int n0 = 0, n1 = 0;
  long long mine = 0;
  int as = as0, au = au0;
  for (int i = lo; i < hi; ++i) {
    const long long g = seg0 + i;
    if (!valid[g]) continue;
    const bool sb = is_sub[g] != 0, up = is_upper[g] != 0;
    const int c = up ? (sb ? au : as) : 0;
    if (sb) { as += up ? -1 : 1; ++n0; n1 += c >= 2; }
    else    { au += up ? -1 : 1; ++n1; n0 += c >= 2; }
    mine += c;
  }
  int len0, len1;
  long long seg_total;
  int at0 = block_exclusive_scan(n0, &len0, scratch);
  int at1 = block_exclusive_scan(n1, &len1, scratch) + block_size;
  long long slot = block_exclusive_scan(mine, &seg_total, scratch_ll);
  // the entries, and the pairs of the uppers whose count is 1; a negative
  // count breaks the contract (an upper before its lower, or entering
  // sets that disagree with the records)
  bool bad = false;
  as = as0;
  au = au0;
  xs = xs1;
  xu = xu1;
  for (int i = lo; i < hi; ++i) {
    const long long g = seg0 + i;
    if (!valid[g]) continue;
    const bool sb = is_sub[g] != 0, up = is_upper[g] != 0;
    const int o = owner[g];
    const int c = up ? (sb ? au : as) : 0;
    const int own = sb ? at0++ : at1++;
    e_id[own] = o;
    e_count[own] = up ? -1 : 0;
    bad |= c < 0;
    if (c >= 2) {
      const int other = sb ? at1++ : at0++;
      e_id[other] = o;
      e_count[other] = c;
      e_base[other] = (int)max(min(slot, (long long)cap), 0LL);
    } else if (c == 1 && slot >= 0 && slot < cap) {
      const int member = (int)(sb ? xu : xs);
      oi[slot] = sb ? o : member;
      oj[slot] = sb ? member : o;
    }
    if (sb) { as += up ? -1 : 1; xs ^= o; }
    else    { au += up ? -1 : 1; xu ^= o; }
    slot += c;
  }
  if (bad) off_contract = 1;
  if (tid == 0) {
    list_len[0] = len0;
    list_len[1] = len1;
    fill_from = (int)max(min(seg_total, (long long)cap), 0LL);
  }
  __syncthreads();

  // steps 2-3: warp 0 replays the subscription set, warp 1 the update
  // set; the other warps fill the slots no pair lands in
  if (warp >= 2) {
    for (int s = fill_from + tid - 64; s < cap; s += blockDim.x - 64) {
      oi[s] = -1;
      oj[s] = -1;
    }
  } else {
    const bool subs = warp == 0;
    const ActiveSet a = subs ? sset : uset;
    const int n = list_len[warp];
    const int* id_l = e_id + warp * block_size;
    const int* count_l = e_count + warp * block_size;
    const int* base_l = e_base + warp * block_size;
    bool flipped_wrong = false;
    for (int k = 0; k < n;) {
      // the run of toggles starting at k, up to 32
      const bool in = k + lane < n;
      const unsigned stops =
          __ballot_sync(0xffffffffu, !in || count_l[k + lane] > 0);
      const int run = stops != 0u ? __ffs(stops) - 1 : 32;
      if (run > 0) {
        flipped_wrong |=
            toggle_run<kSharedMasks>(a, id_l + k, count_l + k, run);
        k += run;
      } else {
        const int b = base_l[k];
        if (b < cap)
          emit_set<kSharedMasks>(a, subs, id_l[k], b, count_l[k], cap, oi, oj,
                                 stage + warp * kStage);
        __syncwarp();
        ++k;
      }
    }
    if (flipped_wrong) off_contract = 1;
  }
  __syncthreads();
  if (!off_contract) return;   // the same in every thread of the block

  // step 4, the general path: the Pallas kernel's replay
  if (tid == 0) atomicAdd(general, 1);
  for (int s = tid; s < cap; s += blockDim.x) {
    oi[s] = -1;
    oj[s] = -1;
  }
  for (int w = tid; w < ws; w += blockDim.x) sset.mask[w] = sub0[p * ws + w];
  for (int w = tid; w < wu; w += blockDim.x) uset.mask[w] = upd0[p * wu + w];
  if (!kSharedMasks) __threadfence_block();
  __syncthreads();
  build_sum(sset, ws);
  build_sum(uset, wu);
  __syncthreads();
  build_top(sset);
  build_top(uset);
  __syncthreads();
  if (warp != 0) return;
  int live_s = cs0, live_u = cu0;   // the sets' popcounts
  long long ptr = 0;
  for (int i = 0; i < block_size; ++i) {
    const long long g = seg0 + i;
    if (!valid[g]) continue;
    const bool sb = is_sub[g] != 0, up = is_upper[g] != 0;
    const int o = owner[g];
    if (up) {
      const int c = sb ? live_u : live_s;
      if (ptr < cap)
        emit_set<kSharedMasks>(sb ? uset : sset, !sb, o, (int)ptr, c, cap, oi,
                               oj, stage);
      __syncwarp();
      ptr += c;
    }
    const int change = set_or_clear<kSharedMasks>(sb ? sset : uset, o, up);
    if (sb) live_s += change;
    else    live_u += change;
  }
}

// Algorithm 6's exclusive scan of one extent type's per-segment delta
// words:  active[0] = 0,  active[p] = (active[p-1] & ~del[p-1]) | add[p-1].
// Row p is the transformer S -> (S & ~del[p]) | add[p]; two of them
// compose (apply 1, then 2) as A = (A1 & ~D2) | A2, D = D1 | D2, which is
// exact for any words, add and del overlapping included, since only A is
// read out.  The paper's two-level scan (Fig. 5) on this monoid: a block
// takes kScanCols word columns and cuts the rows into kScanChunks chunks,
// a warp a chunk; each thread composes its chunk of its column in
// registers, the block composes the chunks' transformers in order in
// shared memory (the master step), and each thread walks its chunk again
// from that carry, writing the active words.  A warp reads one row's 32
// consecutive words (128 bytes, whole sectors) a load, so rows of any
// width and alignment take the same 4-byte path; each word of add and del
// is read twice (the second time partly from L2) and active written once.
constexpr int kScanCols = 32;
constexpr int kScanChunks = 8;

__global__ void __launch_bounds__(kScanCols * kScanChunks)
delta_scan_kernel(const unsigned* __restrict__ add,
                  const unsigned* __restrict__ del,
                  unsigned* __restrict__ active, int num_words, int rows) {
  __shared__ unsigned chunk_a[kScanChunks][kScanCols];
  __shared__ unsigned chunk_d[kScanChunks][kScanCols];
  const int col = threadIdx.x, chunk = threadIdx.y;
  const long long w = (long long)blockIdx.x * kScanCols + col;
  const bool live = w < num_words;
  const size_t stride = (size_t)num_words;
  const int len = (rows + kScanChunks - 1) / kScanChunks;
  const int r0 = min(chunk * len, rows), r1 = min(r0 + len, rows);
  unsigned a = 0u, d = 0u;
  if (live) {
    const unsigned* pa = add + r0 * stride + w;
    const unsigned* pd = del + r0 * stride + w;
#pragma unroll 8
    for (int r = r0; r < r1; ++r, pa += stride, pd += stride) {
      const unsigned x = __ldg(pa), y = __ldg(pd);
      a = (a & ~y) | x;
      d |= y;
    }
  }
  chunk_a[chunk][col] = a;
  chunk_d[chunk][col] = d;
  __syncthreads();
  if (!live) return;
  unsigned acc = 0u;   // the active words entering this chunk
  for (int c = 0; c < chunk; ++c)
    acc = (acc & ~chunk_d[c][col]) | chunk_a[c][col];
  const unsigned* pa = add + r0 * stride + w;
  const unsigned* pd = del + r0 * stride + w;
  unsigned* out = active + r0 * stride + w;
#pragma unroll 8
  for (int r = r0; r < r1; ++r, pa += stride, pd += stride, out += stride) {
    *out = acc;
    acc = (acc & ~__ldg(pd)) | __ldg(pa);
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
  if (blocks <= 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = block_size % 4 == 0 && total % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(deltas) |
                     reinterpret_cast<uintptr_t>(emit)) & 15) == 0;
  const int V = vec ? 4 : 1;
  const int lanes = ((block_size + V - 1) / V + 31) / 32 * 32;
  const int threads = lanes < kEmitMaxThreads ? lanes : kEmitMaxThreads;
  emission_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      EmissionArgs{deltas, offsets, emit, block_emit, total, block_size},
      vec ? 1 : 0);
  return (int)cudaGetLastError();
}

int sbm_delta_bitmasks(const int* owner, const int* is_upper,
                       const int* valid, unsigned* add, unsigned* del,
                       long long total, int block_size, int num_words,
                       void* stream) {
  if (block_size < 1 || block_size > kBitmaskMaxBlock || num_words < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = total / block_size;
  if (blocks <= 0) return (int)cudaGetLastError();
  // radix passes: the bytes of the largest owner id kept (owner < 2^31)
  const long long top = 32LL * num_words - 1;
  int bits = 0;
  while (bits < 31 && (top >> bits) != 0) ++bits;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  const int smem = 12 * block_size;
  const cudaError_t err = cudaFuncSetAttribute(
      delta_bitmask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  delta_bitmask_kernel<<<(unsigned)blocks, kBitmaskThreads, smem,
                         (cudaStream_t)stream>>>(owner, is_upper, valid, add,
                                                 del, block_size, num_words,
                                                 passes);
  return (int)cudaGetLastError();
}

// 1 when pass C keeps its masks in shared memory, 0 when in the global
// scratch rows, -1 when not even the lists and summaries fit.
int sbm_emit_pairs_placement(int block_size, int ws, int wu) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const size_t room = (size_t)optin - kPassCStaticSmem;
  if (pass_c_smem(block_size, ws, wu, true) <= room) return 1;
  if (pass_c_smem(block_size, ws, wu, false) <= room) return 0;
  return -1;
}

// The largest segment (records) pass C takes for these W on this card:
// its lists, stages and summaries in shared memory, the masks in the
// global scratch rows; 0 when not even one record's lists fit.
int sbm_emit_pairs_max_block(int ws, int wu) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t room = (size_t)optin - kPassCStaticSmem;
  const size_t fixed = pass_c_smem(0, ws, wu, false);
  if (fixed >= room) return 0;
  return (int)((room - fixed) / (6 * sizeof(int)));
}

// *general: incremented by each block that took the general path (the
// caller zeroes it; nothing here reads it back).
int sbm_emit_pairs(const int* owner, const int* is_upper, const int* is_sub,
                   const int* valid, const unsigned* sub0,
                   const unsigned* upd0, unsigned* sub_mask,
                   unsigned* upd_mask, int* out_i, int* out_j, int* general,
                   long long total, int block_size, int ws, int wu,
                   long long cap, void* stream) {
  const long long blocks = total / block_size;
  if (blocks <= 0) return (int)cudaGetLastError();
  if (cap < 1 || cap > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int place = sbm_emit_pairs_placement(block_size, ws, wu);
  if (place < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pass_c_smem(block_size, ws, wu, place == 1);
  auto kernel = place == 1 ? emit_pairs_kernel<true> : emit_pairs_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      owner, is_upper, is_sub, valid, sub0, upd0, sub_mask, upd_mask, out_i,
      out_j, general, block_size, ws, wu, (int)cap);
  return (int)cudaGetLastError();
}

// One extent type's active words entering each of `rows` segments of
// `num_words` words.
int sbm_delta_scan(const unsigned* add, const unsigned* del, unsigned* active,
                   int num_words, int rows, void* stream) {
  if (rows < 1 || num_words < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((num_words + kScanCols - 1) / kScanCols));
  delta_scan_kernel<<<grid, dim3(kScanCols, kScanChunks), 0,
                      (cudaStream_t)stream>>>(add, del, active, num_words,
                                               rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
