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
// radix counters, (digit, warp) order, kDigits a warp; each thread scans
// kPerThread of them
constexpr int kPerThread = kDigits / 32;

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

// This warp's span of [0, n) in a block of kWarps warps: whole rounds of
// 32, in warp order.
template <int kWarps>
__device__ __forceinline__ void warp_span(int n, int* lo, int* hi) {
  const int span = (n + 32 * kWarps - 1) / (32 * kWarps) * 32;
  *lo = min((int)(threadIdx.x >> 5) * span, n);
  *hi = min(*lo + span, n);
}

// One stable pass of the radix sort by a block of kWarps warps: records
// [0, n) of (so, sv) to (dst_o, dst_v) by the digit of the owner at
// `shift`; `cnt` holds kDigits * kWarps ints.
template <int kWarps>
__device__ void radix_pass(const int* so, const unsigned short* sv,
                           int* dst_o, unsigned short* dst_v, int n,
                           int shift, int* cnt, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kDigits * kWarps; i += blockDim.x)
    cnt[i] = 0;
  __syncthreads();
  int lo, hi;
  warp_span<kWarps>(n, &lo, &hi);
  // the warp's count per digit; a digit's lowest lane adds its peers
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int d = i < hi ? (so[i] >> shift) & (kDigits - 1) : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (i < hi && (peers & below) == 0) cnt[d * kWarps + warp] +=
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
    const int slot = i < hi ? cnt[d * kWarps + warp] : 0;
    __syncwarp();
    if (i < hi) {
      dst_o[slot + __popc(peers & below)] = o;
      dst_v[slot + __popc(peers & below)] = v;
      if ((peers & below) == 0)
        cnt[d * kWarps + warp] = slot + __popc(peers);
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
  __shared__ int cnt[kDigits * kBitmaskWarps];
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
  warp_span<kBitmaskWarps>(block_size, &lo, &hi);
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
    radix_pass<kBitmaskWarps>(so, sv, to, tv, n, p * kDigitBits, cnt,
                              scratch);
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
// stands.  On this card such a chain is bound by the latency of its steps,
// not by bytes: a segment's outputs are a few hundred KB at most.  So no
// step of the main path waits on the record before it in the stream:
//
//   1. Everything that has a closed form is computed by all threads in
//      parallel.  At an upper endpoint the counterpart set's popcount is
//      the popcount entering the segment plus the counterpart lowers
//      before it in the segment minus the counterpart uppers before it
//      (each extent's lower precedes its upper in the sorted stream):
//      block scans of those ±1 indicators give every emission count (the
//      same count as pass B's emission_kernel), a scan of the counts every
//      upper's slot base, and their sum the segment's total.  The XOR of
//      the set's member ids has the same form (XOR in at a lower, XOR out
//      at an upper), so where the count is 1 the XOR scan is the one
//      member and that pair is written right there.
//   2. The list path answers every other upper on its own, with no
//      replay.  For one side T of the segment, every extent that can be
//      active anywhere in it is one entry (id, open, close): a member of
//      the entering set with open = -1, a lower of side T with open = its
//      position; close is the position of the extent's upper in the
//      segment, or the segment's end.  The counterpart set at the upper at
//      position i is exactly the entries with open < i < close, in
//      ascending id order: the replay's set in the replay's order, so the
//      (num_blocks, cap) arrays are equal element for element.
//      (a) While step 1 reads the entering rows (coalesced, once), every
//          set bit is appended to the sort buffer as an entering record;
//          step 1 then appends the segment's valid records in position
//          order.
//      (b) A stable LSD radix sort on (side, owner) in shared memory, 8-bit
//          digits, __match_any_sync ranks (radix_pass, as the delta-bitmask
//          kernel sorts): each owner's records become one run, its
//          entering record first, then its records in position order.
//      (c) Each thread checks the runs at its records against the only
//          patterns a sorted stream with exact entering sets gives
//          (entering; entering, upper; lower; lower, upper) and writes the
//          packed (open + 1, close) of each run's first record, 0 (never
//          active) for the others.
//      (d) The segment is cut into sub-ranges of kSubRange positions, one
//          warp each.  The warp lists, in id order, each side's entries
//          active anywhere in its sub-range (a ballot compaction through
//          its staging row), kHeld a lane into registers; so no upper
//          rescans the whole side.
//      (e) For every upper of the sub-range whose count is >= 2 the warp
//          tests the other side's entries held in its registers, 32 at a
//          time, and writes each one active at i to the slot base plus its
//          ballot rank (slots >= cap dropped); a list longer than the
//          registers hold is walked in shared memory.  All threads first
//          fill the slots no pair lands in with -1.
//      A block takes the list path when its lists fit the dynamic shared
//      memory (6 ints a record, two stages and the summaries, all taken
//      whole by the list path): a slot base a position, the sort's two
//      buffers (an int key and a 16-bit value for each record and entering
//      member) and its counters; the staging rows reuse the sort's spare
//      buffer.  So the choice is made per block, from its entering
//      popcounts and its record count.
//
// Slots are int32, as in the Pallas kernel: the entry point takes
// cap < 2^31.  The closed forms, the XOR and the list's patterns hold only
// where the Pallas kernel's set and clear are flips: a sorted stream (each
// extent's lower before its upper) and entering sets that agree with it,
// as ops builds them.  The list path checks every owner's run, each
// emission's member count against step 1's, and refuses a negative count;
// a block that fails a check, or whose lists do not fit, takes step 3.
//
//   3. The general path: the block restores its live masks and summaries
//      from the entering sets, refills its (1, cap) row of out_i / out_j
//      with -1 (no other block writes there), and warp 0 replays the
//      segment in stream order: at an upper it emits the counterpart set
//      in ascending id order at the running slot (emit_set; slots >= cap
//      dropped) and advances it by the set's popcount, kept as a running
//      count; then the endpoint sets (lower) or clears (upper) its own
//      bit.  Each set keeps its mask words and two levels of summary: bit b
//      of summary word s is set iff mask word 32 s + b is nonzero, bit b of
//      top word t iff summary word 32 t + b is (one warp load covers the
//      top level up to n = 2^20).  An emission walks the summaries down to
//      the nonzero mask words, lists them in `stage`, reads them 32 at a
//      time (one a lane) and gives each set bit its slot from a warp prefix
//      of popcounts.  The masks live in shared memory when they fit beside
//      the rest (kSharedMasks; at n = m = 1e5, 2 x 12.5 KB); otherwise in
//      the block's rows of the global scratch sub_mask / upd_mask (at
//      n = m = 1e6, 2 x 125 KB), read past L1.  The C entry point chooses.
//      One warp, one record at a time: only exact, not fast.  *general
//      counts the blocks that took it, those that left the list path;
//      nothing waits for it.

// static shared memory of emit_pairs_kernel, kept out of the dynamic budget
constexpr int kPassCStaticSmem = 1024;
// the general path's list of the nonzero mask words under one top word
constexpr int kStage = 32 * 32;
constexpr int kPassCWarps = kThreads / 32;
// positions a sub-range of the list path, and list entries a lane holds in
// registers for one (longer lists are walked in shared memory)
constexpr int kSubRange = 128;
constexpr int kHeld = 4;
// entering words a thread loads at once
constexpr int kRowLoads = 8;
// the sort value of an entering member (a record's is position << 1 |
// is_upper, below it: segments hold fewer than 2^15 records)
constexpr unsigned short kEntering = 0xffffu;

__host__ __device__ inline int words_over(int bits) { return (bits + 31) / 32; }

// Dynamic shared memory of pass C: 6 ints a record and two stages of
// kStage ints (the list path's sort and staging rows; the general path
// uses one stage), the two summary levels of both sets, and the masks when
// kSharedMasks.
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

// The list path's layout in the dynamic shared memory of `words` ints, for
// a segment of block_size records: the slot base of every position (and
// the segment's total at block_size), the sort's two buffers of n_max keys
// and of n_max 16-bit values (n_max even), the radix counters; after the
// sort the spare buffer's keys hold the packed (open + 1, close), and its
// values and the counters the warps' staging rows.
struct ListLayout {
  int* base;
  int* keys[2];
  unsigned short* vals[2];
  int* cnt;
  unsigned short* stage;   // 2 * 32 * kHeld a warp
  int n_max;               // records and entering members the sort takes
};

__device__ __forceinline__ ListLayout list_layout(int* smem, int words,
                                                  int block_size) {
  ListLayout l;
  const int base_words = (block_size + 2) & ~1;
  l.n_max = max((words - base_words - kDigits * kPassCWarps) / 3, 0) & ~1;
  l.base = smem;
  l.keys[0] = smem + base_words;
  l.keys[1] = l.keys[0] + l.n_max;
  l.vals[0] = reinterpret_cast<unsigned short*>(l.keys[1] + l.n_max);
  l.vals[1] = l.vals[0] + l.n_max;
  l.cnt = reinterpret_cast<int*>(l.vals[1] + l.n_max);
  l.stage = l.vals[1];
  return l;
}

// Warp-cooperative: the entries k of [lo, hi) (packed (open + 1, close))
// active at some position of [s, e), in ascending k; the first `room`
// written to out.  Returns their number.
__device__ __forceinline__ int active_in(const int* packed, int lo, int hi,
                                         int s, int e, unsigned short* out,
                                         int room) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  int got = 0;
  for (int k0 = lo; k0 < hi; k0 += 32) {
    const int k = k0 + (threadIdx.x & 31);
    const int x = k < hi ? packed[k] : 0;
    const int open1 = x >> 16, close = x & 0xffff;
    const bool in = open1 < e && s < close && open1 < close;
    const unsigned b = __ballot_sync(0xffffffffu, in);
    const int at = got + __popc(b & below);
    if (in && at < room) out[at] = (unsigned short)k;
    got += __popc(b);
  }
  return got;
}

// Steps 2 (b)-(e) for one block; sets *bad_flag where an owner's run or
// an emission's count broke the contract.  The sort input is in buffer
// `passes & 1`: n = entering members, then the records.
__device__ void list_emit(const ListLayout& l, int n, int block_size,
                          int key_bits, int passes, int cap, int fill_from,
                          const int* seg_sub, const int* seg_owner, int* oi,
                          int* oj, int* scratch, int* split, int* bad_flag) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  // (b) the sort, its result in buffer 0
  const bool odd = passes & 1;
  int* from_k = odd ? l.keys[1] : l.keys[0];
  int* to_k = odd ? l.keys[0] : l.keys[1];
  unsigned short* from_v = odd ? l.vals[1] : l.vals[0];
  unsigned short* to_v = odd ? l.vals[0] : l.vals[1];
  for (int p = 0; p < passes; ++p) {
    radix_pass<kPassCWarps>(from_k, from_v, to_k, to_v, n, p * kDigitBits,
                            l.cnt, scratch);
    int* k = from_k;
    from_k = to_k;
    to_k = k;
    unsigned short* v = from_v;
    from_v = to_v;
    to_v = v;
  }
  const int* key = l.keys[0];
  const unsigned short* val = l.vals[0];
  int* packed = l.keys[1];
  // (c) each owner's run; the first record of the update side
  bool bad = false;
  for (int k = tid; k < n; k += blockDim.x) {
    const int kk = key[k];
    const unsigned short v = val[k];
    const bool up = v != kEntering && (v & 1u);
    const bool first = k == 0 || key[k - 1] != kk;
    int x = 0;
    if (first) {
      if (up) {
        bad = true;   // an upper whose bit is clear: no lower, not entering
      } else {
        int close = block_size;
        if (k + 1 < n && key[k + 1] == kk && val[k + 1] != kEntering &&
            (val[k + 1] & 1u))
          close = val[k + 1] >> 1;
        x = (v == kEntering ? 0 : (v >> 1) + 1) << 16 | close;
      }
    } else if (!up || (k >= 2 && key[k - 2] == kk)) {
      bad = true;     // a lower after a record of its owner, or a third
    }
    packed[k] = x;
    if ((kk >> key_bits) != (k > 0 ? key[k - 1] >> key_bits : 0)) *split = k;
  }
  if (bad) *bad_flag = 1;
  __syncthreads();
  if (*bad_flag) return;
  for (int s = fill_from + tid; s < cap; s += blockDim.x) {
    oi[s] = -1;
    oj[s] = -1;
  }
  // (d) one warp a sub-range: each side's entries active anywhere in it,
  // listed in id order through the warp's staging row into registers
  // (kHeld a lane); side 0 (subscriptions) is [0, mid), side 1 [mid, n)
  const int mid = *split;
  const int held = 32 * kHeld;
  unsigned short* stage = l.stage + warp * 2 * held;
  const int owner_mask = (1 << key_bits) - 1;
  bool wrong = false;
  for (int r = warp; r * kSubRange < block_size; r += kPassCWarps) {
    const int s = r * kSubRange, e = min(s + kSubRange, block_size);
    const int len_s = active_in(packed, 0, mid, s, e, stage, held);
    const int len_u = active_in(packed, mid, n, s, e, stage + held, held);
    __syncwarp();
    int sub_x[kHeld], sub_id[kHeld], upd_x[kHeld], upd_id[kHeld];
#pragma unroll
    for (int m = 0; m < kHeld; ++m) {
      const int j = m * 32 + lane;
      sub_x[m] = sub_id[m] = upd_x[m] = upd_id[m] = 0;
      if (j < min(len_s, held)) {
        sub_x[m] = packed[stage[j]];
        sub_id[m] = key[stage[j]] & owner_mask;
      }
      if (j < min(len_u, held)) {
        upd_x[m] = packed[stage[held + j]];
        upd_id[m] = key[stage[held + j]] & owner_mask;
      }
    }
    __syncwarp();   // the next sub-range rewrites the stage
    // (e) every upper of the sub-range whose count is >= 2, from the
    // other side's entries
    for (int q0 = s; q0 < e; q0 += 32) {
      const int q = q0 + lane;
      int b = 0, c = 0, o = 0, sb = 0;
      bool task = false;
      if (q < e) {
        b = l.base[q];
        c = l.base[q + 1] - b;   // >= 1 only at a valid upper
        if (c >= 2 && b < cap) {
          task = true;
          sb = seg_sub[q] != 0;
          o = seg_owner[q];
        }
      }
      for (unsigned tasks = __ballot_sync(0xffffffffu, task); tasks != 0u;
           tasks &= tasks - 1u) {
        const int src = __ffs(tasks) - 1;
        const int i = q0 + src;
        const int slot = __shfl_sync(0xffffffffu, b, src);
        const int count = __shfl_sync(0xffffffffu, c, src);
        const int oo = __shfl_sync(0xffffffffu, o, src);
        const bool sub_upper = __shfl_sync(0xffffffffu, sb, src) != 0;
        const int len = sub_upper ? len_u : len_s;
        int found = 0;
        if (len <= held) {
#pragma unroll
          for (int m = 0; m < kHeld; ++m) {
            if (m * 32 >= len) break;
            const int x = sub_upper ? upd_x[m] : sub_x[m];
            const bool in = (x >> 16) <= i && i < (x & 0xffff);
            const unsigned hits = __ballot_sync(0xffffffffu, in);
            const int d = slot + found + __popc(hits & below);
            if (in && d < cap) {
              const int id = sub_upper ? upd_id[m] : sub_id[m];
              oi[d] = sub_upper ? oo : id;
              oj[d] = sub_upper ? id : oo;
            }
            found += __popc(hits);
          }
        } else {   // more than the registers hold: the side's entries walked
          const int k1 = sub_upper ? n : mid;
          for (int k0 = sub_upper ? mid : 0; k0 < k1; k0 += 32) {
            const int k = k0 + lane;
            const int x = k < k1 ? packed[k] : 0;
            const bool in = (x >> 16) <= i && i < (x & 0xffff);
            const unsigned hits = __ballot_sync(0xffffffffu, in);
            const int d = slot + found + __popc(hits & below);
            if (in && d < cap) {
              const int id = key[k] & owner_mask;
              oi[d] = sub_upper ? oo : id;
              oj[d] = sub_upper ? id : oo;
            }
            found += __popc(hits);
          }
        }
        wrong |= found != count;
      }
    }
  }
  if (wrong) *bad_flag = 1;
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
                  int block_size, int ws, int wu, int cap, int smem_words,
                  int key_bits, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[33];
  __shared__ unsigned scratch_x[33];
  __shared__ long long scratch_ll[33];
  __shared__ int off_contract;   // a run or a count broke it
  __shared__ int entering;       // entering members appended to the sort
  __shared__ int split;          // the sorted update side's first record
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t p = blockIdx.x;
  ActiveSet sset, uset;
  sset.nsum = words_over(ws);
  sset.ntop = words_over(sset.nsum);
  uset.nsum = words_over(wu);
  uset.ntop = words_over(uset.nsum);
  // the general path's stage and summaries, past the list path's records
  int* stage = reinterpret_cast<int*>(smem) + 6 * block_size;
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
  const ListLayout lay =
      list_layout(reinterpret_cast<int*>(smem), smem_words, block_size);
  // the sort's input, in the buffer that leaves its result in buffer 0
  int* sort_key = passes & 1 ? lay.keys[1] : lay.keys[0];
  unsigned short* sort_val = passes & 1 ? lay.vals[1] : lay.vals[0];
  if (tid == 0) {
    off_contract = 0;
    entering = 0;
  }
  __syncthreads();

  // popcount and id XOR of the sets entering the segment; their members
  // appended to the sort as entering records, one atomic a warp for each
  // round of loads.  A warp whose round would pass n_max stops appending:
  // the block cannot take the list path then.
  bool append = passes > 0 && block_size < kEntering >> 1;   // warp-uniform
  int cs = 0, cu = 0;
  unsigned xs = 0u, xu = 0u;
  for (int side = 0; side < 2; ++side) {
    const int nw = side ? wu : ws;
    const unsigned* row = (side ? upd0 : sub0) + p * nw;
    int c = 0;
    unsigned x_ids = 0u;
    // (w0 - lane, the warp's first word: its lanes take the same rounds)
    for (int w0 = tid; w0 - lane < nw; w0 += kRowLoads * blockDim.x) {
      unsigned xw[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int w = w0 + u * blockDim.x;
        xw[u] = w < nw ? __ldg(row + w) : 0u;
      }
      int got = 0;
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        got += __popc(xw[u]);
        if (xw[u] != 0u) x_ids ^= word_xor(xw[u], w0 + u * blockDim.x);
      }
      c += got;
      if (!append) continue;
      const int before = warp_inclusive_scan(got) - got;
      const int round = __shfl_sync(0xffffffffu, before + got, 31);
      if (round == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(&entering, round);
      at = __shfl_sync(0xffffffffu, at, 0);
      if (at + round > lay.n_max) {
        append = false;
        continue;
      }
      at += before;
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int w = w0 + u * blockDim.x;
        for (unsigned y = xw[u]; y != 0u; y &= y - 1u, ++at) {
          sort_key[at] = side << key_bits | (w * 32 + __ffs(y) - 1);
          sort_val[at] = kEntering;
        }
      }
    }
    if (side) { cu = c; xu = x_ids; }
    else      { cs = c; xs = x_ids; }
  }
  int cs0, cu0;
  unsigned xs0, xu0;
  block_exclusive_scan(cs, &cs0, scratch);
  block_exclusive_scan(cu, &cu0, scratch);
  block_exclusive_scan(xs, &xs0, scratch_x, Xor());
  block_exclusive_scan(xu, &xu0, scratch_x, Xor());

  // step 1: each thread a contiguous chunk of the segment's records
  const long long seg0 = (long long)p * block_size;
  const int chunk = (block_size + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * chunk, block_size);
  const int hi = min(lo + chunk, block_size);
  // (the four loads of a record issued before any branch on them)
  int ds = 0, du = 0, nv = 0;
  xs = xu = 0u;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const long long g = seg0 + i;
    const int v = valid[g], up = is_upper[g], sb = is_sub[g], o = owner[g];
    if (!v) continue;
    ++nv;
    const int d = up ? -1 : 1;
    if (sb) { ds += d; xs ^= o; }
    else    { du += d; xu ^= o; }
  }
  int tot, records;
  unsigned xtot;
  const int as0 = block_exclusive_scan(ds, &tot, scratch) + cs0;
  const int au0 = block_exclusive_scan(du, &tot, scratch) + cu0;
  const unsigned xs1 = block_exclusive_scan(xs, &xtot, scratch_x, Xor()) ^ xs0;
  const unsigned xu1 = block_exclusive_scan(xu, &xtot, scratch_x, Xor()) ^ xu0;
  int rec = block_exclusive_scan(nv, &records, scratch) + cs0 + cu0;
  // the sum of counts of the chunk
  long long mine = 0;
  int as = as0, au = au0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const long long g = seg0 + i;
    const int v = valid[g];
    const bool sb = is_sub[g] != 0, up = is_upper[g] != 0;
    if (!v) continue;
    const int c = up ? (sb ? au : as) : 0;
    if (sb) as += up ? -1 : 1;
    else    au += up ? -1 : 1;
    mine += c;
  }
  long long seg_total;
  long long slot = block_exclusive_scan(mine, &seg_total, scratch_ll);
  // the list path when the sort takes every record and entering member
  // and every slot base is an int (the same in every thread)
  const int n_sort = cs0 + cu0 + records;
  const bool listed = passes > 0 && block_size < kEntering >> 1 &&
                      n_sort <= lay.n_max && seg_total >= 0 &&
                      seg_total < 0x7fffffffLL;
  if (listed) {
    // the slot bases, the sort's records and the pairs of the uppers whose
    // count is 1; a negative count breaks the contract (an upper before
    // its lower, or entering sets that disagree with the records)
    bool bad = false;
    as = as0;
    au = au0;
    xs = xs1;
    xu = xu1;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      const long long g = seg0 + i;
      const int v = valid[g], o = owner[g];
      const bool sb = is_sub[g] != 0, up = is_upper[g] != 0;
      lay.base[i] = (int)slot;
      if (!v) continue;
      const int c = up ? (sb ? au : as) : 0;
      bad |= c < 0 || o < 0 || o >= 32 * (sb ? ws : wu);
      sort_key[rec] = (sb ? 0 : 1 << key_bits) | (o & ((1 << key_bits) - 1));
      sort_val[rec++] = (unsigned short)(i << 1 | (up ? 1 : 0));
      if (c == 1 && slot >= 0 && slot < cap) {
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
      lay.base[block_size] = (int)seg_total;
      split = n_sort;
    }
    __syncthreads();
    // step 2: the list path
    if (!off_contract)
      list_emit(lay, n_sort, block_size, key_bits, passes, cap,
                (int)min(seg_total, (long long)cap), is_sub + seg0,
                owner + seg0, oi, oj, scratch, &split, &off_contract);
    __syncthreads();
    if (!off_contract) return;   // the same in every thread of the block
  }

  // step 3, the general path: the Pallas kernel's replay
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

// *general: incremented by each block that left the list path for the
// general path (the caller zeroes it; nothing here reads it back).
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
  // the list path's sort key: side << key_bits | owner, owners below
  // 32 * max(ws, wu); no list path where the key would pass 30 bits
  const long long top = 32LL * (ws > wu ? ws : wu) - 1;
  int key_bits = 0;
  while (key_bits < 31 && (top >> key_bits) != 0) ++key_bits;
  const int passes =
      key_bits < 30 ? (key_bits + kDigitBits) / kDigitBits : 0;
  auto kernel = place == 1 ? emit_pairs_kernel<true> : emit_pairs_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      owner, is_upper, is_sub, valid, sub0, upd0, sub_mask, upd_mask, out_i,
      out_j, general, block_size, ws, wu, (int)cap,
      (int)(smem / sizeof(int)), key_bits, passes);
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
