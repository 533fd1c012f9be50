// Kernel K2: stable stream compaction of splat updates for Hopper (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/ops/compact.py:
// _kernel; the plain PyTorch version is ops/compact.py:compact_plain.
//
// An update (key, payload) is live iff key < n_targets.  The output holds
// the live (key, payload) pairs in source order, then (sent, 0) up to U,
// and the live count.  The TPU kernel's 14-pass butterfly on a [128, 128]
// chunk tile is a VMEM device and does not carry over.
//
// Design: one pass with decoupled look-back (Merrill and Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).  A
// block draws a tile of kTileItems updates by an atomic ticket, so every
// tile before its own belongs to a block that is already running.  It
// reads the tile's keys (element j*256 + t in round j, so loads coalesce),
// counts the live ones with warp ballots, and publishes the count in its
// status word (flag kAggregate | count).  Its first warp then looks back
// over the predecessors' words, 32 at a time, summing aggregates until it
// meets an inclusive prefix (flag kPrefix), and publishes its own
// inclusive prefix.  Its threads read the live updates' payloads (and only
// those) before the look-back, so the reads overlap it.  With the exclusive
// prefix P the tile writes its live pairs to P + rank, in source order.
// The tail needs no total: the k-th dead update in source order
// goes to U - 1 - k as (sent, 0), and a tile knows the dead updates before
// it (its start - P), so positions [total, U) are filled exactly.  The
// tile of the last ticket writes the live count.  The ticket and the
// status words are scratch that the launch zeroes with one memset, so a
// call is two launches (memset, kernel) and never syncs the host.
//
// What bounds it on the H100: memory bandwidth.  At the Cornell 720p
// frame, U = 2.76M updates: the keys are read once (11 MB), the payloads
// of the live ones (15%: 1.7 MB), and both outputs written (22 MB); the
// bound counts 12 B an update and 4 B a live one, 0.0104 ms.  The
// two-pass kernel it replaced read
// the keys twice and took five more device operations between its passes
// (zeros, cumsum, a copy); on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
// this one takes ~0.025 ms graph-replayed against its ~0.032, and ~31 us
// of the host a call against 90-120.  16 rounds a tile beat 8; without the
// early payload reads it took ~0.033 ms; a look-back by the whole block
// (256 predecessors a round) was no faster than this warp's.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 16;
constexpr int kTileItems = kThreads * kRounds;  // ops/compact.py TILE_ITEMS
constexpr int kWarps = kThreads / 32;
constexpr int kCounts = kRounds * kWarps;  // a live count per (round, warp)
constexpr int kPerLane = kCounts / 32;
constexpr unsigned kFull = 0xffffffffu;
// a status word: flag << 32 | value (0: not yet published)
constexpr unsigned long long kAggregate = 1ull << 32, kPrefix = 2ull << 32;

static_assert(kCounts % 32 == 0, "the first warp scans the counts, kPerLane a lane");

__device__ __forceinline__ unsigned long long read_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void write_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The exclusive prefix of `tile` from its predecessors' status words, by
// one warp; every lane returns it.
__device__ __forceinline__ int look_back(const unsigned long long* status, int tile, int lane) {
  int prefix = 0;
  for (int base = tile - 1;; base -= 32) {
    const int p = base - lane;
    unsigned long long st = p >= 0 ? read_status(status + p) : kPrefix;
    while (__any_sync(kFull, (st >> 32) == 0))
      if ((st >> 32) == 0) st = read_status(status + p);
    const unsigned done = __ballot_sync(kFull, (st >> 32) == 2);
    // lanes up to the nearest predecessor with its inclusive prefix
    const int last = done ? __ffs(done) - 1 : 31;
    prefix += warp_sum(lane <= last ? (int)(unsigned)st : 0);
    if (done) return prefix;
  }
}

// scratch: [0] the ticket counter (its low 32 bits), [1 + tile] the status
// words of n_tiles tiles; zeroed before the launch.
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const int* __restrict__ keys, const int* __restrict__ pay, int u,
                   int n_targets, int sent, unsigned long long* __restrict__ scratch,
                   int n_tiles, int* __restrict__ out_keys, int* __restrict__ out_pay,
                   int* __restrict__ n_live) {
  __shared__ int s_tile, s_prefix, s_total;
  __shared__ int s_counts[kCounts];  // then the exclusive prefix of each (round, warp)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  const long long start = (long long)tile * kTileItems;

  int k[kRounds];
  unsigned ballot[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const long long i = start + j * kThreads + threadIdx.x;
    k[j] = i < u ? keys[i] : n_targets;
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    ballot[j] = __ballot_sync(kFull, k[j] < n_targets);
    if (lane == 0) s_counts[j * kWarps + warp] = __popc(ballot[j]);
  }
  int pv[kRounds];  // the live updates' payloads, in flight during the look-back
#pragma unroll
  for (int j = 0; j < kRounds; ++j)
    pv[j] = k[j] < n_targets ? pay[start + j * kThreads + threadIdx.x] : 0;
  __syncthreads();
  if (warp == 0) {
    int c[kPerLane], sum = 0;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      c[q] = s_counts[lane * kPerLane + q];
      sum += c[q];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      s_counts[lane * kPerLane + q] = run;
      run += c[q];
    }
    const int total = __shfl_sync(kFull, incl, 31);
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) write_status(status, kPrefix | (unsigned)total);
    } else {
      if (lane == 0) write_status(status + tile, kAggregate | (unsigned)total);
      prefix = look_back(status, tile, lane);
      if (lane == 0) write_status(status + tile, kPrefix | (unsigned)(prefix + total));
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_total = total;
    }
  }
  __syncthreads();
  const int prefix = s_prefix;
  const long long dead_before = start - prefix;  // dead updates of the earlier tiles
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const long long i = start + j * kThreads + threadIdx.x;
    if (i >= u) break;
    const int live_rank = s_counts[j * kWarps + warp] + __popc(ballot[j] & below);
    if (k[j] < n_targets) {
      out_keys[prefix + live_rank] = k[j];
      out_pay[prefix + live_rank] = pv[j];
    } else {
      const long long dst = u - 1 - (dead_before + (i - start - live_rank));
      out_keys[dst] = sent;
      out_pay[dst] = 0;
    }
  }
  if (tile == n_tiles - 1 && threadIdx.x == 0) *n_live = prefix + s_total;
}

}  // namespace

// scratch: n_tiles + 1 64-bit words, n_tiles = max(1, ceil(u / kTileItems))
extern "C" int bdpt_compact(const int* keys, const int* pay, int u, int n_targets, int sent,
                            unsigned long long* scratch, int n_tiles, int* out_keys,
                            int* out_pay, int* n_live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (size_t)(n_tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  compact_kernel<<<n_tiles, kThreads, 0, s>>>(keys, pay, u, n_targets, sent, scratch, n_tiles,
                                              out_keys, out_pay, n_live);
  return (int)cudaGetLastError();
}
