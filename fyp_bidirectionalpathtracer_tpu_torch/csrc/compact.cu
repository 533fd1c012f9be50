// Kernel K2: stable stream compaction of splat updates for Hopper (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/ops/compact.py:
// _kernel; the plain PyTorch version is ops/compact.py:compact_plain.
//
// An update (key, payload) is live iff key < n_targets.  Pass 1
// (compact_count_kernel) counts the live updates of each 1024-element
// block; the wrapper turns the counts into exclusive block offsets with
// torch.cumsum; pass 2 (compact_scatter_kernel) ranks each live update in
// its block and writes it to offset + rank, so the live updates come out
// in source order.  Positions from the live total on get the sentinel key
// and a zero payload.  The TPU kernel's 14-pass butterfly on a [128, 128]
// chunk tile is a VMEM device and does not carry over.
//
// What bounds it on the H100: memory bandwidth.  At the Cornell 720p
// frame, U = 2.76M updates: pass 1 reads the keys (11 MB), pass 2 reads
// keys and payloads and writes both outputs (44 MB).  Threads read
// neighbouring elements (element j*256 + t of the block in round j), so
// loads and the sentinel fill coalesce; the in-block rank is a warp ballot
// plus a scan of the 8 warp totals in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;
constexpr int kBlockItems = kThreads * kRounds;  // ops/compact.py BLOCK_ITEMS
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(const int* __restrict__ keys, int u, int n_targets,
                         int* __restrict__ counts) {
  __shared__ int warp_tot[kWarps];
  int c = 0;
  for (int j = 0; j < kRounds; ++j) {
    const int i = blockIdx.x * kBlockItems + j * kThreads + threadIdx.x;
    if (i < u && keys[i] < n_targets) ++c;
  }
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_tot[w];
    counts[blockIdx.x] = s;
  }
}

// offs: [gridDim.x + 1] exclusive block offsets, offs[gridDim.x] = total
__global__ void __launch_bounds__(kThreads)
    compact_scatter_kernel(const int* __restrict__ keys, const int* __restrict__ pay, int u,
                           int n_targets, int sent, const int* __restrict__ offs,
                           int* __restrict__ out_keys, int* __restrict__ out_pay) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = offs[gridDim.x];
  int running = offs[blockIdx.x];
  for (int j = 0; j < kRounds; ++j) {
    const int i = blockIdx.x * kBlockItems + j * kThreads + threadIdx.x;
    const int k = i < u ? keys[i] : sent;
    const bool live = i < u && k < n_targets;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_tot[w];
      before += w < warp ? c : 0;
      round_total += c;
    }
    if (live) {
      const int dst = running + before + __popc(ballot & ((1u << lane) - 1u));
      out_keys[dst] = k;
      out_pay[dst] = pay[i];
    }
    if (i < u && i >= total) {
      out_keys[i] = sent;
      out_pay[i] = 0;
    }
    running += round_total;
    __syncthreads();  // warp_tot is rewritten next round
  }
}

int n_blocks(int u) { return u > 0 ? (u + kBlockItems - 1) / kBlockItems : 1; }

}  // namespace

extern "C" int bdpt_compact_count(const int* keys, int u, int n_targets, int* counts,
                                  void* stream) {
  compact_count_kernel<<<n_blocks(u), kThreads, 0, (cudaStream_t)stream>>>(
      keys, u, n_targets, counts);
  return (int)cudaGetLastError();
}

extern "C" int bdpt_compact_scatter(const int* keys, const int* pay, int u, int n_targets,
                                    int sent, const int* offs, int* out_keys, int* out_pay,
                                    void* stream) {
  compact_scatter_kernel<<<n_blocks(u), kThreads, 0, (cudaStream_t)stream>>>(
      keys, pay, u, n_targets, sent, offs, out_keys, out_pay);
  return (int)cudaGetLastError();
}
