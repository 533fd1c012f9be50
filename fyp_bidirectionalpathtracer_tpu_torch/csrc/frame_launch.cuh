// The launch of kernel K1 (frame.cu has the design): the kernel template,
// which stages the triangle rows (and, for the walk, the node table) in
// dynamic shared memory and runs frame_pixel, and its launch with the
// shared-memory opt-in.  A launch covers the n_sub pixels from pix0 on (a
// shard's rows; the whole image with pix0 = 0, n_sub = W * H), one thread
// each.  frame.cu and frame_small.cu instantiate the
// untextured program, frame_textured.cu the textured one.
#pragma once

#include <cuda_runtime.h>

#include "frame_program.cuh"

namespace bdpt {

constexpr int kFrameThreads = 128;
// The blocks an SM holds at once of frame_small.cu's instantiations, which
// the untextured scenes take where that many blocks' rows fit in an SM's
// shared memory (frame.cu has the measurements)
constexpr int kSmallSceneBlocks = 4;

// MinBlocks: the blocks of kFrameThreads an SM holds at once, which caps
// the registers a thread may use (4: 128 registers)
template <int D, bool Textured, int MinBlocks>
__global__ void __launch_bounds__(kFrameThreads, MinBlocks)
    frame_kernel(FrameParams p, const float* __restrict__ lights,
                 const float* __restrict__ tris, const float* __restrict__ nodes, int n_nodes,
                 FrameOutPtrs out) {
  extern __shared__ float smem[];  // the rows [n_tris, kBwCols], then the nodes
  const int n_bw = p.n_tris * kBwCols;
  float* nodes_smem = smem + n_bw;
  for (int i = threadIdx.x; i < n_bw; i += blockDim.x)
    smem[i] = tris[(i / kBwCols) * kPackCols + (i % kBwCols)];
  if constexpr (Textured)  // the walk's node table
    for (int i = threadIdx.x; i < n_nodes * kNodeCols; i += blockDim.x) nodes_smem[i] = nodes[i];
  __syncthreads();
  const int lin = blockIdx.x * blockDim.x + threadIdx.x;
  if (lin >= p.n_sub) return;
  frame_pixel<D, Textured>(p, lights, smem, nodes_smem, tris, lin, out);
}

// The untextured instantiations run no walk: they pass no nodes (n_nodes 0).
template <int D, bool Textured = false, int MinBlocks = 1>
int launch_frame(const FrameParams& p, const float* lights, const float* tris,
                 const float* nodes, int n_nodes, const FrameOutPtrs& out,
                 cudaStream_t stream) {
  const int n = p.n_sub;
  const size_t smem = ((size_t)p.n_tris * kBwCols + (size_t)n_nodes * kNodeCols) * sizeof(float);
  auto kernel = frame_kernel<D, Textured, MinBlocks>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kFrameThreads - 1) / kFrameThreads);
  kernel<<<grid, kFrameThreads, smem, stream>>>(p, lights, tris, nodes, n_nodes, out);
  return (int)cudaGetLastError();
}

// launch_frame<d_max, Textured, MinBlocks> for a d_max of 1..MaxD read at
// run time (D: the depth this step of the dispatch compares it with)
template <bool Textured, int MinBlocks, int MaxD, int D = 1>
int launch_frame_d(int d_max, const FrameParams& p, const float* lights, const float* tris,
                   const float* nodes, int n_nodes, const FrameOutPtrs& out,
                   cudaStream_t stream) {
  if (d_max == D)
    return launch_frame<D, Textured, MinBlocks>(p, lights, tris, nodes, n_nodes, out, stream);
  if constexpr (D < MaxD)
    return launch_frame_d<Textured, MinBlocks, MaxD, D + 1>(d_max, p, lights, tris, nodes,
                                                            n_nodes, out, stream);
  else
    return (int)cudaErrorInvalidValue;
}

// frame_small.cu: launch_frame<d_max, false, kSmallSceneBlocks>
int launch_frame_small(const FrameParams& p, int d_max, const float* lights, const float* tris,
                       const FrameOutPtrs& out, cudaStream_t stream);

}  // namespace bdpt
