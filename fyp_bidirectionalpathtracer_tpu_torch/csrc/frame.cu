// Kernel K1: the whole-frame BDPT megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel fyp_bidirectionalpathtracer_tpu/accel/
// pallas_frame.py:frame_kernel; the plain PyTorch version is
// accel/frame.py:frame_plain, and the per-pixel program is in
// frame_program.cuh.
//
// Design: one thread per pixel runs the whole program (primary hit,
// G-buffer rows, both subpaths, the three estimator families).  The TPU
// kernel kept 1024 pixels in [8, 128] vector tiles and tested triangles in
// [T, 128] pair tiles with a one-hot MXU fetch of the winner; none of that
// carries over.  Here d_max is a template parameter (1..8), so the camera
// and light vertex arrays unroll; at large d they spill to local memory.
//
// Ray queries (frame_program.cuh closest / any_hit): the textured
// instantiations walk the bake's threaded BVH (bvh.cuh, with the row stride
// kBwCols; the BVH kernels walk its two-box form): about 16 rays a pixel at
// d=3 visit the nodes their slabs enter and test only the triangles of the
// leaves they reach (<= 7 a leaf), in place of every triangle.  The untextured
// instantiations keep the dense pair loop over every triangle: on Cornell's
// 34 triangles at 1280x720 the walk took 1.86 ms against the loop's 0.71 on
// an H100 at 700 W (PERF.md), because the loop's lanes read the same row at
// once (a shared-memory broadcast) and never diverge, while the walks of a
// warp's pixels do (the walk was not timed on untextured scenes of
// 1,314-2,048 triangles, which the gate also admits).  The block stages the
// 12 Baldwin-Weber floats of every triangle and, for the walk, then the
// [N, 8] node table into dynamic shared memory, so every slab and pair test
// reads shared memory: a node read is the dependent load of each walk step,
// and shared memory answers it with no miss, where L1 would miss on the
// first touch of each node by each SM (reading the nodes through L1 was not
// measured).  Bytes, 48 a triangle and 32 a node: 2,304 at Cornell's 34
// triangles (21 nodes), 23,552 at the textured room's 342 (223), 90,752 at
// Cornell + icosphere's 1,314 (865), 140,128 at 2,048 (1,307; the cuda
// tests' scene of that size), of the 232,448 a block may use above the
// opt-in of 48 KB; a BVH has at most 2T - 1 nodes, so even 4,095 nodes at
// 2,048 triangles (229,344 B) fit, and the launch's cudaFuncSetAttribute
// would report a size past the limit.  The untextured instantiations take no
// nodes and stage the rows alone (98,304 B at 2,048).  The winner's 36
// attribute floats are read once a hit from global memory.  Outputs are
// field-major [rows, W*H], so a warp's stores coalesce.  Splat pixel ids and
// rgb8e payloads are int32 outputs of their own.
//
// What bounds it on the H100: the tests of the ray queries (operations;
// chip_smoke.py counts the walk's slab and pair tests, by stage, with the
// BVH kernels' counting walk on the rays the plain version traces, and the
// dense loop's pair tests beside them) and the divergence between the
// pixels of a warp, whose paths and walks differ in length; the registers
// of the program (163-232 a thread at D = 3, 4), which leave few warps
// resident to hide the latency of each dependent read.
//
// Occupancy of the untextured instantiations: at 163 registers an SM holds
// three blocks of 128 threads.  Held to four (__launch_bounds__(128, 4):
// 128 registers, ~300 B of spills at D = 3), K1 ran ~10% faster on scenes
// of 34, 114, 354 and 674 triangles, and ~8% slower at 1,314, whose rows
// (63 KB a block) leave room for three blocks an SM, so the spills bought
// no warps (1280x720, d = 3; NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  So
// a scene whose rows let four blocks share an SM (1,194 triangles at most
// on the H100) launches the four-block instantiations of frame_small.cu,
// and a larger one these; the answers are the same.  A 256-thread block
// was slower at every size.  A pair step that tested each row against
// several rays held in registers (16-byte row loads, several rows a step,
// a division-free reject before the division; not kept) and shadow rays
// batched by estimator family were also tried for K1's queries and ran 10-60% slower than intersect.cuh's
// loops, which K1 keeps (why is not measured: no profiler runs on the
// card).
//
// The textured variant (Textured = true, d_max 1..4, the TPU kernel's
// textured=True program) stores the deferred-texture records and raw
// estimator parts to their own field-major outputs as each is produced,
// in place of the own-pixel result; the untextured instantiations are
// unchanged by it.  Its launch is in frame_textured.cu, built without FMA
// contraction (see there); the kernel template in frame_launch.cuh, the
// small scenes' instantiations in frame_small.cu.
#include <atomic>

#include "frame_launch.cuh"

namespace bdpt {

// Do kSmallSceneBlocks blocks, each with the rows of n_tris triangles in
// shared memory, fit on one SM of the current device?  The room a block
// may take for that is read from the driver once a device.
static bool small_blocks_fit(int n_tris) {
  constexpr int kDevices = 64;
  static std::atomic<long long> room[kDevices];  // bytes + 1; 0: not read yet
  int dev = 0;
  cudaGetDevice(&dev);
  long long r = dev < kDevices ? room[dev].load(std::memory_order_relaxed) : 0;
  if (r == 0) {
    int per_sm = 0, reserved = 0;
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    r = (long long)(per_sm / kSmallSceneBlocks - reserved) + 1;
    if (dev < kDevices) room[dev].store(r, std::memory_order_relaxed);
  }
  return (long long)n_tris * kBwCols * (long long)sizeof(float) <= r - 1;
}

}  // namespace bdpt

extern "C" int bdpt_frame_launch(const bdpt::FrameParams* params, int d_max,
                                 const float* lights, const float* tris, float* res,
                                 float* gbuf, int* splat_pix, int* splat_pay, float* splat_rgba,
                                 void* stream) {
  const bdpt::FrameParams& p = *params;
  const bdpt::FrameOutPtrs out = {res, gbuf, splat_pix, splat_pay, splat_rgba,
                                  nullptr, nullptr, nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  if (bdpt::small_blocks_fit(p.n_tris))
    return bdpt::launch_frame_small(p, d_max, lights, tris, out, s);
  return bdpt::launch_frame_d<false, 1, 8>(d_max, p, lights, tris, nullptr, 0, out, s);
}
