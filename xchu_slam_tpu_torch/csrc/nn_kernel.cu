// Masked brute-force nearest neighbour: for each source point, the index of
// the nearest valid target point and its squared distance.
//
// Replaces the TPU kernel xchu_slam_tpu/ops/pallas/nn_kernel.py::_nn_kernel
// (wrapped by nearest_neighbor), the correspondence search of ICP loop
// verification (ops/icp.py::_nearest).
//
// Design. One thread per source point keeps a running (min, argmin) in
// registers. The block stages targets through shared memory one 256-point
// tile at a time as float4 (x, y, z, valid), so each target is read from
// device memory once per block and broadcast to all 256 threads. d² is the
// direct difference dx²+dy²+dz² in fp32 FMA, which is exact enough that no
// recompute pass is needed (the TPU kernel forms |s|²+|t|²−2s·t on the
// matrix unit and recomputes the exact d² afterwards). A strict `<` keeps
// the earliest index on ties. A row with no valid target gets idx 0 and
// d² 1e30, as the reference wrapper returns. Any N and M are accepted; the
// ragged last tile is masked by its count.
//
// What bounds it on an H100. At the ICP shapes (N = 4096 keyframe points,
// M = 16384 submap points) one call is 67M pairs of ~8 FMA-pipe operations:
// FMA-bound, not memory-bound, since the inputs (256 KB) sit in L2 and each
// block streams them once. The first thing a later version fixes is
// occupancy: N = 4096 gives 16 blocks of 256 threads for 132 SMs, so most of
// the card idles. Splitting M across blocks (e.g. 8 slices per source tile)
// and merging the per-slice (min, argmin) pairs in a second pass, with the
// lower index winning ties, fills the card without changing the result.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the Python wrapper (ops/cuda/nn_kernel.py) allocates the outputs and
// passes PyTorch's current stream.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // source points per block, one per thread
constexpr int kTile = kThreads;  // targets staged per shared-memory tile

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
          const unsigned char* __restrict__ mask, int n, int m,
          int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (i < n) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }
  float best = FLT_MAX;
  int best_j = -1;
  for (int base = 0; base < m; base += kTile) {
    const int j = base + threadIdx.x;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < m) {
      t.x = tgt[3 * j];
      t.y = tgt[3 * j + 1];
      t.z = tgt[3 * j + 2];
      t.w = mask[j] ? 1.f : 0.f;
    }
    tile[threadIdx.x] = t;
    __syncthreads();
    const int cnt = min(kTile, m - base);
    for (int k = 0; k < cnt; ++k) {
      const float4 q = tile[k];
      const float dx = sx - q.x, dy = sy - q.y, dz = sz - q.z;
      const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (q.w != 0.f && d < best) {
        best = d;
        best_j = base + k;
      }
    }
    __syncthreads();
  }
  if (i < n) {
    idx_out[i] = best_j < 0 ? 0 : best_j;
    d2_out[i] = best_j < 0 ? 1e30f : best;
  }
}

}  // namespace

// src [n,3] f32, tgt [m,3] f32, mask [m] bool (1 byte), all contiguous on
// the device; writes idx [n] int32 and d2 [n] f32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int nn_launch(const float* src, const float* tgt,
                         const unsigned char* mask, int n, int m, int* idx,
                         float* d2, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads);
  nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, mask, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
