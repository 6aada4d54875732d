// Masked brute-force nearest neighbour: for each source point, the index of
// the nearest valid target point and its squared distance.
//
// Replaces the TPU kernel xchu_slam_tpu/ops/pallas/nn_kernel.py::_nn_kernel
// (wrapped by nearest_neighbor), the correspondence search of ICP loop
// verification (ops/icp.py::_nearest).
//
// What bounds it on an H100. At the ICP shape (N = 4096 keyframe points,
// M = 16384 submap points) one call is 67.1 M pairs. The fewest FP32
// instructions any correct version needs per pair is 5: the expanded form
// |t|² − 2s·t with |t|² and −2t precomputed is 3 FMAs, then a compare and a
// select for the running minimum (and the exact d² of the winner alone
// afterwards, as the TPU kernel does). The card issues 132 SMs × 4
// schedulers × 32 lanes per clock, 33.5 T instructions/s at the rate behind
// its 67 TFLOP/s FP32 peak, so the call cannot take less than ~10 µs. This
// kernel keeps the direct difference (below), 6 instructions for d² (3
// subtractions, 1 multiply, 2 FMAs) and so 8 per pair: ~16 µs at the same
// rate is the least this arithmetic can take. The inputs are 256 KB and
// stay in L2: bytes are no limit (~0.1 µs at 3.35 TB/s). The kernel is bound
// by the FP32 issue rate, so the design (a) gives every scheduler of the
// card warps to issue from and (b) spends as few issue slots per pair as its
// arithmetic allows.
//
// Design.
// - Work split. A block owns a tile of 128 source points; a thread keeps 4 of
//   them in registers, so the 32 lanes of one warp cover the whole tile. The
//   targets are cut into slices × 16 equal sub-slices in index order: the
//   grid is source tiles × slices, and inside a block each of the 16 warps
//   scans its own sub-slice against the tile. At 4096 × 16384 that is
//   32 tiles × 4 slices = 128 blocks of 16 warps, one block an SM and 4 warps
//   a scheduler, each warp scanning 256 targets. The caller chooses the
//   slice count and the sub-slice length from N, M and the SM count.
// - Inner loop. A warp stages 32 targets at a time in shared memory as
//   float4 (x, y, z, index bits). One broadcast LDS.128 then serves 4 pairs
//   per lane. The mask is folded into staging: a masked or padding target is
//   stored with x = +inf, so its d² is +inf (or NaN) and never `<` the
//   running minimum, and the loop has no mask test and no ragged tail. The
//   index rides in .w, so taking it is one select. Per pair: 6 arithmetic
//   instructions, 1 compare, 2 selects, and a quarter of a load. The 32
//   targets of a round are fully unrolled, which lets the compiler hoist the
//   shared-memory loads; the next 32 are loaded from device memory into
//   registers before the current 32 are scanned.
// - Merge. Each warp scans in ascending index order with a strict `<`, and
//   the 16 warps' partial (min d², argmin) are merged through shared memory
//   in sub-slice order with a strict `<`. Each block leaves its partial in a
//   scratch array [slices][N] that the caller allocates, and a second small
//   kernel merges the slices in order, again with a strict `<`. The lower
//   index therefore wins every tie, as in one sequential scan. No atomics.
//   (A thread-block cluster per source tile, merged through distributed
//   shared memory, was measured and not kept: no faster as clusters of 2,
//   and clusters of 4 and 8 were placed unevenly on the card's SMs.)
// - Arithmetic. d² = fmaf(dz, dz, fmaf(dy, dy, dx·dx)) on the direct
//   difference in fp32, exact enough that no recompute pass is needed (the
//   TPU kernel forms |s|²+|t|²−2s·t on the matrix unit and recomputes the
//   exact d² afterwards). It costs 3 instructions per pair more than the
//   expanded form, and it is what keeps idx and d² bit-identical to the
//   first version. A row with no valid target gets idx 0 and d² 1e30, as
//   the reference wrapper returns. Any N and M are accepted.
//
// `nn_launch_simple` keeps the first version of this kernel (one thread per
// source point, one block per 256 source points, the whole target cloud per
// block) with the same arithmetic and tie rule. It is an oracle for tests
// and for the smoke run's bit-equality check, and nothing else calls it.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the Python wrapper (ops/cuda/nn_kernel.py) allocates the outputs and the
// scratch, chooses the split and passes PyTorch's current stream.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kPts = 4;               // source points per thread
constexpr int kWarps = 16;            // warps per block = sub-slices per block
constexpr int kSrcTile = 32 * kPts;   // source points per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRound = 32;            // targets a warp stages at a time

// Target j as it is staged: (x, y, z, bits of j). A masked target, or one at
// or past `end`, gets x = +inf so that it can never win.
__device__ __forceinline__ float4 stage_target(const float* __restrict__ tgt,
                                               const unsigned char* __restrict__ mask,
                                               int j, int end) {
  float4 t = make_float4(INFINITY, 0.f, 0.f, __int_as_float(-1));
  if (j < end) {
    const float x = tgt[3 * j];
    t.x = mask[j] ? x : INFINITY;
    t.y = tgt[3 * j + 1];
    t.z = tgt[3 * j + 2];
    t.w = __int_as_float(j);
  }
  return t;
}

// Every block writes its partial (min d², argmin) to scratch [slices][n] for
// nn_merge_kernel.
__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
          const unsigned char* __restrict__ mask, int n, int m, int sub_len,
          float* __restrict__ scratch_d, int* __restrict__ scratch_j) {
  __shared__ float4 stage[kWarps][kRound];
  __shared__ float part_d[kWarps][kSrcTile];
  __shared__ int part_j[kWarps][kSrcTile];

  const int rank = blockIdx.y;    // the slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile0 = blockIdx.x * kSrcTile;

  float sx[kPts], sy[kPts], sz[kPts], best[kPts];
  int best_j[kPts];
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = tile0 + p * 32 + lane;
    sx[p] = sy[p] = sz[p] = 0.f;
    if (i < n) {
      sx[p] = src[3 * i];
      sy[p] = src[3 * i + 1];
      sz[p] = src[3 * i + 2];
    }
    best[p] = FLT_MAX;
    best_j[p] = -1;
  }

  // this warp's sub-slice [begin, end) of the targets
  const long long first = static_cast<long long>(rank * kWarps + warp) * sub_len;
  const int begin = static_cast<int>(first < m ? first : m);
  const int end = static_cast<int>(first + sub_len < m ? first + sub_len : m);

  float4 next = stage_target(tgt, mask, begin + lane, end);
  for (int base = begin; base < end; base += kRound) {
    stage[warp][lane] = next;
    __syncwarp();
    next = stage_target(tgt, mask, base + kRound + lane, end);
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const float4 q = stage[warp][k];
      const int qj = __float_as_int(q.w);
#pragma unroll
      for (int p = 0; p < kPts; ++p) {
        const float dx = sx[p] - q.x, dy = sy[p] - q.y, dz = sz[p] - q.z;
        const float d = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        const bool lt = d < best[p];
        best[p] = lt ? d : best[p];
        best_j[p] = lt ? qj : best_j[p];
      }
    }
    __syncwarp();
  }

  // the block's sub-slices, in index order
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    part_d[warp][p * 32 + lane] = best[p];
    part_j[warp][p * 32 + lane] = best_j[p];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kSrcTile; t += kThreads) {
    float b = part_d[0][t];
    int j = part_j[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float d = part_d[w][t];
      if (d < b) {
        b = d;
        j = part_j[w][t];
      }
    }
    if (tile0 + t < n) {
      scratch_d[static_cast<size_t>(rank) * n + tile0 + t] = b;
      scratch_j[static_cast<size_t>(rank) * n + tile0 + t] = j;
    }
  }
}

// The slices' partials [slices][n] in slice order, one thread per source point.
__global__ void __launch_bounds__(256)
nn_merge_kernel(const float* __restrict__ scratch_d,
                const int* __restrict__ scratch_j, int n, int slices,
                int* __restrict__ idx_out, float* __restrict__ d2_out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float b = scratch_d[i];
  int j = scratch_j[i];
  for (int r = 1; r < slices; ++r) {
    const float d = scratch_d[static_cast<size_t>(r) * n + i];
    if (d < b) {
      b = d;
      j = scratch_j[static_cast<size_t>(r) * n + i];
    }
  }
  idx_out[i] = j < 0 ? 0 : j;
  d2_out[i] = j < 0 ? 1e30f : b;
}

constexpr int kSimpleThreads = 256;  // source points per block, one per thread

// The first version: one thread per source point scans every target, staged
// through shared memory 256 at a time as (x, y, z, valid).
__global__ void __launch_bounds__(kSimpleThreads)
nn_kernel_simple(const float* __restrict__ src, const float* __restrict__ tgt,
                 const unsigned char* __restrict__ mask, int n, int m,
                 int* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tile[kSimpleThreads];
  const int i = blockIdx.x * kSimpleThreads + threadIdx.x;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (i < n) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }
  float best = FLT_MAX;
  int best_j = -1;
  for (int base = 0; base < m; base += kSimpleThreads) {
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
    const int cnt = min(kSimpleThreads, m - base);
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
// the device; writes idx [n] int32 and d2 [n] f32. The targets are scanned
// as slices × kWarps sub-slices of `sub_len` targets each, which must cover
// m; scratch_d and scratch_j [slices][n] take the slices' partials. Launches
// on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int nn_launch(const float* src, const float* tgt,
                         const unsigned char* mask, int n, int m, int slices,
                         int sub_len, int* idx, float* d2, float* scratch_d,
                         int* scratch_j, void* stream) {
  if (n <= 0) return 0;
  if (scratch_d == nullptr || scratch_j == nullptr || slices < 1 ||
      slices > 65535 || sub_len < 1 ||
      static_cast<long long>(slices) * kWarps * sub_len < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kSrcTile - 1) / kSrcTile, slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nn_kernel<<<grid, kThreads, 0, s>>>(src, tgt, mask, n, m, sub_len, scratch_d,
                                      scratch_j);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(scratch_d, scratch_j, n,
                                                  slices, idx, d2);
  return static_cast<int>(cudaGetLastError());
}

// The source tile and the sub-slices per slice that `nn_launch` assumes, for
// the wrapper to check its own copy against.
extern "C" void nn_geometry(int* src_tile, int* sub_slices) {
  *src_tile = kSrcTile;
  *sub_slices = kWarps;
}

// Same interface as the first version of `nn_launch`: the oracle kernel.
extern "C" int nn_launch_simple(const float* src, const float* tgt,
                                const unsigned char* mask, int n, int m,
                                int* idx, float* d2, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kSimpleThreads - 1) / kSimpleThreads);
  nn_kernel_simple<<<grid, kSimpleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, mask, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
