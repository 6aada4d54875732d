// One ICP iteration's update on the card: the moment sums of the
// correspondences, the Kabsch (Procrustes) rotation, the transform update,
// the three stop tests and the next iteration's transformed source, in one
// block; plus the verification's set-up and final fitness.
//
// Replaces the body of the reference's lax.while_loop,
// xchu_slam_tpu/ops/icp.py:114-173 (its correspondence search is the NN
// kernel, csrc/nn_kernel.cu). There is no Pallas kernel for it. The plain
// PyTorch version is ops/icp.py::align_ref, which reads the 17 moment sums
// back every iteration and does the 3×3 SVD and the tests on the host.
//
// What bounds it. Per iteration the kernel reads N source points, their
// correspondences and distances (~40 B a point: 0.16 MB at N = 4096) and
// does ~60 flops a point: far below a microsecond of bytes or flops on this
// card. What it waits for is latency: two block reductions (the means, then
// the centred cross-covariance, which needs the means), one thread's 4×4
// eigenproblem, then the transform of the source. So the design is one block
// of 1024 threads (no grid barrier, no atomics), and a verification is a
// CUDA graph of max_iterations × (NN, icp_step) plus the fitness pass, which
// the host enqueues with one replay (ops/icp.py). A `live` flag in the state
// ends the loop: every kernel of a finished trip returns at once.
//
// Design.
// - State, float[24] on the card: T (row-major 4×4, 0-15), iterations (16),
//   converged (17), previous error (18), live (19), fitness (20), live at
//   the start (21).
// - Sums in a fixed order: each thread walks its strided share of the points
//   in index order, a warp butterfly, then the 32 warps' partials in warp
//   order. Reruns are bit-identical; the stop tests see no atomic's order.
// - Rotation: Horn's quaternion form. The 4×4 symmetric matrix N is linear
//   in the cross-covariance M, so its conditioning is M's own (an
//   eigen-decomposition of MᵀM would square it, and planar submaps make M
//   nearly rank 2). The eigenvector of N's largest eigenvalue, by cyclic
//   Jacobi rotations in fp32, is the best proper rotation: the same R as the
//   reference's U·diag(1, 1, det(UVᵀ))·Vᵀ, reflection case included.
// - Stop tests as the reference's: the squared translation and rotation
//   deltas under trans_eps, or an error plateau once the transform has
//   settled to 1e-4; live = !converged && iterations < max_iterations.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the wrapper ops/cuda/icp_kernel.py passes PyTorch's current stream.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps = 8;   // cyclic Jacobi sweeps of the 4×4 eigenproblem

enum Slot { kT = 0, kIt = 16, kConv = 17, kPrevErr = 18, kLive = 19, kFitness = 20,
            kLive0 = 21, kState = 24 };

// Fixed-order sums of N floats per thread over the block; every thread gets
// the results in out[].
template <int N>
__device__ void block_sums(float (&v)[N], float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * N + threadIdx.x];
    red[kWarps * N + threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = red[kWarps * N + j];
  __syncthreads();
}

__device__ inline void transform(const float* T, const float* p, float* q) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    q[a] = fmaf(T[4 * a + 2], p[2], fmaf(T[4 * a + 1], p[1], T[4 * a] * p[0])) + T[4 * a + 3];
}

// The proper rotation R maximising tr(Rᵀ M), M = Σ (t − μt)(s − μs)ᵀ, by
// Horn's quaternion method. One thread.
__device__ void kabsch_rotation(const float* M, float* R) {
  // S = Mᵀ: S[a][b] = Σ s_a t_b
  const float Sxx = M[0], Sxy = M[3], Sxz = M[6];
  const float Syx = M[1], Syy = M[4], Syz = M[7];
  const float Szx = M[2], Szy = M[5], Szz = M[8];
  float A[4][4] = {{Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
                   {Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz},
                   {Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy},
                   {Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz}};
  float V[4][4] = {{1.f, 0.f, 0.f, 0.f}, {0.f, 1.f, 0.f, 0.f},
                   {0.f, 0.f, 1.f, 0.f}, {0.f, 0.f, 0.f, 1.f}};
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        const float apq = A[p][q];
        if (apq == 0.f) continue;
        const float theta = 0.5f * (A[q][q] - A[p][p]) / apq;
        const float t = copysignf(1.f, theta) / (fabsf(theta) + sqrtf(theta * theta + 1.f));
        const float c = 1.f / sqrtf(t * t + 1.f), s = t * c;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
  int best = 0;
  float top = A[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (A[i][i] > top) {
      top = A[i][i];
      best = i;
    }
  }
  float w = 0.f, x = 0.f, y = 0.f, z = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i == best) {
      w = V[0][i];
      x = V[1][i];
      y = V[2][i];
      z = V[3][i];
    }
  }
  const float n = sqrtf(w * w + x * x + y * y + z * z);
  w /= n;
  x /= n;
  y /= n;
  z /= n;
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

// State from the initial guess; cur = init_T · src.
__global__ void __launch_bounds__(kThreads)
icp_init_kernel(const float* __restrict__ src, int n, const float* __restrict__ init_T,
                const unsigned char* __restrict__ live, float* __restrict__ st,
                float* __restrict__ cur) {
  __shared__ float T[16];
  if (threadIdx.x < 16) {
    T[threadIdx.x] = init_T[threadIdx.x];
    st[kT + threadIdx.x] = init_T[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    st[kIt] = 0.f;
    st[kConv] = 0.f;
    st[kPrevErr] = INFINITY;
    st[kLive] = live[0] ? 1.f : 0.f;
    st[kFitness] = 0.f;
    st[kLive0] = live[0] ? 1.f : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) transform(T, src + 3 * i, cur + 3 * i);
}

__global__ void __launch_bounds__(kThreads)
icp_step_kernel(const float* __restrict__ src, const unsigned char* __restrict__ src_mask,
                int n, const float* __restrict__ tgt, const int* __restrict__ idx,
                const float* __restrict__ d2, float* __restrict__ cur,
                float* __restrict__ st, float max_d2, float trans_eps, int max_iterations) {
  __shared__ float red[(kWarps + 1) * 9];
  __shared__ float Tn[16];
  if (!(st[kLive] > 0.5f)) return;
  const int tid = threadIdx.x;

  // the means and the error sum
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    const float w = (src_mask[i] && d2[i] < max_d2) ? 1.f : 0.f;
    const float* t = tgt + 3 * idx[i];
    acc[0] += w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[1 + a] = fmaf(cur[3 * i + a], w, acc[1 + a]);
      acc[4 + a] = fmaf(t[a], w, acc[4 + a]);
    }
    acc[7] = fmaf(d2[i], w, acc[7]);
  }
  float sums[8];
  block_sums<8>(acc, red, sums);
  const float wsum = fmaxf(sums[0], 1.f);
  float mu_s[3], mu_t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = sums[1 + a] / wsum;
    mu_t[a] = sums[4 + a] / wsum;
  }

  // the centred cross-covariance M = Σ w (t − μt)(s − μs)ᵀ
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    const float w = (src_mask[i] && d2[i] < max_d2) ? 1.f : 0.f;
    const float* t = tgt + 3 * idx[i];
    float xs[3], xt[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xs[a] = (cur[3 * i + a] - mu_s[a]) * w;
      xt[a] = t[a] - mu_t[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) m[3 * a + b] = fmaf(xt[a], xs[b], m[3 * a + b]);
    }
  }
  float M[9];
  block_sums<9>(m, red, M);

  if (tid == 0) {
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = M[e] / wsum;
    float R[9];
    kabsch_rotation(M, R);
    float tv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      tv[a] = mu_t[a] - (R[3 * a] * mu_s[0] + R[3 * a + 1] * mu_s[1] + R[3 * a + 2] * mu_s[2]);
    // T ← dT · T
    float T[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) T[e] = st[kT + e];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v = R[3 * a] * T[b] + R[3 * a + 1] * T[4 + b] + R[3 * a + 2] * T[8 + b];
        if (b == 3) v += tv[a];
        Tn[4 * a + b] = v;
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) Tn[12 + b] = T[12 + b];
    const float err = sums[7] / wsum;
    const float trans_delta2 = tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2];
    const float cos_theta = 0.5f * (R[0] + R[4] + R[8] - 1.f);
    const float rot_delta2 = 2.f * (1.f - fminf(fmaxf(cos_theta, -1.f), 1.f));
    const bool conv_transform = trans_delta2 < trans_eps && rot_delta2 < trans_eps;
    const bool conv_plateau = fabsf(st[kPrevErr] - err) < trans_eps;
    const bool settled = trans_delta2 < 1e-4f && rot_delta2 < 1e-4f;
    const bool conv = conv_transform || (conv_plateau && settled);
    const float it = st[kIt] + 1.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) st[kT + e] = Tn[e];
    st[kIt] = it;
    st[kConv] = conv ? 1.f : 0.f;
    st[kPrevErr] = err;
    st[kLive] = (!conv && it < static_cast<float>(max_iterations)) ? 1.f : 0.f;
  }
  __syncthreads();
  // the next iteration's source (and the final fitness pass's)
  for (int i = tid; i < n; i += kThreads) transform(Tn, src + 3 * i, cur + 3 * i);
}

// fitness = Σ w·d² / max(Σ w, 1) at the final transform, if the verification ran.
__global__ void __launch_bounds__(kThreads)
icp_fitness_kernel(const unsigned char* __restrict__ src_mask, int n,
                   const float* __restrict__ d2, float* __restrict__ st, float max_d2) {
  __shared__ float red[(kWarps + 1) * 2];
  if (!(st[kLive0] > 0.5f)) return;
  float acc[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float w = (src_mask[i] && d2[i] < max_d2) ? 1.f : 0.f;
    acc[0] = fmaf(d2[i], w, acc[0]);
    acc[1] += w;
  }
  float sums[2];
  block_sums<2>(acc, red, sums);
  if (threadIdx.x == 0) st[kFitness] = sums[0] / fmaxf(sums[1], 1.f);
}

}  // namespace

extern "C" int icp_state_floats() { return kState; }

// st [24] ← the initial state; cur [n,3] ← init_T [4,4] · src [n,3]. `live`
// is one bool on the device: false makes the whole verification a no-op.
extern "C" int icp_init_launch(const float* src, int n, const float* init_T,
                               const unsigned char* live, float* st, float* cur,
                               void* stream) {
  icp_init_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, n, init_T, live, st, cur);
  return static_cast<int>(cudaGetLastError());
}

// One iteration after the NN kernel gave idx [n] and d2 [n] for cur [n,3]
// against tgt [m,3]; updates st and cur in place. A no-op where st's live
// flag is off.
extern "C" int icp_step_launch(const float* src, const unsigned char* src_mask, int n,
                               const float* tgt, const int* idx, const float* d2,
                               float* cur, float* st, float max_d2, float trans_eps,
                               int max_iterations, void* stream) {
  icp_step_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_mask, n, tgt, idx, d2, cur, st, max_d2, trans_eps, max_iterations);
  return static_cast<int>(cudaGetLastError());
}

// The final fitness from the NN kernel's d2 [n] at the final transform.
extern "C" int icp_fitness_launch(const unsigned char* src_mask, int n, const float* d2,
                                  float* st, float max_d2, void* stream) {
  icp_fitness_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_mask, n, d2, st, max_d2);
  return static_cast<int>(cudaGetLastError());
}
