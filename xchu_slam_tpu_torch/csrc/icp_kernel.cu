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
// the centred cross-covariance, which needs the means), a 4×4 eigenproblem,
// then the transform of the source. So the design is one block (no grid
// barrier, no atomics), and a verification is a CUDA graph of
// max_iterations × (NN, icp_step) plus the fitness pass, which the host
// enqueues with one replay (ops/icp.py). A `live` flag in the state ends the
// loop: every kernel of a finished trip returns at once.
//
// Design.
// - State, float[24] on the card: T (row-major 4×4, 0-15), iterations (16),
//   converged (17), previous error (18), live (19), fitness (20), live at
//   the start (21).
// - One gather per point: the step's 512 threads keep their points (up to
//   kKeep each, 4096 in all) in registers between the two moment passes:
//   the source point, its correspondence t = tgt[idx] and its weight. The
//   current point is T·s with T staged in shared memory at the start (the
//   bits the last step's transform wrote to `cur`), so the centred pass
//   reads no memory. Points past kKeep·512 are read again.
// - Sums in a fixed order: each thread walks its points in index order, a
//   warp butterfly, then one warp a sum adds the warps' partials by a
//   butterfly. Reruns are bit-identical; the stop tests see no atomic's
//   order. Two-pass centred moments: raw second moments minus n·μμᵀ cancel
//   at ±100 m coordinates.
// - Rotation: Horn's quaternion form. The 4×4 symmetric matrix N is linear
//   in the cross-covariance M, so its conditioning is M's own (an
//   eigen-decomposition of MᵀM would square it, and planar submaps make M
//   nearly rank 2). Its eigenvector of the largest eigenvalue is the best
//   proper rotation: the same R as the reference's U·diag(1, 1, det(UVᵀ))·Vᵀ,
//   reflection case included. Found by Jacobi rotations in warp 0, a lane an
//   entry of N and of V, in parallel order (three rounds of two disjoint
//   pairs a sweep), each rotated pair set to 0; sweeps stop once the
//   off-diagonal part is under kOffTol of N's Frobenius norm (both squared),
//   at most kSweeps.
// - Stop tests as the reference's: the squared translation and rotation
//   deltas under trans_eps, or an error plateau once the transform has
//   settled to 1e-4; live = !converged && iterations < max_iterations.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the wrapper ops/cuda/icp_kernel.py passes PyTorch's current stream.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;       // the set-up and fitness kernels
constexpr int kWarps = kThreads / 32;
constexpr int kStepThreads = 512;    // the step kernel
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kKeep = 8;             // points a step thread keeps in registers
constexpr int kSweeps = 8;           // at most, of the 4×4 eigenproblem's Jacobi sweeps
constexpr float kOffTol = 1e-14f;    // the stop: off-diagonal² ≤ kOffTol · Frobenius²

enum Slot { kT = 0, kIt = 16, kConv = 17, kPrevErr = 18, kLive = 19, kFitness = 20,
            kLive0 = 21, kState = 24 };

// Built with -DICP_TICKS (tools/torch_loop_phase_probe.py), the first thread
// stamps the SM's cycle counter at the end of each phase of a step, and the
// Jacobi sweeps go in the last slot; icp_ticks reads the slots of the last
// live step back.
enum Tick { kTPass1, kTReduce1, kTPass2, kTReduce2, kTEigen, kTUpdate, kTTransform,
            kTSweeps, kTicks };
#ifdef ICP_TICKS
__device__ long long g_ticks[kTicks];
#define TICK_START() long long tick_last_ = clock64()
#define TICK(slot)                                                       \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long n_ = clock64();                                    \
      g_ticks[slot] = n_ - tick_last_;                                   \
      tick_last_ = n_;                                                   \
    }                                                                    \
  } while (0)
#define TICK_SET(slot, value)                                            \
  do {                                                                   \
    if (threadIdx.x == 0) g_ticks[slot] = (value);                       \
  } while (0)
#else
#define TICK_START() do {} while (0)
#define TICK(slot) do {} while (0)
#define TICK_SET(slot, value) do {} while (0)
#endif

// Fixed-order sums of N floats per thread over a block of W warps; every
// thread gets the results in out[]. A butterfly in each warp, then warp j
// adds sum j's W partials by a butterfly: no thread adds a chain of them.
template <int N, int W>
__device__ void block_sums(float (&v)[N], float* red, float* out) {
  static_assert(N <= W && W <= 32, "one warp a sum, at most 32 partials");
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
  if (warp < N) {
    float t = lane < W ? red[lane * N + warp] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[W * N + warp] = t;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = red[W * N + j];
  __syncthreads();
}

__device__ inline void transform(const float* T, const float* p, float* q) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    q[a] = fmaf(T[4 * a + 2], p[2], fmaf(T[4 * a + 1], p[1], T[4 * a] * p[0])) + T[4 * a + 3];
}

// The Jacobi rotation (c, σ) that index k takes in a round whose pairs are
// (k, k ^ r): J[k][k] = c, J[k ^ r][k] = σ (−s for the lower index of the
// pair, +s for the upper), the one that zeroes N[p][q]. `a` is this lane's
// entry of N (lane 4i + j holds N[i][j]).
__device__ inline void jacobi_rotation(float a, int k, int r, float& c, float& sigma) {
  const int p = min(k, k ^ r), q = max(k, k ^ r);
  const float app = __shfl_sync(0xffffffffu, a, 5 * p);
  const float aqq = __shfl_sync(0xffffffffu, a, 5 * q);
  const float apq = __shfl_sync(0xffffffffu, a, 4 * p + q);
  c = 1.f;
  float s = 0.f;
  if (apq != 0.f) {
    // t = sgn θ / (|θ| + √(θ² + 1)) = sgn θ · r / (|θ|·r + 1), r = 1/√(θ² + 1),
    // with fast reciprocals; θ is held to ±1e18 so that θ² stays finite (a
    // tiny apq then gives t ≈ 1/(2θ), as it should)
    const float theta = fminf(fmaxf(__fdividef(0.5f * (aqq - app), apq), -1e18f), 1e18f);
    const float r = rsqrtf(fmaf(theta, theta, 1.f));
    const float t = copysignf(__fdividef(r, fmaf(fabsf(theta), r, 1.f)), theta);
    c = rsqrtf(fmaf(t, t, 1.f));
    s = t * c;
  }
  sigma = k == p ? -s : s;
}

// The proper rotation's unit quaternion (w, x, y, z), in every lane of warp 0
// (all 32 lanes call; lanes 16-31 mirror 0-15), from the 3×3 cross-covariance
// M = Σ (t − μt)(s − μs)ᵀ / n by Horn's method: the eigenvector of the
// largest eigenvalue of the 4×4 symmetric N, by Jacobi sweeps in parallel
// order. Returns the sweeps run.
__device__ int horn_quaternion(const float* M, float (&q)[4]) {
  const int lane = threadIdx.x & 31, e = lane & 15, i = e >> 2, j = e & 3;
  // S = Mᵀ: S[a][b] = Σ s_a t_b
  const float Sxx = M[0], Sxy = M[3], Sxz = M[6];
  const float Syx = M[1], Syy = M[4], Syz = M[7];
  const float Szx = M[2], Szy = M[5], Szz = M[8];
  const float N[16] = {Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
                       Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
                       Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
                       Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz};
  float a = 0.f;
#pragma unroll
  for (int f = 0; f < 16; ++f) a = f == e ? N[f] : a;
  float v = i == j ? 1.f : 0.f;
  float frob2 = a * a;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) frob2 += __shfl_xor_sync(0xffffffffu, frob2, o);
  int sweep = 0;
  for (; sweep < kSweeps; ++sweep) {
    float off2 = i == j ? 0.f : a * a;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) off2 += __shfl_xor_sync(0xffffffffu, off2, o);
    if (off2 <= kOffTol * frob2) break;
#pragma unroll
    for (int r = 1; r <= 3; ++r) {   // pairs (0, r) and the other two
      const int pi = i ^ r, pj = j ^ r;
      float ci, si, cj, sj;
      jacobi_rotation(a, i, r, ci, si);
      jacobi_rotation(a, j, r, cj, sj);
      const float a_ipj = __shfl_sync(0xffffffffu, a, 4 * i + pj);
      const float a_pij = __shfl_sync(0xffffffffu, a, 4 * pi + j);
      const float a_pipj = __shfl_sync(0xffffffffu, a, 4 * pi + pj);
      const float v_ipj = __shfl_sync(0xffffffffu, v, 4 * i + pj);
      // N ← Jᵀ N J, V ← V J; the rotated pair's entries are 0
      const float an = fmaf(si * sj, a_pipj, fmaf(si * cj, a_pij, fmaf(ci * sj, a_ipj, ci * cj * a)));
      a = j == pi ? 0.f : an;
      v = fmaf(sj, v_ipj, cj * v);
    }
  }
  int best = 0;
  float top = __shfl_sync(0xffffffffu, a, 0);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const float d = __shfl_sync(0xffffffffu, a, 5 * k);
    if (d > top) {
      top = d;
      best = k;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __shfl_sync(0xffffffffu, v, 4 * k + best);
  const float rn = rsqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] *= rn;
  return sweep;
}

// One point's share of a step's first pass: the weight, the transformed
// source c = T·s and the correspondence t into Σw, Σw·c, Σw·t, Σw·d².
__device__ __forceinline__ void first_moments(const float* T, const float* s, const float* t,
                                              float w, float d2, float (&acc)[8]) {
  float c[3];
  transform(T, s, c);
  acc[0] += w;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    acc[1 + a] = fmaf(c[a], w, acc[1 + a]);
    acc[4 + a] = fmaf(t[a], w, acc[4 + a]);
  }
  acc[7] = fmaf(d2, w, acc[7]);
}

// One point's share of the centred cross-covariance Σ w (t − μt)(c − μs)ᵀ.
__device__ __forceinline__ void centred_moments(const float* T, const float* s, const float* t,
                                                float w, const float* mu_s, const float* mu_t,
                                                float (&m)[9]) {
  float c[3], xs[3], xt[3];
  transform(T, s, c);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    xs[a] = (c[a] - mu_s[a]) * w;
    xt[a] = t[a] - mu_t[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) m[3 * a + b] = fmaf(xt[a], xs[b], m[3 * a + b]);
  }
}

// The first pass over the points this thread reads from memory: i = first,
// first + kStepThreads, ... < n.
__device__ __forceinline__ void first_pass(const float* T, const float* src,
                                           const unsigned char* src_mask, int n,
                                           const float* tgt, const int* idx, const float* d2,
                                           float max_d2, int first, float (&acc)[8]) {
  for (int i = first; i < n; i += kStepThreads) {
    const float w = (src_mask[i] && d2[i] < max_d2) ? 1.f : 0.f;
    first_moments(T, src + 3 * i, tgt + 3 * idx[i], w, d2[i], acc);
  }
}

// The centred pass over the same points.
__device__ __forceinline__ void centred_pass(const float* T, const float* src,
                                             const unsigned char* src_mask, int n,
                                             const float* tgt, const int* idx, const float* d2,
                                             float max_d2, const float* mu_s, const float* mu_t,
                                             int first, float (&m)[9]) {
  for (int i = first; i < n; i += kStepThreads) {
    const float w = (src_mask[i] && d2[i] < max_d2) ? 1.f : 0.f;
    centred_moments(T, src + 3 * i, tgt + 3 * idx[i], w, mu_s, mu_t, m);
  }
}

// A step's update after the rotation's quaternion q (one thread): R and
// the translation from the means, T ← dT · T into Tn, then the stop tests
// and the state into st. `prev` holds the iterations and the last error.
__device__ __forceinline__ void update_state(const float (&q)[4], const float* mu_s,
                                             const float* mu_t, float err, const float* T,
                                             const float* prev, float* Tn, float* st,
                                             float trans_eps, int max_iterations) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  float R[9];
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
  float tv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    tv[a] = mu_t[a] - (R[3 * a] * mu_s[0] + R[3 * a + 1] * mu_s[1] + R[3 * a + 2] * mu_s[2]);
  // T ← dT · T
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
  const float trans_delta2 = tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2];
  const float cos_theta = 0.5f * (R[0] + R[4] + R[8] - 1.f);
  const float rot_delta2 = 2.f * (1.f - fminf(fmaxf(cos_theta, -1.f), 1.f));
  const bool conv_transform = trans_delta2 < trans_eps && rot_delta2 < trans_eps;
  const bool conv_plateau = fabsf(prev[1] - err) < trans_eps;
  const bool settled = trans_delta2 < 1e-4f && rot_delta2 < 1e-4f;
  const bool conv = conv_transform || (conv_plateau && settled);
  const float it = prev[0] + 1.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) st[kT + e] = Tn[e];
  st[kIt] = it;
  st[kConv] = conv ? 1.f : 0.f;
  st[kPrevErr] = err;
  st[kLive] = (!conv && it < static_cast<float>(max_iterations)) ? 1.f : 0.f;
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

__global__ void __launch_bounds__(kStepThreads)
icp_step_kernel(const float* __restrict__ src, const unsigned char* __restrict__ src_mask,
                int n, const float* __restrict__ tgt, const int* __restrict__ idx,
                const float* __restrict__ d2, float* __restrict__ cur,
                float* __restrict__ st, float max_d2, float trans_eps, int max_iterations) {
  __shared__ float red[(kStepWarps + 1) * 9];
  __shared__ float sT[16], Tn[16], prev[2];
  const int tid = threadIdx.x;
  // the transform and the counters, loaded with the live flag: nothing
  // reads st after this
  const float live = st[kLive];
  const float mine = tid < 16 ? st[kT + tid] : tid == 16 ? st[kIt] : tid == 17 ? st[kPrevErr] : 0.f;
  if (!(live > 0.5f)) return;
  TICK_START();

  // pass 1: the means and the error sum, each point gathered once and kept;
  // every load of the thread's points is issued before the first is used
  float ps[kKeep][3], pt[kKeep][3], pw[kKeep], pd[kKeep];
  int pi[kKeep];
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
    const int i = tid + u * kStepThreads;
    const bool in = i < n;
    pi[u] = in ? idx[i] : 0;
    pd[u] = in ? d2[i] : 0.f;
    pw[u] = in && src_mask[i] ? 1.f : 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) ps[u][a] = in ? src[3 * i + a] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
#pragma unroll
    for (int a = 0; a < 3; ++a) pt[u][a] = tid + u * kStepThreads < n ? tgt[3 * pi[u] + a] : 0.f;
  }
  if (tid < 16) sT[tid] = mine;
  if (tid == 16 || tid == 17) prev[tid - 16] = mine;
  __syncthreads();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
    if (tid + u * kStepThreads < n) {
      const float w = (pw[u] > 0.5f && pd[u] < max_d2) ? 1.f : 0.f;
      pw[u] = w;
      // T·s = cur[i], the bits the last transform wrote
      first_moments(sT, ps[u], pt[u], w, pd[u], acc);
    }
  }
  first_pass(sT, src, src_mask, n, tgt, idx, d2, max_d2, tid + kKeep * kStepThreads, acc);
  TICK(kTPass1);
  float sums[8];
  block_sums<8, kStepWarps>(acc, red, sums);
  TICK(kTReduce1);
  const float wsum = fmaxf(sums[0], 1.f);
  float mu_s[3], mu_t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = sums[1 + a] / wsum;
    mu_t[a] = sums[4 + a] / wsum;
  }

  // pass 2: the centred cross-covariance M = Σ w (t − μt)(s − μs)ᵀ, from
  // registers
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
    if (tid + u * kStepThreads < n) centred_moments(sT, ps[u], pt[u], pw[u], mu_s, mu_t, m);
  }
  centred_pass(sT, src, src_mask, n, tgt, idx, d2, max_d2, mu_s, mu_t,
               tid + kKeep * kStepThreads, m);
  TICK(kTPass2);
  float M[9];
  block_sums<9, kStepWarps>(m, red, M);
  TICK(kTReduce2);

  if (tid < 32) {
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = M[e] / wsum;
    float q[4];
    const int sweeps = horn_quaternion(M, q);
    TICK(kTEigen);
    TICK_SET(kTSweeps, sweeps);
    if (tid == 0)
      update_state(q, mu_s, mu_t, sums[7] / wsum, sT, prev, Tn, st, trans_eps, max_iterations);
  }
  TICK(kTUpdate);
  __syncthreads();
  // the next iteration's source (and the final fitness pass's)
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
    const int i = tid + u * kStepThreads;
    if (i < n) transform(Tn, ps[u], cur + 3 * i);
  }
  for (int i = tid + kKeep * kStepThreads; i < n; i += kStepThreads)
    transform(Tn, src + 3 * i, cur + 3 * i);
  TICK(kTTransform);
}

// ---- icp_step split at its reductions, for a sharded verification ---- //
//
// With the source sharded over a mesh of ranks (ops/icp.py::align with
// `mesh`), each reduction of icp_step becomes a collective between ranks, so
// the step is cut where it reduces. icp_step centres its cross-covariance in
// two passes (the means first), so a trip has two cuts: icp_partial stage 0
// writes the shard's 8 first-pass sums (Σw, Σw·s, Σw·t, Σw·d²), stage 1
// writes the shard's 9 centred sums Σ w (t − μt)(s − μs)ᵀ about the means of
// the reduced 8; icp_solve takes the reduced 17 and does the rest of the
// step: the Kabsch rotation, the update, the stop tests and the shard's next
// transformed source. Each does icp_step's arithmetic in icp_step's order
// (the same thread a point, the same block sums), so that a mesh of one
// rank, whose reductions add nothing, reproduces icp_step's state and `cur`
// bit for bit. Stage 0 at the final transform also gives the fitness sums.
__global__ void __launch_bounds__(kStepThreads)
icp_partial_kernel(const float* __restrict__ src, const unsigned char* __restrict__ src_mask,
                   int n, const float* __restrict__ tgt, const int* __restrict__ idx,
                   const float* __restrict__ d2, const float* __restrict__ st,
                   const float* __restrict__ sums_in, float* __restrict__ out, float max_d2,
                   int stage) {
  __shared__ float red[(kStepWarps + 1) * 9];
  __shared__ float sT[16];
  const int tid = threadIdx.x;
  if (tid < 16) sT[tid] = st[kT + tid];
  __syncthreads();
  if (stage == 0) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    first_pass(sT, src, src_mask, n, tgt, idx, d2, max_d2, tid, acc);
    float sums[8];
    block_sums<8, kStepWarps>(acc, red, sums);
    if (tid < 8) out[tid] = sums[tid];
    return;
  }
  const float wsum = fmaxf(sums_in[0], 1.f);
  float mu_s[3], mu_t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = sums_in[1 + a] / wsum;
    mu_t[a] = sums_in[4 + a] / wsum;
  }
  float m[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  centred_pass(sT, src, src_mask, n, tgt, idx, d2, max_d2, mu_s, mu_t, tid, m);
  float M[9];
  block_sums<9, kStepWarps>(m, red, M);
  if (tid < 9) out[8 + tid] = M[tid];
}

// The rest of icp_step from the reduced 17 sums: the rotation, T ← dT·T,
// the stop tests into st, and cur ← T·src for the shard. (With the default
// bounds ptxas spills 16 bytes around the calls of the IEEE division's slow
// path; one block an SM leaves it the registers not to.)
__global__ void __launch_bounds__(kStepThreads, 1)
icp_solve_kernel(const float* __restrict__ src, int n, const float* __restrict__ sums,
                 float* __restrict__ cur, float* __restrict__ st, float trans_eps,
                 int max_iterations) {
  __shared__ float sT[16], Tn[16], prev[2];
  const int tid = threadIdx.x;
  if (tid < 16) sT[tid] = st[kT + tid];
  if (tid == 16) prev[0] = st[kIt];
  if (tid == 17) prev[1] = st[kPrevErr];
  __syncthreads();
  if (tid < 32) {
    const float wsum = fmaxf(sums[0], 1.f);
    float mu_s[3], mu_t[3], M[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mu_s[a] = sums[1 + a] / wsum;
      mu_t[a] = sums[4 + a] / wsum;
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) M[e] = sums[8 + e] / wsum;
    float q[4];
    horn_quaternion(M, q);
    if (tid == 0)
      update_state(q, mu_s, mu_t, sums[7] / wsum, sT, prev, Tn, st, trans_eps, max_iterations);
  }
  __syncthreads();
  for (int i = tid; i < n; i += kStepThreads) transform(Tn, src + 3 * i, cur + 3 * i);
}

// What a step waits for beyond its launch and barriers: mode 0 an empty
// launch of the step's geometry; 1 `reps` dependent eigen-solves in warp 0
// (horn_quaternion on M [9], each fed a last-bit-free function of the one
// before). out[0] keeps the result live, out[1] the sweeps of the last.
__global__ void icp_probe_kernel(int mode, int reps, const float* __restrict__ M,
                                 float* __restrict__ out) {
  if (mode != 1 || threadIdx.x >= 32) return;
  float m[9], q[4] = {1.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 9; ++e) m[e] = M[e];
  int sweeps = 0;
  for (int r = 0; r < reps; ++r) {
    m[8] = M[8] + 1e-30f * q[3];
    sweeps = horn_quaternion(m, q);
  }
  if (threadIdx.x == 0) {
    out[0] = q[0];
    out[1] = static_cast<float>(sweeps);
  }
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
  block_sums<2, kWarps>(acc, red, sums);
  if (threadIdx.x == 0) st[kFitness] = sums[0] / fmaxf(sums[1], 1.f);
}

}  // namespace

extern "C" int icp_state_floats() { return kState; }

#ifdef ICP_TICKS
// The slots of the last live step (kTicks of them), into `host`.
extern "C" int icp_ticks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ticks, sizeof(long long) * kTicks));
}
#endif

// One launch of the probe kernel (1 × 512 threads, the step's geometry).
extern "C" int icp_probe_launch(int mode, int reps, const float* M, float* out, void* stream) {
  icp_probe_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(mode, reps, M, out);
  return static_cast<int>(cudaGetLastError());
}

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
  icp_step_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_mask, n, tgt, idx, d2, cur, st, max_d2, trans_eps, max_iterations);
  return static_cast<int>(cudaGetLastError());
}

// The shard's first-pass sums (stage 0: 8 floats to out[0..7]) or centred
// sums about the means of the reduced `sums_in` (stage 1: 9 floats to
// out[8..16]) of one sharded ICP iteration; T is read from st.
extern "C" int icp_partial_launch(const float* src, const unsigned char* src_mask, int n,
                                  const float* tgt, const int* idx, const float* d2,
                                  const float* st, const float* sums_in, float* out,
                                  float max_d2, int stage, void* stream) {
  if (stage != 0 && stage != 1) return static_cast<int>(cudaErrorInvalidValue);
  icp_partial_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, src_mask, n, tgt, idx, d2, st, sums_in, out, max_d2, stage);
  return static_cast<int>(cudaGetLastError());
}

// The rest of one sharded ICP iteration from the reduced 17 sums: st updated,
// cur [n,3] ← T·src for the shard.
extern "C" int icp_solve_launch(const float* src, int n, const float* sums, float* cur,
                                float* st, float trans_eps, int max_iterations,
                                void* stream) {
  icp_solve_kernel<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, n, sums, cur, st, trans_eps, max_iterations);
  return static_cast<int>(cudaGetLastError());
}

// The final fitness from the NN kernel's d2 [n] at the final transform.
extern "C" int icp_fitness_launch(const unsigned char* src_mask, int n, const float* d2,
                                  float* st, float max_d2, void* stream) {
  icp_fitness_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_mask, n, d2, st, max_d2);
  return static_cast<int>(cudaGetLastError());
}
