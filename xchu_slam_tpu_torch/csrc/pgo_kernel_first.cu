// The first version of the pose-graph PCG kernel (csrc/pgo_kernel.cu holds the
// kernel the solve launches): one Gauss-Newton iteration's linear solve, the
// block-tridiagonal (chain) preconditioner's factorisation and the
// preconditioned conjugate-gradient loop, in one persistent block. Kept whole
// as the yardstick the redesigned kernel is timed against (chip_smoke.py,
// tools/torch_loop_phase_probe.py, ops/cuda/pgo_kernel.py::_cg_first); nothing
// on a main path launches it.
//
// Replaces the XLA loops of xchu_slam_tpu/models/pose_graph.py: the Thomas
// factorisation under lax.scan (:221), the two associative_scan
// substitutions (:251, :257) and the PCG lax.while_loop (:442-461). There is
// no Pallas kernel for them. The plain PyTorch version is
// models/pose_graph.py::solve_ref (a host-paced CG loop).
//
// What bounds it. The work is small: at the circuit's ~163 live keyframes one
// CG iteration reads the factor and the Jacobians (~0.1 MB) and does ~0.2
// MFLOP. What it waits for is latency: the factor recursion and both
// substitutions are dependent chains of 6×6 blocks, one link per keyframe,
// and every CG iteration has two dot products that gate the next step. A
// grid-wide barrier costs 1.07 µs on this card (PERF.md, section 6), a block
// barrier tens of ns, so the whole solve is one block: a launch, then
// __syncthreads between phases, never a grid barrier or a host round trip.
// The stop test `rz > cg_tol·rz0 && it < cg_iterations` is decided here.
//
// Design.
// - One block of kThreads threads. Elementwise phases and the per-keyframe
//   6×6 products stride over the live prefix; the chains run in warp 0, six
//   lanes a block row, each link a 6-term dot product and six shuffles.
// - The live prefix is found here: n_seq is one past the last keyframe with
//   a non-zero chain coupling (past it the factor's A blocks are 0 and the
//   chains stop), n_act one past the last live keyframe (past it every
//   vector is 0). Nothing is read back to the host.
// - Factor (once a launch): Jacobi scaling d = √|diag D|, then the Thomas
//   recursion S_k = D'_k − U'_kᵀ S_{k-1}⁻¹ U'_k in warp 0 (lanes 0-5 take
//   one column each through the two triangular solves and the Schur
//   product, lane 0 the 6×6 Cholesky of the symmetrised, relatively damped
//   block, its diagonal kept as reciprocals so the solves multiply); the
//   decoupled tail's blocks factor in parallel. A link's loads are issued
//   during the link before, in the factor and in both substitutions, so
//   the chains wait for their arithmetic, not for L2.
// - Hessian-vector product from the per-factor 6×6 Jacobians, as the plain
//   version assembles it: chain factors gathered per keyframe from its two
//   edges (no scatter), altitude factors per keyframe, and the loop factors'
//   contributions added in loop order by six lanes. No float atomics: every
//   sum that feeds the stop test (rᵀz, pᵀHp) is a fixed-order block
//   reduction, so reruns are bit-identical.
// - Vectors (r, z, p, Hp, x) live in a scratch array the wrapper allocates
//   (48 KB each at 2048 keyframes); a single block's writes are visible to
//   it after __syncthreads.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the wrapper ops/cuda/pgo_kernel.py allocates the outputs and the scratch
// and passes PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

// Built with -DPGO_TICKS (tools/torch_loop_phase_probe.py), the first thread
// adds the SM's cycle counter's advance since its last stamp to a phase's
// slot at the end of each phase, summed over the launch; pgo_ticks reads the
// slots back. Otherwise TICK is nothing.
enum Tick { kTPrefix, kTScale, kTFactor, kTInit, kTPrecIn, kTForward, kTBlockSolve,
            kTBackward, kTPrecOut, kTHvp, kTReduce, kTUpdate, kTicks };
#ifdef PGO_TICKS
__device__ long long g_ticks[kTicks];
__shared__ long long s_ticks[kTicks + 1];
#define TICK_START()                                                     \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      for (int t_ = 0; t_ < kTicks; ++t_) s_ticks[t_] = 0;               \
      s_ticks[kTicks] = clock64();                                       \
    }                                                                    \
  } while (0)
#define TICK(slot)                                                       \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      const long long n_ = clock64();                                    \
      s_ticks[slot] += n_ - s_ticks[kTicks];                             \
      s_ticks[kTicks] = n_;                                              \
    }                                                                    \
  } while (0)
#define TICK_END()                                                       \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      for (int t_ = 0; t_ < kTicks; ++t_) g_ticks[t_] = s_ticks[t_];     \
  } while (0)
#else
#define TICK_START() do {} while (0)
#define TICK(slot) do {} while (0)
#define TICK_END() do {} while (0)
#endif

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Args {
  const float* D;      // [K,36] diagonal blocks (node 0 fixed to I, damped)
  const float* U;      // [K,36] chain couplings, U[k] couples k-1 and k
  const float* g;      // [K,6] gradient, node 0 zeroed
  const float* Ji;     // [K,36] chain Jacobians w.r.t. node k-1 (edge k)
  const float* Jj;     // [K,36] chain Jacobians w.r.t. node k
  const float* oinfo;  // [6] odometry information
  const float* wp;     // [K] chain factor weights (0 where k-1 or k is dead)
  const float* Jli;    // [L,36] loop Jacobians w.r.t. node li
  const float* Jlj;    // [L,36] loop Jacobians w.r.t. node lj
  const long long* li; // [L]
  const long long* lj; // [L]
  const float* wl;     // [L] robust loop weights (0 where masked)
  const float* gA;     // [K,3] altitude row R[2,:] of every pose
  const float* gz;     // [K] altitude information (0 where none)
  const unsigned char* kf;   // [K] live keyframes
  const unsigned char* run;  // [1] solve at all
  int K, L, cg_iterations;
  float cg_tol;
  float* x;            // [K,6] out: the update
  int* iters;          // [1] out: CG trips
  float* scr;          // scratch, see scratch_floats()
};

// scratch layout (floats)
struct Scratch {
  float *d, *chol, *A, *r, *z, *p, *y, *xv, *wv, *lc;
};

__host__ __device__ inline size_t scratch_floats(int K, int L) {
  return static_cast<size_t>(K) * (6 + 36 + 36 + 6 * 6) + static_cast<size_t>(L) * 12;
}

__device__ inline Scratch carve(float* s, int K) {
  Scratch o;
  o.d = s;
  o.chol = o.d + 6 * K;
  o.A = o.chol + 36 * K;
  o.r = o.A + 36 * K;
  o.z = o.r + 6 * K;
  o.p = o.z + 6 * K;
  o.y = o.p + 6 * K;
  o.xv = o.y + 6 * K;
  o.wv = o.xv + 6 * K;
  o.lc = o.wv + 6 * K;
  return o;
}

// Fixed-order sum of one float per thread over the block: a butterfly in each
// warp, then the warps' sums in warp order. Every thread gets the result.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // `red` may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

__device__ int block_max_int(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? red[lane] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = max(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// Lower Cholesky factor of the symmetric 6×6 S (row-major) into L (row-major,
// upper part zero), its diagonal stored as the reciprocal 1/L_jj: one
// division a column, and the solves below multiply. One thread.
__device__ void chol6(const float* S, float* L) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = S[j * 6 + j];
#pragma unroll
    for (int m = 0; m < j; ++m) s -= L[j * 6 + m] * L[j * 6 + m];
    const float inv = 1.f / sqrtf(s);
    L[j * 6 + j] = inv;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = S[i * 6 + j];
#pragma unroll
      for (int m = 0; m < j; ++m) t -= L[i * 6 + m] * L[j * 6 + m];
      L[i * 6 + j] = t * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) L[i * 6 + j] = 0.f;
  }
}

// chol(damp(S)) with the damping 1e-6·tr(S)/6 + 1e-12 on the diagonal.
__device__ void damp_chol6(float* S, float* L) {
  float tr = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) tr += S[a * 6 + a];
  const float eps = 1e-6f * tr / 6.0f + 1e-12f;
#pragma unroll
  for (int a = 0; a < 6; ++a) S[a * 6 + a] += eps;
  chol6(S, L);
}

// (L Lᵀ)⁻¹ v for one 6-vector, in place (L as chol6 leaves it).
__device__ void chol_solve6(const float* L, float* v) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = v[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s -= L[i * 6 + m] * v[m];
    v[i] = s * L[i * 6 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = v[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s -= L[m * 6 + i] * v[m];
    v[i] = s * L[i * 6 + i];
  }
}

// The preconditioner M⁻¹ v → out (M = the scaled chain factor): forward
// chain, the blocks' Cholesky solves, backward chain, unscaling.
__device__ void precond(const Scratch& s, const float* v, float* out, int n_seq,
                        int n_act) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 6 * n_act; i += kThreads) out[i] = v[i] / s.d[i];
  __syncthreads();
  TICK(kTPrecIn);
  if (tid < 32) {  // forward: y_k = r_k − A_kᵀ y_{k-1}
    // link k's operands are loaded during link k-1: the chain waits only
    // for its FMAs and shuffles, not for L2
    const int c = tid < 6 ? tid : 0;
    float prev[6], Acur[6], Anext[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 6; ++j) prev[j] = out[j];
    float rcur = 0.f, rnext = 0.f;
    if (n_seq > 1) {
#pragma unroll
      for (int j = 0; j < 6; ++j) Acur[j] = s.A[36 + j * 6 + c];
      rcur = out[6 + c];
    }
    for (int k = 1; k < n_seq; ++k) {
      if (k + 1 < n_seq) {
#pragma unroll
        for (int j = 0; j < 6; ++j) Anext[j] = s.A[36 * (k + 1) + j * 6 + c];
        rnext = out[6 * (k + 1) + c];
      }
      float a = rcur;
#pragma unroll
      for (int j = 0; j < 6; ++j) a = fmaf(-Acur[j], prev[j], a);
#pragma unroll
      for (int j = 0; j < 6; ++j) prev[j] = __shfl_sync(0xffffffffu, a, j);
      if (tid < 6) out[6 * k + c] = a;
#pragma unroll
      for (int j = 0; j < 6; ++j) Acur[j] = Anext[j];
      rcur = rnext;
    }
  }
  __syncthreads();
  TICK(kTForward);
  for (int k = tid; k < n_act; k += kThreads) {
    float w[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) w[a] = out[6 * k + a];
    chol_solve6(s.chol + 36 * k, w);
#pragma unroll
    for (int a = 0; a < 6; ++a) out[6 * k + a] = w[a];
  }
  __syncthreads();
  TICK(kTBlockSolve);
  if (tid < 32 && n_seq >= 2) {  // backward: z_k = b_k − A_{k+1} z_{k+1}
    const int c = tid < 6 ? tid : 0;
    float next[6], Acur[6], Anext[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      next[j] = out[6 * (n_seq - 1) + j];
      Acur[j] = s.A[36 * (n_seq - 1) + c * 6 + j];
    }
    float bcur = out[6 * (n_seq - 2) + c], bnext = 0.f;
    for (int k = n_seq - 2; k >= 0; --k) {
      if (k >= 1) {
#pragma unroll
        for (int j = 0; j < 6; ++j) Anext[j] = s.A[36 * k + c * 6 + j];
        bnext = out[6 * (k - 1) + c];
      }
      float a = bcur;
#pragma unroll
      for (int j = 0; j < 6; ++j) a = fmaf(-Acur[j], next[j], a);
#pragma unroll
      for (int j = 0; j < 6; ++j) next[j] = __shfl_sync(0xffffffffu, a, j);
      if (tid < 6) out[6 * k + c] = a;
#pragma unroll
      for (int j = 0; j < 6; ++j) Acur[j] = Anext[j];
      bcur = bnext;
    }
  }
  __syncthreads();
  TICK(kTBackward);
  for (int i = tid; i < 6 * n_act; i += kThreads) out[i] = out[i] / s.d[i];
  __syncthreads();
  TICK(kTPrecOut);
}

// y = H v (node 0 fixed: v and y masked there).
__device__ void hvp(const Args& a, const Scratch& s, const float* v, float* y,
                    int n_act, int n_loop) {
  const int tid = threadIdx.x;
  // chain residual directions, edge e couples e-1 and e
  for (int e = 1 + tid; e < n_act; e += kThreads) {
    const float* Ji = a.Ji + 36 * e;
    const float* Jj = a.Jj + 36 * e;
    const float* vi = v + 6 * (e - 1);
    const float* vj = v + 6 * e;
    const float w = a.wp[e];
    const bool first = e == 1;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        t = fmaf(Ji[r * 6 + b], first ? 0.f : vi[b], t);
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) t = fmaf(Jj[r * 6 + b], vj[b], t);
      s.wv[6 * e + r] = t * a.oinfo[r] * w;
    }
  }
  // loop factors: both nodes' contributions, stored for the ordered sum
  for (int l = tid; l < n_loop; l += kThreads) {
    const float* Ja = a.Jli + 36 * l;
    const float* Jb = a.Jlj + 36 * l;
    const long long i = a.li[l], j = a.lj[l];
    float wj[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float t = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) t = fmaf(Ja[r * 6 + b], i == 0 ? 0.f : v[6 * i + b], t);
#pragma unroll
      for (int b = 0; b < 6; ++b) t = fmaf(Jb[r * 6 + b], j == 0 ? 0.f : v[6 * j + b], t);
      wj[r] = t * a.wl[l];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float ti = 0.f, tj = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        ti = fmaf(Ja[r * 6 + c], wj[r], ti);
        tj = fmaf(Jb[r * 6 + c], wj[r], tj);
      }
      s.lc[12 * l + c] = ti;
      s.lc[12 * l + 6 + c] = tj;
    }
  }
  __syncthreads();
  // per keyframe: its two chain edges and its altitude factor
  for (int n = tid; n < n_act; n += kThreads) {
    float out[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c] = 0.f;
    if (n + 1 < n_act) {
      const float* J = a.Ji + 36 * (n + 1);
      const float* w = s.wv + 6 * (n + 1);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int r = 0; r < 6; ++r) out[c] = fmaf(J[r * 6 + c], w[r], out[c]);
      }
    }
    if (n >= 1) {
      const float* J = a.Jj + 36 * n;
      const float* w = s.wv + 6 * n;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < 6; ++r) t = fmaf(J[r * 6 + c], w[r], t);
        out[c] += t;
      }
      const float* A = a.gA + 3 * n;
      const float sdot = A[0] * v[6 * n] + A[1] * v[6 * n + 1] + A[2] * v[6 * n + 2];
      const float gs = a.gz[n] * sdot;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] += gs * A[c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) y[6 * n + c] = n == 0 ? 0.f : out[c];
  }
  __syncthreads();
  if (tid < 6) {  // the loop factors, in loop order
    const int c = tid;
    for (int l = 0; l < n_loop; ++l) {
      const long long i = a.li[l], j = a.lj[l];
      if (i != 0) y[6 * i + c] += s.lc[12 * l + c];
      if (j != 0) y[6 * j + c] += s.lc[12 * l + 6 + c];
    }
  }
  __syncthreads();
  TICK(kTHvp);
}

__global__ void __launch_bounds__(kThreads) pgo_cg_first_kernel(Args a) {
  __shared__ float red[kWarps + 1];
  __shared__ int ired[kWarps + 1];
  __shared__ float Lprev[36], Ucol[36], Acol[36], Sblk[36];
  const int tid = threadIdx.x;
  const int K = a.K;
  const Scratch s = carve(a.scr, K);
  TICK_START();

  if (!a.run[0]) {
    for (int i = tid; i < 6 * K; i += kThreads) a.x[i] = 0.f;
    if (tid == 0) a.iters[0] = 0;
    return;
  }

  // the live prefix, found here
  int last_u = 0, last_kf = 0;
  for (int k = 1 + tid; k < K; k += kThreads) {
    bool nz = false;
    for (int e = 0; e < 36; ++e) nz |= a.U[36 * k + e] != 0.f;
    if (nz) last_u = k;
  }
  for (int k = tid; k < K; k += kThreads)
    if (a.kf[k]) last_kf = k;
  int last_l = -1;
  for (int l = tid; l < a.L; l += kThreads)
    if (a.wl[l] != 0.f) last_l = l;
  const int n_seq = block_max_int(last_u, ired) + 1;
  const int n_act = max(n_seq, block_max_int(last_kf, ired) + 1);
  const int n_loop = block_max_int(last_l, ired) + 1;
  TICK(kTPrefix);

  // Jacobi scaling and the decoupled blocks (k = 0 and k ≥ n_seq)
  for (int i = tid; i < 6 * n_act; i += kThreads) {
    const int k = i / 6, c = i % 6;
    s.d[i] = sqrtf(fabsf(a.D[36 * k + 7 * c]) + 1e-12f);
  }
  __syncthreads();
  for (int k = tid; k < n_act; k += kThreads) {
    if (k != 0 && k < n_seq) continue;
    float S[36];
    const float* dk = s.d + 6 * k;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) S[i * 6 + j] = a.D[36 * k + i * 6 + j] / (dk[i] * dk[j]);
    if (k != 0) {
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < i; ++j) {
          const float m = 0.5f * (S[i * 6 + j] + S[j * 6 + i]);
          S[i * 6 + j] = m;
          S[j * 6 + i] = m;
        }
    }
    damp_chol6(S, s.chol + 36 * k);
    for (int e = 0; e < 36; ++e) s.A[36 * k + e] = 0.f;
  }
  __syncthreads();
  TICK(kTScale);

  // the Thomas recursion along the coupled prefix, in warp 0; lane j < 6
  // owns column j. Link k+1's operands (its U and D columns, d) are loaded
  // during link k
  if (tid < 32) {
    const int lane = tid;
    const int j = lane < 6 ? lane : 0;
    if (lane < 6) {
      for (int i = 0; i < 6; ++i) Lprev[i * 6 + lane] = s.chol[i * 6 + lane];
    }
    __syncwarp();
    float Uc[6], Dc[6], dp[6], dk[6];
    float Un[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, Dn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float dn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n_seq > 1) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Uc[i] = a.U[36 + i * 6 + j];
        Dc[i] = a.D[36 + i * 6 + j];
        dp[i] = s.d[i];
        dk[i] = s.d[6 + i];
      }
    }
    for (int k = 1; k < n_seq; ++k) {
      if (k + 1 < n_seq) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          Un[i] = a.U[36 * (k + 1) + i * 6 + j];
          Dn[i] = a.D[36 * (k + 1) + i * 6 + j];
          dn[i] = s.d[6 * (k + 1) + i];
        }
      }
      if (lane < 6) {
        float u[6], w[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          u[i] = Uc[i] / (dp[i] * dk[j]);
          Ucol[i * 6 + j] = u[i];
        }
        // A_k[:, j] = S_{k-1}⁻¹ U'_k[:, j]
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float t = u[i];
#pragma unroll
          for (int m = 0; m < i; ++m) t -= Lprev[i * 6 + m] * w[m];
          w[i] = t * Lprev[i * 6 + i];
        }
#pragma unroll
        for (int i = 5; i >= 0; --i) {
          float t = w[i];
#pragma unroll
          for (int m = i + 1; m < 6; ++m) t -= Lprev[m * 6 + i] * w[m];
          w[i] = t * Lprev[i * 6 + i];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          Acol[i * 6 + j] = w[i];
          s.A[36 * k + i * 6 + j] = w[i];
        }
      }
      __syncwarp();
      if (lane < 6) {  // S_k[:, j] = D'_k[:, j] − U'_kᵀ A_k[:, j]
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float t = 0.f;
#pragma unroll
          for (int m = 0; m < 6; ++m) t = fmaf(Ucol[m * 6 + i], Acol[m * 6 + j], t);
          Sblk[i * 6 + j] = Dc[i] / (dk[i] * dk[j]) - t;
        }
      }
      __syncwarp();
      float sym[6];
      if (lane < 6) {
#pragma unroll
        for (int i = 0; i < 6; ++i) sym[i] = 0.5f * (Sblk[i * 6 + j] + Sblk[j * 6 + i]);
      }
      __syncwarp();
      if (lane < 6) {
#pragma unroll
        for (int i = 0; i < 6; ++i) Sblk[i * 6 + lane] = sym[i];
      }
      __syncwarp();
      if (lane == 0) {
        float S[36], L[36];
#pragma unroll
        for (int e = 0; e < 36; ++e) S[e] = Sblk[e];
        damp_chol6(S, L);
#pragma unroll
        for (int e = 0; e < 36; ++e) {
          Lprev[e] = L[e];
          s.chol[36 * k + e] = L[e];
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Uc[i] = Un[i];
        Dc[i] = Dn[i];
        dp[i] = dk[i];
        dk[i] = dn[i];
      }
    }
  }
  __syncthreads();
  TICK(kTFactor);

  // PCG with the relative stop on the preconditioned norm
  for (int i = tid; i < 6 * n_act; i += kThreads) {
    s.r[i] = -a.g[i];
    s.xv[i] = 0.f;
  }
  __syncthreads();
  TICK(kTInit);
  precond(s, s.r, s.z, n_seq, n_act);
  float part = 0.f;
  for (int i = tid; i < 6 * n_act; i += kThreads) {
    s.p[i] = s.z[i];
    part = fmaf(s.r[i], s.z[i], part);
  }
  const float rz0 = block_sum(part, red);
  TICK(kTReduce);
  float rz = rz0;
  int it = 0;
  while (rz > a.cg_tol * rz0 && it < a.cg_iterations) {
    hvp(a, s, s.p, s.y, n_act, n_loop);
    part = 0.f;
    for (int i = tid; i < 6 * n_act; i += kThreads) part = fmaf(s.p[i], s.y[i], part);
    const float alpha = rz / fmaxf(block_sum(part, red), 1e-20f);
    TICK(kTReduce);
    for (int i = tid; i < 6 * n_act; i += kThreads) {
      s.xv[i] = fmaf(alpha, s.p[i], s.xv[i]);
      s.r[i] = fmaf(-alpha, s.y[i], s.r[i]);
    }
    __syncthreads();
    TICK(kTUpdate);
    precond(s, s.r, s.z, n_seq, n_act);
    part = 0.f;
    for (int i = tid; i < 6 * n_act; i += kThreads) part = fmaf(s.r[i], s.z[i], part);
    const float rz_new = block_sum(part, red);
    TICK(kTReduce);
    const float beta = rz_new / fmaxf(rz, 1e-20f);
    for (int i = tid; i < 6 * n_act; i += kThreads) s.p[i] = fmaf(beta, s.p[i], s.z[i]);
    __syncthreads();
    TICK(kTUpdate);
    rz = rz_new;
    ++it;
  }
  for (int i = tid; i < 6 * K; i += kThreads) a.x[i] = i < 6 * n_act ? s.xv[i] : 0.f;
  if (tid == 0) a.iters[0] = it;
  TICK(kTUpdate);
  TICK_END();
}

}  // namespace

#ifdef PGO_TICKS
// The phases' cycle sums of the last launch (kTicks of them), into `host`.
extern "C" int pgo_ticks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ticks, sizeof(long long) * kTicks));
}
#endif

// Scratch floats the launch needs for K keyframes and L loop slots.
extern "C" long long pgo_first_scratch_floats(int K, int L) {
  return static_cast<long long>(scratch_floats(K, L));
}

// One launch: the factor and the whole PCG loop of one Gauss-Newton iteration.
// Every pointer is a contiguous device array (see Args); returns the CUDA
// error of the launch (0 on success).
extern "C" int pgo_cg_first_launch(const float* D, const float* U, const float* g,
                             const float* Ji, const float* Jj, const float* oinfo,
                             const float* wp, const float* Jli, const float* Jlj,
                             const long long* li, const long long* lj,
                             const float* wl, const float* gA, const float* gz,
                             const unsigned char* kf, const unsigned char* run,
                             int K, int L, float cg_tol, int cg_iterations,
                             float* x, int* iters, float* scratch, void* stream) {
  if (K < 2 || L < 0 || cg_iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
         K, L, cg_iterations, cg_tol, x, iters, scratch};
  pgo_cg_first_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
