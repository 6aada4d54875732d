// One Gauss-Newton iteration's linear solve of the pose-graph optimiser:
// the block-tridiagonal (chain) preconditioner's factorisation and the
// preconditioned conjugate-gradient loop, in one persistent block.
//
// Replaces the XLA loops of xchu_slam_tpu/models/pose_graph.py: the Thomas
// factorisation under lax.scan (:221), the two associative_scan
// substitutions (:251, :257) and the PCG lax.while_loop (:442-461). There is
// no Pallas kernel for them. The plain PyTorch version is
// models/pose_graph.py::solve_ref (a host-paced CG loop). The kernel's first
// version, csrc/pgo_kernel_first.cu, is kept as the yardstick.
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
// The first version's chains waited on L2: its factor link took ~3,800
// cycles (its arithmetic alone ~940) and its substitution links 160-260
// (~55 on registers) (PERF.md, section 6, tools/torch_loop_phase_probe.py).
//
// Design.
// - One block of kThreads threads. Elementwise phases and the per-keyframe
//   6×6 products stride over the live prefix.
// - The live prefix is found here: n_seq is one past the last keyframe with
//   a non-zero chain coupling (past it the factor's A blocks are 0 and the
//   chains stop), n_act one past the last live keyframe (past it every
//   vector is 0). Nothing is read back to the host.
// - Factor (once a launch): Jacobi scaling d = √|diag D|; every link's
//   scaled operands U'_k, D'_k are formed by all threads at once into
//   scratch, and warp 0 streams them through a shared-memory ring filled by
//   cp.async kFactorRing links ahead. The Thomas recursion
//   S_k = D'_k − U'_kᵀ S_{k-1}⁻¹ U'_k runs across lanes 0-5, lane j a column:
//   the two triangular solves, the Schur product, then the symmetrised,
//   relatively damped block's Cholesky right-looking, one column a step,
//   pivot column broadcast by shuffles; the diagonal kept as reciprocals.
//   Its arithmetic and order are the first version's, so the factor is bit
//   for bit the first version's: the truncated PCG's result moves by up to
//   3e-4 at 2048 live keyframes when the pivots' reciprocal roots or the
//   scaling's divisions are taken fast (rsqrtf, __fdividef), so they stay
//   IEEE. The decoupled tail's blocks factor in parallel.
// - Substitutions (y_k = r_k − A_kᵀ y_{k-1} forward, z_k = b_k − A_{k+1}
//   z_{k+1} backward). Below kSegmentedMin coupled keyframes, sequential
//   sweeps in warp 0, six lanes a block row, A and the swept vector in
//   shared memory. From kSegmentedMin on, segmented (a blocked form of the
//   reference's associative_scan): the chain is cut into S ≈ √(2·n_seq)
//   segments of Lseg links; lane s runs segment s from a zero start, one
//   lane a segment, A streamed from scratch through the lane's own cp.async
//   ring; one lane then carries the S segment boundaries in order, applying
//   each segment's 6×6 transfer product (formed once a launch, after the
//   factor); then each lane runs its segment again from its true incoming
//   value. Depth 2·Lseg + S links instead of n_seq.
// - Hessian-vector product from the per-factor 6×6 Jacobians, as the plain
//   version assembles it: each chain edge's thread reads its two Jacobians
//   once and forms both nodes' shares, each keyframe's thread gathers its two
//   edges' shares (no scatter) and adds its altitude factor and the loop
//   factors' contributions from its list of loop slots, in loop order (the
//   lists are built once a launch, in shared memory, while warp 0 factors).
//   No float atomics: every sum that feeds the stop test (rᵀz, pᵀHp) is a
//   fixed-order block reduction, so reruns are bit-identical; its order is
//   the first version's (512 virtual lanes on the 384 threads). With its
//   sweeps sequential the kernel is bit for bit the first version, and the
//   segmented sweeps are its only other rounding: at 2048 live keyframes the
//   float32 solve is already 1.3e-4 from a float64 one, and another order of
//   the dot products alone moved the kernel 1e-4 from solve_ref.
// - Shared memory (dynamic, carved in the kernel once the live
//   prefix is known): always the swept vector w (6·n_act floats), the loop
//   lists (n_act + 2·n_loop ints) and contributions (12·n_loop floats); the
//   segmented sweeps' rings (S·kSweepRing·36), transfer products (2·S·36)
//   and boundary values (12·S); or, for sequential sweeps, A (36·n_seq);
//   then, as far as the rest allows, in this order, the CG vectors r, z, p,
//   y, x (6·n_act each), the edges' shares (12·n_act), d (6·n_act) and the
//   Cholesky blocks (36·n_act). What does not fit stays in the scratch the
//   wrapper allocates. The launch takes what the fixed part and the sweeps
//   need at n_act = K (smem_bytes: 148 KB at K = 2048, L = 256), at least
//   kSmemMin: the SM's other ~100 KB stay L1, which the Jacobians' reads
//   need (all 220 KB made `hvp` 3.5× slower). At the circuit's 163 live
//   keyframes everything fits; at 2048 live the vectors stay in scratch.
//   K ≤ kMaxK and L ≤ kMaxL keep the fixed part within the budget.
//
// - The block-Jacobi preconditioner (`precond="jacobi"`, the reference's
//   pose_graph.py:423-432) is the instantiation pgo_cg_kernel<true>: each
//   live keyframe's 6×6 block (node 0 = I, + 1e-6·I, as assembled) factored
//   by chol6 in its own thread, all at once, and M⁻¹ v one forward and
//   backward substitution a keyframe, in parallel; no chain, no sweeps, no
//   scaling. The PCG loop and its fixed-order sums are the same code.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the wrapper ops/cuda/pgo_kernel.py allocates the outputs and the scratch
// and passes PyTorch's current stream.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;   // 168 registers a thread: the factor loop spills at 128
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 220 * 1024;         // dynamic shared memory a launch may take
constexpr int kSmemMin = 96 * 1024;          // ... and takes at least (the rest is L1)
constexpr int kMaxK = 4096, kMaxL = 256;     // keyframe and loop slots the budget holds
constexpr int kFactorRing = 4;               // factor links in flight
constexpr int kSweepRing = 6;                // A blocks in flight a segment lane
// floats between two lanes' rings: an odd number of 16-byte steps, so the
// float4 reads of eight lanes hit eight bank groups
constexpr int kRingStride = kSweepRing * 36 + 4;
constexpr int kMaxSegments = 64;
// coupled keyframes from which the substitutions are segmented: the forced
// sweeps cost the same at 48 and the segmented ones win from 64 on
// (tools/torch_loop_phase_probe.py, PERF.md section 6)
constexpr int kSegmentedMin = 64;

// Built with -DPGO_TICKS (tools/torch_loop_phase_probe.py), the first thread
// adds the SM's cycle counter's advance since its last stamp to a phase's
// slot at the end of each phase, summed over the launch; pgo_ticks reads the
// slots back. Otherwise TICK is nothing.
enum Tick { kTPrefix, kTScale, kTFactor, kTInit, kTPrecIn, kTForward, kTBlockSolve,
            kTBackward, kTPrecOut, kTHvp, kTReduce, kTUpdate, kTTransfer, kTicks };
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
  int seg_min;         // n_seq from which the substitutions are segmented
  int smem_floats;     // the launch's dynamic shared memory
  float* x;            // [K,6] out: the update
  int* iters;          // [1] out: CG trips
  float* scr;          // scratch, see scratch_floats()
};

// scratch layout (floats): A and the scaled operands first (16-byte aligned
// blocks for cp.async), then the rest
__host__ __device__ inline size_t scratch_floats(int K, int L) {
  return static_cast<size_t>(K + 1) * 36 + static_cast<size_t>(K) * (72 + 36 + 6 + 5 * 6 + 12) +
         static_cast<size_t>(L) * 12;
}

struct Scratch {
  float *A, *UD, *chol, *d, *r, *z, *p, *y, *xv, *ec, *lc;
};

__device__ inline Scratch carve_scratch(float* s, int K) {
  Scratch o;
  o.A = s;                       // [K+1,36]: A[n_seq] stays 0 for the backward sweep
  o.UD = o.A + 36 * (K + 1);     // [K,72]: U'_k then D'_k
  o.chol = o.UD + 72 * K;
  o.d = o.chol + 36 * K;
  o.r = o.d + 6 * K;
  o.z = o.r + 6 * K;
  o.p = o.z + 6 * K;
  o.y = o.p + 6 * K;
  o.xv = o.y + 6 * K;
  o.ec = o.xv + 6 * K;   // [K,12]: an edge's shares of its two nodes
  o.lc = o.ec + 12 * K;
  return o;
}

// The segmented sweeps' cut: the fewest links a segment with 2·Lseg² ≥ n_seq
// and at most kMaxSegments segments, made odd so that the segment lanes'
// reads of w (6·Lseg floats apart) meet at most in pairs on a bank.
__host__ __device__ inline int segment_links(int n_seq) {
  int lseg = 1;
  while (2 * lseg * lseg < n_seq || lseg * kMaxSegments < n_seq) ++lseg;
  return lseg | 1;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory for K keyframe and L loop slots: the fixed part and
// the segmented sweeps' (or the sequential sweeps' A) at the worst case of
// n_act = n_seq = K, at least kSmemMin, at most kSmemMax. The vectors take
// what is left at the launch's live prefix; L1 keeps the rest of the SM's
// 256 KB, which the reads of the Jacobians in `hvp` need.
__host__ inline int smem_bytes(int K, int L) {
  const int lseg = segment_links(K), nseg = (K + lseg - 1) / lseg;
  const int fixed = round4(6 * K) + round4(K) + round4(2 * L) + round4(12 * L);
  const int seg = nseg * kRingStride + round4(72 * nseg) + 2 * round4(6 * nseg);
  const int seq = round4(36 * (K < kSegmentedMin ? K : kSegmentedMin));
  const int bytes = 4 * (fixed + (seg > seq ? seg : seq));
  return bytes < kSmemMin ? kSmemMin : (bytes > kSmemMax ? kSmemMax : bytes);
}

// A bump allocator over the dynamic shared memory, in 16-byte steps.
struct Carve {
  float* base;
  int used, cap;
  __device__ bool fits(int n) const { return used + round4(n) <= cap; }
  __device__ float* take(int n) {
    float* p = base + used;
    used += round4(n);
    return p;
  }
  // `n` floats in shared memory if they fit, else `fallback` (scratch)
  __device__ float* take_or(int n, float* fallback) { return fits(n) ? take(n) : fallback; }
};

// Fixed-order dot product Σ x_i y_i over n elements, in the first version's
// order whatever kThreads is: 512 virtual lanes, lane v summing the i ≡ v
// (mod 512) in index order, a butterfly in each virtual warp, then the 16
// warps' sums by a butterfly. Thread t takes lanes t and t + kThreads.
// Every thread gets the result. Reruns are bit-identical and the solve
// rounds as the first version's does.
constexpr int kLanes = 512;
static_assert(kThreads <= kLanes && (kLanes - kThreads) % 32 == 0 && kLanes / 32 <= 32,
              "the virtual lanes' second share must be whole warps");

__device__ float block_dot(const float* x, const float* y, int n, float* red) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool two = tid + kThreads < kLanes;   // whole warps
  float v0 = 0.f, v1 = 0.f;
  for (int i = tid; i < n; i += kLanes) v0 = fmaf(x[i], y[i], v0);
  if (two) {
    for (int i = tid + kThreads; i < n; i += kLanes) v1 = fmaf(x[i], y[i], v1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v0 += __shfl_xor_sync(0xffffffffu, v0, o);
  if (two) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  __syncthreads();  // `red` may still be read from the last call
  if (lane == 0) {
    red[warp] = v0;
    if (two) red[kThreads / 32 + warp] = v1;
  }
  __syncthreads();
  if (warp == 0) {
    float t = lane < kLanes / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[kLanes / 32] = t;
  }
  __syncthreads();
  return red[kLanes / 32];
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

// One link of the factor recursion, by all 32 lanes of warp 0, lane j < 6 a
// column (lanes 6-31 repeat column 0 and keep nothing). From U'_k, D'_k and
// Lprev = chol(S_{k-1}): acol = A_k[:, j] = S_{k-1}⁻¹ U'_k[:, j] in
// registers, and L_k = chol(damp(sym(D'_k − U'_kᵀ A_k))) into Lprev and
// chol_k. Sblk is a 6×6 exchange block. The Cholesky runs across the six
// lanes (kColumns: right-looking, one column a step, the pivot column
// broadcast by shuffles, no branch; the kernel's) or in lane 0 (the first
// version's chol6; the probe kernel times both: 0.87 and 0.84 µs a link on
// the H100, PERF.md section 6); both round as the first version does.
template <bool kColumns>
__device__ inline void factor_link(const float* Un, const float* Dn, float* Lprev, float* Sblk,
                                   int j, float (&acol)[6], float* chol_k) {
  const int lane = threadIdx.x & 31;
  // A_k[:, j], two triangular solves
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = Un[i * 6 + j];
#pragma unroll
    for (int m = 0; m < i; ++m) t -= Lprev[i * 6 + m] * acol[m];
    acol[i] = t * Lprev[i * 6 + i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = acol[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) t -= Lprev[m * 6 + i] * acol[m];
    acol[i] = t * Lprev[i * 6 + i];
  }
  // S_k[:, j] = D'_k[:, j] − U'_kᵀ A_k[:, j]
  float c[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = 0.f;
#pragma unroll
    for (int m = 0; m < 6; ++m) t = fmaf(Un[m * 6 + i], acol[m], t);
    c[i] = Dn[i * 6 + j] - t;
  }
  if (lane < 6) {
#pragma unroll
    for (int i = 0; i < 6; ++i) Sblk[i * 6 + j] = c[i];
  }
  __syncwarp();   // every lane is past its reads of Lprev too
  // symmetrised, damped by 1e-6·tr/6 + 1e-12 (the trace summed in row order)
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    c[i] = 0.5f * (Sblk[i * 6 + j] + Sblk[j * 6 + i]);
    tr += 0.5f * (Sblk[i * 7] + Sblk[i * 7]);
  }
  const float eps = 1e-6f * tr / 6.0f + 1e-12f;
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = i == j ? c[i] + eps : c[i];
  __syncwarp();   // Sblk is free again
  if (kColumns) {
    // at step p lane p makes column p of L (reciprocal diagonal) and
    // broadcasts it; lanes j > p update their column's rows ≥ j
    float lcol[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      // lane p's pivot; the others take a harmless 1 (their entry may be < 0)
      const float inv = 1.f / sqrtf(j == p ? c[p] : 1.f);
      float b[6], bj = 0.f;
#pragma unroll
      for (int i = p + 1; i < 6; ++i) {
        b[i] = __shfl_sync(0xffffffffu, c[i] * inv, p);
        bj = i == j ? b[i] : bj;
      }
#pragma unroll
      for (int i = p; i < 6; ++i) lcol[i] = j == p ? (i == p ? inv : c[i] * inv) : lcol[i];
#pragma unroll
      for (int i = p + 1; i < 6; ++i) {
        const float u = c[i] - b[i] * bj;
        c[i] = (j > p && i >= j) ? u : c[i];
      }
    }
    if (lane < 6) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Lprev[i * 6 + j] = lcol[i];
        chol_k[i * 6 + j] = lcol[i];
      }
    }
  } else {
    if (lane < 6) {
#pragma unroll
      for (int i = 0; i < 6; ++i) Sblk[i * 6 + j] = c[i];
    }
    __syncwarp();
    if (lane == 0) {
      float S[36], L[36];
#pragma unroll
      for (int e = 0; e < 36; ++e) S[e] = Sblk[e];
      chol6(S, L);
#pragma unroll
      for (int e = 0; e < 36; ++e) {
        Lprev[e] = L[e];
        chol_k[e] = L[e];
      }
    }
  }
  __syncwarp();   // Lprev holds L_k
}

// A 6×6 block (16-byte aligned) into registers by nine float4 loads.
__device__ inline void load36(const float* src, float (&m)[36]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float4 f = reinterpret_cast<const float4*>(src)[c];
    m[4 * c] = f.x;
    m[4 * c + 1] = f.y;
    m[4 * c + 2] = f.z;
    m[4 * c + 3] = f.w;
  }
}

// One link of a segment lane's substitution: y ← v − A_kᵀ y (forward) or
// y ← v − A_{k+1} y (backward), Ak the link's block, v the link's input.
template <bool kBackward>
__device__ inline void sweep_link(const float* Ak, const float* v, float (&y)[6]) {
  float n[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float a = v[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) a = fmaf(-(kBackward ? Ak[i * 6 + j] : Ak[j * 6 + i]), y[j], a);
    n[i] = a;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = n[i];
}

// Where a launch keeps what, once the live prefix is known (shared memory or
// scratch), and the segmented sweeps' cut.
struct Layout {
  int n_seq, n_act, n_loop;
  bool seg;            // segmented substitutions
  int lseg, nseg;      // links a segment, segments
  float* w;            // [n_act,6] the swept vector (shared)
  const float* A;      // A for the sequential sweeps (shared or scratch)
  float *aring, *P, *yend, *yin;   // segmented: rings, transfer products, boundaries
  float *r, *z, *p, *y, *xv, *ec, *d, *chol, *lc;
  int *head, *next;    // loop lists: first entry of a keyframe, next entry
};

// Sequential substitution in warp 0, six lanes a block row; link k+1's
// operands are loaded during link k.
template <bool kBackward>
__device__ void seq_sweep(const Layout& s) {
  const int tid = threadIdx.x;
  const int n_seq = s.n_seq;
  float* w = s.w;
  if (tid >= 32 || n_seq < 2) return;
  const int c = tid < 6 ? tid : 0;
  // forward walks k = 1 .. n_seq-1 with A_k (column c), backward k = n_seq-2
  // .. 0 with A_{k+1} (row c)
  auto a_at = [&](int k, int j) {
    return kBackward ? s.A[36 * (k + 1) + c * 6 + j] : s.A[36 * k + j * 6 + c];
  };
  const int first = kBackward ? n_seq - 2 : 1, step = kBackward ? -1 : 1;
  const int end = kBackward ? -1 : n_seq;
  float prev[6], Acur[6], Anext[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    prev[j] = w[6 * (first - step) + j];
    Acur[j] = a_at(first, j);
  }
  float vcur = w[6 * first + c], vnext = 0.f;
  for (int k = first; k != end; k += step) {
    if (k + step != end) {
#pragma unroll
      for (int j = 0; j < 6; ++j) Anext[j] = a_at(k + step, j);
      vnext = w[6 * (k + step) + c];
    }
    float a = vcur;
#pragma unroll
    for (int j = 0; j < 6; ++j) a = fmaf(-Acur[j], prev[j], a);
#pragma unroll
    for (int j = 0; j < 6; ++j) prev[j] = __shfl_sync(0xffffffffu, a, j);
    if (tid < 6) w[6 * k + c] = a;
#pragma unroll
    for (int j = 0; j < 6; ++j) Acur[j] = Anext[j];
    vcur = vnext;
  }
}

// The passes of a segmented substitution. Lane t < nseg works on segment t
// in the sweep's direction, its A blocks streamed from scratch through its
// own cp.async ring. kFromZero: from 0 with the input w, the segment's last
// value to yend. kFinal: from yin[t], every value to w. kTransfer: with no
// input, from each unit vector e_c in turn, the segment's transfer product
// column by column, to P.
enum Pass { kFromZero, kFinal, kTransfer };

template <bool kBackward, int kPass>
__device__ void seg_pass(const Layout& s, const float* A) {
  const int t = threadIdx.x;
  if (t >= s.nseg) return;
  const int lo = t * s.lseg, hi = min(lo + s.lseg, s.n_seq);
  const int len = hi - lo;
  float* ring = s.aring + t * kRingStride;
  // link q of the pass is keyframe k = lo + q (forward) or hi - 1 - q
  // (backward), its block A_k or A_{k+1}
  auto block = [&](int q) { return A + 36 * (kBackward ? hi - q : lo + q); };
  constexpr int kRuns = kPass == kTransfer ? 6 : 1;
  for (int run = 0; run < kRuns; ++run) {
#pragma unroll
    for (int q = 0; q < kSweepRing; ++q) {
      if (q < len) {
#pragma unroll
        for (int c = 0; c < 9; ++c)
          __pipeline_memcpy_async(ring + 36 * q + 4 * c, block(q) + 4 * c, 16);
      }
      __pipeline_commit();
    }
    float y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      y[i] = kPass == kFinal ? s.yin[6 * t + i] : (kPass == kTransfer && i == run ? 1.f : 0.f);
    for (int q = 0; q < len; ++q) {
      __pipeline_wait_prior(kSweepRing - 1);
      const int k = kBackward ? hi - 1 - q : lo + q;
      float* slot = ring + 36 * (q % kSweepRing);
      float Ak[36], v[6];
      load36(slot, Ak);
#pragma unroll
      for (int i = 0; i < 6; ++i) v[i] = kPass == kTransfer ? 0.f : s.w[6 * k + i];
      sweep_link<kBackward>(Ak, v, y);
      if (kPass == kFinal) {
#pragma unroll
        for (int i = 0; i < 6; ++i) s.w[6 * k + i] = y[i];
      }
      if (q + kSweepRing < len) {
#pragma unroll
        for (int c = 0; c < 9; ++c)
          __pipeline_memcpy_async(slot + 4 * c, block(q + kSweepRing) + 4 * c, 16);
      }
      __pipeline_commit();
    }
    if (kPass == kFromZero) {
#pragma unroll
      for (int i = 0; i < 6; ++i) s.yend[6 * t + i] = y[i];
    }
    if (kPass == kTransfer) {
      float* P = s.P + 36 * ((kBackward ? s.nseg : 0) + t);
#pragma unroll
      for (int i = 0; i < 6; ++i) P[i * 6 + run] = y[i];
    }
  }
}

// Segmented substitution: every segment from zero, the boundaries in order by
// one lane (each segment's incoming value from the one before through its
// transfer product), every segment again from its incoming value.
template <bool kBackward>
__device__ void seg_sweep(const Layout& s, const float* A) {
  seg_pass<kBackward, kFromZero>(s, A);
  __syncthreads();
  if (threadIdx.x == 0) {
    float y[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < s.nseg; ++q) {
      const int t = kBackward ? s.nseg - 1 - q : q;
      float P[36], n[6];
      load36(s.P + 36 * ((kBackward ? s.nseg : 0) + t), P);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        s.yin[6 * t + i] = y[i];
        float a = s.yend[6 * t + i];
#pragma unroll
        for (int j = 0; j < 6; ++j) a = fmaf(P[i * 6 + j], y[j], a);
        n[i] = a;
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) y[i] = n[i];
    }
  }
  __syncthreads();
  seg_pass<kBackward, kFinal>(s, A);
}

// The segments' transfer products, once a launch: P_t = M_{hi-1} ⋯ M_lo with
// M_k = −A_kᵀ (forward), and M_lo ⋯ M_{hi-1} with M_k = −A_{k+1}
// (backward), column by column through the segment lanes' rings.
__device__ void transfer_products(const Layout& s, const float* A) {
  seg_pass<false, kTransfer>(s, A);
  seg_pass<true, kTransfer>(s, A);
}

// The preconditioner M⁻¹ v → out. The chain's (kJacobi false; M = the scaled
// chain factor): scaling in, forward chain, the blocks' Cholesky solves,
// backward chain, scaling out; the chains in w. Block-Jacobi (kJacobi): each
// keyframe's own block solve, in parallel.
template <bool kJacobi>
__device__ void precond(const Layout& s, const float* Ag, const float* v, float* out) {
  const int tid = threadIdx.x;
  if constexpr (kJacobi) {
    for (int k = tid; k < s.n_act; k += kThreads) {
      float w[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) w[a] = v[6 * k + a];
      chol_solve6(s.chol + 36 * k, w);
#pragma unroll
      for (int a = 0; a < 6; ++a) out[6 * k + a] = w[a];
    }
    __syncthreads();
    TICK(kTBlockSolve);
    return;
  }
  for (int i = tid; i < 6 * s.n_act; i += kThreads) s.w[i] = v[i] / s.d[i];
  __syncthreads();
  TICK(kTPrecIn);
  if (s.seg) {
    seg_sweep<false>(s, Ag);
  } else {
    seq_sweep<false>(s);
  }
  __syncthreads();
  TICK(kTForward);
  for (int k = tid; k < s.n_act; k += kThreads) {
    float w[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) w[a] = s.w[6 * k + a];
    chol_solve6(s.chol + 36 * k, w);
#pragma unroll
    for (int a = 0; a < 6; ++a) s.w[6 * k + a] = w[a];
  }
  __syncthreads();
  TICK(kTBlockSolve);
  if (s.seg) {
    seg_sweep<true>(s, Ag);
  } else {
    seq_sweep<true>(s);
  }
  __syncthreads();
  TICK(kTBackward);
  for (int i = tid; i < 6 * s.n_act; i += kThreads) out[i] = s.w[i] / s.d[i];
  __syncthreads();
  TICK(kTPrecOut);
}

// y = H v (node 0 fixed: v and y masked there).
__device__ void hvp(const Args& a, const Layout& s, const float* v, float* y) {
  const int tid = threadIdx.x;
  const int n_act = s.n_act;
  // chain factors, edge e couples e-1 and e: its residual direction
  // wv = W (Ji v_{e-1} + Jj v_e), then both nodes' shares Jiᵀ wv and Jjᵀ wv,
  // each Jacobian read once
  for (int e = 1 + tid; e < n_act; e += kThreads) {
    const float* vi = v + 6 * (e - 1);
    const float* vj = v + 6 * e;
    const float w = a.wp[e];
    const bool first = e == 1;
    float Ji[36], Jj[36], t[6];
    load36(a.Ji + 36 * e, Ji);
    load36(a.Jj + 36 * e, Jj);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      t[r] = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) t[r] = fmaf(Ji[r * 6 + b], first ? 0.f : vi[b], t[r]);
#pragma unroll
      for (int b = 0; b < 6; ++b) t[r] = fmaf(Jj[r * 6 + b], vj[b], t[r]);
      t[r] = t[r] * a.oinfo[r] * w;
    }
    float* up = s.ec + 12 * e;   // to node e-1
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float u = 0.f, dn = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        u = fmaf(Ji[r * 6 + c], t[r], u);
        dn = fmaf(Jj[r * 6 + c], t[r], dn);
      }
      up[c] = u;
      up[6 + c] = dn;
    }
  }
  // loop factors: both nodes' contributions
  for (int l = tid; l < s.n_loop; l += kThreads) {
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
  // per keyframe: its two chain edges, its altitude factor, then its loop
  // slots in loop order (the order the first version's serial sum had)
  for (int n = tid; n < n_act; n += kThreads) {
    float out[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c] = 0.f;
    if (n + 1 < n_act) {
#pragma unroll
      for (int c = 0; c < 6; ++c) out[c] = s.ec[12 * (n + 1) + c];
    }
    if (n >= 1) {
#pragma unroll
      for (int c = 0; c < 6; ++c) out[c] += s.ec[12 * n + 6 + c];
      const float* A = a.gA + 3 * n;
      const float sdot = A[0] * v[6 * n] + A[1] * v[6 * n + 1] + A[2] * v[6 * n + 2];
      const float gs = a.gz[n] * sdot;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] += gs * A[c];
      for (int e = s.head[n]; e >= 0; e = s.next[e]) {
        const float* lc = s.lc + 6 * e;   // 12·l + 6·side
#pragma unroll
        for (int c = 0; c < 6; ++c) out[c] += lc[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) y[6 * n + c] = n == 0 ? 0.f : out[c];
  }
  __syncthreads();
  TICK(kTHvp);
}

// kJacobi: the block-Jacobi preconditioner (each keyframe's 6×6 block
// factored on its own, in parallel; no chain, no sweeps) in place of the
// chain's.
template <bool kJacobi>
__global__ void __launch_bounds__(kThreads) pgo_cg_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kLanes / 32 + 1];
  __shared__ int ired[kWarps + 1];
  __shared__ __align__(16) float Lprev[36], Sblk[36], fring[kFactorRing * 72];
  const int tid = threadIdx.x;
  const int K = a.K;
  const Scratch g = carve_scratch(a.scr, K);
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
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float4 f = reinterpret_cast<const float4*>(a.U + 36 * k)[c];
      nz |= (f.x != 0.f) | (f.y != 0.f) | (f.z != 0.f) | (f.w != 0.f);
    }
    if (nz) last_u = k;
  }
  for (int k = tid; k < K; k += kThreads)
    if (a.kf[k]) last_kf = k;
  int last_l = -1;
  for (int l = tid; l < a.L; l += kThreads)
    if (a.wl[l] != 0.f) last_l = l;
  Layout s;
  s.n_seq = block_max_int(last_u, ired) + 1;
  s.n_act = max(s.n_seq, block_max_int(last_kf, ired) + 1);
  s.n_loop = block_max_int(last_l, ired) + 1;
  const int n_seq = s.n_seq, n_act = s.n_act, n_loop = s.n_loop;
  TICK(kTPrefix);

  // where things live
  Carve c{smem, 0, a.smem_floats};
  s.w = c.take(6 * n_act);
  s.head = reinterpret_cast<int*>(c.take(n_act));
  s.next = reinterpret_cast<int*>(c.take(2 * n_loop));
  s.lc = c.take(12 * n_loop);
  s.seg = !kJacobi && n_seq >= a.seg_min;
  s.lseg = segment_links(n_seq);
  s.nseg = (n_seq + s.lseg - 1) / s.lseg;
  s.A = g.A;
  float* As = nullptr;   // A in shared memory as well, for the sequential sweeps
  if (s.seg) {
    s.aring = c.take(s.nseg * kRingStride);
    s.P = c.take(2 * s.nseg * 36);
    s.yend = c.take(6 * s.nseg);
    s.yin = c.take(6 * s.nseg);
  } else if (!kJacobi && c.fits(36 * n_seq)) {
    As = c.take(36 * n_seq);
    s.A = As;
  }
  s.r = c.take_or(6 * n_act, g.r);
  s.z = c.take_or(6 * n_act, g.z);
  s.p = c.take_or(6 * n_act, g.p);
  s.y = c.take_or(6 * n_act, g.y);
  s.xv = c.take_or(6 * n_act, g.xv);
  s.ec = c.take_or(12 * n_act, g.ec);
  s.d = c.take_or(6 * n_act, g.d);
  s.chol = c.take_or(36 * n_act, g.chol);

  if constexpr (kJacobi) {
    for (int n = tid; n < n_act; n += kThreads) s.head[n] = -1;
    // each live block's Cholesky factor (the blocks carry node 0 = I and the
    // 1e-6·I damping already), a thread a keyframe
    for (int k = tid; k < n_act; k += kThreads) {
      float S[36];
      for (int e = 0; e < 36; ++e) S[e] = a.D[36 * k + e];
      chol6(S, s.chol + 36 * k);
    }
    __syncthreads();
    TICK(kTScale);
  } else {
    // Jacobi scaling
    for (int i = tid; i < 6 * n_act; i += kThreads) {
      const int k = i / 6, cc = i % 6;
      s.d[i] = sqrtf(fabsf(a.D[36 * k + 7 * cc]) + 1e-12f);
    }
    for (int n = tid; n < n_act; n += kThreads) s.head[n] = -1;
    __syncthreads();
    // the decoupled blocks (k = 0 and k ≥ n_seq), A's zero blocks, and the
    // chain's scaled operands U'_k, D'_k (k in [1, n_seq))
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
      for (int e = 0; e < 36; ++e) g.A[36 * k + e] = 0.f;
    }
    if (tid < 36) {
      g.A[36 * n_seq + tid] = 0.f;
      if (As) As[tid] = 0.f;
    }
    for (int u = tid; u < 36 * (n_seq - 1); u += kThreads) {
      const int k = 1 + u / 36, e = u % 36, i = e / 6, j = e % 6;
      g.UD[72 * k + e] = a.U[36 * k + e] / (s.d[6 * (k - 1) + i] * s.d[6 * k + j]);
      g.UD[72 * k + 36 + e] = a.D[36 * k + e] / (s.d[6 * k + i] * s.d[6 * k + j]);
    }
    __syncthreads();
    TICK(kTScale);

  }
  if (tid < 32) {
    if constexpr (!kJacobi) {
      // the Thomas recursion along the coupled prefix in warp 0, lane j < 6 a
      // column; lanes 0-17 copy link k+kFactorRing's 72 operands, 16 bytes each,
      // while link k runs
      const int lane = tid;
      const int j = lane < 6 ? lane : 0;
      if (lane < 6) {
        for (int i = 0; i < 6; ++i) Lprev[i * 6 + lane] = s.chol[i * 6 + lane];
      }
#pragma unroll
      for (int q = 0; q < kFactorRing; ++q) {
        const int k = 1 + q;
        if (k < n_seq && lane < 18)
          __pipeline_memcpy_async(fring + 72 * (k % kFactorRing) + 4 * lane,
                                  g.UD + 72 * k + 4 * lane, 16);
        __pipeline_commit();
      }
      for (int k = 1; k < n_seq; ++k) {
        __pipeline_wait_prior(kFactorRing - 1);
        __syncwarp();
        float* slot = fring + 72 * (k % kFactorRing);
        float acol[6];
        factor_link<true>(slot, slot + 36, Lprev, Sblk, j, acol, s.chol + 36 * k);
        // every lane is past its reads of the slot
        const int kn = k + kFactorRing;
        if (kn < n_seq && lane < 18)
          __pipeline_memcpy_async(slot + 4 * lane, g.UD + 72 * kn + 4 * lane, 16);
        __pipeline_commit();
        if (lane < 6) {
#pragma unroll
          for (int i = 0; i < 6; ++i) g.A[36 * k + i * 6 + j] = acol[i];
          if (As) {
#pragma unroll
            for (int i = 0; i < 6; ++i) As[36 * k + i * 6 + j] = acol[i];
          }
        }
      }
    }
  } else if (tid == 32) {
    // meanwhile, each keyframe's list of loop slots (entry 2·l + side), in
    // loop order
    for (int e = 2 * n_loop - 1; e >= 0; --e) {
      const long long node = (e & 1) ? a.lj[e >> 1] : a.li[e >> 1];
      if (node > 0 && node < n_act) {
        s.next[e] = s.head[node];
        s.head[node] = e;
      }
    }
  }
  __syncthreads();
  TICK(kTFactor);
  if (s.seg) {
    transfer_products(s, g.A);
    __syncthreads();
  }
  TICK(kTTransfer);

  // PCG with the relative stop on the preconditioned norm
  for (int i = tid; i < 6 * n_act; i += kThreads) {
    s.r[i] = -a.g[i];
    s.xv[i] = 0.f;
  }
  __syncthreads();
  TICK(kTInit);
  precond<kJacobi>(s, g.A, s.r, s.z);
  for (int i = tid; i < 6 * n_act; i += kThreads) s.p[i] = s.z[i];
  const float rz0 = block_dot(s.r, s.z, 6 * n_act, red);
  TICK(kTReduce);
  float rz = rz0;
  int it = 0;
  while (rz > a.cg_tol * rz0 && it < a.cg_iterations) {
    hvp(a, s, s.p, s.y);
    const float alpha = rz / fmaxf(block_dot(s.p, s.y, 6 * n_act, red), 1e-20f);
    TICK(kTReduce);
    for (int i = tid; i < 6 * n_act; i += kThreads) {
      s.xv[i] = fmaf(alpha, s.p[i], s.xv[i]);
      s.r[i] = fmaf(-alpha, s.y[i], s.r[i]);
    }
    __syncthreads();
    TICK(kTUpdate);
    precond<kJacobi>(s, g.A, s.r, s.z);
    const float rz_new = block_dot(s.r, s.z, 6 * n_act, red);
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

// What a solve waits for, each timed alone (chip_smoke.py's floor lines):
// mode 0 an empty launch; 1 `reps` block barriers; 2 `reps` dependent links
// of the sequential substitution (six lanes, a 6-term dot product and six
// shuffles each, on registers); 3 `reps` dependent links of the first
// version's factor recursion (a 6×6 triangular solve pair, the Schur update
// and a damped Cholesky in one thread, on registers); 4 `reps` links of
// factor_link with the column-parallel Cholesky, 6 with lane 0's (operands
// in shared memory); 5 `reps` links of a segment lane (sweep_link, its block
// in shared memory). `out` keeps the result live.
__global__ void pgo_probe_kernel(int mode, int reps, float* out) {
  __shared__ __align__(16) float Un[36], Dn[36], Lp[36], Sb[36], Ck[36];
  if (mode == 1) {
    for (int r = 0; r < reps; ++r) __syncthreads();
    if (threadIdx.x == 0) out[0] = 1.f;
    return;
  }
  if (threadIdx.x >= 32) return;
  const int c = threadIdx.x;
  if (mode == 2) {
    float prev[6], Ac[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      prev[j] = 0.1f * j;
      Ac[j] = 0.01f * (c + j);
    }
    float a = 0.f;
    for (int r = 0; r < reps; ++r) {
      a = 1.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) a = fmaf(-Ac[j], prev[j], a);
#pragma unroll
      for (int j = 0; j < 6; ++j) prev[j] = __shfl_sync(0xffffffffu, a, j);
    }
    if (c == 0) out[0] = a;
    return;
  }
  if (mode == 3 && c == 0) {
    float L[36], S[36], u[6];
    for (int e = 0; e < 36; ++e) L[e] = (e % 7 == 0) ? 2.f : 0.f;
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int i = 0; i < 6; ++i) u[i] = 0.1f * i + L[7 * i] * 1e-3f;
      chol_solve6(L, u);
#pragma unroll
      for (int e = 0; e < 36; ++e) S[e] = (e % 7 == 0 ? 4.f : 0.f) - 1e-3f * u[e % 6];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j) S[i * 6 + j] = S[j * 6 + i];
      damp_chol6(S, L);
    }
    out[0] = L[35];
    return;
  }
  if (mode == 4 || mode == 6) {
    for (int e = c; e < 36; e += 32) {
      Un[e] = (e % 7 == 0) ? 0.5f : 0.01f * (e % 5);
      Dn[e] = (e % 7 == 0) ? 4.f : 0.f;
      Lp[e] = (e % 7 == 0) ? 0.5f : 0.f;
    }
    __syncwarp();
    const int j = c < 6 ? c : 0;
    float acol[6];
    for (int r = 0; r < reps; ++r) {
      if (mode == 4) {
        factor_link<true>(Un, Dn, Lp, Sb, j, acol, Ck);
      } else {
        factor_link<false>(Un, Dn, Lp, Sb, j, acol, Ck);
      }
    }
    if (c == 0) out[0] = Lp[35] + acol[5];
    return;
  }
  if (mode == 5) {
    for (int e = c; e < 36; e += 32) Un[e] = 0.01f * (e % 5);
    __syncwarp();
    float y[6] = {1.f, 0.f, 0.f, 0.f, 0.f, 0.f}, v[6] = {0.1f, 0.2f, 0.3f, 0.4f, 0.5f, 0.6f};
    for (int r = 0; r < reps; ++r) sweep_link<false>(Un, v, y);
    if (c == 0) out[0] = y[0];
  }
}

}  // namespace

#ifdef PGO_TICKS
// The phases' cycle sums of the last launch (kTicks of them), into `host`.
extern "C" int pgo_ticks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ticks, sizeof(long long) * kTicks));
}
#endif

// One launch of the probe kernel: `threads` threads in one block.
extern "C" int pgo_probe_launch(int mode, int reps, int threads, float* out, void* stream) {
  pgo_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(mode, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// Scratch floats the launch needs for K keyframes and L loop slots.
extern "C" long long pgo_scratch_floats(int K, int L) {
  return static_cast<long long>(scratch_floats(K, L));
}

// The threads of the one block and the slots it takes, for the wrapper to
// check its own copy against.
extern "C" int pgo_threads() { return kThreads; }
extern "C" int pgo_max_keyframes() { return kMaxK; }
extern "C" int pgo_max_loops() { return kMaxL; }

// The segmented sweeps' cut for n_seq coupled keyframes, as the kernel makes
// it: links a segment, and 0 where the sweeps stay sequential.
extern "C" int pgo_segment_links(int n_seq) {
  return n_seq < kSegmentedMin ? 0 : segment_links(n_seq);
}

// One launch with the substitutions segmented from `seg_min` coupled
// keyframes on (the kernel's own choice is kSegmentedMin); pgo_cg_launch
// passes kSegmentedMin. `jacobi` picks the block-Jacobi preconditioner (the
// sweeps then never run). Every pointer is a contiguous device array (see
// Args); returns the CUDA error of the launch (0 on success).
extern "C" int pgo_cg_launch_sweep(const float* D, const float* U, const float* g,
                                   const float* Ji, const float* Jj, const float* oinfo,
                                   const float* wp, const float* Jli, const float* Jlj,
                                   const long long* li, const long long* lj,
                                   const float* wl, const float* gA, const float* gz,
                                   const unsigned char* kf, const unsigned char* run,
                                   int K, int L, float cg_tol, int cg_iterations,
                                   float* x, int* iters, float* scratch, void* stream,
                                   int seg_min, int jacobi) {
  if (K < 2 || K > kMaxK || L < 0 || L > kMaxL || cg_iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(K, L);
  void (*kernel)(Args) = jacobi ? pgo_cg_kernel<true> : pgo_cg_kernel<false>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a{D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf, run,
         K, L, cg_iterations, cg_tol, seg_min, bytes / 4, x, iters, scratch};
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch: the factor and the whole PCG loop of one Gauss-Newton iteration,
// with the chain's preconditioner (`jacobi` 0) or the block-Jacobi one (1).
extern "C" int pgo_cg_launch(const float* D, const float* U, const float* g,
                             const float* Ji, const float* Jj, const float* oinfo,
                             const float* wp, const float* Jli, const float* Jlj,
                             const long long* li, const long long* lj,
                             const float* wl, const float* gA, const float* gz,
                             const unsigned char* kf, const unsigned char* run,
                             int K, int L, float cg_tol, int cg_iterations,
                             float* x, int* iters, float* scratch, void* stream,
                             int jacobi) {
  return pgo_cg_launch_sweep(D, U, g, Ji, Jj, oinfo, wp, Jli, Jlj, li, lj, wl, gA, gz, kf,
                             run, K, L, cg_tol, cg_iterations, x, iters, scratch, stream,
                             kSegmentedMin, jacobi);
}
