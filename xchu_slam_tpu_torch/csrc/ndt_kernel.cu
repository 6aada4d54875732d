// NDT scan-to-map alignment in one persistent kernel: the Newton loop, its
// backtracking line search and every score / gradient / Hessian pass over the
// point × voxel pairs, with both trip counts decided on the card.
//
// The reference has no TPU kernel for this work: it leaves
// xchu_slam_tpu/ops/ndt.py::newton_align (two `lax.while_loop`s) around
// ops/ndt_deriv.py::ndt_value_grad_hess and ops/voxel_map.py::lookup_neighbors
// to XLA. The plain PyTorch version is the host route of
// xchu_slam_tpu_torch/ops/ndt.py::align, whose Python loops read every pass
// back to decide whether to go on.
//
// What bounds it on an H100. One pass is N = 8192 source points against the 7
// DIRECT7 voxels of each: 57,344 pairs, a gather of at most 2.3 MB from a
// 6.1 MB [V,10] table that stays in the 50 MB L2, and ~10 MFLOP. Bytes
// (0.7 µs at 3.35 TB/s) and operations (0.2 µs at 67 TFLOP/s) bound a pass
// below a microsecond; an align is 2-3 Newton iterations of 2-3 passes, each
// a dependent step, so the bound is latency: one launch, and per pass one
// grid-wide barrier, the L2 round trips of the gather and the serial 6×6
// control arithmetic of one thread.
//
// Design.
// - One cooperative launch per align (`cudaLaunchCooperativeKernel`; every
//   block resident, 64 blocks of 128 threads for 8192 points on 132 SMs).
//   The loops live inside the kernel; `grid.sync()` separates a pass's
//   per-block partial sums from the control step that reads them. Work that
//   the loop predicates rule out is never issued.
// - A pass. Thread i owns source points i, i + grid, ...: it transforms the
//   point by the trial pose (R = Rz·Ry·Rx), finds its voxel from the pose the
//   iteration started at (the neighbourhood is fixed for the iteration's
//   line-search trials, as in the reference; the voxel index is recomputed
//   from that pose rather than stored, so a pass keeps no state), reads the
//   centre voxel and its 6 face neighbours with a bounds check each, and
//   accumulates L, Σc·a6 and, on the Hessian pass, the upper triangle of H in
//   registers: 28 floats. The terms of H that depend on the point alone
//   (J = [I | dR·q], the second-order angle term) are applied once per point
//   to Σc·B and Σc·Bδ, not once per pair.
// - Sums in a fixed order, no atomics: a shuffle tree inside each warp, the
//   warps of a block in order, one 28-float partial per block in a scratch
//   array (two buffers, by pass parity, so that a fast block cannot overwrite
//   what a slow one still reads), and after the barrier every block sums all
//   partials in block order. Reruns are bit-identical.
// - Control. After the barrier every block holds the same 28 sums, and its
//   thread 0 runs the same control arithmetic on them: the Jacobi-scaled,
//   Gershgorin-shifted 6×6 Cholesky solve, the Armijo + curvature backtrack
//   with its quadratic interpolation, expansion and `stuck` exit, the pose
//   update and the convergence test. All blocks reach the same decision from
//   the same bits, so no second barrier broadcasts it. The file is compiled
//   with -fmad=false: the thresholds are compared in fp32 as the plain
//   version compares them, without fused multiply-adds.
// - Outputs stay on the card: pose, iterations, converged, φ at the accepted
//   pose, matched fraction and fitness on the last neighbourhood, and the
//   last Hessian pass's (L, g, H). `mode` 1 stops after one Hessian pass at
//   the initial pose (the smoke run compares that pass with the plain one).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;   // L, g[6], H upper triangle [21]
constexpr int kOut = 64;   // floats of the result record

// slots of the result record
constexpr int kOutIters = 6, kOutConverged = 7, kOutPhi = 8, kOutFrac = 9,
              kOutFitness = 10, kOutTrials = 11, kOutL = 12, kOutG = 13,
              kOutH = 19;

struct NdtParams {
  const float* src;            // [n,3]
  const unsigned char* mask;   // [n]
  const float* fin;            // [gx*gy*gz,10]: mean 3, icov upper 6, valid
  const float* origin;         // [3]
  const float* init_pose;      // [6]
  float* out;                  // [kOut]
  float* partial;              // [2][blocks][kAcc]
  int n, gx, gy, gz;
  float res, d1, s, two_s, four_s2, step_size, trans_eps;
  int max_iter, ls_max, mode;
};

// The ten matrices Z·Y·X a pass needs: R, dR/d(r,p,y), d²R/d(rr,rp,ry,pp,py,yy).
// Each axis factor keeps its pattern under differentiation with (c, s, one)
// replaced by (−s, c, 0) and then (−c, −s, 0).
__device__ void rot_product(const float* rpy, int which, float* m) {
  float sr, cr, sp, cp, sy, cy;
  sincosf(rpy[0], &sr, &cr);
  sincosf(rpy[1], &sp, &cp);
  sincosf(rpy[2], &sy, &cy);
  // derivative order per axis for matrix `which`
  // 0: R; 1: r; 2: p; 3: y; 4: rr; 5: rp; 6: ry; 7: pp; 8: py; 9: yy
  const int ox_[10] = {0, 1, 0, 0, 2, 1, 1, 0, 0, 0};
  const int oy_[10] = {0, 0, 1, 0, 0, 1, 0, 2, 1, 0};
  const int oz_[10] = {0, 0, 0, 1, 0, 0, 1, 0, 1, 2};
  float cx = cr, sx = sr, onex = 1.0f;
  if (ox_[which] == 1) { cx = -sr; sx = cr; onex = 0.0f; }
  if (ox_[which] == 2) { cx = -cr; sx = -sr; onex = 0.0f; }
  float cyy = cp, syy = sp, oney = 1.0f;
  if (oy_[which] == 1) { cyy = -sp; syy = cp; oney = 0.0f; }
  if (oy_[which] == 2) { cyy = -cp; syy = -sp; oney = 0.0f; }
  float cz = cy, sz = sy, onez = 1.0f;
  if (oz_[which] == 1) { cz = -sy; sz = cy; onez = 0.0f; }
  if (oz_[which] == 2) { cz = -cy; sz = -sy; onez = 0.0f; }
  // ZY = Z·Y, then (ZY)·X
  const float zy00 = cz * cyy, zy01 = -sz * oney, zy02 = cz * syy;
  const float zy10 = sz * cyy, zy11 = cz * oney, zy12 = sz * syy;
  const float zy20 = -onez * syy, zy22 = onez * cyy;
  m[0] = zy00 * onex; m[1] = zy01 * cx + zy02 * sx; m[2] = zy02 * cx - zy01 * sx;
  m[3] = zy10 * onex; m[4] = zy11 * cx + zy12 * sx; m[5] = zy12 * cx - zy11 * sx;
  m[6] = zy20 * onex; m[7] = zy22 * sx;             m[8] = zy22 * cx;
}

__device__ __forceinline__ int upper_index(int i, int j) {
  // position of (i, j), i <= j, in the row-major upper triangle of a 6×6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

struct Shared {
  float rot[10][9];     // products at the trial pose
  float rot_ctx[9];     // R at the pose the iteration started at
  float eval[6];        // the pose of this pass
  float ctx[6];         // the pose the neighbourhood belongs to
  float warp_part[kWarps][kAcc];
  float tot[kAcc];
  // loop decisions of thread 0, read by the block; one variable per decision,
  // so that the next decision is never written while a warp still reads this one
  int stop_after_pass, ls_done, more;
};

// One pass over the block's points: per-thread accumulators, block partial,
// grid barrier, fixed-order total in sh.tot. kind 0: L, g, H; 1: L, g;
// 2: fitness (matched count, Σ min d², mask count).
template <int kind>
__device__ void pass(const NdtParams& p, Shared& sh, int& buf,
                     cg::grid_group& grid) {
  const int tid = threadIdx.x;
  const int n_rot = (kind == 0) ? 10 : (kind == 1 ? 4 : 1);
  if (tid < n_rot) rot_product(sh.eval + 3, tid, sh.rot[tid]);
  if (tid == 32) rot_product(sh.ctx + 3, 0, sh.rot_ctx);
  __syncthreads();

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

  const float o0 = p.origin[0], o1 = p.origin[1], o2 = p.origin[2];
  const float* R = sh.rot[0];
  const float* Rc = sh.rot_ctx;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + tid; i < p.n; i += stride) {
    if (!p.mask[i]) continue;
    const float q0 = p.src[3 * i], q1 = p.src[3 * i + 1], q2 = p.src[3 * i + 2];
    if (kind == 2) acc[2] += 1.0f;
    // the point under the trial pose, and its voxel under the iteration's pose
    float pt[3], pc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pt[a] = q0 * R[3 * a] + q1 * R[3 * a + 1] + q2 * R[3 * a + 2] + sh.eval[a];
      pc[a] = q0 * Rc[3 * a] + q1 * Rc[3 * a + 1] + q2 * Rc[3 * a + 2] + sh.ctx[a];
    }
    const int ix = (int)floorf((pc[0] - o0) / p.res);
    const int iy = (int)floorf((pc[1] - o1) / p.res);
    const int iz = (int)floorf((pc[2] - o2) / p.res);

    float D[3][3];      // D[a][k] = (dR_k · q)_a
    float E[3][6];      // E[a][m] = (d²R_m · q)_a
    if (kind <= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* M = sh.rot[1 + k];
          D[a][k] = M[3 * a] * q0 + M[3 * a + 1] * q1 + M[3 * a + 2] * q2;
        }
    }
    if (kind == 0) {
#pragma unroll
      for (int m = 0; m < 6; ++m)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* M = sh.rot[4 + m];
          E[a][m] = M[3 * a] * q0 + M[3 * a + 1] * q1 + M[3 * a + 2] * q2;
        }
    }

    float A[21];        // Σ_v c·a6⊗a6 of this point, upper triangle
    float CB[6];        // Σ_v c·B
    float Cbd[3];       // Σ_v c·Bδ
    if (kind == 0) {
#pragma unroll
      for (int k = 0; k < 21; ++k) A[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) CB[k] = 0.0f;
      Cbd[0] = Cbd[1] = Cbd[2] = 0.0f;
    }
    float dmin = INFINITY;

#pragma unroll
    for (int v = 0; v < 7; ++v) {
      // DIRECT7 order: centre, +x, −x, +y, −y, +z, −z
      const int nx = ix + (v == 1) - (v == 2);
      const int ny = iy + (v == 3) - (v == 4);
      const int nz = iz + (v == 5) - (v == 6);
      if (nx < 0 || nx >= p.gx || ny < 0 || ny >= p.gy || nz < 0 || nz >= p.gz)
        continue;
      const long long flat = ((long long)nx * p.gy + ny) * p.gz + nz;
      const float2* row = reinterpret_cast<const float2*>(p.fin + 10 * flat);
      const float2 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2),
                   r3 = __ldg(row + 3), r4 = __ldg(row + 4);
      if (!(r4.y > 0.0f)) continue;
      const float d0 = pt[0] - ((o0 + (float)nx * p.res) + r0.x);
      const float d1_ = pt[1] - ((o1 + (float)ny * p.res) + r0.y);
      const float d2_ = pt[2] - ((o2 + (float)nz * p.res) + r1.x);
      if (kind == 2) {
        dmin = fminf(dmin, d0 * d0 + d1_ * d1_ + d2_ * d2_);
        continue;
      }
      const float xx = r1.y, xy = r2.x, xz = r2.y, yy = r3.x, yz = r3.y, zz = r4.x;
      float a6[6];
      a6[0] = xx * d0 + xy * d1_ + xz * d2_;
      a6[1] = xy * d0 + yy * d1_ + yz * d2_;
      a6[2] = xz * d0 + yz * d1_ + zz * d2_;
      const float x = d0 * a6[0] + d1_ * a6[1] + d2_ * a6[2];
      const float c = p.d1 * expf(p.s * fmaxf(x, 0.0f));
      acc[0] += c;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        a6[3 + k] = a6[0] * D[0][k] + a6[1] * D[1][k] + a6[2] * D[2][k];
      float ca[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        ca[k] = c * a6[k];
        acc[1 + k] += ca[k];
      }
      if (kind == 0) {
        int u = 0;
#pragma unroll
        for (int i2 = 0; i2 < 6; ++i2)
#pragma unroll
          for (int j2 = i2; j2 < 6; ++j2) A[u++] += ca[i2] * a6[j2];
        CB[0] += c * xx; CB[1] += c * xy; CB[2] += c * xz;
        CB[3] += c * yy; CB[4] += c * yz; CB[5] += c * zz;
        Cbd[0] += ca[0]; Cbd[1] += ca[1]; Cbd[2] += ca[2];
      }
    }

    if (kind == 2) {
      if (dmin < INFINITY) { acc[0] += 1.0f; acc[1] += dmin; }
      continue;
    }
    if (kind == 0) {
      // JᵀBJ with J = [I | D] on B = Σ_v c·B, and the second-order angle
      // term Bδ·(d²R·q) on Σ_v c·Bδ
      float J[21];
      const float B[3][3] = {{CB[0], CB[1], CB[2]}, {CB[1], CB[3], CB[4]},
                             {CB[2], CB[4], CB[5]}};
      float BD[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          BD[a][k] = B[a][0] * D[0][k] + B[a][1] * D[1][k] + B[a][2] * D[2][k];
#pragma unroll
      for (int i2 = 0; i2 < 3; ++i2)
#pragma unroll
        for (int j2 = i2; j2 < 3; ++j2) J[upper_index(i2, j2)] = B[i2][j2];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int k = 0; k < 3; ++k) J[upper_index(a, 3 + k)] = BD[a][k];
      const int pack[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = k; l < 3; ++l) {
          const float dbd = D[0][k] * BD[0][l] + D[1][k] * BD[1][l] + D[2][k] * BD[2][l];
          const int m = pack[k][l];
          const float bb = Cbd[0] * E[0][m] + Cbd[1] * E[1][m] + Cbd[2] * E[2][m];
          J[upper_index(3 + k, 3 + l)] = dbd + bb;
        }
#pragma unroll
      for (int k = 0; k < 21; ++k) acc[7 + k] += p.four_s2 * A[k] + p.two_s * J[k];
    }
  }

  // block partial: shuffle tree per warp, then the warps in order
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    acc[k] = v;
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) sh.warp_part[tid >> 5][k] = acc[k];
  }
  __syncthreads();
  float* part = p.partial + (size_t)buf * gridDim.x * kAcc;
  if (tid < kAcc) {
    float v = sh.warp_part[0][tid];
    for (int w = 1; w < kWarps; ++w) v += sh.warp_part[w][tid];
    part[blockIdx.x * kAcc + tid] = v;
  }
  grid.sync();
  if (tid < kAcc) {
    float v = __ldcg(part + tid);
    for (int b = 1; b < (int)gridDim.x; ++b) v += __ldcg(part + b * kAcc + tid);
    sh.tot[tid] = v;
  }
  __syncthreads();
  buf ^= 1;
}

// Unrolled 6×6 Cholesky solve; false if a pivot was not positive.
__device__ bool chol_solve6(const float A[6][6], const float b[6], float x[6]) {
  float L[6][6];
  bool ok = true;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        ok = ok && (s > 1e-10f);
        L[i][j] = sqrtf(fmaxf(s, 1e-12f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return ok;
}

__device__ float dot6(const float* a, const float* b) {
  float s = a[0] * b[0];
  for (int k = 1; k < 6; ++k) s = s + a[k] * b[k];
  return s;
}

// Jacobi-scaled, Gershgorin-shifted Newton direction (ops/ndt.py::newton_direction).
__device__ void newton_direction(const float g[6], const float H[6][6], float dp[6]) {
  float S[6], Hs[6][6], Sg[6];
  for (int i = 0; i < 6; ++i) S[i] = 1.0f / sqrtf(fabsf(H[i][i]) + 1e-8f);
  for (int i = 0; i < 6; ++i) {
    Sg[i] = S[i] * g[i];
    for (int j = 0; j < 6; ++j) Hs[i][j] = H[i][j] * S[i] * S[j];
  }
  float M[6][6], x1[6], x2[6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) M[i][j] = Hs[i][j] + (i == j ? 1e-3f : 0.0f);
  const bool ok1 = chol_solve6(M, Sg, x1);
  float lower = INFINITY, upper = -INFINITY;
  for (int i = 0; i < 6; ++i) {
    float sum = 0.0f;
    for (int j = 0; j < 6; ++j) sum = sum + fabsf(Hs[i][j]);
    const float radius = sum - fabsf(Hs[i][i]);
    lower = fminf(lower, Hs[i][i] - radius);
    upper = fmaxf(upper, Hs[i][i] + radius);
  }
  const float shift = fmaxf(-lower, 0.0f) * 1.05f + 1e-3f * (fabsf(upper) + 1e-3f);
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) M[i][j] = Hs[i][j] + (i == j ? shift : 0.0f);
  chol_solve6(M, Sg, x2);
  for (int i = 0; i < 6; ++i) dp[i] = -(S[i] * (ok1 ? x1[i] : x2[i]));
  if (!(dot6(dp, g) < 0.0f))   // scaled steepest descent if numerics betray us
    for (int i = 0; i < 6; ++i) dp[i] = -(S[i] * S[i]) * g[i];
}

__global__ void __launch_bounds__(kThreads)
ndt_align_kernel(const NdtParams p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const bool lead = tid == 0;
  const bool writer = lead && blockIdx.x == 0;
  int buf = 0;

  // control state, alive in thread 0 of every block (all blocks agree)
  float pose[6], dir[6], g[6], H[6][6];
  float phi0 = 0.0f, dphi0 = 0.0f, alpha0 = 0.0f, a = 0.0f;
  float best_a = 0.0f, best_phi = INFINITY, phi_acc = INFINITY, phi_fin = INFINITY;
  int iters = 0, trials = 0;
  bool converged = false;

  if (writer)
    for (int k = 0; k < kOut; ++k) p.out[k] = 0.0f;   // unused slots read as 0
  if (lead) {
    for (int k = 0; k < 6; ++k) {
      pose[k] = p.init_pose[k];
      sh.eval[k] = pose[k];
      sh.ctx[k] = pose[k];
    }
  }
  __syncthreads();

  while (true) {
    pass<0>(p, sh, buf, grid);                       // L, g, H at `pose`
    if (lead) {
      phi0 = sh.tot[0];
      for (int k = 0; k < 6; ++k) g[k] = p.two_s * sh.tot[1 + k];
      int u = 7;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) { H[i][j] = sh.tot[u]; H[j][i] = sh.tot[u]; ++u; }
      if (writer) {
        p.out[kOutL] = phi0;
        for (int k = 0; k < 6; ++k) p.out[kOutG + k] = g[k];
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j < 6; ++j) p.out[kOutH + 6 * i + j] = H[i][j];
      }
      float dp[6];
      newton_direction(g, H, dp);
      float nn = dp[0] * dp[0];
      for (int k = 1; k < 6; ++k) nn = nn + dp[k] * dp[k];
      const float dpn = sqrtf(nn) + 1e-12f;
      for (int k = 0; k < 6; ++k) dir[k] = dp[k] / dpn;
      dphi0 = dot6(g, dir);
      alpha0 = fminf(dpn, p.step_size);
      a = alpha0;
      best_a = 0.0f; best_phi = INFINITY; phi_acc = INFINITY;
      for (int k = 0; k < 6; ++k) sh.eval[k] = pose[k] + a * dir[k];
      sh.stop_after_pass = p.mode;
    }
    __syncthreads();
    if (sh.stop_after_pass) return;                              // mode 1: one pass only

    // Armijo + curvature backtrack (ops/ndt.py::_backtrack)
    bool done = false;
    for (int t = 0; t < p.ls_max; ++t) {
      pass<1>(p, sh, buf, grid);                     // L, g at pose + a·dir
      if (lead) {
        ++trials;
        const float mu = 1e-4f, nu = 0.9f;
        const float phi_a = sh.tot[0];
        float ga[6];
        for (int k = 0; k < 6; ++k) ga[k] = p.two_s * sh.tot[1 + k];
        const float dphi_a = dot6(ga, dir);
        const bool suff = phi_a <= phi0 + mu * a * dphi0;
        const bool curv = fabsf(dphi_a) <= nu * fabsf(dphi0);
        const bool accept = suff && curv;
        if (phi_a < best_phi) { best_a = a; best_phi = phi_a; }
        const float denom = 2.0f * (phi_a - phi0 - dphi0 * a);
        const float a_q = fabsf(denom) > 1e-12f ? -dphi0 * a * a / denom : 0.5f * a;
        float a_next = fminf(fmaxf(a_q, 0.1f * a), 0.5f * a);
        if (suff && !curv && dphi_a < 0.0f) a_next = fminf(2.0f * a, alpha0);
        const bool stuck = fabsf(a_next - a) < 1e-12f * fmaxf(a, 1e-12f);
        if (accept || stuck) { phi_acc = phi_a; done = true; }
        if (!accept) a = a_next;
        for (int k = 0; k < 6; ++k) sh.eval[k] = pose[k] + a * dir[k];
        sh.ls_done = done;
      }
      __syncthreads();
      if (sh.ls_done) break;
    }

    if (lead) {
      float alpha;
      if (done) { alpha = a; phi_fin = phi_acc; }
      else if (best_phi < phi0) { alpha = best_a; phi_fin = best_phi; }
      else { alpha = 0.0f; phi_fin = phi0; }       // nothing improved: no step
      // the neighbourhood of the fitness pass is this iteration's
      for (int k = 0; k < 6; ++k) sh.ctx[k] = pose[k];
      for (int k = 0; k < 6; ++k) pose[k] = pose[k] + alpha * dir[k];
      ++iters;
      converged = alpha < p.trans_eps;
      const bool more = !converged && iters < p.max_iter;
      for (int k = 0; k < 6; ++k) sh.eval[k] = pose[k];
      if (more)
        for (int k = 0; k < 6; ++k) sh.ctx[k] = pose[k];
      sh.more = more;
    }
    __syncthreads();
    if (!sh.more) break;
  }

  pass<2>(p, sh, buf, grid);                          // fitness on the last neighbourhood
  if (writer) {
    for (int k = 0; k < 6; ++k) p.out[k] = pose[k];
    p.out[kOutIters] = (float)iters;
    p.out[kOutConverged] = converged ? 1.0f : 0.0f;
    p.out[kOutPhi] = phi_fin;
    p.out[kOutFrac] = sh.tot[0] / fmaxf(sh.tot[2], 1.0f);
    p.out[kOutFitness] = sh.tot[1] / fmaxf(sh.tot[0], 1.0f);
    p.out[kOutTrials] = (float)trials;
  }
}

}  // namespace

extern "C" {

// (threads per block, accumulators per partial, floats of the result record)
void ndt_geometry(int* threads, int* acc, int* out) {
  *threads = kThreads;
  *acc = kAcc;
  *out = kOut;
}

// Blocks of the kernel that the device can hold at once (0 on an error, or
// where the device cannot launch cooperatively).
int ndt_max_blocks(int device) {
  int coop = 0, sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess
      || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ndt_align_kernel,
                                                    kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// One align (mode 0) or one Hessian pass at `init_pose` (mode 1) on `stream`.
// `blocks` must not exceed ndt_max_blocks(); `partial` holds 2·blocks·28
// floats, `out` 64. Returns the CUDA error code of the launch (0 = success).
int ndt_align_launch(const void* src, const void* mask, const void* fin,
                     const void* origin, const void* init_pose, void* out,
                     void* partial, int n, int gx, int gy, int gz, float res,
                     float d1, float s, float two_s, float four_s2,
                     float step_size, float trans_eps, int max_iter, int ls_max,
                     int mode, int blocks, void* stream) {
  NdtParams p;
  p.src = static_cast<const float*>(src);
  p.mask = static_cast<const unsigned char*>(mask);
  p.fin = static_cast<const float*>(fin);
  p.origin = static_cast<const float*>(origin);
  p.init_pose = static_cast<const float*>(init_pose);
  p.out = static_cast<float*>(out);
  p.partial = static_cast<float*>(partial);
  p.n = n; p.gx = gx; p.gy = gy; p.gz = gz;
  p.res = res; p.d1 = d1; p.s = s; p.two_s = two_s; p.four_s2 = four_s2;
  p.step_size = step_size; p.trans_eps = trans_eps;
  p.max_iter = max_iter; p.ls_max = ls_max; p.mode = mode;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ndt_align_kernel), dim3(blocks), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
