// NDT scan-to-map alignment in one persistent kernel: the Newton loop, its
// line search and every score / gradient / Hessian pass over the point ×
// voxel pairs, with both trip counts decided on the card.
//
// The reference has no TPU kernel for this work: it leaves
// xchu_slam_tpu/ops/ndt.py::newton_align (two `lax.while_loop`s) around
// ops/ndt_deriv.py::ndt_value_grad_hess and ops/voxel_map.py::lookup_neighbors
// to XLA. The plain PyTorch version is xchu_slam_tpu_torch/ops/ndt.py::
// align_ref, whose Python loops read every pass back to decide whether to go
// on.
//
// What bounds it on an H100. One pass is N = 8192 source points against the 7
// DIRECT7 voxels of each: 57,344 pairs, a gather of at most 2.3 MB from a
// 6.1 MB [V,10] table that stays in the 50 MB L2, and 10-30 MFLOP. Bytes
// (0.7 µs at 3.35 TB/s) and operations (0.2-0.5 µs at 67 TFLOP/s) bound a
// pass below a microsecond; an align is 2-3 Newton iterations of 2-3 passes,
// each a dependent step, so what it waits for is latency: one launch (1.4 µs
// in a CUDA graph), and per pass one grid-wide barrier (1.07 µs), dependent
// round trips to L2 (0.15 µs each when the card is idle, several times that
// when every SM asks at once) and, after a Hessian pass, the 6×6 control
// arithmetic (1.5 µs). The design keeps each of these short or off the path
// rather than the arithmetic small. (Times: chip_smoke.py's floor lines,
// NVIDIA H100 80GB HBM3 at 700 W.)
//
// Design.
// - One cooperative launch per align (`cudaLaunchCooperativeKernel`; every
//   block resident, one block of 512 threads an SM: 128 blocks for 8192
//   points on 132 SMs, see ops/cuda/ndt_kernel.py::plan). The loops live
//   inside the kernel; `grid.sync()` separates a pass's per-block partial
//   sums from the control step that reads them. Work that the loop predicates
//   rule out is never issued. Two barriers written by hand (a counter that
//   only grows, polled by one thread a block; partial sums sent as 8-byte
//   words of value and pass tag, polled by every reader) were both slower
//   than `grid.sync()` and are not here.
// - A pass works on (point, neighbour) pairs, a lane per pair: 8 lanes own one
//   source point, lanes 0-6 its DIRECT7 voxels (centre, ±x, ±y, ±z), lane 7
//   idles. Every lane issues its one row gather (5 × 8 bytes) at once, so a
//   pass waits for one round trip to L2 where a thread that walks its 7 rows
//   in turn waits for seven, and its instruction stream is a seventh as long
//   (straight-line code runs at the pace instructions are fetched). A lane
//   transforms its point by the trial pose (R = Rz·Ry·Rx), finds the voxel
//   from the pose the iteration started at (the neighbourhood is fixed for
//   the iteration's line-search trials, as in the reference), and adds its
//   pair's share of L, Σc·a6 and, on the Hessian pass, the upper triangle of
//   H to 28 registers. Every term of H is linear in the pair's (c·B, c·Bδ),
//   so the point's J-terms are added pair by pair too: no exchange inside the
//   8 lanes, at the price of arithmetic the card has to spare. Only the
//   fitness sums need the point: a 3-step shuffle min over its 8 lanes.
// - What a thread would ask L2 for again stays in shared memory, where the
//   launch gives every thread one pair for good (one trip of the grid-stride
//   loop: N ≤ 64 points a resident block): the block's points, loaded once,
//   and the voxel row each Hessian pass gathered, which the iteration's
//   line-search trials and the fitness pass share. Only Hessian passes
//   gather, and only those at which the control step decided to gather
//   again (`regather_dist` below). A larger N runs the same passes on a
//   grid-stride loop with no state between them: the voxel is recomputed from
//   the pose the neighbourhood belongs to and gathered again, to the same
//   bits.
// - Every line-search trial also adds the fitness sums, three more lanes of
//   the same reduction: the accepted trial ran at the align's last pose on
//   its last neighbourhood, so the separate fitness pass (and its barrier)
//   runs only where the line search ended otherwise.
// - Sums in a fixed order, no atomics: a transposing butterfly inside each
//   warp (31 shuffles for all 32 sums: at each step a lane hands half of its
//   values to its partner, and lane k ends with sum k), the warps of a block
//   in order, one 32-float partial per block in a scratch array (two buffers,
//   by pass parity, so that a fast block cannot overwrite what a slow one
//   still reads). After the barrier every block reads all partials, every
//   load issued before the first add, and sums them in the same tree. Reruns
//   are bit-identical.
// - Control. After the barrier every block holds the same sums, and its
//   first warp runs the same control arithmetic on them, all lanes alike: the
//   Jacobi-scaled, Gershgorin-shifted 6×6 Cholesky solve, the Armijo +
//   curvature backtrack with its quadratic interpolation, expansion and
//   `stuck` exit, the pose update and the convergence test. The two tiers of
//   the Newton direction are one instruction stream on two matrices, so even
//   lanes solve the first and odd lanes the second at once. The same warp
//   then publishes the next pass's poses and their ten rotation products (a
//   lane per sine and cosine, a lane per product), so a pass starts with no
//   trigonometry and no barrier of its own. All blocks reach the same
//   decision from the same bits, so no second barrier broadcasts it. The
//   file is compiled with -fmad=false: the thresholds are compared in fp32
//   as the plain version compares them, without fused multiply-adds; the
//   passes' pair arithmetic asks for its fused multiply-adds by name.
// - Regathering (`regather_dist`, a launch argument of every instantiation,
//   ops/ndt.py::newton_align's rule, the reference's
//   xchu_slam_tpu/ops/ndt.py:495-531). After each step the control warp
//   measures how far the pose has moved from the pose the neighbourhood was
//   gathered at (‖Δt‖ + 60·‖Δr‖); the next Hessian pass gathers again only
//   past `regather_dist`, else it reuses the rows it holds. A convergence
//   counts only on an iteration whose neighbourhood was fresh (gathered at
//   its pose, or the pose had not moved since); a convergence refused on a
//   stale one forces a gather at the next iteration. At 0, the default,
//   every iteration that moved gathers and no convergence is refused.
// - Outputs stay on the card: pose, iterations, converged, φ at the accepted
//   pose, matched fraction and fitness on the last neighbourhood, the last
//   Hessian pass's (L, g, H) and the number of passes run. `mode` 1 stops
//   after one Hessian pass at the initial pose (the smoke run compares that
//   pass with the plain one).
// - Modes. The kernel is a template on the neighbourhood's size kM and the
//   line search kLs (`ls_mode`), one instantiation each; the wrapper picks it
//   from the spec, and DIRECT7 with backtracking is the code described above.
//   kM = 1 (DIRECT1): a lane a point. kM = 27 (DIRECT26, and KDTREE, which
//   also drops, by a launch flag, the voxels whose mean lies `res` or more
//   from the point at the iteration's pose, as the reference's radius search
//   does): 32 lanes a point, lanes 27-31 idle; 8192 points are then 4 trips
//   of the grid-stride loop on 128 blocks, and the rows of all 4 stay in the
//   dynamic shared memory (80 KB a block; past 4 trips every pass gathers
//   again), so that the line-search trials gather nothing. kLs: the
//   reference's More-Thuente search with its loop live (the first trial at
//   clip(α0, trans_eps/2, step_size), then up to ls_max more while the
//   interval has not converged and the trial fails the Wolfe test; psi drives
//   the open interval), or its executed step (that first trial alone, one
//   pass an iteration). Both return the last trial evaluated, so the
//   fitness sums of the last trial pass are the align's.
// - The probe kernels at the end time what the align waits for, each alone:
//   an empty launch, grid and cluster barriers, a chain of dependent L2
//   loads, the control step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;   // L, g[6], H upper triangle [21]
constexpr int kRow = 32;   // floats of one partial: kAcc padded to a warp
constexpr int kFit = 28;   // fitness sums in the padding: matched count, Σ min d², mask count
constexpr int kOut = 64;   // floats of the result record
constexpr unsigned kFull = 0xffffffffu;

// The neighbourhood of kM voxels a point: 1 (DIRECT1), 7 (DIRECT7: centre,
// ±x, ±y, ±z) or 27 (DIRECT26 and KDTREE: the 3×3×3 cube in the reference's
// `meshgrid(..., indexing="ij")` order). A point owns kLanes lanes, a power
// of two that holds its kM pairs (the lanes past kM idle), and the row cache
// spans at most kCacheTrips trips of the grid-stride loop.
template <int kM>
struct Neighbours {
  static_assert(kM == 1 || kM == 7 || kM == 27, "DIRECT1, DIRECT7 or the 27-cube");
  static constexpr int kLanes = kM == 1 ? 1 : (kM == 7 ? 8 : 32);
  static constexpr int kCacheTrips = kM == 27 ? 4 : 1;
  static constexpr int kPointsPerTrip = kThreads / kLanes;
  static constexpr int kPoints = kPointsPerTrip * kCacheTrips;
  // rows of more than one trip (80 KB at 4) need dynamic shared memory
  static constexpr bool kDynamicRows = kCacheTrips > 1;
  static constexpr int kRowSlots = kDynamicRows ? 1 : kThreads;
  static constexpr int kRowStride = kThreads * kCacheTrips;
  static constexpr int kDynamicBytes = kDynamicRows ? 10 * kRowStride * 4 : 0;
};

// the line searches (`ls_mode`)
enum LineSearch { kBacktrack = 0, kMoreThuente = 1, kRefClamped = 2 };

// slots of the result record
constexpr int kOutIters = 6, kOutConverged = 7, kOutPhi = 8, kOutFrac = 9,
              kOutFitness = 10, kOutTrials = 11, kOutL = 12, kOutG = 13,
              kOutH = 19, kOutPasses = 55;

struct NdtParams {
  const float* src;            // [n,3]
  const unsigned char* mask;   // [n]
  const float* fin;            // [gx*gy*gz,10]: mean 3, icov upper 6, valid
  const float* origin;         // [3]
  const float* init_pose;      // [6]
  float* out;                  // [kOut]
  float* partial;              // [2][blocks][kRow]
  int n, gx, gy, gz;
  float res, d1, s, two_s, four_s2, step_size, trans_eps;
  int max_iter, ls_max, mode;
  int kdtree;                  // 27-cube: keep voxels whose mean is within res
  float res2;                  // res² (KDTREE)
  float regather_dist;         // gather again past this ‖Δt‖ + 60·‖Δr‖
};

// The ten matrices Z·Y·X a pass needs: R, dR/d(r,p,y), d²R/d(rr,rp,ry,pp,py,yy),
// from the sines and cosines of (roll, pitch, yaw). Each axis factor keeps its
// pattern under differentiation with (c, s, one) replaced by (−s, c, 0) and
// then (−c, −s, 0).
__device__ __forceinline__ void rot_product(float sr, float cr, float sp, float cp,
                                            float sy, float cy, int which, float* m) {
  // derivative order per axis for matrix `which`, two bits each
  // 0: R; 1: r; 2: p; 3: y; 4: rr; 5: rp; 6: ry; 7: pp; 8: py; 9: yy
  const int ox = (0x01604 >> (2 * which)) & 3;   // {0, 1, 0, 0, 2, 1, 1, 0, 0, 0}
  const int oy = (0x18410 >> (2 * which)) & 3;   // {0, 0, 1, 0, 0, 1, 0, 2, 1, 0}
  const int oz = (0x91040 >> (2 * which)) & 3;   // {0, 0, 0, 1, 0, 0, 1, 0, 1, 2}
  float cx = cr, sx = sr, onex = 1.0f;
  if (ox == 1) { cx = -sr; sx = cr; onex = 0.0f; }
  if (ox == 2) { cx = -cr; sx = -sr; onex = 0.0f; }
  float cyy = cp, syy = sp, oney = 1.0f;
  if (oy == 1) { cyy = -sp; syy = cp; oney = 0.0f; }
  if (oy == 2) { cyy = -cp; syy = -sp; oney = 0.0f; }
  float cz = cy, sz = sy, onez = 1.0f;
  if (oz == 1) { cz = -sy; sz = cy; onez = 0.0f; }
  if (oz == 2) { cz = -cy; sz = -sy; onez = 0.0f; }
  // ZY = Z·Y, then (ZY)·X
  const float zy00 = cz * cyy, zy01 = -sz * oney, zy02 = cz * syy;
  const float zy10 = sz * cyy, zy11 = cz * oney, zy12 = sz * syy;
  const float zy20 = -onez * syy, zy22 = onez * cyy;
  m[0] = zy00 * onex; m[1] = zy01 * cx + zy02 * sx; m[2] = zy02 * cx - zy01 * sx;
  m[3] = zy10 * onex; m[4] = zy11 * cx + zy12 * sx; m[5] = zy12 * cx - zy11 * sx;
  m[6] = zy20 * onex; m[7] = zy22 * sx;             m[8] = zy22 * cx;
}

__host__ __device__ constexpr int upper_index(int i, int j) {
  // position of (i, j), i <= j, in the row-major upper triangle of a 6×6
  return i * 6 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// Built with -DNDT_TICKS (tools/torch_ndt_phase_probe.py), the first thread of
// block 0 leaves the SM's cycle count at each phase of the last pass of each
// kind, and after the control step of the last Hessian pass.
#ifdef NDT_TICKS
__device__ long long g_ticks[32];
#define TICK(slot) \
  do { if (blockIdx.x == 0 && threadIdx.x == 0) g_ticks[slot] = clock64(); } while (0)
#else
#define TICK(slot)
#endif

template <int kM>
struct Shared {
  using Nb = Neighbours<kM>;
  float4 rot[11][3];    // products at the trial pose: 9 floats each, padded to 12;
  //                       the eleventh is R at the pose the iteration started at
  float eval[6];        // the pose of this pass
  float ctx[6];         // the pose the neighbourhood belongs to
  float warp_part[kWarps][kRow];
  float tot[kRow];
  // where the launch gives every thread its pairs for good (at most
  // kCacheTrips trips of the grid-stride loop): the point of each kLanes
  // lanes, and the voxel row the last Hessian pass gathered for each of the
  // thread's pairs, kept for the passes that share its neighbourhood (the
  // line-search trials and the fitness pass); rows of more than one trip
  // live in the dynamic shared memory instead
  float4 point[Nb::kPoints];           // x, y, z, mask
  float origin[3];                     // the grid's origin
  float row[10][Nb::kRowSlots];        // voxel mean in the map frame 3, icov upper 6, valid
  // loop decisions of the first thread, read by the block; one variable per
  // decision, so that the next decision is never written while a warp still
  // reads this one
  int stop_after_pass, ls_done, more, fit_known, gather;
};

// (M · q) for the padded 3×3 `m`
__device__ __forceinline__ void mat_vec(const float4* m, float q0, float q1, float q2,
                                        float& r0, float& r1, float& r2) {
  const float4 a = m[0], b = m[1], c = m[2];
  r0 = dot3(a.x, a.y, a.z, q0, q1, q2);
  r1 = dot3(a.w, b.x, b.y, q0, q1, q2);
  r2 = dot3(b.z, b.w, c.x, q0, q1, q2);
}

// Sums v[k] over the warp for every k at once: at each step a lane keeps one
// half of its values and hands the other to its partner, so the butterfly
// costs 16 + 8 + 4 + 2 + 1 shuffles. Lane k returns the warp's sum of v[k].
template <int half>
__device__ __forceinline__ void fold(float (&v)[kRow], int lane) {
  const bool up = (lane & half) != 0;
#pragma unroll
  for (int k = 0; k < half; ++k) {
    const float send = up ? v[k] : v[k + half];
    const float keep = up ? v[k + half] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, half);
  }
}

__device__ __forceinline__ float warp_transpose_sum(float (&v)[kRow], int lane) {
  fold<16>(v, lane);
  fold<8>(v, lane);
  fold<4>(v, lane);
  fold<2>(v, lane);
  fold<1>(v, lane);
  return v[0];
}

// The control warp publishes the pose of the next pass and the pose its
// neighbourhood belongs to, with their rotation products: lanes 0-5 take one
// sine and cosine each, lanes 0-9 build one product each at the trial pose,
// lane 10 R at the neighbourhood's pose. The block reads them after the
// barrier that follows every control step.
template <int kM>
__device__ __forceinline__ void publish(Shared<kM>& sh, const float eval[6],
                                        const float ctx[6]) {
  const int lane = threadIdx.x & 31;
  float angle = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lane == k) angle = eval[3 + k];
    if (lane == 3 + k) angle = ctx[3 + k];
  }
  float sn, cs;
  sincosf(angle, &sn, &cs);
  const int at = lane == 10 ? 3 : 0;      // lane 10 reads the neighbourhood's angles
  const float sr = __shfl_sync(kFull, sn, at), cr = __shfl_sync(kFull, cs, at);
  const float sp = __shfl_sync(kFull, sn, at + 1), cp = __shfl_sync(kFull, cs, at + 1);
  const float sy = __shfl_sync(kFull, sn, at + 2), cy = __shfl_sync(kFull, cs, at + 2);
  if (lane <= 10)
    rot_product(sr, cr, sp, cp, sy, cy, lane == 10 ? 0 : lane,
                reinterpret_cast<float*>(sh.rot[lane]));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) { sh.eval[k] = eval[k]; sh.ctx[k] = ctx[k]; }
  }
}

// The row cache of the launch: static shared memory for one trip, the
// dynamic shared memory for more; float `a` of a row of trip `trip` sits at
// [a * kRowStride + trip * kThreads + tid].
template <int kM>
__device__ __forceinline__ float* row_cache(Shared<kM>& sh) {
  if constexpr (Neighbours<kM>::kDynamicRows) {
    extern __shared__ float4 ndt_dynamic_smem[];
    return reinterpret_cast<float*>(ndt_dynamic_smem);
  } else {
    return &sh.row[0][0];
  }
}

// One pass over the pairs: per-lane accumulators, block partial, grid barrier,
// fixed-order total in sh.tot. kind 0: L, g, H; 1: L, g and the fitness sums
// (matched count, Σ min d², mask count); 2: the fitness sums alone. kFresh
// (the shard pass) gathers every pass and keeps no rows.
template <int kM, int kind, bool kFresh = false>
__device__ __forceinline__ void pass(const NdtParams& p, Shared<kM>& sh, int& buf,
                                     cg::grid_group& grid) {
  using Nb = Neighbours<kM>;
  constexpr int kLanes = Nb::kLanes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  TICK(kind * 8);

  float acc[kRow];
#pragma unroll
  for (int k = 0; k < kRow; ++k) acc[k] = 0.0f;

  const float* R = reinterpret_cast<const float*>(sh.rot[0]);
  const float* Rc = reinterpret_cast<const float*>(sh.rot[10]);
  const float o0 = sh.origin[0], o1 = sh.origin[1], o2 = sh.origin[2];
  float* rows = row_cache(sh);
  // the lane's voxel: DIRECT7 centre, +x, −x, +y, −y, +z, −z, lane 7 idle;
  // the 27-cube (v / 9, v / 3 % 3, v % 3) − 1, lanes 27-31 idle
  const int v = lane & (kLanes - 1);
  int dx = 0, dy = 0, dz = 0;
  if constexpr (kM == 7) {
    dx = (v == 1) - (v == 2); dy = (v == 3) - (v == 4); dz = (v == 5) - (v == 6);
  } else if constexpr (kM == 27) {
    dx = v / 9 - 1; dy = (v / 3) % 3 - 1; dz = v % 3 - 1;
  }
  const long long items = (long long)p.n * kLanes;
  const long long stride = (long long)gridDim.x * kThreads;
  // the trip count is the warp's, so that every lane reaches the shuffles
  // kept: at most kCacheTrips trips, a thread's pairs never change
  const bool kept = items <= stride * Nb::kCacheTrips;
  // a Hessian pass that does not gather again reads the rows it holds, as
  // the line-search passes do
  const bool reuse = kept && !kFresh && (kind != 0 || !sh.gather);
  int trip = 0;         // of the kept trips; one trip (DIRECT1, DIRECT7) is trip 0
  constexpr bool kTrips = Nb::kCacheTrips > 1;
  for (long long base = (long long)blockIdx.x * kThreads + (tid & ~31); base < items;
       base += stride, ++trip) {
    const int i = (int)((base + lane) / kLanes);
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
    bool point_on = false;
    if (kept) {
      const float4 q = sh.point[(kTrips ? trip * Nb::kPointsPerTrip : 0) + tid / kLanes];
      q0 = q.x; q1 = q.y; q2 = q.z; point_on = q.w != 0.0f;
    } else if (i < p.n) {
      // the mask and the point are asked for together
      const unsigned char m = __ldg(p.mask + i);
      q0 = __ldg(p.src + 3 * i); q1 = __ldg(p.src + 3 * i + 1); q2 = __ldg(p.src + 3 * i + 2);
      point_on = m != 0;
    }
    float* row = rows + (kTrips ? trip * kThreads : 0) + tid;
    // the point under the trial pose
    float pt[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      pt[a] = q0 * R[3 * a] + q1 * R[3 * a + 1] + q2 * R[3 * a + 2] + sh.eval[a];
    // the voxel's mean in the map frame (c), its inverse covariance, and
    // whether the pair counts: kept from the last gathering pass, or gathered
    // at the point's voxel under the pose the neighbourhood belongs to
    // (sh.ctx, which past the kept trips is recomputed every pass, and may be
    // a stale pose on purpose)
    float c0, c1, c2, xx, xy, xz, yy, yz, zz;
    bool on;
    if (reuse) {
      c0 = row[0]; c1 = row[Nb::kRowStride]; c2 = row[2 * Nb::kRowStride];
      xx = row[3 * Nb::kRowStride]; xy = row[4 * Nb::kRowStride];
      xz = row[5 * Nb::kRowStride]; yy = row[6 * Nb::kRowStride];
      yz = row[7 * Nb::kRowStride]; zz = row[8 * Nb::kRowStride];
      on = row[9 * Nb::kRowStride] != 0.0f;
    } else {
      float pc[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        pc[a] = q0 * Rc[3 * a] + q1 * Rc[3 * a + 1] + q2 * Rc[3 * a + 2] + sh.ctx[a];
      const int nx = (int)floorf((pc[0] - o0) / p.res) + dx;
      const int ny = (int)floorf((pc[1] - o1) / p.res) + dy;
      const int nz = (int)floorf((pc[2] - o2) / p.res) + dz;
      on = point_on && v < kM && nx >= 0 && nx < p.gx && ny >= 0 && ny < p.gy
           && nz >= 0 && nz < p.gz;
      float2 r0 = {0.0f, 0.0f}, r1 = r0, r2 = r0, r3 = r0, r4 = r0;
      if (on) {
        const long long flat = ((long long)nx * p.gy + ny) * p.gz + nz;
        const float2* src_row = reinterpret_cast<const float2*>(p.fin + 10 * flat);
        r0 = __ldg(src_row); r1 = __ldg(src_row + 1); r2 = __ldg(src_row + 2);
        r3 = __ldg(src_row + 3); r4 = __ldg(src_row + 4);
      }
      on = on && r4.y > 0.0f;
      c0 = (o0 + (float)nx * p.res) + r0.x;
      c1 = (o1 + (float)ny * p.res) + r0.y;
      c2 = (o2 + (float)nz * p.res) + r1.x;
      if constexpr (kM == 27) {
        // KDTREE: the voxels whose mean lies within res of the point where
        // the neighbourhood is gathered (the reference's radius search)
        if (p.kdtree) {
          const float e0 = pc[0] - c0, e1 = pc[1] - c1, e2 = pc[2] - c2;
          on = on && e0 * e0 + e1 * e1 + e2 * e2 < p.res2;
        }
      }
      xx = r1.y; xy = r2.x; xz = r2.y; yy = r3.x; yz = r3.y; zz = r4.x;
      if (kept && !kFresh) {
        row[0] = c0; row[Nb::kRowStride] = c1; row[2 * Nb::kRowStride] = c2;
        row[3 * Nb::kRowStride] = xx; row[4 * Nb::kRowStride] = xy;
        row[5 * Nb::kRowStride] = xz; row[6 * Nb::kRowStride] = yy;
        row[7 * Nb::kRowStride] = yz; row[8 * Nb::kRowStride] = zz;
        row[9 * Nb::kRowStride] = on ? 1.0f : 0.0f;
      }
    }
    const float d0 = pt[0] - c0, d1_ = pt[1] - c1, d2_ = pt[2] - c2;

    if (kind >= 1) {
      // fitness: the nearest of the point's valid voxel means, a min over its
      // kLanes lanes. A line-search trial adds it too: where the trial's pose
      // is the align's last, no fitness pass follows.
      float dmin = on ? d0 * d0 + d1_ * d1_ + d2_ * d2_ : INFINITY;
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        dmin = fminf(dmin, __shfl_xor_sync(kFull, dmin, off));
      if (point_on && v == 0) {
        acc[kFit + 2] += 1.0f;
        if (dmin < INFINITY) { acc[kFit] += 1.0f; acc[kFit + 1] += dmin; }
      }
    }
    if (kind == 2 || !on) continue;

    float a6[6];
    a6[0] = dot3(xx, xy, xz, d0, d1_, d2_);
    a6[1] = dot3(xy, yy, yz, d0, d1_, d2_);
    a6[2] = dot3(xz, yz, zz, d0, d1_, d2_);
    const float x = dot3(d0, d1_, d2_, a6[0], a6[1], a6[2]);
    const float c = p.d1 * expf(p.s * fmaxf(x, 0.0f));
    acc[0] += c;
    float D[3][3];      // D[a][k] = (dR_k · q)_a
#pragma unroll
    for (int k = 0; k < 3; ++k) mat_vec(sh.rot[1 + k], q0, q1, q2, D[0][k], D[1][k], D[2][k]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      a6[3 + k] = dot3(a6[0], a6[1], a6[2], D[0][k], D[1][k], D[2][k]);
    float ca[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      ca[k] = c * a6[k];
      acc[1 + k] += ca[k];
    }
    if (kind == 0) {
      // 4s²·c·a6⊗a6
#pragma unroll
      for (int i2 = 0; i2 < 6; ++i2) {
        const float sa = p.four_s2 * ca[i2];
#pragma unroll
        for (int j2 = i2; j2 < 6; ++j2)
          acc[7 + upper_index(i2, j2)] = fmaf(sa, a6[j2], acc[7 + upper_index(i2, j2)]);
      }
      // 2s·(JᵀBJ with J = [I | D] on this pair's c·B, and the second-order
      // angle term c·Bδ·(d²R·q))
      const float ct = p.two_s * c;
      const float B[3][3] = {{ct * xx, ct * xy, ct * xz}, {ct * xy, ct * yy, ct * yz},
                             {ct * xz, ct * yz, ct * zz}};
      float BD[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int j2 = a; j2 < 3; ++j2) acc[7 + upper_index(a, j2)] += B[a][j2];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          BD[a][k] = dot3(B[a][0], B[a][1], B[a][2], D[0][k], D[1][k], D[2][k]);
          acc[7 + upper_index(a, 3 + k)] += BD[a][k];
        }
      }
      const float w0 = p.two_s * ca[0], w1 = p.two_s * ca[1], w2 = p.two_s * ca[2];
      int m2 = 0;       // rr, rp, ry, pp, py, yy
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int l = k; l < 3; ++l) {
          float e0, e1, e2;
          mat_vec(sh.rot[4 + m2], q0, q1, q2, e0, e1, e2);
          ++m2;
          const float dbd = dot3(D[0][k], D[1][k], D[2][k], BD[0][l], BD[1][l], BD[2][l]);
          acc[7 + upper_index(3 + k, 3 + l)] += dbd + dot3(w0, w1, w2, e0, e1, e2);
        }
    }
  }
  TICK(kind * 8 + 1);
  // block partial: the butterfly in each warp, then the warps in order
  const float mine = warp_transpose_sum(acc, lane);
  sh.warp_part[warp][lane] = mine;
  __syncthreads();
  float* part = p.partial + (size_t)buf * gridDim.x * kRow;
  if (tid < kRow) {
    float t = sh.warp_part[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += sh.warp_part[w][tid];
    part[blockIdx.x * kRow + tid] = t;
  }
  TICK(kind * 8 + 2);
  grid.sync();
  TICK(kind * 8 + 3);
  // every block sums all partials in one order: thread t the blocks t/32,
  // t/32 + 16, ... of sum t%32, then the warps in order
  float t = 0.0f;
  const int cells = gridDim.x * kRow;
#pragma unroll 8
  for (int e = tid; e < cells; e += kThreads) t += __ldcg(part + e);
  sh.warp_part[warp][lane] = t;
  __syncthreads();
  if (tid < kRow) {
    float u = sh.warp_part[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) u += sh.warp_part[w][tid];
    sh.tot[tid] = u;
  }
  __syncthreads();
  TICK(kind * 8 + 4);
  buf ^= 1;
}

// Unrolled 6×6 Cholesky solve; false if a pivot was not positive.
__device__ __forceinline__ bool chol_solve6(const float A[6][6], const float b[6],
                                            float x[6]) {
  float L[6][6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        ok = ok && (s > 1e-10f);
        L[i][j] = sqrtf(fmaxf(s, 1e-12f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return ok;
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float s = a[0] * b[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) s = s + a[k] * b[k];
  return s;
}

// Jacobi-scaled, Gershgorin-shifted Newton direction (ops/ndt.py::
// newton_direction). Called by a whole warp with the same arguments in every
// lane: even lanes solve the lightly damped tier, odd lanes the shifted one.
__device__ __forceinline__ void newton_direction(const float g[6], const float H[6][6],
                                                 float dp[6]) {
  float S[6], Hs[6][6], Sg[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) S[i] = 1.0f / sqrtf(fabsf(H[i][i]) + 1e-8f);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Sg[i] = S[i] * g[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) Hs[i][j] = H[i][j] * S[i] * S[j];
  }
  float lower = INFINITY, upper = -INFINITY;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) sum = sum + fabsf(Hs[i][j]);
    const float radius = sum - fabsf(Hs[i][i]);
    lower = fminf(lower, Hs[i][i] - radius);
    upper = fmaxf(upper, Hs[i][i] + radius);
  }
  const float shift = fmaxf(-lower, 0.0f) * 1.05f + 1e-3f * (fabsf(upper) + 1e-3f);
  const float damp = (threadIdx.x & 1) ? shift : 1e-3f;
  float M[6][6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) M[i][j] = Hs[i][j] + (i == j ? damp : 0.0f);
  const bool ok = chol_solve6(M, Sg, x);
  const bool ok1 = __shfl_sync(kFull, (int)ok, 0) != 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float x1 = __shfl_sync(kFull, x[i], 0), x2 = __shfl_sync(kFull, x[i], 1);
    dp[i] = -(S[i] * (ok1 ? x1 : x2));
  }
  if (!(dot6(dp, g) < 0.0f)) {  // scaled steepest descent if numerics betray us
#pragma unroll
    for (int i = 0; i < 6; ++i) dp[i] = -(S[i] * S[i]) * g[i];
  }
}

// ‖Δt‖ + 60·‖Δr‖ between two poses, summed as ops/ndt.py::_moved sums it.
__device__ __forceinline__ float moved(const float a[6], const float b[6]) {
  float d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = a[k] - b[k];
  return sqrtf((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
         + 60.0f * sqrtf((d[3] * d[3] + d[4] * d[4]) + d[5] * d[5]);
}

// What follows a Hessian pass: (L, g, H) from the 28 sums, the Newton
// direction, its unit vector, slope and first step length. A whole warp calls
// it, all lanes alike.
__device__ __forceinline__ void newton_step(const float* tot, float two_s, float step_size,
                                            float g[6], float H[6][6], float dir[6],
                                            float& dphi0, float& alpha0) {
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = two_s * tot[1 + k];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) { H[i][j] = tot[7 + upper_index(i, j)]; H[j][i] = H[i][j]; }
  float dp[6];
  newton_direction(g, H, dp);
  float nn = dp[0] * dp[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) nn = nn + dp[k] * dp[k];
  const float dpn = sqrtf(nn) + 1e-12f;
#pragma unroll
  for (int k = 0; k < 6; ++k) dir[k] = dp[k] / dpn;
  dphi0 = dot6(g, dir);
  alpha0 = fminf(dpn, step_size);
}

// More-Thuente pieces (ops/ndt.py::mt_trial_value, mt_update_interval; the
// reference's ndt_omp_impl.hpp:646-757), on the lead warp's registers, all
// lanes alike. Every case is computed, as the plain version's selects do.
__device__ __forceinline__ float safe_div(float num, float den) {
  const float tiny = 1e-30f;
  return num / (fabsf(den) > tiny ? den : (den >= 0.0f ? tiny : -tiny));
}

__device__ __forceinline__ float mt_trial_value(float a_l, float f_l, float g_l, float a_u,
                                                float f_u, float g_u, float a_t, float f_t,
                                                float g_t) {
  const float z1 = 3.0f * safe_div(f_t - f_l, a_t - a_l) - g_t - g_l;
  const float w1 = sqrtf(fmaxf(z1 * z1 - g_t * g_l, 0.0f));
  const float a_c1 = a_l + (a_t - a_l) * safe_div(w1 - g_l - z1, g_t - g_l + 2.0f * w1);
  const float a_q = a_l - 0.5f * (a_l - a_t) * safe_div(g_l, g_l - safe_div(f_l - f_t, a_l - a_t));
  const float case1 = fabsf(a_c1 - a_l) < fabsf(a_q - a_l) ? a_c1 : 0.5f * (a_q + a_c1);
  const float a_s = a_l - safe_div(a_l - a_t, g_l - g_t) * g_l;
  const float case2 = fabsf(a_c1 - a_t) >= fabsf(a_s - a_t) ? a_c1 : a_s;
  const float a_t3 = fabsf(a_c1 - a_t) < fabsf(a_s - a_t) ? a_c1 : a_s;
  const float case3 = a_t > a_l ? fminf(a_t + 0.66f * (a_u - a_t), a_t3)
                                : fmaxf(a_t + 0.66f * (a_u - a_t), a_t3);
  const float z4 = 3.0f * safe_div(f_t - f_u, a_t - a_u) - g_t - g_u;
  const float w4 = sqrtf(fmaxf(z4 * z4 - g_t * g_u, 0.0f));
  const float case4 = a_u + (a_t - a_u) * safe_div(w4 - g_u - z4, g_t - g_u + 2.0f * w4);
  if (f_t > f_l) return case1;
  if (g_t * g_l < 0.0f) return case2;
  return fabsf(g_t) <= fabsf(g_l) ? case3 : case4;
}

// updateIntervalMT: the endpoints after a trial at (a_t, f_t, g_t); true where
// the interval converged (none of the update cases applies)
__device__ __forceinline__ bool mt_update_interval(float& a_l, float& f_l, float& g_l,
                                                   float& a_u, float& f_u, float& g_u,
                                                   float a_t, float f_t, float g_t) {
  if (f_t > f_l) {
    a_u = a_t; f_u = f_t; g_u = g_t;
    return false;
  }
  const float side = g_t * (a_l - a_t);
  if (side > 0.0f) {
    a_l = a_t; f_l = f_t; g_l = g_t;
    return false;
  }
  if (side < 0.0f) {
    a_u = a_l; f_u = f_l; g_u = g_l;
    a_l = a_t; f_l = f_t; g_l = g_t;
    return false;
  }
  return true;
}

// kM voxels a point, line search kLs. Every instantiation is the same loop;
// kM picks the lanes and the row cache (Neighbours), kLs the block that
// follows the Hessian pass.
template <int kM, int kLs>
__global__ void __launch_bounds__(kThreads, 1)
ndt_align_kernel(const NdtParams p) {
  using Nb = Neighbours<kM>;
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared<kM> sh;
  const int tid = threadIdx.x;
  const bool lead = tid < 32;          // the control warp; its lanes agree
  const bool first = tid == 0;         // writes the block's shared decisions
  const bool writer = first && blockIdx.x == 0;
  int buf = 0;

  // control state, alive in the first warp of every block (all blocks agree)
  float pose[6], ctx[6], eval[6], dir[6], g[6], H[6][6];
  float phi0 = 0.0f, dphi0 = 0.0f, alpha0 = 0.0f, a = 0.0f;
  float best_a = 0.0f, best_phi = INFINITY, phi_acc = INFINITY, phi_fin = INFINITY;
  float a_eval = 0.0f, fit_n = 0.0f, fit_d = 0.0f, fit_m = 0.0f;   // the last trial's step and fitness sums
  int iters = 0, trials = 0;
  bool converged = false;
  bool fresh = true;    // this iteration's neighbourhood was gathered at its pose
  const float mu = 1e-4f, nu = 0.9f;
  // the More-Thuente / clamped steps' range: [trans_eps / 2, step_size]
  const float step_min = 0.5f * p.trans_eps, step_max = p.step_size;

  if (writer)
    for (int k = 0; k < kOut; ++k) p.out[k] = 0.0f;   // unused slots read as 0
  if (lead) {
#pragma unroll
    for (int k = 0; k < 6; ++k) { pose[k] = p.init_pose[k]; ctx[k] = pose[k]; }
    publish(sh, pose, ctx);
  }
  if (tid >= 32 && tid < 35) sh.origin[tid - 32] = p.origin[tid - 32];
  if (tid == 35) sh.gather = 1;                    // the first pass gathers at the initial pose
  const long long stride = (long long)gridDim.x * kThreads;
  if ((long long)p.n * Nb::kLanes <= stride * Nb::kCacheTrips && tid >= 64) {
    // at most kCacheTrips trips: the block's points stay in shared memory for
    // every pass
    for (int j = tid - 64; j < Nb::kPoints; j += kThreads - 64) {
      const int trip = j / Nb::kPointsPerTrip;
      const int i = (int)(((long long)blockIdx.x * kThreads + trip * stride) / Nb::kLanes)
                    + j % Nb::kPointsPerTrip;
      float4 q = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i < p.n) {
        q.x = __ldg(p.src + 3 * i); q.y = __ldg(p.src + 3 * i + 1); q.z = __ldg(p.src + 3 * i + 2);
        q.w = __ldg(p.mask + i) ? 1.0f : 0.0f;
      }
      sh.point[j] = q;
    }
  }
  __syncthreads();

  while (true) {
    pass<kM, 0>(p, sh, buf, grid);                   // L, g, H at `pose`
    if (lead) {
      phi0 = sh.tot[0];
      newton_step(sh.tot, p.two_s, p.step_size, g, H, dir, dphi0, alpha0);
      TICK(24);
      // backtracking starts at α0; More-Thuente and the clamped step at
      // clip(α0, step_min, step_max)
      a = kLs == kBacktrack ? alpha0 : fminf(fmaxf(alpha0, step_min), step_max);
      best_a = 0.0f; best_phi = INFINITY; phi_acc = INFINITY;
#pragma unroll
      for (int k = 0; k < 6; ++k) eval[k] = pose[k] + a * dir[k];
      publish(sh, eval, ctx);
      if (first) sh.stop_after_pass = p.mode;
      if (writer) {
        p.out[kOutL] = phi0;
#pragma unroll
        for (int k = 0; k < 6; ++k) p.out[kOutG + k] = g[k];
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) p.out[kOutH + 6 * i + j] = H[i][j];
      }
    }
    __syncthreads();
    TICK(25);
    if (sh.stop_after_pass) return;                  // mode 1: one pass only

    bool done = false;
    if constexpr (kLs == kBacktrack) {
      // Armijo + curvature backtrack (ops/ndt.py::_backtrack)
      for (int t = 0; t < p.ls_max; ++t) {
        if (lead) a_eval = a;
        pass<kM, 1>(p, sh, buf, grid);               // L, g at pose + a·dir
        if (lead) {
          ++trials;
          fit_n = sh.tot[kFit]; fit_d = sh.tot[kFit + 1]; fit_m = sh.tot[kFit + 2];
          const float phi_a = sh.tot[0];
          float ga[6];
#pragma unroll
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
          if (!done && t + 1 < p.ls_max) {           // another trial follows
#pragma unroll
            for (int k = 0; k < 6; ++k) eval[k] = pose[k] + a * dir[k];
            publish(sh, eval, ctx);
          }
          if (first) sh.ls_done = done;
        }
        __syncthreads();
        if (sh.ls_done) break;
      }
    } else if constexpr (kLs == kMoreThuente) {
      // More-Thuente with its loop live (ops/ndt.py::mt_exact_search): the
      // first trial at clip(α0), then up to ls_max more while the interval
      // has not converged and the trial fails the Wolfe test. psi drives the
      // open interval; the endpoints switch to φ when it closes.
      const float g0 = (1.0f - mu) * dphi0;        // dpsi at a = 0
      float a_l = 0.0f, f_l = 0.0f, g_l = g0, a_u = 0.0f, f_u = 0.0f, g_u = g0;
      bool open = true, later = false;
      int t = 0;                                     // trials after the first
      while (true) {
        if (lead) a_eval = a;
        pass<kM, 1>(p, sh, buf, grid);               // φ, ∇ at pose + a·dir
        if (lead) {
          ++trials;
          fit_n = sh.tot[kFit]; fit_d = sh.tot[kFit + 1]; fit_m = sh.tot[kFit + 2];
          const float phi_n = sh.tot[0];
          float ga[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) ga[k] = p.two_s * sh.tot[1 + k];
          const float dphi_n = dot6(ga, dir);
          const float psi_n = phi_n - phi0 - mu * a * dphi0;
          const float dpsi_n = dphi_n - mu * dphi0;
          bool conv = false;
          if (later) {
            if (open && psi_n <= 0.0f && dpsi_n >= 0.0f) {
              // the endpoints' psi → φ conversion, with the reference's sign
              f_l = f_l + phi0 - mu * dphi0 * a_l;
              g_l = g_l + mu * dphi0;
              f_u = f_u + phi0 - mu * dphi0 * a_u;
              g_u = g_u + mu * dphi0;
              open = false;
            }
            conv = mt_update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a, open ? psi_n : phi_n,
                                      open ? dpsi_n : dphi_n);
            ++t;
          }
          later = true;
          phi_acc = phi_n;
          const bool wolfe = psi_n <= 0.0f && dphi_n <= -nu * dphi0;
          const bool again = !conv && t < p.ls_max && !wolfe;
          if (again) {
            a = fminf(fmaxf(mt_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a,
                                           open ? psi_n : phi_n, open ? dpsi_n : dphi_n),
                            step_min), step_max);
#pragma unroll
            for (int k = 0; k < 6; ++k) eval[k] = pose[k] + a * dir[k];
            publish(sh, eval, ctx);
          }
          if (first) sh.ls_done = !again;
        }
        __syncthreads();
        if (sh.ls_done) break;
      }
      done = true;                                   // the step is the last trial
    } else {
      // the reference's executed step (its More-Thuente loop is dead code):
      // one trial at clip(α0), whose φ the diagnostics keep
      if (lead) a_eval = a;
      pass<kM, 1>(p, sh, buf, grid);
      if (lead) {
        ++trials;
        fit_n = sh.tot[kFit]; fit_d = sh.tot[kFit + 1]; fit_m = sh.tot[kFit + 2];
        phi_acc = sh.tot[0];
        done = true;
      }
    }

    if (lead) {
      float alpha;
      if (done) { alpha = a; phi_fin = phi_acc; }
      else if (best_phi < phi0) { alpha = best_a; phi_fin = best_phi; }
      else { alpha = 0.0f; phi_fin = phi0; }       // nothing improved: no step
#pragma unroll
      for (int k = 0; k < 6; ++k) pose[k] = pose[k] + alpha * dir[k];
      ++iters;
      // a convergence counts on a fresh neighbourhood only; one refused on
      // a stale neighbourhood makes the next iteration gather
      const bool conv_raw = alpha < p.trans_eps;
      converged = conv_raw && fresh;
      const bool more = !converged && iters < p.max_iter;
      bool gather = false;
      if (more) {
        // the next Hessian pass gathers at the new pose where it moved past
        // regather_dist; the fitness pass keeps this iteration's
        // neighbourhood
        const float moved0 = moved(pose, ctx);
        gather = (conv_raw && !fresh) || moved0 > p.regather_dist;
        fresh = gather || moved0 <= 1e-9f;
        if (gather) {
#pragma unroll
          for (int k = 0; k < 6; ++k) ctx[k] = pose[k];
        }
      }
      publish(sh, pose, ctx);
      if (first) {
        sh.more = more;
        sh.gather = gather;
        // the accepted trial ran at this very pose, on this neighbourhood
        sh.fit_known = done && alpha == a_eval;
      }
    }
    __syncthreads();
    if (!sh.more) break;
  }

  if (!sh.fit_known) {
    pass<kM, 2>(p, sh, buf, grid);                   // fitness on the last neighbourhood
    if (lead) { fit_n = sh.tot[kFit]; fit_d = sh.tot[kFit + 1]; fit_m = sh.tot[kFit + 2]; }
  }
  if (writer) {
    for (int k = 0; k < 6; ++k) p.out[k] = pose[k];
    p.out[kOutIters] = (float)iters;
    p.out[kOutConverged] = converged ? 1.0f : 0.0f;
    p.out[kOutPhi] = phi_fin;
    p.out[kOutFrac] = fit_n / fmaxf(fit_m, 1.0f);
    p.out[kOutFitness] = fit_d / fmaxf(fit_n, 1.0f);
    p.out[kOutTrials] = (float)trials;
    p.out[kOutPasses] = (float)(iters + trials + (sh.fit_known ? 0 : 1));
  }
}

// ---- the shard pass of a sharded align ---- //

// One pass over a shard's pairs, for an align whose points are sharded over a
// mesh of ranks (ops/ndt.py::align with `mesh`): there the Newton and
// line-search control runs on the host from the sums that every rank reduces
// in the same order, so the kernel evaluates one pass and stops. `poses`
// (p.init_pose) holds two poses: the pose the pass evaluates at (0-5) and the
// pose the neighbourhood is gathered at (6-11), the pose the Newton iteration
// started at, as the align kernel's line-search trials and the plain version
// (`newton_align`) keep it. `kind` 0: L, g, H; 1: L, g and the fitness sums;
// 2: the fitness sums alone. Every pass gathers afresh (no rows are kept
// between launches); the block partials are summed in the align kernel's
// fixed order, and block 0 writes the kRow sums to p.out.
template <int kM>
__global__ void __launch_bounds__(kThreads, 1)
ndt_pass_kernel(const NdtParams p, int kind) {
  using Nb = Neighbours<kM>;
  cg::grid_group grid = cg::this_grid();
  __shared__ Shared<kM> sh;
  const int tid = threadIdx.x;
  int buf = 0;
  if (tid < 32) {
    float eval[6], ctx[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) { eval[k] = p.init_pose[k]; ctx[k] = p.init_pose[6 + k]; }
    publish(sh, eval, ctx);
  }
  if (tid >= 32 && tid < 35) sh.origin[tid - 32] = p.origin[tid - 32];
  const long long stride = (long long)gridDim.x * kThreads;
  if ((long long)p.n * Nb::kLanes <= stride * Nb::kCacheTrips && tid >= 64) {
    for (int j = tid - 64; j < Nb::kPoints; j += kThreads - 64) {
      const int trip = j / Nb::kPointsPerTrip;
      const int i = (int)(((long long)blockIdx.x * kThreads + trip * stride) / Nb::kLanes)
                    + j % Nb::kPointsPerTrip;
      float4 q = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i < p.n) {
        q.x = __ldg(p.src + 3 * i); q.y = __ldg(p.src + 3 * i + 1); q.z = __ldg(p.src + 3 * i + 2);
        q.w = __ldg(p.mask + i) ? 1.0f : 0.0f;
      }
      sh.point[j] = q;
    }
  }
  __syncthreads();
  if (kind == 0) pass<kM, 0, true>(p, sh, buf, grid);
  else if (kind == 1) pass<kM, 1, true>(p, sh, buf, grid);
  else pass<kM, 2, true>(p, sh, buf, grid);
  if (blockIdx.x == 0 && tid < kRow) p.out[tid] = sh.tot[tid];
}

// ---- probes: what an align waits for, each alone ---- //

// `syncs` grid-wide barriers and nothing else (a cooperative launch).
__global__ void probe_grid_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

// `syncs` cluster-wide barriers and nothing else (one thread-block cluster).
__global__ void probe_cluster_kernel(int syncs) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int s = 0; s < syncs; ++s) cluster.sync();
}

// `hops` loads from L2, each address taken from the load before it.
__global__ void probe_chase_kernel(const int* next, int hops, int* out) {
  int j = 0;
  for (int h = 0; h < hops; ++h) j = __ldcg(next + j);
  *out = j;
}

// `steps` control steps of a Hessian pass in one warp: 28 sums in, the trial
// pose out; each step's input hangs on the step before.
__global__ void probe_control_kernel(const float* sums, int steps, float two_s,
                                     float step_size, float* out) {
  float tot[kAcc], g[6], H[6][6], dir[6], dphi0 = 0.0f, alpha0 = 0.0f, carry = 0.0f;
  for (int k = 0; k < kAcc; ++k) tot[k] = __ldcg(sums + k);
  for (int s = 0; s < steps; ++s) {
    tot[1] = tot[1] + carry;
    tot[7] = tot[7] + carry;
    newton_step(tot, two_s, step_size, g, H, dir, dphi0, alpha0);
    carry = 0.0f * (alpha0 * dir[0] + dphi0);
  }
  if (threadIdx.x == 0)
    for (int k = 0; k < 6; ++k) out[k] = alpha0 * dir[k] + carry;
}

}  // namespace

extern "C" {

// (threads per block, accumulators, floats per partial, floats of the result
// record)
void ndt_geometry(int* threads, int* acc, int* row, int* out) {
  *threads = kThreads;
  *acc = kAcc;
  *row = kRow;
  *out = kOut;
}

// Lanes a point and the trips the row cache spans, for `neighbours` voxels a
// point (1, 7 or 27; 0 for another count).
void ndt_neighbours(int neighbours, int* lanes, int* cache_trips) {
  *lanes = neighbours == 1 ? Neighbours<1>::kLanes
         : neighbours == 7 ? Neighbours<7>::kLanes
         : neighbours == 27 ? Neighbours<27>::kLanes : 0;
  *cache_trips = neighbours == 1 ? Neighbours<1>::kCacheTrips
               : neighbours == 7 ? Neighbours<7>::kCacheTrips
               : neighbours == 27 ? Neighbours<27>::kCacheTrips : 0;
}

}  // extern "C"

namespace {

using AlignKernel = void (*)(NdtParams);

template <int kM>
AlignKernel pick_ls(int ls) {
  return ls == kBacktrack ? ndt_align_kernel<kM, kBacktrack>
       : ls == kMoreThuente ? ndt_align_kernel<kM, kMoreThuente>
       : ls == kRefClamped ? ndt_align_kernel<kM, kRefClamped> : nullptr;
}

// The instantiation for `neighbours` voxels a point and line search `ls`, its
// dynamic shared memory, and that memory granted to it (nullptr on an unknown
// pair or a refused attribute).
AlignKernel pick(int neighbours, int ls, int* dynamic_bytes) {
  AlignKernel k = nullptr;
  *dynamic_bytes = 0;
  if (neighbours == 1) k = pick_ls<1>(ls);
  if (neighbours == 7) k = pick_ls<7>(ls);
  if (neighbours == 27) {
    k = pick_ls<27>(ls);
    *dynamic_bytes = Neighbours<27>::kDynamicBytes;
  }
  if (k != nullptr && *dynamic_bytes > 0
      && cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *dynamic_bytes) != cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return k;
}

using PassKernel = void (*)(NdtParams, int);

PassKernel pick_pass(int neighbours) {
  return neighbours == 1 ? ndt_pass_kernel<1>
       : neighbours == 7 ? ndt_pass_kernel<7>
       : neighbours == 27 ? ndt_pass_kernel<27> : nullptr;
}

}  // namespace

extern "C" {

// Blocks of the instantiation (`neighbours`, `ls`) that the device can hold at
// once (0 on an error, or where the device cannot launch cooperatively).
int ndt_max_blocks(int device, int neighbours, int ls) {
  int coop = 0, sms = 0, per_sm = 0, dynamic_bytes = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess
      || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const AlignKernel k = pick(neighbours, ls, &dynamic_bytes);
  if (k == nullptr
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(k),
                                                       kThreads, dynamic_bytes) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// One align (mode 0) or one Hessian pass at `init_pose` (mode 1) on `stream`,
// with `neighbours` voxels a point (1, 7 or 27; `kdtree` masks the 27 by
// distance² < res2 = res²) and line search `ls` (0 backtrack, 1 More-Thuente,
// 2 the clamped step), gathering again past `regather_dist`. `blocks` must
// not exceed ndt_max_blocks(); `partial` holds 2·blocks·32 floats, `out` 64.
// Returns the CUDA error code of the launch (0 = success).
int ndt_align_launch(const void* src, const void* mask, const void* fin,
                     const void* origin, const void* init_pose, void* out,
                     void* partial, int n, int gx, int gy, int gz, float res,
                     float d1, float s, float two_s, float four_s2,
                     float step_size, float trans_eps, int max_iter, int ls_max,
                     int mode, int blocks, int neighbours, int ls, int kdtree,
                     float res2, float regather_dist, void* stream) {
  int dynamic_bytes = 0;
  const AlignKernel k = pick(neighbours, ls, &dynamic_bytes);
  if (k == nullptr || (kdtree && neighbours != 27))
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.kdtree = kdtree; p.res2 = res2; p.regather_dist = regather_dist;
  void* args[] = {&p};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k), dim3(blocks), dim3(kThreads), args,
      dynamic_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the shard pass for `neighbours` voxels a point that the device
// holds at once (0 on an error, or where it cannot launch cooperatively).
int ndt_pass_max_blocks(int device, int neighbours) {
  int coop = 0, sms = 0, per_sm = 0;
  const PassKernel k = pick_pass(neighbours);
  if (k == nullptr
      || cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) != cudaSuccess
      || !coop
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, reinterpret_cast<const void*>(k),
                                                       kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// One shard pass (see ndt_pass_kernel) on `stream`: `poses` holds the pose
// of the pass and the pose of the neighbourhood (12 floats), `out` receives
// 32 sums, `partial` holds blocks·32 floats; `kind` 0 (L, g, H), 1 (L, g,
// fitness) or 2 (fitness). `blocks` must not exceed ndt_pass_max_blocks().
// Returns the CUDA error code of the launch (0 = success).
int ndt_pass_launch(const void* src, const void* mask, const void* fin, const void* origin,
                    const void* poses, void* out, void* partial, int n, int gx, int gy,
                    int gz, float res, float d1, float s, float two_s, float four_s2,
                    int kind, int blocks, int neighbours, int kdtree, float res2,
                    void* stream) {
  const PassKernel k = pick_pass(neighbours);
  if (k == nullptr || kind < 0 || kind > 2 || (kdtree && neighbours != 27))
    return static_cast<int>(cudaErrorInvalidValue);
  NdtParams p = {};
  p.src = static_cast<const float*>(src);
  p.mask = static_cast<const unsigned char*>(mask);
  p.fin = static_cast<const float*>(fin);
  p.origin = static_cast<const float*>(origin);
  p.init_pose = static_cast<const float*>(poses);
  p.out = static_cast<float*>(out);
  p.partial = static_cast<float*>(partial);
  p.n = n; p.gx = gx; p.gy = gy; p.gz = gz;
  p.res = res; p.d1 = d1; p.s = s; p.two_s = two_s; p.four_s2 = four_s2;
  p.kdtree = kdtree; p.res2 = res2;
  void* args[] = {&p, &kind};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef NDT_TICKS
// The cycle counts of the last launch (32 values; see TICK), after a synchronise.
int ndt_ticks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_ticks, sizeof(long long) * 32));
}
#endif

// Clusters of `cluster` blocks × `threads` of the cluster probe that the
// device can hold at once (0: such a cluster cannot be placed; < 0: an error).
int ndt_probe_max_clusters(int cluster, int threads) {
  if (cluster > 8 && cudaFuncSetAttribute(probe_cluster_kernel,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, probe_cluster_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}

// One probe launch on `stream`. kind 0: `reps` grid barriers on a cooperative
// launch of blocks × threads; 1: `reps` cluster barriers on one cluster of
// `blocks` blocks × threads; 2: `reps` dependent L2 loads through `in` (an
// int32 table of next indices) in one thread; 3: `reps` control steps on the
// 28 sums at `in`, in one warp. Returns the CUDA error code (0 = success).
int ndt_probe_launch(int kind, int blocks, int threads, int reps, const void* in,
                     void* out, float two_s, float step_size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (kind == 0) {
    void* args[] = {&reps};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(probe_grid_kernel),
                                      dim3(blocks), dim3(threads), args, 0, st);
  } else if (kind == 1) {
    if (blocks > 8)
      err = cudaFuncSetAttribute(probe_cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(blocks);
      cfg.blockDim = dim3(threads);
      cfg.stream = st;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = blocks;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, probe_cluster_kernel, reps);
    }
  } else if (kind == 2) {
    probe_chase_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(in), reps,
                                        static_cast<int*>(out));
  } else if (kind == 3) {
    probe_control_kernel<<<1, 32, 0, st>>>(static_cast<const float*>(in), reps, two_s,
                                           step_size, static_cast<float*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) { cudaGetLastError(); return static_cast<int>(err); }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
