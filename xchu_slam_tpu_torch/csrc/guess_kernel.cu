// The device engine's external NDT guess: the IMU and wheel-odometry windows
// of one scan integrated into the guess delta on the card, from the pose the
// card holds, with nothing read back.
//
// Replaces the reference's `device_pipeline._ext_guess`
// (xchu_slam_tpu/models/device_pipeline.py:341-369) and the two lax.scans it
// calls (xchu_slam_tpu/ops/imu.py::integrate_imu, integrate_wheel_odom),
// which the reference leaves to XLA. There is no Pallas kernel for it. The
// plain PyTorch version is ops/imu.py::ext_guess_ref.
//
// What bounds it. A window is 16 samples (~0.6 KB for both): no byte or flop
// count matters on this card. The work is two chains of 16 dependent steps,
// each a rotation from Euler angles (three sincos), a 3×3 product and three
// atan2(sin, cos) wraps: latency, one step after the other. As PyTorch ops
// the plain chain is ~300 launches of a few bytes each; here it is one
// launch of one warp.
//
// Design.
// - One block of 32 threads. All lanes stage both windows in shared memory
//   (the per-sample dt, clamped and 0 where masked, the rates, the vectors),
//   then lane 0 runs the IMU chain and lane 1 the wheel chain. Both lanes run
//   the same instructions: the wheel lane's acceleration is 0 and its
//   velocity the sample's own vector, so `pos + v·dt + ½·a·dt²` is its
//   `pos + v·dt` exactly, and the warp never diverges inside the chain.
// - Lane 0 takes lane 1's delta by shuffles and writes the combine (wheel
//   translation, IMU rotation), `use_ext` (every window in use holds a valid
//   sample) and the IMU velocity.
// - The plain version's order of operations, built with -fmad=false so that
//   no multiply and add are contracted; sinf / cosf / atan2f are the
//   accurate library functions, not the fast intrinsics.
//
// Built with nvcc (sm_90a) into a shared library with a plain C interface;
// the wrapper ops/cuda/guess_kernel.py passes PyTorch's current stream.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr float kGravity = 9.80665f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float wrap_angle(float a) { return atan2f(sinf(a), cosf(a)); }

// One sample of a chain. `u` is the body-frame vector (IMU: specific force;
// wheel: linear velocity), `w` the Euler rates; the attitude r is the one
// before the sample, as the plain version's R = euler_to_matrix(before[k]).
__device__ __forceinline__ void chain_step(bool imu, float d, const float* u, const float* w,
                                           float* pos, float* vel, float* r) {
  const float cr = cosf(r[0]), sr = sinf(r[0]);
  const float cp = cosf(r[1]), sp = sinf(r[1]);
  const float cy = cosf(r[2]), sy = sinf(r[2]);
  const float R[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                      sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                      -sp, cp * sr, cp * cr};
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = R[3 * i] * u[0] + R[3 * i + 1] * u[1] + R[3 * i + 2] * u[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float a = imu ? (i == 2 ? x[i] - kGravity : x[i] - 0.0f) : 0.0f;
    const float v = imu ? vel[i] : x[i];
    pos[i] = pos[i] + v * d + 0.5f * a * d * d;
    vel[i] = vel[i] + a * d;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = wrap_angle(r[i] + w[i] * d);
}

// Shared memory per window: dt [m], valid [m], rates [3m], vectors [3m].
__device__ void stage(const float* stamps, const float* rate, const float* vec,
                      const unsigned char* mask, int m, float* s) {
  float* dt = s;
  float* valid = s + m;
  float* srate = s + 2 * m;
  float* svec = s + 5 * m;
  for (int k = threadIdx.x; k < m; k += kLanes) {
    const bool ok = stamps != nullptr && mask[k] != 0;
    const float d = stamps == nullptr ? 0.0f : stamps[k] - stamps[k > 0 ? k - 1 : 0];
    dt[k] = ok ? fmaxf(d, 0.0f) : 0.0f;
    valid[k] = ok ? 1.0f : 0.0f;
  }
  for (int k = threadIdx.x; k < 3 * m; k += kLanes) {
    srate[k] = rate == nullptr ? 0.0f : rate[k];
    svec[k] = vec == nullptr ? 0.0f : vec[k];
  }
}

__global__ void __launch_bounds__(kLanes, 1) guess_kernel(
    const float* __restrict__ pose0, const float* __restrict__ vel_in,
    const float* imu_stamps, const float* gyro, const float* accel,
    const unsigned char* imu_mask, const float* whl_stamps, const float* angular,
    const float* linear, const unsigned char* whl_mask, int m, int use_imu, int use_odom,
    float* __restrict__ delta, unsigned char* __restrict__ use_ext,
    float* __restrict__ vel_out) {
  extern __shared__ float smem[];
  stage(imu_stamps, gyro, accel, imu_mask, m, smem);
  stage(whl_stamps, angular, linear, whl_mask, m, smem + 8 * m);
  __syncthreads();

  const int lane = threadIdx.x;
  float d[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float vel[3] = {vel_in[0], vel_in[1], vel_in[2]};
  int have = 0;
  if (lane < 2) {
    const float* s = smem + 8 * m * lane;
    const bool imu = lane == 0;
    float pos[3] = {pose0[0], pose0[1], pose0[2]};
    float r[3] = {pose0[3], pose0[4], pose0[5]};
    for (int k = 0; k < m; ++k) {
      have |= s[m + k] != 0.0f;
      chain_step(imu, s[k], s + 5 * m + 3 * k, s + 2 * m + 3 * k, pos, vel, r);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d[i] = pos[i] - pose0[i];
      d[3 + i] = wrap_angle(r[i] - pose0[3 + i]);
    }
  }
  __syncwarp();
  float w[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = __shfl_sync(kFull, d[i], 1);
  const int have_w = __shfl_sync(kFull, have, 1);
  if (lane != 0) return;
  // the combine: wheel translation, IMU rotation
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float x = 0.0f;
    if (use_imu && use_odom) x = i < 3 ? w[i] : d[i];
    else if (use_imu) x = d[i];
    else if (use_odom) x = w[i];
    delta[i] = x;
  }
  *use_ext = (use_imu || use_odom) && (!use_imu || have) && (!use_odom || have_w);
#pragma unroll
  for (int i = 0; i < 3; ++i) vel_out[i] = use_imu ? vel[i] : vel_in[i];
}

// The latency floor's pieces, in the kernel's geometry (1 × 32): mode 0
// returns at once; mode 1 runs `reps` chains of m samples in lanes 0-1 on
// register-resident inputs derived from out[0] (so nothing folds away) and
// writes the result to out[lane].
__global__ void __launch_bounds__(kLanes, 1) guess_probe_kernel(int mode, int reps, int m,
                                                                float* out) {
  if (mode == 0 || threadIdx.x >= 2) return;
  const bool imu = threadIdx.x == 0;
  const float seed = out[0];
  float pos[3] = {seed, 0.5f * seed, 0.0f};
  float vel[3] = {1.0f, 0.0f, 0.0f};
  float r[3] = {0.01f, -0.02f, seed};
  const float u[3] = {0.3f, 0.1f, 9.8f};
  const float w[3] = {0.01f, 0.02f, 0.4f};
  for (int i = 0; i < reps; ++i)
    for (int k = 0; k < m; ++k) chain_step(imu, 0.00625f, u, w, pos, vel, r);
  out[threadIdx.x] = pos[0] + pos[1] + pos[2] + r[0] + r[1] + r[2];
}

}  // namespace

// delta [6], use_ext (one bool) and vel_out [3] ← the guess of one scan from
// pose0 [6] and vel_in [3]. A window's pointers are null where its mode is
// off; each window is stamps [m], rates [m,3], vectors [m,3], mask [m].
extern "C" int guess_launch(const float* pose0, const float* vel_in, const float* imu_stamps,
                            const float* gyro, const float* accel, const unsigned char* imu_mask,
                            const float* whl_stamps, const float* angular, const float* linear,
                            const unsigned char* whl_mask, int m, int use_imu, int use_odom,
                            float* delta, unsigned char* use_ext, float* vel_out, void* stream) {
  const size_t smem = sizeof(float) * 16 * static_cast<size_t>(m);
  guess_kernel<<<1, kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
      pose0, vel_in, imu_stamps, gyro, accel, imu_mask, whl_stamps, angular, linear, whl_mask,
      m, use_imu, use_odom, delta, use_ext, vel_out);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the probe kernel (1 × 32 threads, the kernel's geometry).
extern "C" int guess_probe_launch(int mode, int reps, int m, float* out, void* stream) {
  guess_probe_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(mode, reps, m, out);
  return static_cast<int>(cudaGetLastError());
}
