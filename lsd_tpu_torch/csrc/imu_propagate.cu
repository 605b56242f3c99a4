// IMU forward propagation of the LIO front, hand-written for Hopper (sm_90a).
//
// Replaces the masked lax.scan of lsd_tpu/slam/imu.py:propagate; the JAX
// package has no Pallas kernel for it (XLA compiled the scan).  For each of
// the M IMU slots in order: dt from the previous stamp (the first interval
// 0, clamped to [0, 0.1] s, 0 where the slot is masked); for a valid slot
// the nominal state update (quaternion, velocity, position) and the
// covariance P <- F P F^T + Q dt with the 24x24 error-state transition F;
// a masked slot leaves state and P as they were.  Every slot writes its
// track row (quat, pos, vel).  The formulas, their order and their
// small-angle branches are those of slam/imu.py:propagate_plain, the plain
// PyTorch version that the kernel is held to.
//
// Bound on an H100 SXM: at M = 16 with every slot valid, two dense 24x24
// products a slot are about 0.9 MFLOP (13 ns at 67 TFLOP/s fp32) and the
// kernel reads and writes about 6 KB (P twice, the IMU rows, the track):
// 2 ns at 3.35 TB/s.  Neither bounds it: the recursion is serial from slot
// to slot and tiny, so it is bound by the latency of its dependent steps,
// about 2.4 us a valid slot on an H100, against the ~3,200 launches of the
// per-slot loop at 16 slots.
// The design answers that with one launch of one block, everything in
// shared memory, and no global traffic inside the recursion:
//   - 576 threads, one per entry of P.  Thread 0 carries the nominal state
//     in registers, updates it and writes the slot's 36 varying entries of
//     F (the rest stays the identity); then F P and (F P) F^T + Q dt are
//     formed one entry per thread, in two passes between barriers.
//   - the mask is uniform across the block, so a masked slot costs one
//     track row and no barrier.
//   - rows of P, F P and F are padded to 25 floats: the second pass reads
//     F by rows without bank conflicts.
//   - P is read through its strides: the LIO step's covariance is
//     column-major, and a copy would cost a launch of its own.
// No atomics in the sums and a fixed order of every sum: the result is bitwise
// repeatable, and the launch (no allocation, no sync) can be captured in
// a CUDA graph.  fp32 throughout, built with -fmad=false like every kernel
// of the package.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kErr = 24;                       // error-state dimension
constexpr int kThreads = kErr * kErr;          // one thread per entry of P
constexpr int kRow = kErr + 1;                 // padded row of P, F P and F in shared memory
constexpr int kMaxSlots = 64;
constexpr int kCols = 7;                       // t, gyro (3), accel (3)
// error-state blocks (state.py): position, rotation, velocity, biases, gravity
constexpr int kP = 0, kR = 3, kV = 6, kBg = 9, kBa = 12, kG = 15;

struct Quat {
  float w, x, y, z;
};

// |v| with the plain version's epsilon: sqrt(sum v^2 + 1e-18)
__device__ __forceinline__ float safe_norm3(float x, float y, float z) {
  return sqrtf(x * x + y * y + z * z + 1e-18f);
}

__device__ __forceinline__ float sinc(float x) {      // sin(x) / x, safe at 0
  return fabsf(x) < 1e-5f ? 1.0f - x * x / 6.0f : sinf(x) / x;
}

__device__ __forceinline__ float cosc(float x) {      // (1 - cos(x)) / x^2, safe at 0
  const float x2 = x * x;
  return fabsf(x) < 1e-4f ? 0.5f - x2 / 24.0f : (1.0f - cosf(x)) / x2;
}

__device__ __forceinline__ Quat quat_normalize(Quat q) {
  const float n = sqrtf(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z + 1e-18f);
  const float d = n < 1e-8f ? 1e-8f : n;
  q = {q.w / d, q.x / d, q.y / d, q.z / d};
  const float s = q.w < 0.0f ? -1.0f : 1.0f;          // w >= 0: log goes the short way
  return {q.w * s, q.x * s, q.y * s, q.z * s};
}

__device__ __forceinline__ Quat quat_mul(const Quat& a, const Quat& b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

__device__ __forceinline__ Quat quat_from_rotvec(float x, float y, float z) {
  const float half = safe_norm3(x, y, z) / 2.0f;
  const float k = 0.5f * sinc(half);                  // sin(t/2) / t
  return {cosf(half), k * x, k * y, k * z};
}

// row-major rotation matrix of q (normalized first)
__device__ __forceinline__ void quat_to_matrix(Quat q, float (&R)[9]) {
  q = quat_normalize(q);
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

__device__ __forceinline__ void hat(float x, float y, float z, float (&W)[9]) {
  W[0] = 0.0f, W[1] = -z, W[2] = y;
  W[3] = z, W[4] = 0.0f, W[5] = -x;
  W[6] = -y, W[7] = x, W[8] = 0.0f;
}

// Rodrigues: I + sinc(t) W + cosc(t) W W, row-major
__device__ __forceinline__ void exp_so3(float x, float y, float z, float (&E)[9]) {
  const float t = safe_norm3(x, y, z);
  const float s = sinc(t), c = cosc(t);
  float W[9];
  hat(x, y, z, W);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
      E[3 * i + j] = (i == j ? 1.0f : 0.0f) + s * W[3 * i + j] + c * ww;
    }
}

__global__ void __launch_bounds__(kThreads, 1)
imu_propagate_kernel(const float* __restrict__ quat0, const float* __restrict__ pos0,
                     const float* __restrict__ vel0, const float* __restrict__ bgv,
                     const float* __restrict__ bav, const float* __restrict__ gravv,
                     const float* __restrict__ Pg, int p_row, int p_col,
                     const float* __restrict__ imu, const unsigned char* __restrict__ mask, int m,
                     float q_gyr, float q_acc, float q_bg, float q_ba, float acc_scale,
                     float* __restrict__ out) {
  __shared__ float sP[kErr * kRow];                   // P
  __shared__ float sT[kErr * kRow];                   // F P
  __shared__ float sF[kErr * kRow];                   // F
  __shared__ float sImu[kMaxSlots * kCols];
  __shared__ unsigned char sMask[kMaxSlots];
  count_launch();
  const int tid = threadIdx.x;
  const int i = tid / kErr, j = tid % kErr;

  sP[i * kRow + j] = Pg[i * p_row + j * p_col];
  sF[i * kRow + j] = i == j ? 1.0f : 0.0f;
  for (int k = tid; k < m * kCols; k += kThreads) sImu[k] = imu[k];
  for (int k = tid; k < m; k += kThreads) sMask[k] = mask[k];
  // Q dt is added on the diagonal only: the process noise of entry i
  const float qi = (i != j)  ? 0.0f
                   : i < kR  ? 0.0f
                   : i < kV  ? q_gyr
                   : i < kBg ? q_acc
                   : i < kBa ? q_bg
                   : i < kG  ? q_ba
                             : 0.0f;

  // the nominal state, carried by thread 0
  Quat q = {0.0f, 0.0f, 0.0f, 0.0f};
  float pos[3] = {}, vel[3] = {}, bg[3] = {}, ba[3] = {}, grav[3] = {};
  if (tid == 0) {
    q = {quat0[0], quat0[1], quat0[2], quat0[3]};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pos[c] = pos0[c];
      vel[c] = vel0[c];
      bg[c] = bgv[c];
      ba[c] = bav[c];
      grav[c] = gravv[c];
    }
  }
  float* track_q = out + kErr * kErr + 10;
  float* track_p = track_q + 4 * m;
  float* track_v = track_p + 3 * m;
  __syncthreads();

  for (int k = 0; k < m; ++k) {
    if (sMask[k]) {                                   // the same for every thread
      // dt from the previous stamp: diff with the first interval 0, clamped
      const float t = sImu[k * kCols];
      float dt = t - sImu[(k > 0 ? k - 1 : 0) * kCols];
      dt = dt < 0.0f ? 0.0f : dt;
      dt = dt > 0.1f ? 0.1f : dt;
      if (tid == 0) {
        const float* row = sImu + k * kCols;
        float w[3], a[3], R[9];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          w[c] = row[1 + c] - bg[c];
          a[c] = row[4 + c] * acc_scale - ba[c];
        }
        quat_to_matrix(q, R);
        const Quat nq = quat_normalize(quat_mul(q, quat_from_rotvec(w[0] * dt, w[1] * dt,
                                                                    w[2] * dt)));
        float E[9], H[9];
        exp_so3(-w[0] * dt, -w[1] * dt, -w[2] * dt, E);
        hat(a[0], a[1], a[2], H);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float acc_w = R[3 * r] * a[0] + R[3 * r + 1] * a[1] + R[3 * r + 2] * a[2]
                              + grav[r];
          pos[r] = pos[r] + vel[r] * dt + 0.5f * acc_w * dt * dt;
          vel[r] = vel[r] + acc_w * dt;
          // the varying blocks of F (slam/imu.py:_step_F)
          sF[(kP + r) * kRow + kV + r] = dt;
          sF[(kR + r) * kRow + kBg + r] = -dt;
          sF[(kV + r) * kRow + kG + r] = dt;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            sF[(kR + r) * kRow + kR + c] = E[3 * r + c];
            sF[(kV + r) * kRow + kR + c] =
                (-R[3 * r] * H[c] + -R[3 * r + 1] * H[3 + c] + -R[3 * r + 2] * H[6 + c]) * dt;
            sF[(kV + r) * kRow + kBa + c] = -R[3 * r + c] * dt;
          }
        }
        q = nq;
      }
      __syncthreads();
      float s = 0.0f;                                 // (F P)[i][j]
#pragma unroll
      for (int c = 0; c < kErr; ++c) s += sF[i * kRow + c] * sP[c * kRow + j];
      sT[i * kRow + j] = s;
      __syncthreads();
      s = 0.0f;                                       // (F P F^T)[i][j] + Q dt
#pragma unroll
      for (int c = 0; c < kErr; ++c) s += sT[i * kRow + c] * sF[j * kRow + c];
      sP[i * kRow + j] = s + qi * dt;
      __syncthreads();
    }
    if (tid == 0) {
      track_q[4 * k] = q.w;
      track_q[4 * k + 1] = q.x;
      track_q[4 * k + 2] = q.y;
      track_q[4 * k + 3] = q.z;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        track_p[3 * k + c] = pos[c];
        track_v[3 * k + c] = vel[c];
      }
    }
  }

  out[tid] = sP[i * kRow + j];
  if (tid == 0) {
    float* st = out + kErr * kErr;
    st[0] = q.w, st[1] = q.x, st[2] = q.y, st[3] = q.z;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      st[4 + c] = pos[c];
      st[7 + c] = vel[c];
    }
  }
}

}  // namespace

extern "C" {

// Launch the propagation on `stream` of device `device`.  All pointers are
// device pointers to contiguous float32 (the mask: bool, one byte a slot):
// quat (4, wxyz), pos, vel, bg, ba, grav (3 each), imu (m, 7) rows [t, gyro,
// accel], mask (m); and P (24, 24) with strides p_row, p_col in elements (the
// LIO step's covariance comes out of an inverse column-major).  q_* are the diagonal process-noise
// densities (gyro, accel, gyro bias walk, accel bias walk), acc_scale the
// accelerometer's scale to m/s^2.  out (576 + 10 + 10 m) receives P (24,
// 24), the final quat, pos, vel, then the track's quat (m, 4), pos (m, 3)
// and vel (m, 3).  Returns 0 once launched, else the CUDA error code.
int imu_propagate_launch(const float* quat, const float* pos, const float* vel,
                         const float* bg, const float* ba, const float* grav, const float* P,
                         int p_row, int p_col, const float* imu, const unsigned char* mask,
                         int m, float q_gyr,
                         float q_acc, float q_bg, float q_ba, float acc_scale, float* out,
                         int device, void* stream) {
  if (m < 1 || m > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  imu_propagate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      quat, pos, vel, bg, ba, grav, P, p_row, p_col, imu, mask, m, q_gyr, q_acc, q_bg, q_ba,
      acc_scale, out);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// The launches of this library's kernel on `device` since the last reset
// (csrc/launch_count.cuh); zeroes them when reset != 0.  Waits for the
// device.  Returns 0, else the CUDA error code.
int imu_propagate_launch_count(int device, int reset, unsigned long long* count) {
  return read_launch_count(device, reset, count);
}

}  // extern "C"
