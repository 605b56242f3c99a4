// Fused point-to-plane measurement reduction for the LIO Gauss-Newton
// iteration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lsd_tpu/ops/pallas_p2p.py:_kernel (:43-114,
// pallas_call at :150).  For each point: lidar -> body -> world transform,
// residual r = n.p_w + d, the FAST-LIO gate (s = 1 - 0.9|r|/sqrt|p_l| > 0.9,
// |r| < max_resid, w > 0), 12 Jacobian rows (the extrinsic block times the
// est_ext flag), and the weighted sums J^T W J (12x12), J^T W r (12),
// n_valid, sum |r| and sum w.  The result is written in the 24-dim
// error-state layout: Jacobian rows 0:6 -> [0:6], rows 6:12 -> [18:24].
//
// Bound on an H100 SXM: the kernel reads 32 B per point (xyz, normal, d, w)
// and does about 300 fp32 operations per point.  At N = 16384 that is
// 512 KiB, about 0.16 us at 3.35 TB/s, and about 5 MFLOP, about 0.07 us at
// 67 TFLOP/s, so it is bound by bytes; in practice both are far below the
// few microseconds of a launch, and the kernel is launch-bound.  The design
// therefore keeps to two launches and no host work:
//   pass 1: a fixed grid of blocks grid-strides over the points; each thread
//           keeps the 78 upper-triangle entries of J^T W J, the 12 of J^T W r
//           and the 3 stats in registers; a warp-shuffle reduction and then
//           a shared-memory reduction over warps give one 93-float partial
//           per block.
//   pass 2: one block sums the partials in a fixed order and writes HtH
//           (symmetric fill), Htr and stats.
// There are no float atomics and the grid depends only on N, so the result
// is bitwise repeatable.  fp32 throughout.  Build with -fmad=false: the
// per-point arithmetic then rounds exactly as the plain PyTorch version
// (ops/p2p.py:p2p_reduce_plain), so the validity gate decides ties alike.
// The ragged tail needs no padding: the grid-stride loop stops at n.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 2 * 132;            // two blocks per H100 SM
constexpr int kJ = 12;                         // active Jacobian columns
constexpr int kTri = kJ * (kJ + 1) / 2;        // 78 upper-triangle entries
constexpr int kAcc = kTri + kJ + 3;            // + J^T W r + 3 stats = 93
constexpr int kErr = 24;                       // error-state dimension

__device__ __forceinline__ int tri_index(int a, int b) {   // a <= b
  return a * kJ - a * (a - 1) / 2 + (b - a);
}

// error-state index (0..23) -> active Jacobian column, or -1
__device__ __forceinline__ int active_col(int i) {
  return i < 6 ? i : (i >= 18 ? i - 12 : -1);
}

__global__ void __launch_bounds__(kThreads)
p2p_partial_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                   const float* __restrict__ dpl, const float* __restrict__ wgt,
                   const float* __restrict__ params, int n, float max_resid,
                   float est_ext, float* __restrict__ partials) {
  // params: R (9, row-major), Re (9), te (3), pos (3)
  __shared__ float prm[24];
  __shared__ float red[kWarps][kAcc];
  if (threadIdx.x < 24) prm[threadIdx.x] = params[threadIdx.x];
  __syncthreads();
  const float* R = prm;
  const float* Re = prm + 9;
  const float* te = prm + 18;
  const float* pos = prm + 21;

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
    const float w = wgt[i];
    // body (IMU) frame: pb = Re pl + te;  world: pw = R pb + pos
    const float pbx = Re[0] * x + Re[1] * y + Re[2] * z + te[0];
    const float pby = Re[3] * x + Re[4] * y + Re[5] * z + te[1];
    const float pbz = Re[6] * x + Re[7] * y + Re[8] * z + te[2];
    const float pwx = R[0] * pbx + R[1] * pby + R[2] * pbz + pos[0];
    const float pwy = R[3] * pbx + R[4] * pby + R[5] * pbz + pos[1];
    const float pwz = R[6] * pbx + R[7] * pby + R[8] * pbz + pos[2];
    const float r = nx * pwx + ny * pwy + nz * pwz + dpl[i];
    const float ar = fabsf(r);
    // FAST-LIO validity gate: s = 1 - 0.9 |r| / sqrt(|p_l|) > 0.9
    const float pnorm = sqrtf(x * x + y * y + z * z);
    const float s = 1.0f - 0.9f * ar / sqrtf(fmaxf(pnorm, 1e-3f));
    if (!((w > 0.0f) && (s > 0.9f) && (ar < max_resid))) continue;

    // n^T R
    const float nRx = nx * R[0] + ny * R[3] + nz * R[6];
    const float nRy = nx * R[1] + ny * R[4] + nz * R[7];
    const float nRz = nx * R[2] + ny * R[5] + nz * R[8];
    // (n^T R) Re
    const float nRRex = nRx * Re[0] + nRy * Re[3] + nRz * Re[6];
    const float nRRey = nRx * Re[1] + nRy * Re[4] + nRz * Re[7];
    const float nRRez = nRx * Re[2] + nRy * Re[5] + nRz * Re[8];
    float j[kJ];
    j[0] = nx;
    j[1] = ny;
    j[2] = nz;
    j[3] = -(nRy * pbz - nRz * pby);                 // d r / d theta = -(nR) x pb
    j[4] = -(nRz * pbx - nRx * pbz);
    j[5] = -(nRx * pby - nRy * pbx);
    j[6] = -(nRRey * z - nRRez * y) * est_ext;       // -(nR Re) x pl
    j[7] = -(nRRez * x - nRRex * z) * est_ext;
    j[8] = -(nRRex * y - nRRey * x) * est_ext;
    j[9] = nRx * est_ext;                            // d r / d t_ext
    j[10] = nRy * est_ext;
    j[11] = nRz * est_ext;

#pragma unroll
    for (int a = 0; a < kJ; ++a) {
      const float ja = j[a] * w;
#pragma unroll
      for (int b = a; b < kJ; ++b) acc[tri_index(a, b)] += ja * j[b];
      acc[kTri + a] += ja * r;
    }
    acc[kTri + kJ] += 1.0f;
    acc[kTri + kJ + 1] += ar;
    acc[kTri + kJ + 2] += w;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kAcc; k += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][k];
    partials[blockIdx.x * kAcc + k] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
p2p_finalize_kernel(const float* __restrict__ partials, int n_blocks,
                    float* __restrict__ HtH, float* __restrict__ Htr,
                    float* __restrict__ stats) {
  __shared__ float tot[kAcc];
  for (int k = threadIdx.x; k < kAcc; k += kThreads) {
    float v = 0.0f;
    for (int b = 0; b < n_blocks; ++b) v += partials[b * kAcc + k];
    tot[k] = v;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kErr * kErr; o += kThreads) {
    const int a = active_col(o / kErr), b = active_col(o % kErr);
    HtH[o] = (a < 0 || b < 0) ? 0.0f : tot[a <= b ? tri_index(a, b) : tri_index(b, a)];
  }
  if (threadIdx.x < kErr) {
    const int a = active_col(threadIdx.x);
    Htr[threadIdx.x] = a < 0 ? 0.0f : tot[kTri + a];
  }
  if (threadIdx.x < 3) stats[threadIdx.x] = tot[kTri + kJ + threadIdx.x];
}

}  // namespace

extern "C" {

// Floats of scratch the caller must provide for the per-block partials.
int p2p_reduce_scratch_floats() { return kMaxBlocks * kAcc; }

// Launch both passes on `stream`.  All pointers are device pointers to
// contiguous float32: pts (n, 3), nrm (n, 3), dpl (n), wgt (n), params (24),
// partials (p2p_reduce_scratch_floats()), HtH (24, 24), Htr (24), stats (3)
// = [n_valid, sum |r|, sum w].  Returns the CUDA error code (0 = launched).
int p2p_reduce_launch(const float* pts, const float* nrm, const float* dpl,
                      const float* wgt, const float* params, int n,
                      float max_resid, float est_ext, float* partials,
                      float* HtH, float* Htr, float* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_blocks = (n + kThreads - 1) / kThreads;
  n_blocks = n_blocks < 1 ? 1 : (n_blocks > kMaxBlocks ? kMaxBlocks : n_blocks);
  p2p_partial_kernel<<<n_blocks, kThreads, 0, s>>>(pts, nrm, dpl, wgt, params, n,
                                                   max_resid, est_ext, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  p2p_finalize_kernel<<<1, kThreads, 0, s>>>(partials, n_blocks, HtH, Htr, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
