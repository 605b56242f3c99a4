// Fused point-to-plane measurement reduction for the LIO Gauss-Newton
// iteration, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lsd_tpu/ops/pallas_p2p.py:_kernel (:43-114,
// pallas_call at :150).  For each point: lidar -> body -> world transform,
// residual r = n.p_w + d, the FAST-LIO gate (s = 1 - 0.9|r|/sqrt|p_l| > 0.9,
// |r| < max_resid, w > 0), 12 Jacobian rows (the extrinsic block only when
// it is estimated), and the weighted sums J^T W J (12x12), J^T W r (12),
// n_valid, sum |r| and sum w.  The result is written in the 24-dim
// error-state layout: Jacobian rows 0:6 -> [0:6], rows 6:12 -> [18:24].
//
// Bound on an H100 SXM: the kernel reads 32 B per point (xyz, normal, d, w)
// and does about 140 fp32 operations per valid point without the extrinsic
// block (about 300 with it).  At N = 16384 that is 512 KiB, about 0.16 us
// at 3.35 TB/s, and about 2 MFLOP, about 0.03 us at 67 TFLOP/s, so it is
// bound by bytes; both are far below the microsecond of a launch, so the
// design is about launches, latency and the reduction's structure:
//   - one launch of one thread-block cluster of 16 blocks of 256 threads
//     (8 blocks where a 16-block cluster does not fit: 16 is beyond the
//     portable size, and a card with fewer SMs per GPC, or a partition of
//     one, may not hold it).  The cluster grid-strides over the points,
//     kUnroll points per thread per step with all their loads (and the
//     pose's) issued together.
//   - without extrinsic estimation (the LIO main path) the extrinsic
//     Jacobian columns are zero, so that kernel keeps only the 6x6 pose
//     block: 30 sums per thread instead of 93, half the work per point.
//   - each thread keeps its upper-triangle sums of J^T W J, J^T W r and the
//     3 stats in registers (fused multiply-adds).  The block transposes them
//     through shared memory; each warp sums its 32 rows column by column,
//     then one thread per column sums the warps in order.
//   - every block pushes its partial into rank 0's shared memory through
//     distributed shared memory and arrives on the cluster barrier; rank 0
//     alone waits, sums the partials in rank order and writes HtH
//     (symmetric fill), Htr and stats.  The other blocks exit at once: no
//     block's own shared memory is read by another.
// No global scratch, no float atomics and a grid that does not depend on N:
// the result is bitwise repeatable and the launch can be captured in a CUDA
// graph.  fp32 throughout.  Build with -fmad=false: the gate's arithmetic
// then rounds exactly as the plain PyTorch version
// (ops/p2p.py:p2p_reduce_plain), so it decides ties alike.
//
// The launch shape was chosen by timing 128, 256 and 512 threads and 8 and
// 16 blocks on an H100 (PERF.md, Findings).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "launch_count.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kClusters[2] = {16, 8};          // blocks per cluster, in order of preference
constexpr int kUnroll = 4;                     // points per thread per step
constexpr int kErr = 24;                       // error-state dimension
constexpr int kMaxDevices = 64;
constexpr int kErrNoCluster = -1;              // the cluster does not fit on the card

// Sizes of the kernel with (kExt) or without the extrinsic block.
template <bool kExt>
struct Shape {
  static constexpr int kJ = kExt ? 12 : 6;           // Jacobian columns kept
  static constexpr int kTri = kJ * (kJ + 1) / 2;     // upper-triangle sums
  static constexpr int kAcc = kTri + kJ + 3;         // + J^T W r + 3 stats: 93 or 30
  static constexpr int kRow = kThreads + 1;          // transpose row, padded: no bank conflicts
  // dynamic shared memory: the transpose, then one partial per warp
  static constexpr int kSmemBytes =
      (kAcc * kRow + kWarps * kAcc) * static_cast<int>(sizeof(float));
  static_assert(kThreads >= kAcc, "a block must cover its sums");
};

template <int kJ>
__device__ __forceinline__ int tri_index(int a, int b) {   // a <= b
  return a * kJ - a * (a - 1) / 2 + (b - a);
}

// error-state index (0..23) -> kept Jacobian column, or -1
template <bool kExt>
__device__ __forceinline__ int active_col(int i) {
  return i < 6 ? i : (kExt && i >= 18 ? i - 12 : -1);
}

// One point: gate it and, if it is valid, add its terms to acc.  The gate
// and the Jacobian are computed in the order of p2p_reduce_plain.
template <bool kExt>
__device__ __forceinline__ void accumulate(float (&acc)[Shape<kExt>::kAcc],
                                           const float (&prm)[24], float x, float y, float z,
                                           float nx, float ny, float nz, float dp, float w,
                                           float max_resid) {
  using S = Shape<kExt>;
  const float* R = prm;
  const float* Re = prm + 9;
  const float* te = prm + 18;
  const float* pos = prm + 21;
  // body (IMU) frame: pb = Re pl + te;  world: pw = R pb + pos
  const float pbx = Re[0] * x + Re[1] * y + Re[2] * z + te[0];
  const float pby = Re[3] * x + Re[4] * y + Re[5] * z + te[1];
  const float pbz = Re[6] * x + Re[7] * y + Re[8] * z + te[2];
  const float pwx = R[0] * pbx + R[1] * pby + R[2] * pbz + pos[0];
  const float pwy = R[3] * pbx + R[4] * pby + R[5] * pbz + pos[1];
  const float pwz = R[6] * pbx + R[7] * pby + R[8] * pbz + pos[2];
  const float r = nx * pwx + ny * pwy + nz * pwz + dp;
  const float ar = fabsf(r);
  // FAST-LIO validity gate: s = 1 - 0.9 |r| / sqrt(|p_l|) > 0.9
  const float pnorm = sqrtf(x * x + y * y + z * z);
  const float s = 1.0f - 0.9f * ar / sqrtf(fmaxf(pnorm, 1e-3f));
  if (!((w > 0.0f) && (s > 0.9f) && (ar < max_resid))) return;

  // n^T R
  const float nRx = nx * R[0] + ny * R[3] + nz * R[6];
  const float nRy = nx * R[1] + ny * R[4] + nz * R[7];
  const float nRz = nx * R[2] + ny * R[5] + nz * R[8];
  float j[S::kJ];
  j[0] = nx;
  j[1] = ny;
  j[2] = nz;
  j[3] = -(nRy * pbz - nRz * pby);                 // d r / d theta = -(nR) x pb
  j[4] = -(nRz * pbx - nRx * pbz);
  j[5] = -(nRx * pby - nRy * pbx);
  if constexpr (kExt) {
    // (n^T R) Re
    const float nRRex = nRx * Re[0] + nRy * Re[3] + nRz * Re[6];
    const float nRRey = nRx * Re[1] + nRy * Re[4] + nRz * Re[7];
    const float nRRez = nRx * Re[2] + nRy * Re[5] + nRz * Re[8];
    j[6] = -(nRRey * z - nRRez * y);               // -(nR Re) x pl
    j[7] = -(nRRez * x - nRRex * z);
    j[8] = -(nRRex * y - nRRey * x);
    j[9] = nRx;                                    // d r / d t_ext
    j[10] = nRy;
    j[11] = nRz;
  }

#pragma unroll
  for (int a = 0; a < S::kJ; ++a) {
    const float ja = j[a] * w;
#pragma unroll
    for (int b = a; b < S::kJ; ++b) {
      float& sum = acc[tri_index<S::kJ>(a, b)];
      sum = __fmaf_rn(ja, j[b], sum);
    }
    acc[S::kTri + a] = __fmaf_rn(ja, r, acc[S::kTri + a]);
  }
  acc[S::kTri + S::kJ] += 1.0f;
  acc[S::kTri + S::kJ + 1] += ar;
  acc[S::kTri + S::kJ + 2] += w;
}

template <bool kExt, int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
p2p_reduce_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ dpl, const float* __restrict__ wgt,
                  const float* __restrict__ Rg, const float* __restrict__ Reg,
                  const float* __restrict__ teg, const float* __restrict__ posg, int n,
                  float max_resid, float* __restrict__ out) {
  using S = Shape<kExt>;
  extern __shared__ float red[];                  // [kAcc][kRow], then [kWarps][kAcc]
  __shared__ float slots[kCluster * S::kAcc];     // every block's partial (rank 0)
  __shared__ float tot[S::kAcc];                  // the cluster's total (rank 0)
  // announce that this block runs: no block writes into rank 0's shared
  // memory before rank 0 has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  count_launch();
  const int tid = threadIdx.x;
  const unsigned rank = cg::this_cluster().block_rank();

  float prm[24];                                  // R (9, row-major), Re (9), te (3), pos (3)
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    prm[k] = __ldg(Rg + k);
    prm[9 + k] = __ldg(Reg + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    prm[18 + k] = __ldg(teg + k);
    prm[21 + k] = __ldg(posg + k);
  }

  float acc[S::kAcc];
#pragma unroll
  for (int k = 0; k < S::kAcc; ++k) acc[k] = 0.0f;

  // A block with no points still reaches the cluster barrier below.
  // 64-bit indices: base + u * stride may pass INT_MAX near the end
  constexpr long long stride = kCluster * kThreads;
  for (long long base = rank * kThreads + tid; base < n; base += kUnroll * stride) {
    float x[kUnroll], y[kUnroll], z[kUnroll], nx[kUnroll], ny[kUnroll], nz[kUnroll];
    float dp[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      const bool in = i < n;
      x[u] = in ? pts[3 * i] : 0.0f;
      y[u] = in ? pts[3 * i + 1] : 0.0f;
      z[u] = in ? pts[3 * i + 2] : 0.0f;
      nx[u] = in ? nrm[3 * i] : 0.0f;
      ny[u] = in ? nrm[3 * i + 1] : 0.0f;
      nz[u] = in ? nrm[3 * i + 2] : 0.0f;
      dp[u] = in ? dpl[i] : 0.0f;
      w[u] = in ? wgt[i] : 0.0f;                  // w = 0 fails the gate
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      accumulate<kExt>(acc, prm, x[u], y[u], z[u], nx[u], ny[u], nz[u], dp[u], w[u], max_resid);
  }

  // block reduction in a fixed order: transpose, each warp sums its 32
  // rows of each column, then one thread per column sums the warps
  float* wsum = red + S::kAcc * S::kRow;
#pragma unroll
  for (int k = 0; k < S::kAcc; ++k) red[k * S::kRow + tid] = acc[k];
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = lane; k < S::kAcc; k += 32) {
    const float* col = red + k * S::kRow + warp * 32;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int t = 0; t < 32; t += 4) {
      s0 += col[t];
      s1 += col[t + 1];
      s2 += col[t + 2];
      s3 += col[t + 3];
    }
    wsum[warp * S::kAcc + k] = (s0 + s1) + (s2 + s3);
  }
  __syncthreads();
  float part = 0.0f;
  if (tid < S::kAcc) {
#pragma unroll 8
    for (int wi = 0; wi < kWarps; ++wi) part += wsum[wi * S::kAcc + tid];
  }

  // push the partial to rank 0 and arrive; only rank 0 waits for them all
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");    // every block runs
  if (tid < S::kAcc)
    cg::this_cluster().map_shared_rank(&slots[0], 0)[rank * S::kAcc + tid] = part;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // releases the push
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");    // acquires every push
  if (tid < S::kAcc) {
    float v = 0.0f;
#pragma unroll
    for (int b = 0; b < kCluster; ++b) v += slots[b * S::kAcc + tid];
    tot[tid] = v;
  }
  __syncthreads();

  for (int o = tid; o < kErr * kErr; o += kThreads) {
    const int a = active_col<kExt>(o / kErr), b = active_col<kExt>(o % kErr);
    out[o] = (a < 0 || b < 0) ? 0.0f
                              : tot[a <= b ? tri_index<S::kJ>(a, b) : tri_index<S::kJ>(b, a)];
  }
  if (tid < kErr) {
    const int a = active_col<kExt>(tid);
    out[kErr * kErr + tid] = a < 0 ? 0.0f : tot[S::kTri + a];
  }
  if (tid < 3) out[kErr * kErr + kErr + tid] = tot[S::kTri + S::kJ + tid];
}

template <bool kExt, int kCluster>
cudaLaunchConfig_t launch_config(cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Shape<kExt>::kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Kernel attributes on the current device, and whether one cluster fits:
// 0, kErrNoCluster, or a CUDA error.
template <bool kExt, int kCluster>
int configure() {
  cudaError_t err = cudaSuccess;
  if (kCluster > 8) {
    err = cudaFuncSetAttribute(p2p_reduce_kernel<kExt, kCluster>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(p2p_reduce_kernel<kExt, kCluster>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<kExt>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<kExt, kCluster>(nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, p2p_reduce_kernel<kExt, kCluster>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return clusters >= 1 ? 0 : kErrNoCluster;
}

template <int kCluster>
int configure_both() {
  const int s = configure<false, kCluster>();
  return s != 0 ? s : configure<true, kCluster>();
}

// Whether both kernels of cluster size kClusters[k] are set up on the
// device, configured once per device; the result is kept.
int configured(int k, int device) {
  static std::once_flag once[2][kMaxDevices];
  static int status[2][kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[k][device], [k, device] {
    status[k][device] = k == 0 ? configure_both<kClusters[0]>() : configure_both<kClusters[1]>();
    cudaGetLastError();   // a size that failed here must not fail a later launch
  });
  return status[k][device];
}

// Sets *size to the first of kClusters that fits on the device and returns
// 0; else returns kErrNoCluster or a CUDA error.
int chosen_cluster(int device, int* size) {
  int status = kErrNoCluster;
  for (int k = 0; k < 2; ++k) {
    status = configured(k, device);
    if (status == 0) {
      *size = kClusters[k];
      break;
    }
  }
  return status;
}

template <bool kExt, int kCluster>
cudaError_t launch(const float* pts, const float* nrm, const float* dpl, const float* wgt,
                   const float* R, const float* Re, const float* te, const float* pos, int n,
                   float max_resid, float* out, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config<kExt, kCluster>(stream, &attr);
  return cudaLaunchKernelEx(&cfg, p2p_reduce_kernel<kExt, kCluster>, pts, nrm, dpl, wgt, R, Re,
                            te, pos, n, max_resid, out);
}

template <int kCluster>
cudaError_t launch_sized(bool est_ext, const float* pts, const float* nrm, const float* dpl,
                         const float* wgt, const float* R, const float* Re, const float* te,
                         const float* pos, int n, float max_resid, float* out,
                         cudaStream_t stream) {
  return est_ext
      ? launch<true, kCluster>(pts, nrm, dpl, wgt, R, Re, te, pos, n, max_resid, out, stream)
      : launch<false, kCluster>(pts, nrm, dpl, wgt, R, Re, te, pos, n, max_resid, out, stream);
}

// Runs fn() with `device` current, restoring the caller's device after.
template <typename Fn>
int on_device(int device, Fn fn) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int status = fn();
  if (current != device) cudaSetDevice(current);
  return status;
}

}  // namespace

extern "C" {

// Launch the reduction on `stream` of device `device`.  All pointers are
// device pointers to contiguous float32: pts (n, 3), nrm (n, 3), dpl (n),
// wgt (n), R (3, 3), Re (3, 3), te (3), pos (3), and out (24*24 + 24 + 3)
// = HtH (24, 24), Htr (24), stats (3) = [n_valid, sum |r|, sum w].
// est_ext != 0 adds the extrinsic Jacobian block.  cluster is the number of
// blocks in the cluster: 0 for the device's choice (p2p_reduce_shape), or
// 16 or 8 to ask for that size.  Returns 0 once launched, -1 when the
// cluster does not fit on the card, else the CUDA error code.
int p2p_reduce_launch(const float* pts, const float* nrm, const float* dpl,
                      const float* wgt, const float* R, const float* Re, const float* te,
                      const float* pos, int n, float max_resid, int est_ext, int cluster,
                      float* out, int device, void* stream) {
  return on_device(device, [=] {
    int size = cluster;
    if (size == 0) {
      const int status = chosen_cluster(device, &size);
      if (status != 0) return status;
    } else if (size != kClusters[0] && size != kClusters[1]) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      const int status = configured(size == kClusters[0] ? 0 : 1, device);
      if (status != 0) return status;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        size == kClusters[0]
            ? launch_sized<kClusters[0]>(est_ext, pts, nrm, dpl, wgt, R, Re, te, pos, n,
                                         max_resid, out, s)
            : launch_sized<kClusters[1]>(est_ext, pts, nrm, dpl, wgt, R, Re, te, pos, n,
                                         max_resid, out, s);
    if (err == cudaSuccess) err = cudaGetLastError();
    return static_cast<int>(err);
  });
}

// The launch shape p2p_reduce_launch uses on `device` when it is given
// cluster 0: *blocks in the cluster (16 where a 16-block cluster of both
// kernels fits, else 8) and *threads per block.  Returns 0, -1 when
// neither size fits, else the CUDA error code.
int p2p_reduce_shape(int device, int* blocks, int* threads) {
  *threads = kThreads;
  return on_device(device, [=] { return chosen_cluster(device, blocks); });
}

// The launches of this library's kernel on `device` since the last reset
// (csrc/launch_count.cuh); zeroes them when reset != 0.  Waits for the
// device.  Returns 0, else the CUDA error code.
int p2p_reduce_launch_count(int device, int reset, unsigned long long* count) {
  return read_launch_count(device, reset, count);
}

}  // extern "C"
