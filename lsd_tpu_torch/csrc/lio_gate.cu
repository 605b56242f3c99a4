// Degeneracy gate of the LIO iteration, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: lsd_tpu/slam/lio.py:_gate_degenerate runs
// jnp.linalg.eigh on the 6x6 pose block of H^T H and jnp.linalg.eigvalsh on
// its 3x3 block A[3:6, 3:6], which XLA compiled.  On the card
// torch.linalg.eigh and eigvalsh each wait for the host twice (inside
// cuSOLVER and at their error check): 16 waits a scan at 4 iterations, and
// a step that waits cannot be captured in a CUDA graph.  This kernel
// computes the same function in one launch that never waits, allocates
// nothing and reads nothing back, so the iteration can be replayed as a
// graph.  The formulas are those of slam/lio.py:_gate_degenerate_plain, the
// plain PyTorch version the kernel is held to:
//   - A = the 6x6 pose block, read from its lower triangle (as eigh reads
//     it); its eigen-decomposition A = V diag(lam) V^T; keep_k = lam_k >=
//     degen_thresh; E = the 24x24 identity with Pi = V diag(keep) V^T in its
//     top-left 6x6 block; n_degenerate = 6 - sum(keep);
//   - the eigenvalues mu of A[3:6, 3:6] (lower triangle);
//     n_weak = #{mu_k < degen_rel_frac * max(mu)}.
// Both decompositions are exact symmetric ones: cyclic Jacobi, run to
// convergence (the off-diagonal mass below 1e-26 of the matrix's, about
// 1e-13 of its norm, or at most kMaxSweeps sweeps, which a finite matrix
// never reaches: Jacobi converges quadratically, in 5-8 sweeps at 6x6), in
// float64; inputs and outputs are float32.
//
// Bound on an H100 SXM: it reads 144 B (the 6x6 block) and writes 2,312 B
// (E and two counts): under 1 ns at 3.35 TB/s; a sweep is ~1,500 flops.
// Neither bounds it: it is a chain of dependent rotations, bound by their
// latency.  The design shortens the chain: one block of 64 threads; warp 0
// runs the 6x6 Jacobi in the parallel round-robin order (5 rounds a sweep,
// each 3 disjoint rotations applied at once: every lane updates one or two
// of the 36 entries of A and of V), synchronising with __syncwarp only;
// lane 0 of warp 1 meanwhile runs the 3x3 one serially in registers.  The
// sums of Pi are taken in a fixed order and no sum uses atomics: the result
// is bitwise repeatable.
#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kN = 6;                  // the pose block
constexpr int kErr = 24;               // error-state dimension: E is kErr x kErr
constexpr int kThreads = 64;
constexpr int kMaxSweeps = 40;
constexpr double kTol = 1e-26;         // off-diagonal mass / total mass at convergence

// the round-robin pairing of 6 indices: 5 rounds of 3 disjoint pairs cover
// each of the 15 pairs once
__constant__ int kPairs[5][3][2] = {
    {{0, 5}, {1, 4}, {2, 3}},
    {{0, 4}, {3, 5}, {1, 2}},
    {{0, 3}, {2, 4}, {1, 5}},
    {{0, 2}, {1, 3}, {4, 5}},
    {{0, 1}, {2, 5}, {3, 4}},
};

// (c, s) of the rotation G (G_pp = G_qq = c, G_pq = s, G_qp = -s) for which
// (G^T A G)_pq = 0 (Golub and Van Loan, the symmetric Schur decomposition)
__device__ __forceinline__ void schur2(double app, double aqq, double apq, double& c,
                                       double& s) {
  if (apq == 0.0) {
    c = 1.0;
    s = 0.0;
    return;
  }
  const double tau = (aqq - app) / (2.0 * apq);
  const double t = (tau >= 0.0 ? 1.0 : -1.0) / (fabs(tau) + sqrt(1.0 + tau * tau));
  c = 1.0 / sqrt(1.0 + t * t);
  s = t * c;
}

// eigenvalues of a symmetric 3x3 in b (overwritten; they end on its diagonal)
__device__ void jacobi3(double b[3][3]) {
  constexpr int kP[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0, all = 0.0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const double v = b[i][j] * b[i][j];
        all += v;
        if (i != j) off += v;
      }
    if (!(off > kTol * all)) break;    // converged (or not finite)
    for (int r = 0; r < 3; ++r) {
      const int p = kP[r][0], q = kP[r][1];
      double c, s;
      schur2(b[p][p], b[q][q], b[p][q], c, s);
      for (int k = 0; k < 3; ++k) {    // columns: B G
        const double bkp = b[k][p], bkq = b[k][q];
        b[k][p] = c * bkp - s * bkq;
        b[k][q] = s * bkp + c * bkq;
      }
      for (int k = 0; k < 3; ++k) {    // rows: G^T (B G)
        const double bpk = b[p][k], bqk = b[q][k];
        b[p][k] = c * bpk - s * bqk;
        b[q][k] = s * bpk + c * bqk;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lio_gate_kernel(const float* __restrict__ hth, int s_row, int s_col, float degen_thresh,
                float degen_rel_frac, float* __restrict__ E, int* __restrict__ counts) {
  __shared__ double a[kN][kN];
  __shared__ double v[kN][kN];
  __shared__ double rot_c[kN], rot_s[kN];
  __shared__ int mate[kN];
  __shared__ float pi[kN][kN];
  __shared__ int n_weak;
  count_launch();
  const int tid = threadIdx.x;

  if (tid < kN * kN) {
    const int i = tid / kN, j = tid % kN;
    const int r = i > j ? i : j, c = i > j ? j : i;          // the lower triangle
    a[i][j] = static_cast<double>(hth[r * s_row + c * s_col]);
    v[i][j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();

  if (tid < 32) {
    // the 6x6 pose block: lane handles entries e0 = lane and e1 = lane + 32
    const int lane = tid;
    const int e0 = lane, e1 = lane + 32;
    const bool has1 = e1 < kN * kN;
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
      double off = 0.0, all = 0.0;
      {
        const int i = e0 / kN, j = e0 % kN;
        const double x = a[i][j] * a[i][j];
        all += x;
        if (i != j) off += x;
      }
      if (has1) {
        const int i = e1 / kN, j = e1 % kN;
        const double x = a[i][j] * a[i][j];
        all += x;
        if (i != j) off += x;
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        off += __shfl_xor_sync(0xffffffffu, off, m);
        all += __shfl_xor_sync(0xffffffffu, all, m);
      }
      if (!(off > kTol * all)) break;  // the same on every lane
      for (int round = 0; round < 5; ++round) {
        if (lane < 3) {
          const int p = kPairs[round][lane][0], q = kPairs[round][lane][1];
          double c, s;
          schur2(a[p][p], a[q][q], a[p][q], c, s);
          rot_c[p] = c;
          rot_c[q] = c;
          rot_s[p] = -s;                 // G_qp: column p's entry at its mate
          rot_s[q] = s;                  // G_pq: column q's entry at its mate
          mate[p] = q;
          mate[q] = p;
        }
        __syncwarp();
        // A' = G^T A G and V' = V G: column j of G holds c at j and
        // rot_s[j] at mate[j]
        double na0, nv0, na1 = 0.0, nv1 = 0.0;
        {
          const int i = e0 / kN, j = e0 % kN, mi = mate[i], mj = mate[j];
          const double ci = rot_c[i], si = rot_s[i], cj = rot_c[j], sj = rot_s[j];
          na0 = ci * cj * a[i][j] + ci * sj * a[i][mj] + si * cj * a[mi][j]
                + si * sj * a[mi][mj];
          nv0 = v[i][j] * cj + v[i][mj] * sj;
        }
        if (has1) {
          const int i = e1 / kN, j = e1 % kN, mi = mate[i], mj = mate[j];
          const double ci = rot_c[i], si = rot_s[i], cj = rot_c[j], sj = rot_s[j];
          na1 = ci * cj * a[i][j] + ci * sj * a[i][mj] + si * cj * a[mi][j]
                + si * sj * a[mi][mj];
          nv1 = v[i][j] * cj + v[i][mj] * sj;
        }
        __syncwarp();
        a[e0 / kN][e0 % kN] = na0;
        v[e0 / kN][e0 % kN] = nv0;
        if (has1) {
          a[e1 / kN][e1 % kN] = na1;
          v[e1 / kN][e1 % kN] = nv1;
        }
        __syncwarp();
      }
    }
  } else if (tid == 32) {
    // the 3x3 block A[3:6, 3:6], from the input (warp 0 rotates a[][])
    double b[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const int r = 3 + (i > j ? i : j), c = 3 + (i > j ? j : i);
        b[i][j] = static_cast<double>(hth[r * s_row + c * s_col]);
      }
    jacobi3(b);
    const double mu_max = fmax(fmax(b[0][0], b[1][1]), b[2][2]);
    const double bar = static_cast<double>(degen_rel_frac) * mu_max;
    n_weak = (b[0][0] < bar) + (b[1][1] < bar) + (b[2][2] < bar);
  }
  __syncthreads();

  if (tid < kN * kN) {
    const int i = tid / kN, j = tid % kN;
    const double thresh = static_cast<double>(degen_thresh);
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      if (a[k][k] >= thresh) sum += v[i][k] * v[j][k];
    pi[i][j] = static_cast<float>(sum);
  }
  __syncthreads();

  for (int e = tid; e < kErr * kErr; e += kThreads) {
    const int i = e / kErr, j = e % kErr;
    E[e] = (i < kN && j < kN) ? pi[i][j] : (i == j ? 1.0f : 0.0f);
  }
  if (tid == 0) {
    const double thresh = static_cast<double>(degen_thresh);
    int kept = 0;
    for (int k = 0; k < kN; ++k) kept += a[k][k] >= thresh;
    counts[0] = kN - kept;
    counts[1] = n_weak;
  }
}

}  // namespace

extern "C" {

// Launch the gate on `stream` of device `device`.  hth points at the
// float32 H^T H (at least 6x6) with strides s_row, s_col in elements; E
// (24, 24) float32 contiguous and counts (2,) int32 [n_degenerate, n_weak]
// receive the result.  Returns 0 once launched, else the CUDA error code.
int lio_gate_launch(const float* hth, int s_row, int s_col, float degen_thresh,
                    float degen_rel_frac, float* E, int* counts, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  lio_gate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hth, s_row, s_col, degen_thresh, degen_rel_frac, E, counts);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// The launches of this library's kernel on `device` since the last reset
// (csrc/launch_count.cuh); zeroes them when reset != 0.  Waits for the
// device.  Returns 0, else the CUDA error code.
int lio_gate_launch_count(int device, int reset, unsigned long long* count) {
  return read_launch_count(device, reset, count);
}

}  // extern "C"
