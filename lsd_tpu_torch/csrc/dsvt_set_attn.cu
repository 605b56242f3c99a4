// Set attention of DSVT (Wang et al., CVPR 2023), hand-written for Hopper (sm_90a).
//
// Replaces no kernel of the JAX package, which has no transformer: it was
// added for the DSVT-Pillar detector (models/dsvt.py).  One launch computes
// one set-attention layer over every set of a frame: each set gathers the
// rows of its 36 slots from the per-pillar Q, K and V (projected beforehand,
// which is the same mathematics as projecting the gathered rows), masks the
// slots that repeat the slot before them as keys, runs 8-head softmax
// attention over the set with float32 scores, sums and softmax, and writes
// each pillar's output from the slot the partition marks as its first.
// The formulas and their order are those of models/dsvt.py:
// set_attention_plain, the plain PyTorch version the kernel is held to.
//
// Bound on an H100 SXM: per pillar the kernel reads its Q, K and V rows
// (3 x 192 bf16) and writes one output row (192 bf16); per slot an index
// and a flag.  At ~55k pillars and ~2k sets a layer that is ~85 MB, 25 us
// at 3.35 TB/s, against ~2 GFLOP (2 x 2 x 36 x 36 x 192 a set), 2 us at the
// bf16 tensor-core peak: bound by memory, and by the latency of its
// gathers, which are rows scattered over the pillar table.
// The design answers that with one block a set and everything of the set in
// shared memory:
//   - 288 threads, one per (head, query slot).  The set's K and V rows are
//     gathered once into shared memory with 16-byte loads (27 KB a set), so
//     each row of the pillar table is read once a set, not once a query.
//   - a thread keeps its query's 24 values and 36 scores in registers; the
//     threads of a warp share their head, so their reads of K and V in
//     shared memory are broadcasts.
//   - only the slots that write a pillar compute: a repeated slot's query
//     is never used.
//   - a set past the frame's count (its first flag clear) exits at once:
//     the launch covers the static set capacity and reads the frame's count
//     from the flags on the card, so no host sync decides its size.
// No atomics, a fixed order of every sum and one writer a row: the result is
// bitwise repeatable, and the launch (no allocation, no sync) can be
// captured in a CUDA graph.  Built with -fmad=false like every kernel of
// the package.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTau = 36;                       // set size
constexpr int kD = 192;                        // d_model
constexpr int kHeads = 8;
constexpr int kHd = kD / kHeads;               // 24 a head
constexpr int kThreads = kTau * kHeads;        // one per (head, query slot)
constexpr int kChunks = kD / 8;                // 16-byte chunks a row
constexpr unsigned char kKey = 1;              // the slot is a key of its set
constexpr unsigned char kWrite = 2;            // the slot writes its pillar's output

__global__ void __launch_bounds__(kThreads)
dsvt_set_attn_kernel(const __nv_bfloat16* __restrict__ q, long long q_stride,
                     const __nv_bfloat16* __restrict__ k, long long k_stride,
                     const __nv_bfloat16* __restrict__ v, long long v_stride,
                     const int* __restrict__ inds, const unsigned char* __restrict__ flags,
                     float scale, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 sK[kTau][kD];
  __shared__ __align__(16) __nv_bfloat16 sV[kTau][kD];
  __shared__ int sInd[kTau];
  __shared__ unsigned char sFlag[kTau];

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTau;
  // a set in use has its first slot as a key; the test is uniform over the block
  if (!(flags[base] & kKey)) return;
  if (tid < kTau) {
    sInd[tid] = inds[base + tid];
    sFlag[tid] = flags[base + tid];
  }
  __syncthreads();
  for (int c = tid; c < kTau * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const long long p = sInd[row];
    *reinterpret_cast<uint4*>(&sK[row][col]) =
        *reinterpret_cast<const uint4*>(k + p * k_stride + col);
    *reinterpret_cast<uint4*>(&sV[row][col]) =
        *reinterpret_cast<const uint4*>(v + p * v_stride + col);
  }
  __syncthreads();

  const int h = tid / kTau, i = tid % kTau;
  if (!(sFlag[i] & kWrite)) return;           // no barrier follows
  const long long p = sInd[i];
  const int c0 = h * kHd;

  float qf[kHd];
  const __nv_bfloat162* qrow = reinterpret_cast<const __nv_bfloat162*>(q + p * q_stride + c0);
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d) {
    const float2 f = __bfloat1622float2(qrow[d]);
    qf[2 * d] = f.x;
    qf[2 * d + 1] = f.y;
  }

  float s[kTau];
  const float neg_inf = __int_as_float(static_cast<int>(0xff800000u));
  float m = neg_inf;
#pragma unroll
  for (int j = 0; j < kTau; ++j) {
    const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(&sK[j][c0]);
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kHd / 2; ++d) {
      const float2 f = __bfloat1622float2(krow[d]);
      acc += qf[2 * d] * f.x;
      acc += qf[2 * d + 1] * f.y;
    }
    s[j] = (sFlag[j] & kKey) ? acc * scale : neg_inf;
    m = fmaxf(m, s[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kTau; ++j) {
    s[j] = expf(s[j] - m);                    // a masked key: exp(-inf) = 0
    sum += s[j];
  }

  float o[kHd];
#pragma unroll
  for (int d = 0; d < kHd; ++d) o[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < kTau; ++j) {
    const __nv_bfloat162* vrow = reinterpret_cast<const __nv_bfloat162*>(&sV[j][c0]);
#pragma unroll
    for (int d = 0; d < kHd / 2; ++d) {
      const float2 f = __bfloat1622float2(vrow[d]);
      o[2 * d] += s[j] * f.x;
      o[2 * d + 1] += s[j] * f.y;
    }
  }
  const float inv = 1.0f / sum;
  __align__(16) __nv_bfloat162 packed[kHd / 2];
#pragma unroll
  for (int d = 0; d < kHd / 2; ++d)
    packed[d] = __floats2bfloat162_rn(o[2 * d] * inv, o[2 * d + 1] * inv);
  uint4* dst = reinterpret_cast<uint4*>(out + p * kD + c0);
  const uint4* src = reinterpret_cast<const uint4*>(packed);
#pragma unroll
  for (int c = 0; c < kHd / 8; ++c) dst[c] = src[c];
}

}  // namespace

extern "C" {

// Launch one set-attention layer on `stream` of device `device`.  q, k and
// v are bf16 device pointers to (P, 192) rows with row strides q_stride,
// k_stride and v_stride in elements (multiples of 8, the pointers 16-byte
// aligned); inds (n_sets, 36) int32 pillar rows and flags (n_sets, 36)
// bytes (1: the slot is a key, 2: it writes its pillar) of the partition;
// scale multiplies each score; out (P, 192) bf16, contiguous, receives the
// rows of the pillars whose first slot lies in a set in use and is left as
// it is elsewhere.  Returns 0 once launched, else the CUDA error code.
int dsvt_set_attn_launch(const void* q, long long q_stride, const void* k, long long k_stride,
                         const void* v, long long v_stride, const int* inds,
                         const unsigned char* flags, int n_sets, float scale, void* out,
                         int device, void* stream) {
  if (n_sets < 1) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  dsvt_set_attn_kernel<<<n_sets, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), q_stride, static_cast<const __nv_bfloat16*>(k),
      k_stride, static_cast<const __nv_bfloat16*>(v), v_stride, inds, flags, scale,
      static_cast<__nv_bfloat16*>(out));
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
