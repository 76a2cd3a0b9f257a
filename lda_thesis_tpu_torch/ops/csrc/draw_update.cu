// One position of the exact dense collapsed-Gibbs sweep on Hopper (sm_90a).
//
// Replaces the TPU kernel lda_thesis_tpu/ops/gibbs_pallas.py::_build
// (pallas_call at gibbs_pallas.py:87, called through fused_draw_update): for
// every document row d at one type position, with f = f[d], z_old = z_old[d]:
//   n       = n_dk[d, k] - ((k == z_old) ? f : 0)
//   w[k]    = ((labs[d, k] * (n + alpha)) * (cv[d, k] + beta)) * recip[k]
//   c       = inclusive cumsum of w over the K topics (order below)
//   z_new   = #{k < K : c[k] < u[d] * c[K-1]}, kept at z_old where f == 0
//   n_dk[d, z_old] -= f;  n_dk[d, z_new] += f           (in place)
//   dnk[z_old] -= f;      dnk[z_new] += f                (atomics, all rows)
// The caller decrements and gathers the topic-word row cv = n_vk[v] and forms
// recip = 1/(n_k - dec + V*beta) before the launch, and commits the increment
// to n_vk after it, as the reference does (lda_thesis_tpu/ops/gibbs.py:175-188).
//
// Summation order of c (draw_update_torch in draw_update_cuda.py repeats it):
// lane l of the row's warp owns the contiguous topics [l*P, (l+1)*P) with
// P = ceil(K/32); it sums its w in order starting from 0 (p), the lane totals
// are scanned across the warp (Hillis-Steele, offsets 1..16, inclusive), and
// c[k] = base_l + p[k] with base_l the scan at lane l-1 (0 for lane 0).  All
// in float32 with no FMA contraction (built with -fmad=false).  Counts are
// integers below 2^24 in float32, so the count updates and the atomics onto
// dnk are exact in any order.
//
// Design.  One warp per document row, rows independent.  Each lane walks its
// P topics twice: once for its total, once, after the warp scan has given the
// row total, to count the c below the draw; the second pass re-reads the row
// from L1/L2 and repeats the first pass's operations bit for bit.  Lane 0
// applies the two count updates and the two atomics.  A row with f == 0 only
// copies z_old.  Rows past D are not launched; there is no padding.
//
// Bound on this card.  Each live row (f > 0) must read its n_dk, cv and labs
// rows ((K,) float32 each) and write two n_dk elements, so a launch moves
// about 12*live*K bytes against about 8 fp32 operations per (row, topic): the
// bytes bound it (3.35 TB/s), e.g. 3.0 us at the first position of the
// widest dense Labeled-LDA bucket (1,653 live rows, K = 512).  The launch
// overhead is of the same order, and the exact sweep makes one launch per
// type position with a handful of small PyTorch ops around it, so the path
// is bound by the host, not by this kernel (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float weight(const float* __restrict__ labs,
                                        const float* ndk,
                                        const float* __restrict__ cv,
                                        const float* __restrict__ recip,
                                        size_t row, int k, int z_old, float f,
                                        float alpha, float beta) {
  const float n = ndk[row + k] - ((k == z_old) ? f : 0.0f);
  float w = labs[row + k] * (n + alpha);
  w = w * (cv[row + k] + beta);
  return w * recip[k];
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
draw_update_kernel(const float* __restrict__ u,      // (D,)
                   const float* __restrict__ f,      // (D,)
                   const int* __restrict__ z_old,    // (D,)
                   const float* __restrict__ labs,   // (D, K)
                   float* ndk,                       // (D, K), updated in place
                   const float* __restrict__ cv,     // (D, K)
                   const float* __restrict__ recip,  // (K,)
                   int* __restrict__ z_new,          // (D,)
                   float* __restrict__ dnk,          // (K,), zeroed by the caller
                   int D, int K, float alpha, float beta) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= D) return;  // warp-uniform: the whole warp leaves together
  const float fd = f[d];
  const int zo = z_old[d];
  if (fd == 0.0f) {  // warp-uniform
    if (lane == 0) z_new[d] = zo;
    return;
  }
  const size_t row = (size_t)d * K;
  const int per = (K + 31) / 32;
  const int k0 = min(lane * per, K);
  const int k1 = min(k0 + per, K);

  float s = 0.0f;
  for (int k = k0; k < k1; ++k)
    s = s + weight(labs, ndk, cv, recip, row, k, zo, fd, alpha, beta);

  float incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl = incl + y;
  }
  float base = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) base = 0.0f;
  const float total = __shfl_sync(kFullMask, base + s, (K - 1) / per);
  const float r = u[d] * total;

  int below = 0;
  float p = 0.0f;
  for (int k = k0; k < k1; ++k) {
    p = p + weight(labs, ndk, cv, recip, row, k, zo, fd, alpha, beta);
    below += (base + p < r) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_xor_sync(kFullMask, below, off);

  if (lane == 0) {
    const int zn = min(below, K - 1);
    z_new[d] = zn;
    ndk[row + zo] = ndk[row + zo] - fd;
    ndk[row + zn] = ndk[row + zn] + fd;
    atomicAdd(dnk + zo, -fd);
    atomicAdd(dnk + zn, fd);
  }
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int draw_update_launch(const float* u, const float* f,
                                  const int* z_old, const float* labs,
                                  float* ndk, const float* cv,
                                  const float* recip, int* z_new, float* dnk,
                                  int D, int K, float alpha, float beta,
                                  void* stream) {
  const int blocks = (D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  draw_update_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      u, f, z_old, labs, ndk, cv, recip, z_new, dnk, D, K, alpha, beta);
  return (int)cudaGetLastError();
}
