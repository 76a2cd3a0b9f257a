// Merge-block collapsed-Gibbs sampler for Labeled LDA on Hopper (sm_90a).
//
// Replaces the TPU kernel lda_thesis_tpu/ops/gibbs_fused.py::_build_block_kernel
// (pallas_call at gibbs_fused.py:334): M sweeps over the U type positions of
// every document against a topic-word table frozen at block start, on each
// document's compact A-slot label support.  The caller gathers the frozen
// per-slot counts (cv) and commits the count deltas after the block.
//
// Per position p with f > 0 (all in float32, no FMA contraction: built with
// -fmad=false; the plain version fused_block_torch in fused_block_cuda.py
// repeats this order exactly):
//   own     = (a == z0[p]) ? f : 0          own token's block-start count
//   ndk_m   = n_dk - ((a == z[p]) ? f : 0)  live doc-topic count, minus own
//   w       = ((valid * (ndk_m + alpha)) * ((cv - own) + beta)) * rcp_rn(nkg - own)
//   c       = inclusive Hillis-Steele scan of w over the slots: offsets
//             1, 2, 4, 8, 16, each step c[a] = c[a] + c[a - off] for a >= off
//   z'      = #{a < A : c[a] < u * c[A-1]}
//   n_dk    = ndk_m + ((a == z') ? f : 0)
// A position with f == 0 keeps its z and leaves n_dk unchanged, so it is
// skipped (the plain version computes it and discards the draw: the same
// bits, since x - 0 + 0 == x).
//
// Design.  Documents are independent within a block (the table is frozen), so
// one warp owns one document and lane a owns slot a (A <= 32).  n_dk, valid
// and nkg live in one register per lane for the whole block; the document's
// z, z0 and f sit in shared memory.  The cumsum is a warp scan of shuffles, the
// draw one ballot + popc.  Inputs per position are one contiguous A-float row
// of cv (layout (D, U, A)) and one uniform.
//
// Bound on this card.  The block reads cv (4·A·U·D bytes) and the uniforms
// (4·M·U·D bytes) once and does about a dozen fp32 operations per (slot,
// position with f > 0, sweep).  At the main path's shapes (depth-3 abstracts,
// A = 24, M = 25, four buckets) that is 51 MB and 1.34 GFLOP per merge block,
// so the fp32 rate (67 TFLOP/s) bounds it at 20 us; the bytes alone would take
// 15 us at 3.35 TB/s.  This design does not approach that (2.8 ms per block
// on an H100 SXM at 700 W, PERF.md): each warp walks M·U positions one after
// another, each step a chain of dependent shuffles behind two loads, so the
// kernel is bound by that latency chain and by the number of resident warps
// (one per document, ~1k per bucket against 132 SMs x 64 warps).  Keeping cv
// in shared memory across the M sweeps, or overlapping several documents per
// warp, is work for a later change.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_block_kernel(const float* __restrict__ cv,     // (D, U, A)
                   const float* __restrict__ f,      // (U, D)
                   const float* __restrict__ uni,    // (M, U, D)
                   const int* __restrict__ z0,       // (U, D)
                   const float* __restrict__ nkg,    // (A, D), pre-biased by V*beta
                   const float* __restrict__ valid,  // (A, D)
                   const float* __restrict__ ndk0,   // (A, D)
                   int* __restrict__ z_out,          // (U, D)
                   float* __restrict__ ndk_out,      // (A, D)
                   int M, int U, int A, int D, float alpha, float beta) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + warp;
  if (d >= D) return;  // warp-uniform: the whole warp leaves together

  int* z_cur = smem + warp * 3 * U;  // current slot of each position
  int* z_start = z_cur + U;          // block-start slot of each position
  float* f_doc = reinterpret_cast<float*>(z_start + U);
  for (int p = lane; p < U; p += 32) {
    const int z = z0[(size_t)p * D + d];
    z_cur[p] = z;
    z_start[p] = z;
    f_doc[p] = f[(size_t)p * D + d];
  }
  __syncwarp();

  const bool live = lane < A;
  float ndk = live ? ndk0[(size_t)lane * D + d] : 0.0f;
  const float vl = live ? valid[(size_t)lane * D + d] : 0.0f;
  const float nk = live ? nkg[(size_t)lane * D + d] : 1.0f;
  const float* cv_doc = cv + (size_t)d * U * A;

  for (int m = 0; m < M; ++m) {
    const float* u_sweep = uni + (size_t)m * U * D + d;
    for (int p = 0; p < U; ++p) {
      const float fp = f_doc[p];
      if (fp == 0.0f) continue;  // warp-uniform
      const float up = u_sweep[(size_t)p * D];
      const float cvp = live ? cv_doc[(size_t)p * A + lane] : 0.0f;
      const int zs = z_start[p];
      const int zo = z_cur[p];

      const float own = (lane == zs) ? fp : 0.0f;
      const float ndk_m = ndk - ((lane == zo) ? fp : 0.0f);
      const float cv_eff = cvp - own;
      const float nk_eff = nk - own;
      float w = vl * (ndk_m + alpha);
      w = w * (cv_eff + beta);
      w = w * __frcp_rn(nk_eff);

      float c = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFullMask, c, off);
        if (lane >= off) c = c + y;
      }
      const float r = up * __shfl_sync(kFullMask, c, A - 1);
      const int zn = __popc(__ballot_sync(kFullMask, live && c < r));

      ndk = ndk_m + ((lane == zn) ? fp : 0.0f);
      if (lane == 0) z_cur[p] = zn;
      __syncwarp();
    }
  }

  for (int p = lane; p < U; p += 32) z_out[(size_t)p * D + d] = z_cur[p];
  if (live) ndk_out[(size_t)lane * D + d] = ndk;
}

}  // namespace

extern "C" size_t fused_block_smem_bytes(int U) {
  return (size_t)kWarpsPerBlock * 3 * U * sizeof(int);
}

// Launches the kernel on `stream`; returns cudaGetLastError() as an int.
extern "C" int fused_block_launch(const float* cv, const float* f,
                                  const float* uni, const int* z0,
                                  const float* nkg, const float* valid,
                                  const float* ndk0, int* z_out,
                                  float* ndk_out, int M, int U, int A, int D,
                                  float alpha, float beta, void* stream) {
  const size_t smem = fused_block_smem_bytes(U);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_block_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, M, U, A, D, alpha,
      beta);
  return (int)cudaGetLastError();
}
