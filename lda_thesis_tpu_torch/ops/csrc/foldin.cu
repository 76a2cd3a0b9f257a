// The fold-in sweep on Hopper (sm_90a): one launch per sweep, one warp per
// held-out document.
//
// It replaces no Pallas kernel.  JAX's fold-in
// (lda_thesis_tpu/ops/gibbs.py foldin_sweep) is a lax.scan of XLA ops over
// the positions; the port ran the same ops as a CUDA graph of about 16
// PyTorch kernels a position (ops/gibbs._foldin_positions, replayed by
// ops/gibbs.FoldinSweep), whose time was its nodes' launches, not their
// work.  This kernel runs the whole sweep.  For document d (row d of the
// state) and each position p = 0 .. U-1 in order, with f = ff[d, p] > 0,
// v = tv[d, p] and z_old = z[d, p]:
//   n[z_old] -= f
//   w[k]  = (n[k] + alpha[d, k]) * phi[v, k]     (each op rounded on its own)
//   c     = inclusive cumsum of w over the K topics, in torch's order (below)
//   z_new = #{k < K : c[k] < u[p, d] * c[K-1]}   (a count, not a search: c
//           need not be monotone in float32)
//   z[d, p] = z_new;  n[z_new] += f
// Positions with f <= 0 change nothing in the plain version (their two
// count updates add -0 and +0 and their topic stays), so the warp skips
// them.  phi is frozen, so documents do not interact and every warp walks
// its own document alone; counts are float32 integers below 2^24, so every
// count update is exact.
//
// Summation order.  The plain version's torch.cumsum over the innermost dim
// of a (D, K) tensor on a card runs at::native::tensor_kernel_scan_innermost_dim
// (ATen/native/cuda/ScanUtils.cuh), whose order depends only on (D, K): lx =
// get_log_num_threads_x_inner_scan(D, K) in [4, 9] (unsigned arithmetic;
// the wrapper computes it, foldin_cuda.scan_log_width) sets chunks of W =
// 2^(lx+1) topics; each chunk first adds the running total of the chunks
// before it into its element 0, then runs a Sklansky tree: at level m
// (s = 2^m) every element i with bit m set adds element
// (i & ~(2s-1)) | (s-1); elements past K are 0.  (torch scans a single
// row, D = 1, with CUB instead; the kernel keeps the rule's order there.)
// The kernel keeps that order exactly.  Lane l holds topics 32r + l (row r);
// chunk j is rows jS .. jS+S-1, S = W/32.  An element i >= 1 of a chunk
// takes the carry only at the level of its highest bit h, from element
// 2^h - 1; before that level its value L_i is carry-free.  So all rows'
// L values are computed at once (levels 0-4 by shuffles within a row,
// higher levels by broadcasting lane 31 of an earlier row), and only the
// chain C_0 = x_0 + carry, C_{t+1} = L_{2^(t+1)-1} + C_t runs serially
// across chunks; then element i is L_i + C_h.  Every add is the same
// operation on the same operands as in torch's tree, so the bits are the
// same.  The plain version is ops/gibbs._foldin_positions.
//
// Bound on this card.  Per live position a warp reads one phi row (K
// floats; the depth-3 table, 8,969 x 512 x 4 B = 18 MB, stays in the 50 MB
// L2) and does about 4 operations a topic: counting each byte once, a sweep
// of the Labeled-LDA fold-in (D = 464, U = 128, K = 512) could take about
// 5 us.  The sweep is bound instead by each warp's serial chain: the
// positions of a document are sequential, so a sweep takes the longest
// document's live positions times one position's latency, whose
// instructions are mostly warp shuffles (about 11 a row of 32 topics: five
// tree levels and six chain broadcasts) beside 6 + log2(S) dependent adds
// a chunk; on an H100 about 1.2 us a position at K = 512, 0.35 us at K = 15.
// The design keeps that chain short: the document's n row and its alpha
// row live in registers for the whole sweep (written back once), the next
// live position's phi row is loaded while the current draw runs, the
// position scalars come 32 positions at a time (one load per lane,
// shuffled out), and four warps a CTA put one document on each scheduler
// of an SM.  Topic counts past 32 * kRowsMax (1,024) take the wide route:
// the same scan over segments of 32 rows, n read and written in place, w
// recomputed in a second pass for the count.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kRowsMax = 32;  // register route: K <= 32 * kRowsMax

struct Args {
  int* z;               // (D, U) topics, in place
  float* ndk;           // (D, K) counts, in place
  const long long* tv;  // (D, U) word of each position (a row of phi)
  const float* ff;      // (D, U) frequency of each position
  const float* phi;     // (V, K) frozen topic-word table, read in place
  const float* u;       // (U, D) uniforms
  const float* alpha_t; // alpha of (d, k) at d * as0 + k * as1, or null: alpha
  long long as0, as1;
  float alpha;
  int D, U, K;
};

__device__ __forceinline__ float alpha_at(const Args& a, int d, int k) {
  return a.alpha_t ? a.alpha_t[d * a.as0 + k * a.as1] : a.alpha;
}

// Inclusive scan of NR rows (element 32r + lane of x) in torch's order for
// chunks of 32 << LS elements, the chunks' running total starting at
// `carry`; returns the running total after the last chunk.
template <int NR, int LS>
__device__ __forceinline__ float chunk_scan(float (&x)[NR], float carry, int lane) {
  constexpr int S = 1 << LS;
  static_assert(NR % S == 0, "a segment holds whole chunks");
  // carry-free values: levels 0-4 within each row; a chunk's first row
  // stops each lane before the level of its highest bit
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const int s = 1 << m;
    const int src = (lane & ~(2 * s - 1)) | (s - 1);
    const bool has = (lane & s) != 0;
    const bool below_top = has && lane >= 2 * s;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float y = __shfl_sync(kFull, x[r], src);
      x[r] = ((r % S == 0) ? below_top : has) ? x[r] + y : x[r];
    }
  }
  // levels 5 .. 4 + LS: a row adds lane 31 of an earlier row of its chunk,
  // below the level of its sub-chunk index's highest bit
#pragma unroll
  for (int m = 0; m < LS; ++m) {
    const int s = 1 << m;
    float bc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int q = r % S;
      bc[r] = ((q & (2 * s - 1)) == s - 1 && (q & ~(2 * s - 1)) != 0)
                  ? __shfl_sync(kFull, x[r], 31) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int q = r % S;
      if ((q & s) && q >= 2 * s) x[r] = x[r] + bc[r - q + ((q & ~(2 * s - 1)) | (s - 1))];
    }
  }
  // the chain, chunk by chunk; element i >= 1 adds C of its highest bit
  const int h = 31 - __clz(lane);  // -1 for lane 0
#pragma unroll
  for (int j = 0; j < NR / S; ++j) {
    const int r0 = j * S;
    const float l0 = __shfl_sync(kFull, x[r0], 0), l1 = __shfl_sync(kFull, x[r0], 1);
    const float l3 = __shfl_sync(kFull, x[r0], 3), l7 = __shfl_sync(kFull, x[r0], 7);
    const float l15 = __shfl_sync(kFull, x[r0], 15), l31 = __shfl_sync(kFull, x[r0], 31);
    float top[LS > 0 ? LS : 1];  // lane 31 of rows r0 + 2^(H+1) - 1
#pragma unroll
    for (int H = 0; H < LS; ++H) top[H] = __shfl_sync(kFull, x[r0 + (2 << H) - 1], 31);
    const float c0 = l0 + carry;
    const float c1 = l1 + c0;
    const float c2 = l3 + c1;
    const float c3 = l7 + c2;
    const float c4 = l15 + c3;
    const float own = h <= 0 ? c0 : h == 1 ? c1 : h == 2 ? c2 : h == 3 ? c3 : c4;
    x[r0] = lane == 0 ? c0 : x[r0] + own;
    float c = l31 + c4;
#pragma unroll
    for (int H = 0; H < LS; ++H) {
#pragma unroll
      for (int q = 1 << H; q < (2 << H); ++q) x[r0 + q] = x[r0 + q] + c;
      c = top[H] + c;
    }
    carry = c;
  }
  return carry;
}

// The position scalars of 32 positions p0 + lane, one per lane.
struct Window {
  float f, u;
  long long v;
  int z;
};

__device__ __forceinline__ Window load_window(const Args& a, int d, int p0, int lane) {
  Window w{0.0f, 0.0f, 0, 0};
  const int p = p0 + lane;
  if (p < a.U) {
    const size_t i = (size_t)d * a.U + p;
    w.f = a.ff[i];
    w.v = a.tv[i];
    w.z = a.z[i];
    w.u = a.u[(size_t)p * a.D + d];
  }
  return w;
}

// Calls visit(f, u, z_old, v, v_next) for each live position of document d
// in order (v_next: the word of the next live position of the same window,
// or -1) and stores the topic it returns; each window's topics are written
// back once.
template <class Visit>
__device__ __forceinline__ void walk_positions(const Args& a, int d, int lane, Visit visit) {
  for (int p0 = 0; p0 < a.U; p0 += 32) {
    Window w = load_window(a, d, p0, lane);
    const unsigned mask = __ballot_sync(kFull, w.f > 0.0f);
    unsigned live = mask;
    while (live) {  // warp-uniform
      const int b = __ffs(live) - 1;
      live &= live - 1;
      const float f = __shfl_sync(kFull, w.f, b);
      const float u = __shfl_sync(kFull, w.u, b);
      const int zo = __shfl_sync(kFull, w.z, b);
      const long long v = __shfl_sync(kFull, w.v, b);
      const long long vn = live ? __shfl_sync(kFull, w.v, __ffs(live) - 1) : -1;
      const int zn = visit(f, u, zo, v, vn);
      if (lane == b) w.z = zn;
    }
    if ((mask >> lane) & 1u) a.z[(size_t)d * a.U + p0 + lane] = w.z;
  }
}

template <int R>
__device__ __forceinline__ void load_row(float (&dst)[R], const float* row, int K, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = 32 * r + lane;
    dst[r] = k < K ? __ldg(row + k) : 0.0f;
  }
}

// The number of topics k < K whose scanned value lies below the threshold.
template <int NR>
__device__ __forceinline__ int count_below(const float (&c)[NR], float thr, int k0, int K,
                                           int lane) {
  int below = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r)
    below += __popc(__ballot_sync(kFull, k0 + 32 * r + lane < K && c[r] < thr));
  return below;
}

// Element kr*32 + (K-1)%32 of the rows, on every lane (kr: its row).
template <int NR>
__device__ __forceinline__ float element(const float (&c)[NR], int kr, int K) {
  float t = 0.0f;
#pragma unroll
  for (int r = 0; r < NR; ++r) t = r == kr ? c[r] : t;
  return __shfl_sync(kFull, t, (K - 1) & 31);
}

// Register route: R rows of 32 topics (K <= 32 R), chunks of 32 << LS.
template <int R, int LS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) foldin_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= a.D) return;  // warp-uniform
  const int K = a.K;
  float* ndk = a.ndk + (size_t)d * K;
  float n[R], al[R], ph[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = 32 * r + lane;
    n[r] = k < K ? ndk[k] : 0.0f;
    al[r] = k < K ? alpha_at(a, d, k) : 0.0f;
  }
  bool have = false;  // ph holds the current position's row
  walk_positions(a, d, lane, [&](float f, float u, int zo, long long v, long long vn) {
    if (!have) load_row(ph, a.phi + (size_t)v * K, K, lane);
    float nx[R];
    if (vn >= 0) load_row(nx, a.phi + (size_t)vn * K, K, lane);  // in flight during the draw
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (32 * r + lane == zo) n[r] = n[r] - f;
      x[r] = __fmul_rn(__fadd_rn(n[r], al[r]), ph[r]);
    }
    chunk_scan<R, LS>(x, 0.0f, lane);
    const float thr = __fmul_rn(u, element(x, (K - 1) >> 5, K));
    const int zn = count_below(x, thr, 0, K, lane);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * r + lane == zn) n[r] = n[r] + f;
    have = vn >= 0;
    if (have) {
#pragma unroll
      for (int r = 0; r < R; ++r) ph[r] = nx[r];
    }
    return zn;
  });
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = 32 * r + lane;
    if (k < K) ndk[k] = n[r];
  }
}

// w of the 32 rows of segment g: (n + alpha) * phi, 0 past K.
__device__ __forceinline__ void wide_segment(float (&x)[kRowsMax], const Args& a, int d,
                                             const float* n, const float* ph, int g,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    const int k = 32 * (kRowsMax * g + r) + lane;
    x[r] = k < a.K ? __fmul_rn(__fadd_rn(n[k], alpha_at(a, d, k)), __ldg(ph + k)) : 0.0f;
  }
}

// Wide route (K > 32 kRowsMax): segments of kRowsMax rows, n in place in
// device memory, two passes (the total, then the count).
template <int LS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) foldin_wide_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (d >= a.D) return;  // warp-uniform
  const int K = a.K;
  constexpr int kSeg = 32 * kRowsMax;
  const int segs = (K + kSeg - 1) / kSeg;
  const int last = (K - 1) / kSeg, kr = ((K - 1) % kSeg) >> 5;
  float* ndk = a.ndk + (size_t)d * K;
  walk_positions(a, d, lane, [&](float f, float u, int zo, long long v, long long) {
    const float* ph = a.phi + (size_t)v * K;
    if (lane == 0) ndk[zo] = ndk[zo] - f;
    __syncwarp();
    float x[kRowsMax], carry = 0.0f, total = 0.0f;
    for (int g = 0; g < segs; ++g) {
      wide_segment(x, a, d, ndk, ph, g, lane);
      carry = chunk_scan<kRowsMax, LS>(x, carry, lane);
      if (g == last) total = element(x, kr, K);
    }
    const float thr = __fmul_rn(u, total);
    int zn = 0;
    carry = 0.0f;
    for (int g = 0; g < segs; ++g) {  // the same operations again
      wide_segment(x, a, d, ndk, ph, g, lane);
      carry = chunk_scan<kRowsMax, LS>(x, carry, lane);
      zn += count_below(x, thr, kSeg * g, K, lane);
    }
    __syncwarp();
    if (lane == 0) ndk[zn] = ndk[zn] + f;
    __syncwarp();
    return zn;
  });
}

template <int R, int LS>
int launch_rows(const Args& a, int ls, cudaStream_t stream) {
  // rows past R are padding, which never feeds a topic below K: a chunk
  // wider than R rows scans as one of R rows
  if constexpr ((1 << LS) < R) {
    if (ls > LS) return launch_rows<R, LS + 1>(a, ls, stream);
  }
  const int blocks = (a.D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  foldin_kernel<R, LS><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LS>
int launch_wide(const Args& a, int ls, cudaStream_t stream) {
  if constexpr (LS < 5) {
    if (ls > LS) return launch_wide<LS + 1>(a, ls, stream);
  }
  const int blocks = (a.D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  foldin_wide_kernel<LS><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches one fold-in sweep on `stream` over D >= 1 documents of U >= 1
// positions and K >= 1 topics; log_width is torch's lx for (D, K) (4 .. 9).
// Returns cudaGetLastError() as an int.
extern "C" int foldin_sweep_launch(int* z, float* ndk, const long long* tv, const float* ff,
                                   const float* phi, const float* u, const float* alpha_t,
                                   long long as0, long long as1, float alpha, int D, int U,
                                   int K, int log_width, void* stream) {
  const Args a{z, ndk, tv, ff, phi, u, alpha_t, as0, as1, alpha, D, U, K};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ls = log_width - 4;  // chunks of 32 << ls topics
  const int rows = (K + 31) / 32;
  if (rows <= 1) return launch_rows<1, 0>(a, ls, s);
  if (rows <= 2) return launch_rows<2, 0>(a, ls, s);
  if (rows <= 4) return launch_rows<4, 0>(a, ls, s);
  if (rows <= 8) return launch_rows<8, 0>(a, ls, s);
  if (rows <= 16) return launch_rows<16, 0>(a, ls, s);
  if (rows <= kRowsMax) return launch_rows<kRowsMax, 0>(a, ls, s);
  return launch_wide<0>(a, ls, s);
}
