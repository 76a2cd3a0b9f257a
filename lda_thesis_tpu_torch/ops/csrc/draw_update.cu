// One position of the exact dense collapsed-Gibbs sweep on Hopper (sm_90a):
// the draw kernel and the count-commit kernel.
//
// The draw kernel replaces the TPU kernel
// lda_thesis_tpu/ops/gibbs_pallas.py::_build (pallas_call at
// gibbs_pallas.py:87, called through fused_draw_update): for the i-th live
// document row d (f = f[d] > 0, z_old = z_old[d]) at one type position, with
// cv = table[rows[i]] (the topic-word row of its word, read in place) and
// recip[k] = 1/(n_k[k] + V*beta) (n_k after the position's decrement) or a
// given recip:
//   n       = n_dk[d, k] - ((k == z_old) ? f : 0)
//   w[k]    = ((labs[d, k] * (n + alpha)) * (cv[k] + beta)) * recip[k]
//   c       = inclusive cumsum of w over the K topics (order below)
//   z_new   = min(#{k < K : c[k] < u[d] * c[K-1]}, K-1)
//   n_dk[d, z_old] -= f;  n_dk[d, z_new] += f           (in place)
//   dnk[z_old] -= f;      dnk[z_new] += f                (atomics, if dnk given)
// A row with f == 0 keeps its topic.  The commit kernel applies the table and
// topic-total updates the reference makes around the draw
// (lda_thesis_tpu/ops/gibbs.py:178-187): n_vk[v, z] += s*f and n_k[z] += s*f
// for the live slots of one position's decrement (s = -1) and the previous
// position's increment (s = +1), by atomicAdd.  Counts are integers below
// 2^24 in float32, so every count update is exact in any order.  The two
// kernels alternate on one stream: every decrement lands before any row
// reads the table, and every read ends before the increment lands.
//
// Summation order of c (_chunk_cumsum in draw_update_cuda.py repeats it):
// lane l of the row's warp takes topics 32*i + l, chunk i = 0, 1, ...; within
// a chunk the lanes' w are scanned inclusively (Hillis-Steele, offsets
// 1..16; lanes past K hold 0), giving s_i[l]; then c[32*i + l] = carry_i +
// s_i[l] with carry_0 = 0 and carry_{i+1} = carry_i + s_i[31].  All in
// float32 with no FMA contraction (built with -fmad=false); 1/x is
// correctly rounded (no fast-math).
//
// Design.  One warp per live row, 8 rows per CTA; the grid spans only the
// position's live rows (lists built once per sweep state, with each live
// row's word beside it, so the table row's address does not wait on d).
// A chain axis is the grid's y (the *_chains_kernel variants, launched for
// C > 1): CTA (x, c) draws live rows of chain c, whose u, z, n_dk, table and
// n_k sit at c times their chain strides; f, labs, the live list and the
// rows' words are shared by every chain (every chain sweeps the same
// documents).  A CTA never holds two chains, so each chain's draw is its
// single-chain draw, bit for bit.  C = 1 launches the single-chain kernels,
// which compute no chain offsets: computed at c = 0, they made a replayed
// single-chain sweep 5% slower on an H100
// (tools/probe_single_chain_sweep.py).
// Each warp-wide load of labs, n_dk and the table row is 128 contiguous
// bytes.  For K <= 1024 (NC chunks, a template argument) the code is
// straight-line: every chunk's loads are issued at once into registers
// while the CTA stages recip in shared memory, the chunks' scans run level
// by level across the chunks so that their shuffles overlap, and a running
// carry joins them; the latency of memory is paid once per launch, not once
// per chunk.  Wider rows recompute the same w and scan in a second pass,
// with no bound on K.  The count below the draw is the sum over chunks of
// popc(ballot(k < K && c < r)).  Lane 0 applies the two n_dk updates.
//
// Bound on this card.  Each live row must read its n_dk, labs and table rows
// ((K,) float32 each) and write two n_dk elements: about 12*live*K bytes
// against about 8 fp32 operations per (row, topic), so bytes bound it
// (3.35 TB/s); e.g. 3.0 us at the first position of the widest dense
// Labeled-LDA bucket (1,653 live rows, K = 512).  The table (V*K*4 bytes,
// 18.4 MB at the depth-3 shape) and a bucket's labs and n_dk stay in the
// 50 MB L2 across a sweep, so a launch can run under that bound.  At small
// positions a launch costs its latency: the CTA's start and two dependent
// loads (the live list, then the row).  The commit moves a few bytes per
// live slot; its time is launch latency and the atomics on n_k.  C chains
// in one launch move (8*C + 4)*live*K bytes (labs is shared) in the
// latency of one launch; from C = 2 on, their tables and n_dk (about 27 MB a
// chain at the depth-3 shape) no longer stay in L2 across a sweep.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 32;  // register path: K <= 32 * kMaxChunks
constexpr int kCommitThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

struct DrawArgs {
  const float* u;          // (D,)
  const float* f;          // (D,)
  const int* z_old;        // (D,)
  int* z_new;              // (D,), may be z_old (in place)
  const float* labs;       // (D, K)
  float* ndk;              // (D, K), updated in place
  const float* table;      // (V, K) topic-word counts, rows read in place
  const long long* rows;   // (n,) table row of each drawn row, or null: row d
  const float* nk;         // (K,) topic totals after the decrement, or null
  const float* recip;      // (K,) given 1/(n_k + V*beta), or null: from nk
  float* dnk;              // (K,) change of the topic totals, or null
  const int* live;         // (n,) rows to draw, or null: rows 0..n-1
  int n, K;
  float alpha, beta, vbeta;
};

// Chain strides in elements: chain c's u, z_old and z_new, ndk, table and
// nk sit at c times these from chain 0's.
struct ChainStrides {
  long long u, z, ndk, table, nk;
};

// The arguments of chain c: its own state, the shared inputs unchanged.
__device__ __forceinline__ DrawArgs chain_args(const DrawArgs& in, const ChainStrides& s,
                                               size_t c) {
  DrawArgs a = in;
  a.u += c * s.u;
  a.z_old += c * s.z;
  a.z_new += c * s.z;
  a.ndk += c * s.ndk;
  a.table += c * s.table;
  if (a.nk) a.nk += c * s.nk;
  return a;
}

__device__ __forceinline__ float recip_at(const DrawArgs& a, int k) {
  return a.recip ? a.recip[k] : 1.0f / (a.nk[k] + a.vbeta);
}

// Inclusive Hillis-Steele scan of one value per lane.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x = x + y;
  }
  return x;
}

// Loads of one row, issued before anything waits on them (one unused slot
// each when NC == 0).
template <int NC>
struct RowLoads {
  float labs[NC > 0 ? NC : 1], ndk[NC > 0 ? NC : 1], cv[NC > 0 ? NC : 1];
};

// One draw per warp, for the li-th drawn row d.  NC > 0: the row's values
// come preloaded in `ld`, c is kept in NC registers per lane and recip read
// from shared memory; NC == 0: any K, two passes over device memory, recip
// computed per topic.
template <int NC>
__device__ __forceinline__ void draw_row(const DrawArgs& a, const RowLoads<NC>& ld,
                                         const float* s_recip, int li, int d, float fd,
                                         int zo, float u, int lane) {
  const int K = a.K;
  const int last = (K - 1) >> 5;  // chunk of topic K-1
  float carry = 0.0f, total = 0.0f;
  int below = 0;
  if constexpr (NC > 0) {
    // Straight-line code over all NC chunks, selects and no branches (topics
    // past K hold w = 0): a branch would let the compiler sink each chunk's
    // loads to their use and keeps it from interleaving the chunks' scans.
    float c[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int k = 32 * i + lane;
      const float n = ld.ndk[i] - ((k == zo) ? fd : 0.0f);
      float w = ld.labs[i] * (n + a.alpha);
      w = w * (ld.cv[i] + a.beta);
      w = w * s_recip[k];
      c[i] = k < K ? w : 0.0f;
    }
    // the chunks' Hillis-Steele scans, level by level across the chunks so
    // that their shuffles overlap; each chunk's operations as in warp_scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float y = __shfl_up_sync(kFullMask, c[i], off);
        c[i] = lane >= off ? c[i] + y : c[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float s = c[i];
      c[i] = carry + s;
      const float t = __shfl_sync(kFullMask, c[i], (K - 1) & 31);
      if (i == last) total = t;
      carry = carry + __shfl_sync(kFullMask, s, 31);
    }
    const float r = u * total;
#pragma unroll
    for (int i = 0; i < NC; ++i)
      below += __popc(__ballot_sync(kFullMask, 32 * i + lane < K && c[i] < r));
    if (lane == 0) {
      float* ndk = a.ndk + (size_t)d * K;
      const int zn = min(below, K - 1);
      a.z_new[d] = zn;
      // both loads in flight at once; the values of the two updates made
      // one after the other
      const float n_old = ndk[zo], n_new = ndk[zn];
      const float dec = n_old - fd;
      if (zn == zo) {
        ndk[zo] = dec + fd;
      } else {
        ndk[zo] = dec;
        ndk[zn] = n_new + fd;
      }
      if (a.dnk) {
        atomicAdd(a.dnk + zo, -fd);
        atomicAdd(a.dnk + zn, fd);
      }
    }
  } else {
    const float* __restrict__ labs = a.labs + (size_t)d * K;
    const float* __restrict__ cv = a.table + (size_t)(a.rows ? a.rows[li] : d) * K;
    const float* ndk = a.ndk + (size_t)d * K;
    auto scan = [&](int j) -> float {
      const int k = 32 * j + lane;
      float w = 0.0f;
      if (k < K) {
        const float n = ndk[k] - ((k == zo) ? fd : 0.0f);
        w = labs[k] * (n + a.alpha);
        w = w * (cv[k] + a.beta);
        w = w * recip_at(a, k);
      }
      return warp_scan(w, lane);
    };
    for (int j = 0; j <= last; ++j) {
      const float s = scan(j);
      if (j == last) total = __shfl_sync(kFullMask, carry + s, (K - 1) & 31);
      carry = carry + __shfl_sync(kFullMask, s, 31);
    }
    const float r = u * total;
    carry = 0.0f;
    for (int j = 0; j <= last; ++j) {  // the same operations again
      const float s = scan(j);
      below += __popc(__ballot_sync(kFullMask, 32 * j + lane < K && carry + s < r));
      carry = carry + __shfl_sync(kFullMask, s, 31);
    }
    if (lane == 0) {
      float* ndk = a.ndk + (size_t)d * K;
      const int zn = min(below, K - 1);
      a.z_new[d] = zn;
      ndk[zo] = ndk[zo] - fd;
      ndk[zn] = ndk[zn] + fd;
      if (a.dnk) {
        atomicAdd(a.dnk + zo, -fd);
        atomicAdd(a.dnk + zn, fd);
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void draw_update_body(const DrawArgs& a) {
  __shared__ float s_recip[NC > 0 ? 32 * NC : 1];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // this thread's share of n_k (or the given recip) for the CTA's staging,
  // loaded first: it does not wait on the row index
  constexpr int kThreads = kWarpsPerBlock * 32;
  constexpr int kStage = NC > 0 ? (32 * NC + kThreads - 1) / kThreads : 1;
  float staged[kStage];
  if constexpr (NC > 0) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int k = threadIdx.x + kThreads * j;
      staged[j] = k < a.K ? __ldg((a.recip ? a.recip : a.nk) + k) : 0.0f;
    }
  }
  int d = 0, zo = 0;
  float fd = 0.0f, u = 0.0f;
  RowLoads<NC> ld;
  if (i < a.n) {  // warp-uniform
    d = a.live ? a.live[i] : i;
    fd = a.f[d];
    zo = a.z_old[d];
    u = a.u[d];
    if constexpr (NC > 0) {
      // every chunk's loads in flight together, not waiting on f (the
      // sweep launches live rows only), the table row's index not waiting
      // on d
      const size_t row = (size_t)d * a.K;
      const size_t trow = (size_t)(a.rows ? a.rows[i] : d) * a.K;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int k = 32 * j + lane;
        const bool in = k < a.K;
        ld.labs[j] = in ? __ldg(a.labs + row + k) : 0.0f;
        ld.ndk[j] = in ? a.ndk[row + k] : 0.0f;
        ld.cv[j] = in ? __ldg(a.table + trow + k) : 0.0f;
      }
    }
  }
  if constexpr (NC > 0) {  // while the row's loads are in flight
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int k = threadIdx.x + kThreads * j;
      if (k < a.K) s_recip[k] = a.recip ? staged[j] : 1.0f / (staged[j] + a.vbeta);
    }
    __syncthreads();
  }
  if (i >= a.n) return;  // warp-uniform: the whole warp leaves together
  if (fd == 0.0f) {      // warp-uniform
    if (lane == 0) a.z_new[d] = zo;
    return;
  }
  draw_row<NC>(a, ld, s_recip, i, d, fd, zo, u, lane);
}

template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
draw_update_kernel(const DrawArgs a) {
  draw_update_body<NC>(a);
}

// blockIdx.y = chain c.
template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
draw_update_chains_kernel(const DrawArgs a, const ChainStrides s) {
  draw_update_body<NC>(chain_args(a, s, blockIdx.y));
}

struct Slots {
  const long long* rows;  // (D,) table row of each document
  const int* z;           // (D,) topic of each document's slot (chain 0's)
  const float* f;         // (D,) frequency
  const int* live;        // (n,) rows with f > 0
  int n;
};

// The slots' topics are read at z_off + d (z_off: the chain's offset).
__device__ __forceinline__ void count_commit_body(float* table, float* nk, int K,
                                                  const Slots& dec, const Slots& inc,
                                                  size_t z_off) {
  int j = blockIdx.x * kCommitThreads + threadIdx.x;
  const bool is_dec = j < dec.n;
  if (!is_dec) j -= dec.n;
  if (j >= (is_dec ? dec.n : inc.n)) return;
  // fields picked one by one: a reference to either parameter would copy
  // both to the stack
  const int d = (is_dec ? dec.live : inc.live)[j];
  const int z = (is_dec ? dec.z : inc.z)[z_off + d];
  const float f = is_dec ? -dec.f[d] : inc.f[d];
  atomicAdd(table + (size_t)(is_dec ? dec.rows : inc.rows)[d] * K + z, f);
  atomicAdd(nk + z, f);
}

__global__ void __launch_bounds__(kCommitThreads)
count_commit_kernel(float* table, float* nk, int K, const Slots dec, const Slots inc) {
  count_commit_body(table, nk, K, dec, inc, 0);
}

// blockIdx.y = chain c: its topics at c * s_z, its table and totals at
// c * s_table and c * s_nk.
__global__ void __launch_bounds__(kCommitThreads)
count_commit_chains_kernel(float* table, float* nk, int K, const Slots dec,
                           const Slots inc, long long s_z, long long s_table,
                           long long s_nk) {
  const size_t c = blockIdx.y;
  count_commit_body(table + c * s_table, nk + c * s_nk, K, dec, inc, c * s_z);
}

template <int NC>
int launch_draw(const DrawArgs& a, int chains, const ChainStrides& s, cudaStream_t stream) {
  const int blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (chains == 1)
    draw_update_kernel<NC><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a);
  else
    draw_update_chains_kernel<NC>
        <<<dim3(blocks, chains), kWarpsPerBlock * 32, 0, stream>>>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the draw kernel on `stream` for n rows (n >= 1) of each of
// `chains` chains (>= 1; chain strides in elements, see ChainStrides);
// returns cudaGetLastError() as an int.
extern "C" int draw_update_launch(const float* u, const float* f, const int* z_old,
                                  int* z_new, const float* labs, float* ndk,
                                  const float* table, const long long* rows,
                                  const float* nk, const float* recip, float* dnk,
                                  const int* live, int n, int K, float alpha,
                                  float beta, float vbeta, int chains, long long s_u,
                                  long long s_z, long long s_ndk, long long s_table,
                                  long long s_nk, void* stream) {
  const DrawArgs a{u, f, z_old, z_new, labs, ndk, table, rows, nk, recip, dnk, live,
                   n, K, alpha, beta, vbeta};
  const ChainStrides c{s_u, s_z, s_ndk, s_table, s_nk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (K + 31) / 32;
  if (chunks <= 1) return launch_draw<1>(a, chains, c, s);
  if (chunks <= 2) return launch_draw<2>(a, chains, c, s);
  if (chunks <= 4) return launch_draw<4>(a, chains, c, s);
  if (chunks <= 6) return launch_draw<6>(a, chains, c, s);
  if (chunks <= 8) return launch_draw<8>(a, chains, c, s);
  if (chunks <= 12) return launch_draw<12>(a, chains, c, s);
  if (chunks <= 16) return launch_draw<16>(a, chains, c, s);
  if (chunks <= 24) return launch_draw<24>(a, chains, c, s);
  if (chunks <= kMaxChunks) return launch_draw<kMaxChunks>(a, chains, c, s);
  return launch_draw<0>(a, chains, c, s);
}

// Launches the commit kernel on `stream` for n_dec + n_inc >= 1 slots of each
// of `chains` chains (>= 1): chain c's topics at c * s_z, its table and
// totals at c * s_table and c * s_nk (elements).
extern "C" int count_commit_launch(float* table, float* nk, int K,
                                   const long long* dec_rows, const int* dec_z,
                                   const float* dec_f, const int* dec_live, int n_dec,
                                   const long long* inc_rows, const int* inc_z,
                                   const float* inc_f, const int* inc_live, int n_inc,
                                   int chains, long long s_z, long long s_table,
                                   long long s_nk, void* stream) {
  const Slots dec{dec_rows, dec_z, dec_f, dec_live, n_dec};
  const Slots inc{inc_rows, inc_z, inc_f, inc_live, n_inc};
  const int blocks = (n_dec + n_inc + kCommitThreads - 1) / kCommitThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chains == 1)
    count_commit_kernel<<<blocks, kCommitThreads, 0, s>>>(table, nk, K, dec, inc);
  else
    count_commit_chains_kernel<<<dim3(blocks, chains), kCommitThreads, 0, s>>>(
        table, nk, K, dec, inc, s_z, s_table, s_nk);
  return (int)cudaGetLastError();
}
