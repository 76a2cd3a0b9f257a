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
//   c       = inclusive scan of w over the slots, in this order: a
//             Hillis-Steele scan within each group of eight slots (offsets
//             1, 2, 4: l[a] = l[a] + l[a - off] for a % 8 >= off), then
//             c[a] = P[a / 8] + l[a] with the group totals T = l[8h + 7]
//             and P[0] = 0, P[1] = T[0], P[2] = T[0] + T[1],
//             P[3] = (T[0] + T[1]) + T[2]
//   z'      = #{a < A : c[a] < u * c[A-1]}
//   n_dk    = ndk_m + ((a == z') ? f : 0)
// A position with f == 0 keeps its z and leaves n_dk unchanged, so it is
// skipped (the plain version computes it and discards the draw: the same
// bits, since x - 0 + 0 == x).
//
// Bound on this card.  Counted as the function's traffic and arithmetic, the
// block reads cv (4·A·U·D bytes) and the uniforms (4·M·U·D bytes) once and
// does about a dozen fp32 operations per (slot, position with f > 0, sweep):
// at the main path's shapes (depth-3 abstracts, A = 24, M = 25, four buckets)
// 51 MB and 1.34 GFLOP per merge block, 20 us at 67 TFLOP/s.  No design that
// keeps the sampler's semantics reaches that: each draw reads the n_dk the
// draw before it left, so a document's M·L draws (L = its positions with
// f > 0) form one dependent chain, and a bucket's kernel takes at least its
// longest chain times the latency of one step: 25 x (32 + 48 + 80 + 128) =
// 7,200 steps per merge block where each bucket's longest document fills its
// width.  A step's chain is five float operations, three shuffle-and-add
// scan levels, one round of four shuffles issued together, two or three
// adds, a multiply and a compare, a ballot and a popc, and the update's
// compare, select and add: some 230 cycles, so the chain floor is about
// 0.85 ms per merge block at 1.98 GHz.
//
// Design: a step costs only its compute chain.
//   * A CTA is one warp and owns one document, lane a on slot a (A <= 32).
//     Packing W documents into a CTA for fewer waves did not pay: at W = 2
//     and 4 the kernel was as fast or slower where the waves fell (two-wave
//     shapes, CascadeLDA's level blocks) and at most 6% faster elsewhere
//     (tools/probe_fused_block.py, on an NVIDIA H100 80GB HBM3 at 700 W).
//   * Frozen operands are staged in shared memory once per launch.  The
//     document's cv slab (U·A contiguous floats, doc-major) lands with one
//     cp.async.bulk completing on an mbarrier (a cooperative copy where the
//     slab is not 16-byte aligned; the bulk copy is 3-4% faster per launch
//     on the H100 at the main path's shapes).  The warp builds the
//     document's list of live positions (f > 0) and, per live position and
//     slot, the pair (cvb, r) = ((cv - own) + beta, rcp_rn(nkg - own)): own
//     uses the block-start slot, fixed for the whole block, so neither
//     depends on the chain.  The plain version computes them per step: the
//     same operations on the same values give the same bits.
//   * The step loop walks exactly the live positions, interior gaps
//     included: an outer loop over sweeps, an inner one over live positions,
//     with no branch on f and no guard in the scan (lanes >= A read slot 0's
//     row and only change lanes above them, which take no part in the draw).
//     The scan runs in groups of eight lanes, three shuffle levels instead
//     of five, and one round of shuffles gathers the group totals and slot
//     A-1's sum, from which every lane forms both its prefix and
//     u * c[A-1].  (f, current slot) of each live position is one 8-byte
//     word; every lane writes the same draw into it, so each lane reads back
//     its own write and no warp barrier sits in the loop.
//   * The uniforms stream two sweeps ahead through a ring of three buffers:
//     4-byte cp.async gathers sweep m+2's values for the live positions at
//     the start of sweep m (the (M, U, D) layout puts a document's values
//     D floats apart, too narrow a stride for TMA).
//   * Step s+1's operands (its (cvb, r) pair, (f, slot) and u) are loaded
//     from shared memory before step s's draw, from addresses that need no
//     load, and consumed a step later.  The step loop makes no load from
//     device memory or L2.
// n_dk and valid stay in registers for the block.  The staging bounds U:
// fused_block_max_positions(A) gives the largest U whose shared memory fits
// one CTA on the current device (563 at A = 32 on an H100).
//
// The warp route (fused_block_warp_kernel<S>) replaces the same TPU kernel
// for 32 < A <= 32 * S_MAX slots at any U, and for A <= 32 where U >
// fused_block_max_positions(A): every LocalLDA run at 32 < K <= 256 (A =
// 56, 104 and 200 at K = 50, 100 and 200), and label sets or documents the
// staged route cannot hold.  S_MAX = kWarpRowsMax = 8 (A <= 256): ptxas reports no
// spill stores for any of S = 1..8 (nvcc -Xptxas -v; chip_smoke.py's build
// phase checks it).  Its bound is the function's, as above: the work and
// the bytes do not change with the route (chip_smoke.bound counts them for
// a launch).  Its chain step, for S = ceil(A/32) rows: the owner's update
// and the weight (five dependent float operations), three shuffle-and-add
// scan levels, the group totals' round of shuffles, 4·S - 1 sequential
// prefix adds, a select and an add, one shuffle of c[A-1] and a multiply,
// a compare, ballot and popc per row and their sum, and the update's
// compare, select and add: some 300 cycles at S = 2, so its chain floor is
// about 0.15 us per draw of the longest document at 1.98 GHz (19 us at
// U = 128, 0.15 ms at U = 1,024).  With tens of documents per SM the
// instruction throughput, not that chain, sets the time: about 40 warp instructions per row
// of slots and 20 more per step.  What the design does about both:
//   * One warp per document and no block barrier.  Lane l owns slots
//     l + 32·j, j < S (S a template parameter, 1..S_MAX); its n_dk, valid
//     and rcp_rn(n_k) are register arrays with compile-time indices.  Each
//     row of 32 slots runs the staged kernel's three shuffle levels in
//     groups of eight lanes; the 4·S group totals come by shuffles from
//     lanes 7, 15, 23 and 31 of each row, all in one round, and every
//     lane forms the sequential prefix P[h] = P[h-1] + T[h-1] in registers
//     and takes its group's P by selects: the plain version's order, bit
//     for bit.  u·c[A-1] takes slot A-1's prefixed sum by one shuffle, and
//     the new slot is the sum over rows of popc(ballot(c < r)), the last
//     row masked to the lanes below A.
//   * The cv rows stream ahead of the chain.  A chunk of C consecutive
//     positions is C·A·4 contiguous bytes of the (D, U, A) layout; C is a
//     power of two up to 32 sized by A (warp_chunk_positions: buffers of
//     2 KB, or 8 rows up to 4 KB), so the two-buffer ring holds 4-8 KB per
//     warp.  Lane 0 brings each chunk in with one cp.async.bulk on its
//     buffer's mbarrier, a chunk ahead (a 4-byte cp.async per element where
//     A·4 is not a multiple of 16).  A walk of at most two chunks stays
//     resident across the M sweeps.
//   * The per-position scalars (f, block-start slot, live slot, uniform)
//     are D floats apart, too narrow a stride for TMA: lane i loads those of
//     position base + i for the next 32 positions a chunk of 32 ahead, and
//     forms rcp_rn(n_k[zb] - f) for it from the totals in shared memory.  A
//     step takes them by shuffles from lane p - base.  The live slot stays
//     in that lane's register and goes to z_out once per 32 positions and
//     sweep.
//   * The step loop has no branch, no barrier and no wait: it runs over one
//     ring chunk (a segment, inside one chunk of 32 positions), and the next
//     position's cv row and scalars are loaded while the count is in
//     flight.  Between segments: the wait for the next chunk, the refill
//     of the one just read, the write-back and the next 32 scalars.  (A
//     branch on f, a wait or a division inside the loop made ptxas guard
//     every shuffle with a divergence check and split the loop there, so
//     that the loads of a step waited on one another.)  A position with
//     f == 0 is computed and its draw discarded, as in the plain version:
//     the same bits.
//   * The walk ends at the document's last position with f > 0; when it is
//     one position long, the next segment is the same position and reads
//     the slot this step drew.
//   * One warp (one document) per CTA: two and four independent warps per
//     CTA were no faster across the timed shapes on the H100 (PERF.md).
//
// The wide route (fused_block_wide_kernel) replaces the same TPU kernel for
// 32 * S_MAX < A <= fused_block_wide_max_slots() (9,852 on an H100): every
// LocalLDA run at K > 256 (A = 304 at K = 300) and label sets wider than
// 256.  Its bound is the function's, as above: at LocalLDA's shapes (4,635
// documents, U = 128, about 300k live positions, M = 1) the cv rows and
// uniforms of the live positions, 0.116 ms at A = 304 and 0.384 ms at
// A = 1,000 over 3.35 TB/s (chip_smoke.bound).  A step's work grows as A:
// per row of 32 slots the weight (five float operations), three
// shuffle-and-add scan levels, four shuffles for the row's group totals,
// four sequential prefix adds, a select, a compare, a ballot and a popc;
// with tens of documents per SM, the latency of those shuffles and loads,
// not the instruction count, sets the time.  What the design does:
//   * The warp route's layout past 8 rows: one warp per document and no
//     block barrier; lane l owns slots l + 32·j.  Rows 0..7 keep n_dk,
//     valid and rcp_rn(n_k) in registers; rows 8..S-1 keep them in shared
//     memory, [row][lane], so that each lane reads and writes only its own
//     slots, free of bank conflicts and of any warp barrier.  The live
//     count changes at two slots a step: their owners update them in
//     place, in the plain version's order ((n_dk - f) + f).
//   * Each row's four group totals come by shuffles and extend the
//     sequential prefix P[h] = P[h-1] + T[h-1] carried across rows in a
//     register, so a row's prefixed sums are known as soon as it is
//     scanned, and a step holds no sequential pass over all ceil(A/8)
//     groups (the CTA route's cost, which grows as A^2).  The rows in
//     shared memory keep their prefixed sums there until u * c[A-1] is
//     known; the draw is the sum over rows of popc(ballot(c < r)).
//   * The cv rows stream through a two-buffer ring, each chunk as many
//     positions as fit 4 KB (one past 512 slots), by cp.async.bulk on an
//     mbarrier, and the per-position scalars a chunk of 32 ahead, as in
//     the warp route, whose walk (walk_chunks) the two routes share.
//     Eight register rows, two buffers and 4 KB chunks were the fastest of
//     the sizes timed on the H100; W = ceil(S/8) warps per document with
//     every row in registers and two CTA barriers a step was 1.3-1.6x
//     slower at both shapes (PERF.md).
//
// The CTA route (fused_block_general_kernel) keeps only the slot counts
// past the wide route's widest, at any U, with the same arithmetic and scan
// order; no user path reaches it.
//   * A CTA owns one document; thread t owns slot t (and, past 1,024 slots,
//     slots t + T, t + 2T, ...), T = 32 * ceil(A / 32) threads, at most
//     1,024.  Each warp scans its slots in groups of eight lanes; the group
//     totals go to shared memory and, after a barrier, every thread forms
//     the sequential prefix over the ceil(A/8) groups; the draw is a count
//     across the CTA (a warp reduction, then the warps' counts through
//     shared memory after a second barrier).
//   * Each step reads its scalars and cv row from global memory (L2), the
//     next position's a step ahead, the cv rows prefetched into L2 four
//     positions ahead.  Slot t's n_dk and constants stay in registers, the
//     other slots' state in shared memory, about 20.5 bytes per slot; past
//     the card's limit (about 11,000 slots on an H100) the wrapper hands
//     the kernel a scratch buffer in global memory instead, so A has no
//     limit.  Two barriers and a serial prefix per step made it 19x its
//     bound at A = 304 and 36x at A = 1,000 (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;  // the scan's lane groups
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ inline size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// The landing slab of the document's cv, U·A floats.
__host__ __device__ inline size_t landing_bytes(int U, int A) {
  return round16((size_t)U * A * 4);
}

// After the landing slab: the (cvb, r) pairs of the live positions (U x A
// float2), (f, current slot) per live position (int2), the position of each
// live position, the slot per position, three sweeps of uniforms, 32
// block-start totals; then the mbarrier.
__host__ __device__ inline size_t staging_bytes(int U, int A) {
  return round16((size_t)U * A * 8 + (size_t)U * (8 + 4 + 4 + 12) + 32 * 4);
}

__host__ __device__ inline size_t smem_bytes(int U, int A) {
  return landing_bytes(U, A) + staging_bytes(U, A) + 8;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sweep m's uniforms of the live positions into buf[0..L), as one group.
__device__ inline void stage_uniforms(float* buf, const int* pos, int L,
                                      const float* __restrict__ uni, int m,
                                      int M, int U, int D, int d, int lane) {
  if (m < M)
    for (int i = lane; i < L; i += 32)
      cp_async4(buf + i, uni + ((size_t)m * U + pos[i]) * D + d);
  cp_async_commit();
}

// One draw at a position of frequency fp whose slot is zo, from its frozen
// (cvb, r): returns the new slot and leaves the live counts in ndk.  g is
// the lane's group of eight slots, gl that of slot A-1.
__device__ __forceinline__ int draw(float& ndk, float vl, float2 cr, float u,
                                   float fp, int zo, int lane, int g, int gl,
                                   int A, unsigned live_bits, float alpha) {
  const float ndk_m = ndk - ((lane == zo) ? fp : 0.0f);
  float c = vl * (ndk_m + alpha);
  c = c * cr.x;
  c = c * cr.y;
  // inclusive scan within each group of eight lanes
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, c, off, kGroup);
    if ((lane & (kGroup - 1)) >= off) c = c + y;
  }
  // the group totals and slot A-1's in-group sum, gathered together
  const float t0 = __shfl_sync(kFullMask, c, kGroup - 1);
  const float t1 = __shfl_sync(kFullMask, c, 2 * kGroup - 1);
  const float t2 = __shfl_sync(kFullMask, c, 3 * kGroup - 1);
  const float c_last = __shfl_sync(kFullMask, c, A - 1);
  const float t01 = t0 + t1;
  const float t012 = t01 + t2;
  const float before = g == 0 ? 0.0f : g == 1 ? t0 : g == 2 ? t01 : t012;
  const float before_last = gl == 0 ? 0.0f : gl == 1 ? t0 : gl == 2 ? t01 : t012;
  c = before + c;
  const float r = u * (before_last + c_last);  // u * c[A-1]
  const int zn = __popc(__ballot_sync(kFullMask, c < r) & live_bits);
  ndk = ndk_m + ((lane == zn) ? fp : 0.0f);
  return zn;
}

__global__ void __launch_bounds__(32)
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int d = blockIdx.x;
  const bool live = lane < A;
  const int slot = live ? lane : 0;  // lanes >= A read slot 0's row, in range
  const unsigned live_bits = A == 32 ? kFullMask : (1u << A) - 1u;
  const int g = lane / kGroup;
  const int gl = (A - 1) / kGroup;

  float* landing = reinterpret_cast<float*>(smem);  // (U, A) cv
  float2* rows = reinterpret_cast<float2*>(smem + landing_bytes(U, A));
  int2* fz = reinterpret_cast<int2*>(rows + (size_t)U * A);  // (f, slot) per live position
  int* pos = reinterpret_cast<int*>(fz + U);                 // position per live position
  int* zp = pos + U;                                         // slot per position
  float* ubuf = reinterpret_cast<float*>(zp + U);            // (3, U) uniforms
  float* nk = ubuf + 3 * U;                                  // (32,) block-start totals
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + landing_bytes(U, A) +
                                               staging_bytes(U, A));

  // 1. the document's cv slab: one bulk copy where it is 16-byte aligned
  const float* cv_src = cv + (size_t)d * U * A;
  const uint32_t slab_bytes = (uint32_t)((size_t)U * A * sizeof(float));
  const bool bulk = ((reinterpret_cast<uintptr_t>(cv_src) & 15) == 0) &&
                    ((slab_bytes & 15) == 0) && slab_bytes > 0;
  if (bulk) {
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(mbar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();  // the barrier is initialised before anyone waits on it
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(mbar)), "r"(slab_bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(landing)), "l"(cv_src), "r"(slab_bytes),
             "r"(smem_addr(mbar)) : "memory");
    }
  } else {
    const size_t n = (size_t)U * A;
    for (size_t e = lane; e < n; e += 32) landing[e] = cv_src[e];
  }

  // 2. while the slab is in flight: the live positions, the slots, the
  //    registers, and the first two sweeps of uniforms
  int L = 0;
  float ndk = 0.0f, vl = 0.0f;
  for (int base = 0; base < U; base += 32) {
    const int p = base + lane;
    float fv = 0.0f;
    int zv = 0;
    if (p < U) {
      fv = f[(size_t)p * D + d];
      zv = z0[(size_t)p * D + d];
      zp[p] = zv;
    }
    const unsigned mask = __ballot_sync(kFullMask, fv > 0.0f);
    if (fv > 0.0f) {
      const int i = L + __popc(mask & ((1u << lane) - 1u));
      fz[i] = make_int2(__float_as_int(fv), zv);
      pos[i] = p;
    }
    L += __popc(mask);
  }
  if (live) {
    ndk = ndk0[(size_t)lane * D + d];
    vl = valid[(size_t)lane * D + d];
    nk[lane] = nkg[(size_t)lane * D + d];
  }
  __syncwarp();
  stage_uniforms(ubuf, pos, L, uni, 0, M, U, D, d, lane);
  stage_uniforms(ubuf + U, pos, L, uni, 1, M, U, D, d, lane);

  if (bulk) {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(smem_addr(mbar)) : "memory");
    }
  } else {
    __syncwarp();
  }

  // 3. the frozen constants of the live positions, by live position
  for (int e = lane; e < L * A; e += 32) {
    const int i = e / A;
    const int a = e - i * A;
    const int p = pos[i];
    const float own = (a == zp[p]) ? __int_as_float(fz[i].x) : 0.0f;
    rows[e] = make_float2((landing[p * A + a] - own) + beta, __frcp_rn(nk[a] - own));
  }
  cp_async_wait_all();  // sweeps 0 and 1
  __syncwarp();

  // 4. M sweeps over the live positions, an outer loop over sweeps and an
  //    inner one over positions.  Registers hold step s's operands and the
  //    loads for step s+1 are made before step s's draw.  Every lane writes
  //    the same draw into fz, so each lane reads back its own write; when
  //    L == 1 the next step is this position again and takes the draw
  //    itself.
  int zn = 0;
  if (L > 0) {
    float2 cr = rows[slot];
    int2 fzs = fz[0];
    float u = ubuf[0];
    for (int m = 0; m < M; ++m) {
      // sweep m+1's uniforms landed a sweep ago; sweep m-1's buffer is free
      cp_async_wait_all();
      __syncwarp();
      stage_uniforms(ubuf + ((m + 2) % 3) * U, pos, L, uni, m + 2, M, U, D, d, lane);
      const float* u_cur = ubuf + (m % 3) * U;
      const float* u_next = ubuf + ((m + 1) % 3) * U;
      for (int i = 0; i < L; ++i) {
        const bool wrap = i + 1 == L;
        const int i1 = wrap ? 0 : i + 1;
        const float2 cr1 = rows[i1 * A + slot];
        const int2 fzs1 = fz[i1];
        const float u1 = (wrap ? u_next : u_cur)[i1];
        zn = draw(ndk, vl, cr, u, __int_as_float(fzs.x), fzs.y, lane, g, gl, A,
                  live_bits, alpha);
        fz[i].y = zn;
        cr = cr1;
        fzs = fzs1;
        if (L == 1) fzs.y = zn;
        u = u1;
      }
    }
    __syncwarp();
    for (int j = lane; j < L; j += 32) zp[pos[j]] = fz[j].y;
    __syncwarp();
  }

  for (int p = lane; p < U; p += 32) z_out[(size_t)p * D + d] = zp[p];
  if (live) ndk_out[(size_t)lane * D + d] = ndk;
}

// ------------------------------------------------------------ general route

constexpr int kMaxThreads = 1024;
constexpr int kPrefetch = 4;  // positions ahead for the cv rows' L2 prefetch

__host__ __device__ inline int n_groups(int A) { return (A + kGroup - 1) / kGroup; }

// One thread per slot in whole warps, at most 1024; beyond, thread t also
// owns slots t + T, t + 2T, ...
__host__ __device__ inline int general_threads(int A) {
  const int T = (A + 31) / 32 * 32;
  return T < kMaxThreads ? T : kMaxThreads;
}

// Slots the threads cover: (slots per thread) x threads.
__host__ __device__ inline int general_slots(int A) {
  const int T = general_threads(A);
  return (A + T - 1) / T * T;
}

// Per document: n_dk, valid, totals, their reciprocals and scan values per
// covered slot, the group totals, and 32 warp counts.
__host__ __device__ inline size_t general_state_floats(int A) {
  const size_t N = general_slots(A);
  return 5 * N + N / kGroup + 32;
}

// The weight of slot a at a position of frequency fp, current slot zo and
// block-start slot zb: the staged kernel's product, in its order.  r0 is
// rcp_rn(nk), the reciprocal where the slot holds no own count.
__device__ __forceinline__ float general_weight(float ndk, float vl, float nk, float r0,
                                                float cvv, int a, int zo, int zb,
                                                float fp, float alpha, float beta) {
  const float own = (a == zb) ? fp : 0.0f;
  const float ndk_m = ndk - ((a == zo) ? fp : 0.0f);
  float w = vl * (ndk_m + alpha);
  w = w * ((cvv - own) + beta);
  return w * ((a == zb) ? __frcp_rn(nk - own) : r0);
}

// The inclusive scan within each group of eight lanes (offsets 1, 2, 4).
__device__ __forceinline__ float group_scan(float c, int lane) {
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, c, off, kGroup);
    if ((lane & (kGroup - 1)) >= off) c = c + y;
  }
  return c;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_block_general_kernel(const float* __restrict__ cv,     // (D, U, A)
                           const float* __restrict__ f,      // (U, D)
                           const float* __restrict__ uni,    // (M, U, D)
                           const int* __restrict__ z0,       // (U, D)
                           const float* __restrict__ nkg,    // (A, D)
                           const float* __restrict__ valid,  // (A, D)
                           const float* __restrict__ ndk0,   // (A, D)
                           int* __restrict__ z_out,          // (U, D), the live z
                           float* __restrict__ ndk_out,      // (A, D)
                           float* __restrict__ scratch,      // per-document state, or null
                           int M, int U, int A, int D, float alpha, float beta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, T = blockDim.x, d = blockIdx.x;
  const int lane = t & 31, warp = t >> 5, n_warps = T >> 5;
  const int G = n_groups(A), N = general_slots(A);
  float* state = scratch ? scratch + (size_t)d * general_state_floats(A)
                         : reinterpret_cast<float*>(smem);
  float* ndk = state;          // (N,) live n_dk of slots t + j*T, j >= 1; owner-only
  float* vl = ndk + N;         // (N,) valid
  float* nk = vl + N;          // (N,) block-start totals, pre-biased
  float* r0 = nk + N;          // (N,) rcp_rn(nk)
  float* lsc = r0 + N;         // (N,) in-group scan values of the step
  float* tot = lsc + N;        // (N / 8,) group totals of the step
  int* cnt = reinterpret_cast<int*>(tot + N / kGroup);  // (32,) warp counts

  // 1. per-slot state (slot t in registers, the rest in `state`), the live
  //    z, and the last position with f > 0
  for (int a = t; a < N; a += T) {
    const bool in = a < A;
    const float nka = in ? nkg[(size_t)a * D + d] : 1.0f;
    ndk[a] = in ? ndk0[(size_t)a * D + d] : 0.0f;
    vl[a] = in ? valid[(size_t)a * D + d] : 0.0f;
    nk[a] = nka;
    r0[a] = __frcp_rn(nka);
  }
  const bool mine = t < A;  // slot t is a real slot
  float ndk_t = ndk[t];
  const float vl_t = vl[t], nk_t = nk[t], r0_t = r0[t];
  int last = -1;
  for (int p = t; p < U; p += T) {
    z_out[(size_t)p * D + d] = z0[(size_t)p * D + d];
    if (f[(size_t)p * D + d] > 0.0f) last = p;
  }
  last = __reduce_max_sync(kFullMask, last);
  if (lane == 0) cnt[warp] = last;
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) last = max(last, cnt[w]);
  const int walk = last + 1;  // positions walked per sweep

  // 2. M sweeps over positions 0..walk-1; the next position's scalars and
  //    slot t's cv are loaded before this one's draw.  Every thread writes
  //    the same draw into z_out, so each reads back its own write.
  if (walk > 0 && M > 0) {
    const float* cv_doc = cv + (size_t)d * U * A;
    float fp1 = f[d], u1 = uni[d];
    int zo1 = z_out[d], zb1 = z0[d];
    float cv1 = mine ? cv_doc[t] : 0.0f;
    for (int m = 0; m < M; ++m) {
      for (int p = 0; p < walk; ++p) {
        const float fp = fp1, u = u1, cv_t = cv1;
        const int zo = zo1, zb = zb1;
        int pn = p + 1, mn = m;
        if (pn == walk) { pn = 0; ++mn; }
        if (mn < M) {
          fp1 = f[(size_t)pn * D + d];
          zb1 = z0[(size_t)pn * D + d];
          zo1 = z_out[(size_t)pn * D + d];
          u1 = uni[((size_t)mn * U + pn) * D + d];
          cv1 = mine ? cv_doc[(size_t)pn * A + t] : 0.0f;
        }
        const int pf = p + kPrefetch < walk ? p + kPrefetch : p + kPrefetch - walk;
        if (lane == 0 && mine && pf < walk)
          asm volatile("prefetch.global.L2 [%0];\n" :: "l"(cv_doc + (size_t)pf * A + t));
        if (!(fp > 0.0f)) continue;

        // phase 1: each slot's weight and the in-group scan; the group
        // totals to shared memory
        const float* cv_row = cv_doc + (size_t)p * A;
        const float l_t = group_scan(
            mine ? general_weight(ndk_t, vl_t, nk_t, r0_t, cv_t, t, zo, zb, fp, alpha, beta)
                 : 0.0f, lane);
        lsc[t] = l_t;
        if ((lane & (kGroup - 1)) == kGroup - 1) tot[t / kGroup] = l_t;
        for (int a = t + T; a < N; a += T) {
          const float l = group_scan(
              a < A ? general_weight(ndk[a], vl[a], nk[a], r0[a], cv_row[a], a, zo, zb,
                                     fp, alpha, beta)
                    : 0.0f, lane);
          lsc[a] = l;
          if ((lane & (kGroup - 1)) == kGroup - 1) tot[a / kGroup] = l;
        }
        __syncthreads();

        // phase 2: the groups' sequential prefix P[h] = P[h-1] + T[h-1],
        // u * c[A-1], and the count of slots with c < u * c[A-1]
        float P = 0.0f, P_t = 0.0f;
        const int h_t = t / kGroup;
        for (int h = 0; h < G; ++h) {
          if (h == h_t) P_t = P;
          if (h + 1 < G) P = P + tot[h];
        }
        const float r = u * (P + lsc[A - 1]);
        int n = (mine && P_t + l_t < r) ? 1 : 0;
        if (N > T) {  // slots t + j*T, j >= 1: their prefixes from the start
          float Ph = 0.0f;
          int h = 0;
          for (int a = t + T; a < A; a += T) {
            for (; h < a / kGroup; ++h) Ph = Ph + tot[h];
            n += (Ph + lsc[a] < r) ? 1 : 0;
          }
        }
        n = __reduce_add_sync(kFullMask, n);
        if (lane == 0) cnt[warp] = n;
        __syncthreads();
        int zn = 0;
        for (int w = 0; w < n_warps; ++w) zn += cnt[w];

        // phase 3: the owners of the two slots the draw touches, in the
        // plain version's order: (n_dk - f·[a = zo]) + f·[a = zn]
        if (t == zo) ndk_t = ndk_t - fp;
        if (t == zn) ndk_t = ndk_t + fp;
        if (N > T) {
          if (zo >= T && zo < N && zo % T == t) ndk[zo] = ndk[zo] - fp;
          if (zn >= T && zn < N && zn % T == t) ndk[zn] = ndk[zn] + fp;
        }
        z_out[(size_t)p * D + d] = zn;
        if (pn == p) zo1 = zn;  // walk == 1: the next draw is this position's
      }
    }
  }
  if (mine) ndk_out[(size_t)t * D + d] = ndk_t;
  for (int a = t + T; a < A; a += T) ndk_out[(size_t)a * D + d] = ndk[a];
}

// --------------------------------------------------------------- warp route

constexpr int kWarpRowsMax = 8;        // S_MAX: rows of 32 slots, A <= 256
constexpr int kRingBufs = 2;           // cv chunks in flight per warp
constexpr size_t kChunkBytes = 2048;   // cv bytes per ring buffer, as a rule

// Positions per cv chunk: a power of two up to 32 (so that chunks tile the
// 32-position scalar chunks), the most whose rows fit kChunkBytes, but 8
// where 8 rows fit twice that (A <= 128): a chunk's first step waits and
// loads its operands unpipelined, and at C = 4 that cost shows.
__host__ __device__ inline int warp_chunk_positions(int A) {
  int C = 32;
  while (C > 1 && (size_t)C * A * 4 > kChunkBytes) C >>= 1;
  return C < 8 && (size_t)8 * A * 4 <= 2 * kChunkBytes ? 8 : C;
}

__host__ __device__ inline size_t warp_buf_bytes(int A) {
  return round16((size_t)warp_chunk_positions(A) * A * 4);
}

// Per warp: the ring, the block-start totals (A floats), one mbarrier per
// buffer; a multiple of 16 bytes.
__host__ __device__ inline size_t warp_smem_bytes(int A) {
  return kRingBufs * warp_buf_bytes(A) + round16((size_t)A * 4) + kRingBufs * 8;
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// The first half of a warp-route draw at a position of frequency fp, live
// slot zo and block-start slot zb, with rz = rcp_rn(n_k[zb] - fp) and the
// position's cv values cvv: leaves n_dk minus the own count in ndk, every
// slot's prefixed sum in c and u * c[A-1] in r.  g0..g2: the lane's group
// of eight within its row.
template <int S>
__device__ __forceinline__ void warp_weigh(float (&ndk)[S], const float (&vl)[S],
                                           const float (&r0)[S], const float (&cvv)[S],
                                           float fp, int zo, int zb, float u, float rz,
                                           int lane, int last_lane, bool g0, bool g1, bool g2,
                                           float alpha, float beta, float (&c)[S], float& r) {
  float l[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int a = lane + 32 * j;
    const bool own_slot = a == zb;
    const float own = own_slot ? fp : 0.0f;
    ndk[j] = ndk[j] - ((a == zo) ? fp : 0.0f);  // ndk_m
    float w = vl[j] * (ndk[j] + alpha);
    w = w * ((cvv[j] - own) + beta);
    w = w * (own_slot ? rz : r0[j]);
    l[j] = group_scan(w, lane);
  }
  // the group totals of every row, gathered together, then the sequential
  // prefix P[h] = P[h-1] + T[h-1]
  float P[4 * S];
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      P[4 * j + k] = __shfl_sync(kFullMask, l[j], kGroup * k + kGroup - 1);
#pragma unroll
  for (int h = 4 * S - 1; h > 0; --h) P[h] = P[h - 1];  // P[h] holds T[h-1]
  P[0] = 0.0f;
#pragma unroll
  for (int h = 1; h < 4 * S; ++h) P[h] = P[h - 1] + P[h];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const float before = g0 ? P[4 * j] : g1 ? P[4 * j + 1] : g2 ? P[4 * j + 2] : P[4 * j + 3];
    c[j] = before + l[j];
  }
  r = u * __shfl_sync(kFullMask, c[S - 1], last_lane);  // u * c[A-1]
}

// The draw's second half: the number of slots below A with c < r.
template <int S>
__device__ __forceinline__ int warp_count(const float (&c)[S], float r, unsigned last_bits) {
  int zn = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    unsigned bits = __ballot_sync(kFullMask, c[j] < r);
    if (j + 1 == S) bits &= last_bits;
    zn += __popc(bits);
  }
  return zn;
}

// A ring buffer's row: the lane's S cv values (none past slot A-1).
template <int S>
__device__ __forceinline__ void load_row(float (&cvv)[S], const float* row, int A, int lane) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int a = lane + 32 * j;
    cvv[j] = (j + 1 < S || a < A) ? row[a] : 0.0f;
  }
}

// Chunk k of the walk into ring buffer b: one bulk copy by lane 0 on the
// buffer's mbarrier, or a 4-byte cp.async per element and one commit group
// per lane.
__device__ __forceinline__ void ring_fill(int k, int b, int C, int walk, int A,
                                           const float* cv_doc, float* ring,
                                           size_t buf_floats, uint64_t* bar, bool bulk,
                                           int lane) {
  const int p0 = k * C, np = min(C, walk - p0);
  const float* src = cv_doc + (size_t)p0 * A;
  float* dst = ring + b * buf_floats;
  if (bulk) {
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(np * A * 4);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bar + b)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar + b))
          : "memory");
    }
  } else {
    for (int e = lane; e < np * A; e += 32) cp_async4(dst + e, src + e);
    cp_async_commit();
  }
}

// Starts a warp's ring of NB buffers: their mbarriers where chunks come by
// bulk copy, then chunks 0 .. min(NB, total) - 1.  Its __syncwarp also
// orders the per-slot state the lanes wrote before it.
template <int NB>
__device__ __forceinline__ void ring_start(int total, int C, int walk, int A,
                                           const float* cv_doc, float* ring,
                                           size_t buf_floats, uint64_t* bar, bool bulk,
                                           int lane) {
  if (bulk && lane == 0) {
    for (int b = 0; b < NB; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bar + b)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int g = 0; g < min(NB, total); ++g)
    ring_fill(g, g, C, walk, A, cv_doc, ring, buf_floats, bar, bulk, lane);
}

// Waits for ring chunk g of `total` on a ring of NB buffers (chunks up to
// g + NB - 1 requested).  The 4-byte copies' groups complete in order: it
// lets NB - 1 stay in flight where that many were requested, else none.
template <int NB>
__device__ __forceinline__ void ring_wait(int g, int total, uint64_t* bar, bool bulk) {
  if (bulk) {
    mbar_wait(bar + g % NB, (uint32_t)((g / NB) & 1));
  } else {
    if (g + NB - 1 < total) asm volatile("cp.async.wait_group %0;\n" :: "n"(NB - 1) : "memory");
    else cp_async_wait_all();
    __syncwarp();
  }
}

// A warp's walk of document d: positions up to its last with f > 0, none
// where M == 0.  The positions past the walk keep z0 in z_out.
__device__ __forceinline__ int warp_walk(const float* __restrict__ f,
                                         const int* __restrict__ z0, int* z_out, int M,
                                         int U, int D, int d, int lane) {
  int last = -1;
  for (int p = lane; p < U; p += 32)
    if (f[(size_t)p * D + d] > 0.0f) last = p;
  const int walk = M > 0 ? __reduce_max_sync(kFullMask, last) + 1 : 0;
  for (int p = walk + lane; p < U; p += 32)
    z_out[(size_t)p * D + d] = z0[(size_t)p * D + d];
  return walk;
}

// The scalars of position sc*32 + lane in sweep m (none past the walk): f,
// block-start slot, live slot (z0's in sweep 0; z_out's after, unless the
// walk is one chunk of 32, whose live slots stay in registers) and uniform.
__device__ __forceinline__ void fetch_scalars(int m, int sc, int nsc, int walk, int U,
                                              int D, int d, int lane,
                                              const float* __restrict__ f,
                                              const int* __restrict__ z0,
                                              const float* __restrict__ uni,
                                              const int* z_out, float& fv, int& zb,
                                              int& zl, float& uv) {
  const int q = sc * 32 + lane;
  fv = 0.0f, zb = 0, zl = 0, uv = 0.0f;
  if (q < walk) {
    const size_t o = (size_t)q * D + d;
    fv = f[o];
    zb = z0[o];
    zl = m == 0 ? zb : nsc > 1 ? z_out[o] : 0;
    uv = uni[((size_t)m * U + q) * D + d];
  }
}

// A document's walk by its warp, for the warp and wide routes: the cv ring
// of NB buffers of C positions (resident across the M sweeps where the walk
// is at most NB chunks), the per-position scalars a chunk of 32 ahead with
// rcp_rn(n_k[zb] - f), and the 32 live slots written back after each 32
// positions.  n_k[zb] comes from nk when the scalars are taken, where
// NkShared (the block-start totals in shared memory, (A,)), else from nk
// when they are loaded (nkg in global memory, (A, D)).  A segment is one
// ring chunk inside one chunk of 32, positions [p0, p1): seg(p0, p1, row,
// f_c, u_c, rz_c, zb_c, zl_c) runs its steps from cv row `row`, taking
// position cb + i's scalars from lane i of *_c and leaving its draw in
// lane i's zl_c.
template <int NB, bool NkShared, class Seg>
__device__ __forceinline__ void walk_chunks(const float* __restrict__ cv,
                                            const float* __restrict__ f,
                                            const float* __restrict__ uni,
                                            const int* __restrict__ z0, const float* nk,
                                            int* z_out, int M, int U, int A, int D, int d,
                                            int lane, int walk, int C, float* ring,
                                            size_t buf_floats, uint64_t* bar, Seg seg) {
  const int nck = (walk + C - 1) / C, nsc = (walk + 31) / 32;
  const bool resident = nck <= NB;  // loaded once for all M sweeps
  const int total = resident ? nck : M * nck;
  const bool bulk = A % 4 == 0 && (reinterpret_cast<uintptr_t>(cv) & 15) == 0;
  const float* cv_doc = cv + (size_t)d * U * A;
  ring_start<NB>(total, C, walk, A, cv_doc, ring, buf_floats, bar, bulk, lane);

  // Scalars: *_c of the 32 positions being read (lane i: position cb + i),
  // *_n of the next 32, loaded a chunk ahead.
  float f_n, u_n, nk_n = 0.0f, f_c = 0.0f, u_c = 0.0f, rz_c = 0.0f;
  int zb_n, zl_n, zb_c = 0, zl_c = 0;
  auto fetch = [&](int m, int sc) {
    fetch_scalars(m, sc, nsc, walk, U, D, d, lane, f, z0, uni, z_out, f_n, zb_n, zl_n, u_n);
    if (!NkShared) nk_n = nk[(size_t)min(max(zb_n, 0), A - 1) * D + d];
  };
  fetch(0, 0);

  for (int m = 0; m < M; ++m) {
    for (int k = 0; k < nck; ++k) {
      const int p0 = k * C, p1 = min(p0 + C, walk);
      if ((p0 & 31) == 0) {  // take the next 32 positions' scalars
        f_c = f_n, u_c = u_n, zb_c = zb_n;
        if (m == 0 || nsc > 1) zl_c = zl_n;  // one chunk of 32: its slots carry over
        rz_c = __frcp_rn((NkShared ? nk[min(max(zb_c, 0), A - 1)] : nk_n) - f_c);
        const int sc = p0 / 32 + 1;  // the 32 after these: (m, sc) or (m + 1, 0)
        if (sc < nsc) fetch(m, sc);
        else if (m + 1 < M) fetch(m + 1, 0);
      }
      const int g = resident ? k : m * nck + k;
      if (!resident || m == 0) ring_wait<NB>(g, total, bar, bulk);
      seg(p0, p1, ring + (g % NB) * buf_floats, f_c, u_c, rz_c, zb_c, zl_c);
      if ((p1 & 31) == 0 || p1 == walk) {  // write the 32 live slots back
        const int cb = (p1 - 1) & ~31;
        if (cb + lane < walk) z_out[(size_t)(cb + lane) * D + d] = zl_c;
      }
      if (!resident && g + NB < total) {  // refill the buffer
        __syncwarp();  // every lane is done with chunk g's buffer
        // chunk g + NB is chunk k + NB of the walk, wrapped (streaming
        // means nck > NB, so one wrap at most)
        const int k2 = k + NB < nck ? k + NB : k + NB - nck;
        ring_fill(k2, g % NB, C, walk, A, cv_doc, ring, buf_floats, bar, bulk, lane);
      }
    }
  }
}

// One warp per CTA, one document per warp.  The explicit minimum of one CTA
// per SM lets ptxas give each S the registers it needs: with the thread
// bound alone it held S = 2 to 60 registers, which ran slower on the H100,
// and spilled at some S.
template <int S>
__global__ void __launch_bounds__(32, 1)
fused_block_warp_kernel(const float* __restrict__ cv,     // (D, U, A)
                        const float* __restrict__ f,      // (U, D)
                        const float* __restrict__ uni,    // (M, U, D)
                        const int* __restrict__ z0,       // (U, D)
                        const float* __restrict__ nkg,    // (A, D), pre-biased
                        const float* __restrict__ valid,  // (A, D)
                        const float* __restrict__ ndk0,   // (A, D)
                        int* z_out,                       // (U, D), the live z
                        float* __restrict__ ndk_out,      // (A, D)
                        int M, int U, int A, int D, float alpha, float beta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, d = blockIdx.x;
  const size_t buf_floats = warp_buf_bytes(A) / 4;
  float* ring = reinterpret_cast<float*>(smem);
  float* nk_s = ring + kRingBufs * buf_floats;  // (A,) block-start totals
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRingBufs * warp_buf_bytes(A) +
                                              round16((size_t)A * 4));

  // 1. per-slot registers (slot lane + 32 j); the totals to shared memory
  float ndk[S], vl[S], r0[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int a = lane + 32 * j;
    const bool in = a < A;
    const float nka = in ? nkg[(size_t)a * D + d] : 1.0f;
    ndk[j] = in ? ndk0[(size_t)a * D + d] : 0.0f;
    vl[j] = in ? valid[(size_t)a * D + d] : 0.0f;
    r0[j] = in ? __frcp_rn(nka) : 0.0f;
    if (in) nk_s[a] = nka;
  }

  // 2. the walk; z_out of the positions past it
  const int walk = warp_walk(f, z0, z_out, M, U, D, d, lane);

  if (walk > 0) {
    const int last_lane = (A - 1) & 31;
    const unsigned last_bits = kFullMask >> (31 - last_lane);  // the last row's lanes below A
    const int grp = lane / kGroup;
    const bool g0 = grp == 0, g1 = grp == 1, g2 = grp == 2;
    // a segment's loop makes no branch and no wait; the next position's
    // operands are loaded a step ahead
    walk_chunks<kRingBufs, true>(
        cv, f, uni, z0, nk_s, z_out, M, U, A, D, d, lane, walk, warp_chunk_positions(A), ring,
        buf_floats, bar,
        [&](int p0, int p1, const float* row, float f_c, float u_c, float rz_c, int zb_c,
            int& zl_c) {
          float cvv[S];
          load_row<S>(cvv, row, A, lane);
          const int i0 = p0 & 31;
          float fp = __shfl_sync(kFullMask, f_c, i0), u = __shfl_sync(kFullMask, u_c, i0);
          float rz = __shfl_sync(kFullMask, rz_c, i0);
          int zo = __shfl_sync(kFullMask, zl_c, i0), zb = __shfl_sync(kFullMask, zb_c, i0);
          // unrolled by two: ptxas then overlaps one step's tail with the
          // next step's head (within a percent or two at S = 2, faster at
          // S = 1 and 4 on the H100)
#pragma unroll 2
          for (int p = p0; p < p1; ++p) {
            float c[S], r;
            warp_weigh<S>(ndk, vl, r0, cvv, fp, zo, zb, u, rz, lane, last_lane, g0, g1, g2,
                          alpha, beta, c, r);
            // while the count is in flight: the next position's operands
            // (the segment's last step loads its own again, unused)
            const bool step = p + 1 < p1;
            const int i = (p + step) & 31;
            row += step ? A : 0;
            load_row<S>(cvv, row, A, lane);
            const float fp_n = __shfl_sync(kFullMask, f_c, i);
            u = __shfl_sync(kFullMask, u_c, i);
            rz = __shfl_sync(kFullMask, rz_c, i);
            const int zo_n = __shfl_sync(kFullMask, zl_c, i);
            zb = __shfl_sync(kFullMask, zb_c, i);
            // the draw: a position with f == 0 keeps its slot (and adds 0)
            int zn = warp_count<S>(c, r, last_bits);
            zn = fp > 0.0f ? zn : zo;
#pragma unroll
            for (int j = 0; j < S; ++j) ndk[j] = ndk[j] + ((lane + 32 * j == zn) ? fp : 0.0f);
            zl_c = lane == (p & 31) ? zn : zl_c;
            fp = fp_n, zo = zo_n;
          }
        });
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int a = lane + 32 * j;
    if (a < A) ndk_out[(size_t)a * D + d] = ndk[j];
  }
}

template <int S>
int warp_launch(size_t smem, cudaStream_t stream, const float* cv, const float* f,
                const float* uni, const int* z0, const float* nkg, const float* valid,
                const float* ndk0, int* z_out, float* ndk_out, int M, int U, int A, int D,
                float alpha, float beta) {
  fused_block_warp_kernel<S><<<D, 32, smem, stream>>>(
      cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, M, U, A, D, alpha, beta);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- wide route

constexpr int kWideRegRows = 8;           // rows of 32 slots in registers
constexpr int kWideRingBufs = 2;          // cv chunks in flight per warp
constexpr size_t kWideChunkBytes = 4096;  // cv bytes per ring buffer, at most

__host__ __device__ inline int wide_rows(int A) { return (A + 31) / 32; }

// Positions per cv chunk: a power of two up to 32 whose rows fit
// kWideChunkBytes, at least one.
__host__ __device__ inline int wide_chunk_positions(int A) {
  int C = 32;
  while (C > 1 && (size_t)C * A * 4 > kWideChunkBytes) C >>= 1;
  return C;
}

__host__ __device__ inline size_t wide_buf_bytes(int A) {
  return round16((size_t)wide_chunk_positions(A) * A * 4);
}

// Per warp: the ring; four floats a slot of the rows past the register
// rows (n_dk, valid, rcp_rn(n_k), the step's prefixed sum), [row][lane];
// one mbarrier per buffer.  For A > 32 * kWideRegRows.
__host__ __device__ inline size_t wide_smem_bytes(int A) {
  return kWideRingBufs * wide_buf_bytes(A) +
         (size_t)(wide_rows(A) - kWideRegRows) * 32 * 16 + kWideRingBufs * 8;
}

// A row's prefixed sums from its in-group sums l: its four group totals by
// shuffles from lanes 7, 15, 23 and 31, then the sequential prefix carried
// across rows in run, P[4j] = run and P[4j+k+1] = P[4j+k] + T[4j+k] (so
// P[0] = 0 and P[1] = 0 + T[0] = T[0]); returns P of the lane's group + l.
__device__ __forceinline__ float row_prefix(float l, float& run, int grp) {
  const float t0 = __shfl_sync(kFullMask, l, kGroup - 1);
  const float t1 = __shfl_sync(kFullMask, l, 2 * kGroup - 1);
  const float t2 = __shfl_sync(kFullMask, l, 3 * kGroup - 1);
  const float t3 = __shfl_sync(kFullMask, l, 4 * kGroup - 1);
  const float p0 = run, p1 = p0 + t0, p2 = p1 + t1, p3 = p2 + t2;
  run = p3 + t3;
  return (grp == 0 ? p0 : grp == 1 ? p1 : grp == 2 ? p2 : p3) + l;
}

// One warp per CTA, one document per warp, A > 32 * kWideRegRows slots:
// rows 0..R-1 in registers as the warp route's, rows R..S-1 in shared memory.
__global__ void __launch_bounds__(32, 1)
fused_block_wide_kernel(const float* __restrict__ cv,     // (D, U, A)
                        const float* __restrict__ f,      // (U, D)
                        const float* __restrict__ uni,    // (M, U, D)
                        const int* __restrict__ z0,       // (U, D)
                        const float* __restrict__ nkg,    // (A, D), pre-biased
                        const float* __restrict__ valid,  // (A, D)
                        const float* __restrict__ ndk0,   // (A, D)
                        int* z_out,                       // (U, D), the live z
                        float* __restrict__ ndk_out,      // (A, D)
                        int M, int U, int A, int D, float alpha, float beta) {
  constexpr int R = kWideRegRows, NB = kWideRingBufs;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, d = blockIdx.x;
  const int E = wide_rows(A) - R;  // rows in shared memory, >= 1
  const size_t buf_floats = wide_buf_bytes(A) / 4;
  float* ring = reinterpret_cast<float*>(smem);
  float* ndk_s = ring + NB * buf_floats;  // slot 32 (R + e) + lane at 32 e + lane
  float* vl_s = ndk_s + 32 * E;
  float* r0_s = vl_s + 32 * E;
  float* c_s = r0_s + 32 * E;
  uint64_t* bar = reinterpret_cast<uint64_t*>(c_s + 32 * E);

  // 1. per-slot state: rows 0..R-1 (every slot below A) in registers, the
  //    rest in shared memory, each slot read and written by its own lane only
  float ndk[R], vl[R], r0[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const size_t o = (size_t)(lane + 32 * j) * D + d;
    ndk[j] = ndk0[o];
    vl[j] = valid[o];
    r0[j] = __frcp_rn(nkg[o]);
  }
  for (int e = 0; e < E; ++e) {
    const int a = 32 * (R + e) + lane;
    const size_t o = (size_t)a * D + d;
    ndk_s[32 * e + lane] = a < A ? ndk0[o] : 0.0f;
    vl_s[32 * e + lane] = a < A ? valid[o] : 0.0f;
    r0_s[32 * e + lane] = a < A ? __frcp_rn(nkg[o]) : 0.0f;
  }

  // 2. the walk; z_out of the positions past it
  const int walk = warp_walk(f, z0, z_out, M, U, D, d, lane);

  if (walk > 0) {
    const int last_lane = (A - 1) & 31;
    const unsigned last_bits = kFullMask >> (31 - last_lane);  // the last row's lanes below A
    const int grp = lane / kGroup;
    walk_chunks<NB, false>(
        cv, f, uni, z0, nkg, z_out, M, U, A, D, d, lane, walk, wide_chunk_positions(A), ring,
        buf_floats, bar,
        [&](int p0, int p1, const float* row, float f_c, float u_c, float rz_c, int zb_c,
            int& zl_c) {
          for (int p = p0; p < p1; ++p, row += A) {
            const int i = p & 31;
            const float fp = __shfl_sync(kFullMask, f_c, i), u = __shfl_sync(kFullMask, u_c, i);
            const float rz = __shfl_sync(kFullMask, rz_c, i);
            const int zo = __shfl_sync(kFullMask, zl_c, i), zb = __shfl_sync(kFullMask, zb_c, i);
            // every slot's weight, in-group scan and prefixed sum, row by row
            float run = 0.0f, c[R];
#pragma unroll
            for (int j = 0; j < R; ++j) {
              const int a = lane + 32 * j;
              const bool own_slot = a == zb;
              const float own = own_slot ? fp : 0.0f;
              ndk[j] = ndk[j] - ((a == zo) ? fp : 0.0f);  // ndk_m
              float w = vl[j] * (ndk[j] + alpha);
              w = w * ((row[a] - own) + beta);
              w = w * (own_slot ? rz : r0[j]);
              c[j] = row_prefix(group_scan(w, lane), run, grp);
            }
            float c_end = 0.0f;  // the last row's
#pragma unroll 4
            for (int e = 0; e < E; ++e) {
              const int a = 32 * (R + e) + lane, s = 32 * e + lane;
              const bool own_slot = a == zb;
              const float own = own_slot ? fp : 0.0f;
              const float ndk_m = ndk_s[s] - ((a == zo) ? fp : 0.0f);
              float w = vl_s[s] * (ndk_m + alpha);
              w = w * (((a < A ? row[a] : 0.0f) - own) + beta);
              w = w * (own_slot ? rz : r0_s[s]);
              c_end = row_prefix(group_scan(w, lane), run, grp);
              c_s[s] = c_end;
            }
            const float r = u * __shfl_sync(kFullMask, c_end, last_lane);  // u * c[A-1]
            // the draw: the slots below A with c < r; a position with f == 0
            // keeps its slot (and adds 0)
            int zn = 0;
#pragma unroll
            for (int j = 0; j < R; ++j) zn += __popc(__ballot_sync(kFullMask, c[j] < r));
#pragma unroll 4
            for (int e = 0; e + 1 < E; ++e)
              zn += __popc(__ballot_sync(kFullMask, c_s[32 * e + lane] < r));
            zn += __popc(__ballot_sync(kFullMask, c_end < r) & last_bits);
            zn = fp > 0.0f ? zn : zo;
#pragma unroll
            for (int j = 0; j < R; ++j) ndk[j] = ndk[j] + ((lane + 32 * j == zn) ? fp : 0.0f);
            // in shared memory only slots zo and zn change, each by its own
            // lane, in the plain version's order: (n_dk - f) + f
            const int so = zo - 32 * R, sn = zn - 32 * R;
            if (fp > 0.0f && so >= 0 && zo < A && lane == (zo & 31)) ndk_s[so] = ndk_s[so] - fp;
            if (fp > 0.0f && sn >= 0 && zn < A && lane == (zn & 31)) ndk_s[sn] = ndk_s[sn] + fp;
            zl_c = lane == i ? zn : zl_c;
          }
        });
  }
#pragma unroll
  for (int j = 0; j < R; ++j) ndk_out[(size_t)(lane + 32 * j) * D + d] = ndk[j];
  for (int e = 0; e < E; ++e) {
    const int a = 32 * (R + e) + lane;
    if (a < A) ndk_out[(size_t)a * D + d] = ndk_s[32 * e + lane];
  }
}

// The device's shared memory per CTA (opt-in), or -1 on a CUDA error.
int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return limit;
}

}  // namespace

// The largest U the kernel takes at A slots on the current device (its
// staging must fit one CTA's shared memory); -1 on a CUDA error.
extern "C" int fused_block_max_positions(int A) {
  const int limit = smem_limit();
  if (limit < 0 || A < 1 || A > 32) return -1;
  int U = 0;
  while (smem_bytes(U + 1, A) <= (size_t)limit) ++U;
  return U;
}

// Bytes of per-document state of the general route at A slots; it lives
// in shared memory where it fits (fused_block_smem_limit()), else in a
// scratch buffer of D times as many bytes that the caller passes.
extern "C" long long fused_block_general_state_bytes(int A) {
  return A < 1 ? -1 : (long long)(general_state_floats(A) * sizeof(float));
}

// The device's opt-in shared memory per CTA; -1 on a CUDA error.
extern "C" int fused_block_smem_limit() { return smem_limit(); }

// Launches the general route on `stream`, one CTA per document, with its
// state in `scratch` (D * fused_block_general_state_bytes(A) bytes) or, if
// that is null, in shared memory; returns cudaGetLastError() as an int.
extern "C" int fused_block_general_launch(const float* cv, const float* f,
                                          const float* uni, const int* z0,
                                          const float* nkg, const float* valid,
                                          const float* ndk0, int* z_out,
                                          float* ndk_out, float* scratch, int M,
                                          int U, int A, int D, float alpha,
                                          float beta, void* stream) {
  const int limit = smem_limit();
  const size_t smem = scratch ? 0 : general_state_floats(A) * sizeof(float);
  if (A < 1 || U < 0 || M < 0 || limit < 0 || smem > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_block_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_block_general_kernel<<<D, general_threads(A), smem,
                               static_cast<cudaStream_t>(stream)>>>(
      cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, scratch, M, U, A, D,
      alpha, beta);
  return (int)cudaGetLastError();
}

// S_MAX: the warp route takes A <= 32 * fused_block_warp_rows_max() slots.
extern "C" int fused_block_warp_rows_max() { return kWarpRowsMax; }

// Launches the warp route on `stream`, one CTA of one warp per document;
// returns cudaGetLastError() as an int.
extern "C" int fused_block_warp_launch(const float* cv, const float* f,
                                       const float* uni, const int* z0,
                                       const float* nkg, const float* valid,
                                       const float* ndk0, int* z_out, float* ndk_out,
                                       int M, int U, int A, int D, float alpha,
                                       float beta, void* stream) {
  const int S = (A + 31) / 32;
  const size_t smem = warp_smem_bytes(A);
  if (A < 1 || S > kWarpRowsMax || U < 0 || M < 0 || D < 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FB_WARP_CASE(N)                                                           \
  case N:                                                                         \
    return warp_launch<N>(smem, st, cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, \
                          M, U, A, D, alpha, beta);
  switch (S) {
    FB_WARP_CASE(1) FB_WARP_CASE(2) FB_WARP_CASE(3) FB_WARP_CASE(4)
    FB_WARP_CASE(5) FB_WARP_CASE(6) FB_WARP_CASE(7) FB_WARP_CASE(8)
  }
#undef FB_WARP_CASE
  return (int)cudaErrorInvalidValue;
}

// The widest A the wide route takes on the current device (its shared
// memory must fit one CTA, opt-in); 32 * kWideRegRows where it takes none,
// -1 on a CUDA error.
extern "C" int fused_block_wide_max_slots() {
  const int limit = smem_limit();
  if (limit < 0) return -1;
  int A = 32 * kWideRegRows;
  while (wide_smem_bytes(A + 1) <= (size_t)limit) ++A;
  return A;
}

// Launches the wide route on `stream`, one CTA of one warp per document,
// for 32 * kWideRegRows < A <= fused_block_wide_max_slots(); returns
// cudaGetLastError() as an int.
extern "C" int fused_block_wide_launch(const float* cv, const float* f,
                                       const float* uni, const int* z0,
                                       const float* nkg, const float* valid,
                                       const float* ndk0, int* z_out, float* ndk_out,
                                       int M, int U, int A, int D, float alpha,
                                       float beta, void* stream) {
  const int limit = smem_limit();
  if (A <= 32 * kWideRegRows || U < 0 || M < 0 || D < 1 || limit < 0 ||
      wide_smem_bytes(A) > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes(A);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_block_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_block_wide_kernel<<<D, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, M, U, A, D, alpha, beta);
  return (int)cudaGetLastError();
}

// Launches the staged kernel on `stream`, one CTA per document; returns
// cudaGetLastError() as an int.
extern "C" int fused_block_launch(const float* cv, const float* f,
                                  const float* uni, const int* z0,
                                  const float* nkg, const float* valid,
                                  const float* ndk0, int* z_out,
                                  float* ndk_out, int M, int U, int A, int D,
                                  float alpha, float beta, void* stream) {
  const int limit = smem_limit();
  const size_t smem = smem_bytes(U, A);
  if (A < 1 || A > 32 || U < 0 || limit < 0 || smem > (size_t)limit)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_block_kernel<<<D, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      cv, f, uni, z0, nkg, valid, ndk0, z_out, ndk_out, M, U, A, D, alpha,
      beta);
  return (int)cudaGetLastError();
}
