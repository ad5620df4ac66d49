// K3: the fused working-set head, and K4: the two-pass score head.
//
// Replaces repro/kernels/fused_ws.py:fused_ws_pallas (body _fused_kernel,
// tile width _pick_bp), scalar coordinates. From the feature-major design
// Xt [p, n] it computes, for every feature j,
//   grad_j  = Xt[j] . r + offset_j
//   score_j = the violation score (subdiff distance or fixed point),
// then, for every tile of bp features, the tile's top-kc features under the
// lax.top_k order (priority descending, lowest index first on ties,
// generalized support pinned to +inf; slots past the tile's valid rows emit
// index p).
//
// The TPU kernel copies the candidate columns out of the tile it holds in
// VMEM. An SM cannot hold a tile of X (bp*n*8 bytes), so a copy here is a
// second pass over device memory, and its [tiles * kc, n] buffer is as
// large as X once ws >= bp. So no candidate row is copied: the working set
// is merged from the tiles' sorted candidate lists, and the wrapper
// (kernels/ops.py) gathers just its K rows of Xt.
//
// What bounds it on the H100: bytes. X is read once (p*n values); the
// score, sort and index work is small beside that.
//
// Design: three launches on the caller's stream, no host read.
//  1. score launch: one warp a feature, each lane streaming contiguous
//     elements of the feature's row with four independent partial sums so
//     loads stay in flight; the score epilogue runs in registers on lane 0,
//     which writes the gradient, the score and the selection priority.
//  2. select launch: one CTA a tile sorts the tile's (priority, index)
//     pairs in shared memory with a bitonic network whose comparison is the
//     lax.top_k total order and writes the first kc indices (cand_idx).
//  3. merge launch: the working set, the first K of that order over all
//     features, is the first K of the merged tile lists (a feature in it
//     is within its tile's first kc = min(bp, K)). ceil(sqrt(tiles)) CTAs
//     each merge a run of tiles into their first K (merge path: each
//     thread finds its run of outputs by a binary search, then merges it),
//     and the last CTA to finish merges those lists. It replaces a stable
//     sort of all p priorities (several launches, a sixth of the head).
//
// K3b (fused_ws_block) replaces the block branch of the same Pallas kernel
// (multitask coefficients beta [p, T], raw gradient R [n, T], a block
// penalty): grad = Xt @ R + offset (a [p, T] product), the row score of
// each feature, and each tile's top-kc candidates (cand_idx) in the
// lax.top_k order. Like K3 it copies no candidate rows.
// Bound on the H100: bytes (X read once, 1.6 GB at n = 10,000,
// p = 20,000: 0.48 ms at 3.35 TB/s); the 2 p n T products (8 GFLOP at
// T = 20) take 0.12 ms on the float64 tensor cores (67 TF/s), so they must
// overlap the stream of X. Design, float64:
//  1. product launch: one launch of mma.sync f64 (DMMA) over the whole
//     [p, N] product (N = T columns), chosen by the launch plan
//     (kernels/fused_ws.py: product_plan):
//     - narrow (N <= 24, block_mma_kernel): a CTA of 4 warps takes 64
//       features (a warp 16 = two m-tiles of m8n8k4) x 24 columns (three
//       n-tiles of 8) over one span of the samples. X [64, 32] and R
//       [32, 24] tiles stream into shared memory with cp.async, two
//       stages; rows are padded (36 and 28 values) so that the fragment
//       loads of a half-warp fall in 16 distinct banks. At ~51 KB of
//       shared memory four CTAs share an SM.
//     - wide (N > 24, wide_mma_kernel): a CTA of 8 warps (2 x 4) takes 64
//       features x a column tile of up to 128 (a warp 32 features x 4
//       n-tiles of 8, the 4 warps of a row taking n-tiles in turn, so a
//       ragged column tile stays balanced over the SM's schedulers), with
//       mma.sync m16n8k4 (an sm_90 shape: the tensor cores reach their
//       67 TF/s rate only on the m16n8 shapes, half of it on m8n8k4),
//       stages of 16 samples through a 4-stage cp.async ring, two CTAs an
//       SM so that one CTA's copies overlap the other's MMAs; rows padded
//       to 20 and 132 values (conflict-free half-warp fragment loads). The
//       column-tile index is the grid's fastest, so the CTAs that share a
//       tile of X run together and X streams from HBM about once; R stays
//       in L2. What bounds it: the copies (their address work and
//       shared-memory writes between the MMAs), not the tensor cores, L2
//       or HBM (PERF.md section 6, where the other tiles and MMA shapes
//       tried are timed).
//     The samples split into spans (the grid's slowest index), chosen by
//     the plan against the card's CTA slots; each CTA writes its partial
//     product, unreduced, to a scratch [spans, p, ld] (ld: 24 narrow, N
//     wide).
//  2. reduce and score launch (reduce_epilogue_kernel), a CTA a block of
//     features: grad = the spans' partials summed in span order (the same
//     order on every run: the result is deterministic) + offset, read and
//     written in memory order, then the row epilogue, one thread a
//     feature (norms over T, the block prox or subdifferential, the
//     priority with the generalized support pinned to +inf).
//  3. select launch: K3's tile sort (cand_idx).
// float32 keeps the scalar product (block_score_kernel): the tensor cores
// have no float32 path of this precision.
//
// K3l (fused_ws_lanes) is K3 over S lanes that share X, the chunked
// driver's dense head (fused_ws_pallas under the reference's vmap: one
// launch over all lanes). Each lane s has its raw gradient R[:, s], its
// beta, L, generalized support and row of the codec vector. Bound: bytes,
// X read once for every lane (S separate K3s would read it S times).
// Design, float64: K3b's product launch on R [n, S] (narrow for S <= 24,
// wide above); the reduce and score launch (one thread a (feature, lane)
// for the scores) sums the spans, computes the scalar score and writes
// grad, score and priority lane-major [S, p]; K3's select and merge
// launches then run with the lane on their grids' y index.
//
// K3bl (fused_ws_block_lanes) is K3b over S lanes of multitask blocks that
// share X (the block branch of fused_ws_pallas under the reference's vmap).
// Lane s has its raw gradient R[:, s*T .. s*T + T - 1] (R [n, S*T],
// lane-major), its beta [p, T], L, generalized support and row of the
// codec vector. Bound: bytes at small S*T (X read once for every lane),
// the float64 tensor cores' operations at large S*T. Design, float64: one
// product launch over all S*T columns (wide past 24: X streams once), then
// the reduce and score launch over blocks of features: it sums the spans'
// partials, writes them + offset to grad [S, p, T], and one thread a
// (feature, lane) computes the row score with the lane's beta, L and
// parameter row and writes score and priority lane-major [S, p]; K3's
// select and merge launches then run with the lane on their grids' y
// index.
//
// K4 (ws_score) replaces repro/kernels/ws_score.py:ws_score_pallas (body
// _score_kernel): the score pass alone, with optional sample weights fused
// into the load, grad_j = Xt[j] . (r * w) + offset_j, and only the scores
// written. It is bound by bytes (X read once). It is K3's score launch with
// the weight product in the inner loop and neither gradient nor priority
// stored.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prox.cuh"

namespace {

constexpr int kScoreThreads = 256;   // 8 warps: 8 features per CTA
constexpr int kSelectThreads = 512;
constexpr int kMergeThreads = 512;
constexpr int kMergeSmemK = 6144;    // the largest K whose merge buffers
                                     // (3 K entries) fit in shared memory
constexpr int kBlkFeat = 64;         // K3b: features per CTA (2 per thread)
constexpr int kBlkN = 64;            // K3b: samples per staged chunk
constexpr int kBlkThreads = 256;     // K3b: 32 feature pairs x 8 task lanes
// the narrow float64 product (DMMA, N <= 24): features and samples a CTA
// tile, columns, padded shared-memory rows, threads; the most sample spans
// of either product
constexpr int kMmaM = 64;
constexpr int kMmaK = 32;
constexpr int kMmaT = 24;
constexpr int kMmaXS = kMmaK + 4;
constexpr int kMmaRS = kMmaT + 4;
constexpr int kMmaThreads = 128;
constexpr int kMmaMaxSplits = 16;
constexpr size_t kMmaSmem = 2 * (kMmaM * kMmaXS + kMmaK * kMmaRS) * sizeof(double);
// the wide float64 product (N > 24): warps down and across a CTA, its
// features, the most columns, samples a stage, ring stages, CTAs an SM
// the registers are budgeted for, threads, padded shared-memory rows
constexpr int kWideWM = 2;
constexpr int kWideWN = 4;
constexpr int kWideM = 32 * kWideWM;
constexpr int kWideN = 128;
constexpr int kWideK = 16;
constexpr int kWideStages = 4;
constexpr int kWidePerSM = 2;
constexpr int kWideThreads = 32 * kWideWM * kWideWN;
constexpr int kWideXS = kWideK + 4;
constexpr int kWideRS = kWideN + 4;
constexpr size_t kWideSmem =
    (size_t)kWideStages * (kWideM * kWideXS + kWideK * kWideRS) * sizeof(double);

template <typename T>
__device__ __forceinline__ bool before(T pa, int ia, T pb, int ib) {
  return (pa > pb) || (pa == pb && ia < ib);
}

// the residual entry the score pass multiplies by: r_i, or r_i * w_i
template <typename T, bool HAS_W>
__device__ __forceinline__ T resid(const T* __restrict__ r, const T* __restrict__ w, int i) {
  if (HAS_W) return r[i] * w[i];
  return r[i];
}

// one warp per feature: scores (and, where the pointers are given, the
// gradient and the selection priority under the generalized support)
template <typename T, bool HAS_W>
__global__ void score_kernel(const T* __restrict__ Xt, const T* __restrict__ r,
                             const T* __restrict__ w, const T* __restrict__ beta,
                             const T* __restrict__ L, const T* __restrict__ offset,
                             const uint8_t* __restrict__ gsupp, T* scores, T* grad, T* pri,
                             int n, int p, int pen, int use_fp,
                             const double* __restrict__ prm) {
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(pen, prm);
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= p) return;  // the whole warp leaves together
  const T* x = Xt + j * (long long)n;
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int i = lane;
  for (; i + 96 < n; i += 128) {
    a0 = a0 + x[i] * resid<T, HAS_W>(r, w, i);
    a1 = a1 + x[i + 32] * resid<T, HAS_W>(r, w, i + 32);
    a2 = a2 + x[i + 64] * resid<T, HAS_W>(r, w, i + 64);
    a3 = a3 + x[i + 96] * resid<T, HAS_W>(r, w, i + 96);
  }
  for (; i < n; i += 32) a0 = a0 + x[i] * resid<T, HAS_W>(r, w, i);
  T acc = (a0 + a1) + (a2 + a3);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const T g = acc + offset[j];
    const T sc = rt::violation_score(pen, use_fp, beta[j], g, L[j], p0, p1);
    scores[j] = sc;
    if (grad) grad[j] = g;
    if (pri) pri[j] = (gsupp[j] ? (T)INFINITY : sc) + T(0);  // +0 folds -0.0 into +0.0
  }
}

// one CTA a tile of bp features: the tile's top-kc indices (cand_idx) in
// the lax.top_k order of the priorities (of lane blockIdx.y: pri [S, p],
// cand_idx [S, tiles * kc])
template <typename T>
__global__ void select_kernel(const T* __restrict__ pri_in, int* cand_idx, int p, int bp, int kc,
                              int sortn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pri = reinterpret_cast<T*>(smem_raw);
  int* idx = reinterpret_cast<int*>(pri + sortn);
  // the lane (blockIdx.y): its priorities and its tiles' lists
  pri_in += (long long)blockIdx.y * p;
  cand_idx += (long long)blockIdx.y * gridDim.x * kc;
  const long long base = (long long)blockIdx.x * bp;
  for (int f = threadIdx.x; f < sortn; f += blockDim.x) {
    const long long j = base + f;
    pri[f] = (f < bp && j < p) ? pri_in[j] : (T)(-INFINITY);
    idx[f] = f;
  }
  __syncthreads();

  // bitonic sort: position 0 holds the first element of the total order
  for (int k = 2; k <= sortn; k <<= 1) {
    for (int s = k >> 1; s > 0; s >>= 1) {
      for (int i = threadIdx.x; i < sortn; i += blockDim.x) {
        const int m = i ^ s;
        if (m > i) {
          const bool asc = (i & k) == 0;
          const bool swap = asc ? before(pri[m], idx[m], pri[i], idx[i])
                                : before(pri[i], idx[i], pri[m], idx[m]);
          if (swap) {
            const T tp = pri[i];
            pri[i] = pri[m];
            pri[m] = tp;
            const int ti = idx[i];
            idx[i] = idx[m];
            idx[m] = ti;
          }
        }
      }
      __syncthreads();
    }
  }

  const long long row0 = (long long)blockIdx.x * kc;
  for (int k = threadIdx.x; k < kc; k += blockDim.x) {
    const int sel = idx[k];
    const long long j = base + sel;
    cand_idx[row0 + k] = (sel < bp && j < p) ? (int)j : p;
  }
}

// the position i in A of the d-th output of merge(A, B) (ties take A first):
// the first d outputs are A[0, i) and B[0, d - i)
template <typename T>
__device__ int merge_path(const T* ap, const int* ai, int la, const T* bq, const int* bi, int lb,
                          int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = d - mid - 1;
    if (before(bq[j], bi[j], ap[mid], ai[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// C[0, lc) = the first lc outputs of merge(A, B), by every thread of the
// CTA (each a contiguous run found by merge_path); ends with a barrier
template <typename T>
__device__ void merge_into(const T* ap, const int* ai, int la, const T* bq, const int* bi, int lb,
                           T* cp, int* ci, int lc) {
  const int per = (lc + blockDim.x - 1) / blockDim.x;
  const int d0 = min(lc, (int)threadIdx.x * per), d1 = min(lc, d0 + per);
  if (d0 < d1) {
    int i = merge_path(ap, ai, la, bq, bi, lb, d0), j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      if (j >= lb || (i < la && !before(bq[j], bi[j], ap[i], ai[i]))) {
        cp[d] = ap[i];
        ci[d] = ai[i];
        ++i;
      } else {
        cp[d] = bq[j];
        ci[d] = bi[j];
        ++j;
      }
    }
  }
  __syncthreads();
}

// K3's working set: the first K features of the lax.top_k order of the
// priorities, from the tiles' sorted top-kc lists (cand_idx). Every CTA
// merges the lists of `per_cta` consecutive tiles into its top K (a
// tile whose first candidate comes after the K-th kept one is skipped),
// writes them to part [gridDim.x, K] (sentinels past the candidates it
// has), and the last CTA to finish merges those partial lists and writes
// ws. The buffers A, C (K entries each, the kept list and the merge
// output) and B (K entries, the list merged in) lie in shared memory, or
// where `gbuf_pri` is given in that global scratch [gridDim.x, 3, K]. The
// grid's y index is the lane: every array above is the lane's, one counter
// a lane.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    ws_merge_kernel(const T* __restrict__ pri, const int* __restrict__ cand_idx, T* part_pri,
                    int* part_idx, T* gbuf_pri, int* gbuf_idx, unsigned* counter, long long* ws,
                    int p, int bp, int kc, int K, int per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  {
    // the lane (blockIdx.y): its priorities, lists, scratch, counter, ws
    const long long ln = blockIdx.y;
    const long long tiles_ = (p + bp - 1) / bp;
    pri += ln * p;
    cand_idx += ln * tiles_ * kc;
    part_pri += ln * gridDim.x * K;
    part_idx += ln * gridDim.x * K;
    if (gbuf_pri) {
      gbuf_pri += ln * gridDim.x * 3 * K;
      gbuf_idx += ln * gridDim.x * 3 * K;
    }
    counter += ln;
    ws += ln * K;
  }
  T* bufp;
  int* bufi;
  if (gbuf_pri) {
    bufp = gbuf_pri + (long long)blockIdx.x * 3 * K;
    bufi = gbuf_idx + (long long)blockIdx.x * 3 * K;
  } else {
    bufp = reinterpret_cast<T*>(smem_raw);
    bufi = reinterpret_cast<int*>(bufp + 3 * K);
  }
  T *ap = bufp, *cp = bufp + K, *bq = bufp + 2 * K;
  int *ai = bufi, *ci = bufi + K, *bi = bufi + 2 * K;
  const int tid = threadIdx.x;
  const int tiles = (p + bp - 1) / bp;
  int la = 0;
  const int t1 = min(tiles, (int)(blockIdx.x + 1) * per_cta);
  for (int t = blockIdx.x * per_cta; t < t1; ++t) {
    const int lb = min(kc, p - t * bp);  // the tile's real candidates
    const int* src = cand_idx + (long long)t * kc;
    if (la == K && !before(pri[src[0]], src[0], ap[K - 1], ai[K - 1])) continue;
    for (int k = tid; k < lb; k += blockDim.x) {
      const int j = src[k];
      bi[k] = j;
      bq[k] = pri[j];
    }
    __syncthreads();
    const int lc = min(K, la + lb);
    merge_into(ap, ai, la, bq, bi, lb, cp, ci, lc);
    T* tp = ap;
    ap = cp;
    cp = tp;
    int* ti = ai;
    ai = ci;
    ci = ti;
    la = lc;
  }
  T* mp = part_pri + (long long)blockIdx.x * K;
  int* mi = part_idx + (long long)blockIdx.x * K;
  for (int k = tid; k < K; k += blockDim.x) {
    mp[k] = k < la ? ap[k] : (T)(-INFINITY);
    mi[k] = k < la ? ai[k] : 0x7fffffff;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last CTA: merge the partial lists (read past L1: other SMs wrote them)
  la = 0;
  for (int g = 0; g < (int)gridDim.x; ++g) {
    const T* gp = part_pri + (long long)g * K;
    const int* gi = part_idx + (long long)g * K;
    if (la == K && !before(__ldcg(gp), __ldcg(gi), ap[K - 1], ai[K - 1])) continue;
    for (int k = tid; k < K; k += blockDim.x) {
      bq[k] = __ldcg(gp + k);
      bi[k] = __ldcg(gi + k);
    }
    __syncthreads();
    const int lc = min(K, la + K);
    merge_into(ap, ai, la, bq, bi, K, cp, ci, lc);
    T* tp = ap;
    ap = cp;
    cp = tp;
    int* ti = ai;
    ai = ci;
    ci = ti;
    la = lc;
  }
  for (int k = tid; k < K; k += blockDim.x) ws[k] = ai[k];
}

// K3b's score launch: A task slots of 8 lanes each per pass (TC = 8A
// tasks), tasks t0 .. t0 + TC - 1 of every pass
template <typename T, int A>
__global__ void __launch_bounds__(kBlkThreads)
    block_score_kernel(const T* __restrict__ Xt, const T* __restrict__ R,
                       const T* __restrict__ beta, const T* __restrict__ L,
                       const T* __restrict__ offset, const uint8_t* __restrict__ gsupp,
                       T* scores, T* grad, T* pri, int n, int p, int nt, int pen, int use_fp,
                       const double* __restrict__ prm) {
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(pen, prm);
  constexpr int TC = 8 * A;
  constexpr int XS = kBlkN + 1;  // padded X tile row: the 4 feature pairs of a
                                 // warp read 4 different banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int XPER = kBlkFeat * kBlkN / kBlkThreads;  // X values per thread
  constexpr int RPER = kBlkN * TC / kBlkThreads;        // R values per thread
  T* xs = reinterpret_cast<T*>(smem_raw);  // [kBlkFeat][XS]
  T* rs = xs + kBlkFeat * XS;              // [kBlkN][TC]
  const int tid = threadIdx.x;
  const int s = tid & 7, g = tid >> 3;     // task lane, feature pair
  const long long f0 = (long long)blockIdx.x * kBlkFeat;
  const long long j0 = f0 + g, j1 = f0 + g + 32;
  // this thread's share of a chunk: X elements (xf + 4k, xi), R elements
  // tid + 256 k of the [kBlkN, TC] chunk
  const int xi = tid % kBlkN, xf = tid / kBlkN;
  T xr[XPER], rr[RPER];
  for (int t0 = 0; t0 < nt; t0 += TC) {
    const int tc = min(TC, nt - t0);
    auto fetch = [&](int i0) {  // chunk i0 into xr / rr
      const int nc = min(kBlkN, n - i0);
#pragma unroll
      for (int k = 0; k < XPER; ++k) {
        const long long j = f0 + xf + k * (kBlkThreads / kBlkN);
        xr[k] = (j < p && xi < nc) ? Xt[j * n + i0 + xi] : T(0);
      }
#pragma unroll
      for (int k = 0; k < RPER; ++k) {
        const int e = tid + k * kBlkThreads, i = e / TC, t = e % TC;
        rr[k] = (i < nc && t < tc) ? R[(long long)(i0 + i) * nt + t0 + t] : T(0);
      }
    };
    T acc0[A], acc1[A];
#pragma unroll
    for (int a = 0; a < A; ++a) acc0[a] = acc1[a] = T(0);
    fetch(0);
    for (int i0 = 0; i0 < n; i0 += kBlkN) {
#pragma unroll
      for (int k = 0; k < XPER; ++k) xs[(xf + k * (kBlkThreads / kBlkN)) * XS + xi] = xr[k];
#pragma unroll
      for (int k = 0; k < RPER; ++k) rs[tid + k * kBlkThreads] = rr[k];
      __syncthreads();
      if (i0 + kBlkN < n) fetch(i0 + kBlkN);  // in flight during the products
#pragma unroll 4
      for (int i = 0; i < kBlkN; ++i) {
        const T x0 = xs[g * XS + i];
        const T x1 = xs[(g + 32) * XS + i];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const T rv = rs[i * TC + s + 8 * a];
          acc0[a] = fma(x0, rv, acc0[a]);
          acc1[a] = fma(x1, rv, acc1[a]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int t = s + 8 * a;
      if (t < tc) {
        if (j0 < p) grad[j0 * nt + t0 + t] = acc0[a] + offset[j0];
        if (j1 < p) grad[j1 * nt + t0 + t] = acc1[a] + offset[j1];
      }
    }
  }
  __syncthreads();  // the CTA's gradient rows are written
  if (tid < kBlkFeat) {
    const long long j = f0 + tid;
    if (j < p) {
      const T sc = rt::block_violation_score(pen, use_fp, beta + j * nt, grad + j * nt, nt,
                                             L[j], p0, p1);
      scores[j] = sc;
      pri[j] = (gsupp[j] ? (T)INFINITY : sc) + T(0);  // +0 folds -0.0 into +0.0
    }
  }
}

// cp.async of `B` bytes (8 or 16) from global to shared memory; a source
// size of 0 fills the destination with zeros
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b on an 8x8x4 float64 tile (a: A[gid][tig], b: B[tig][gid],
// d: D[gid][2 tig + 0, 1] with gid = lane / 4, tig = lane % 4)
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// K3b and K3l float64, the narrow product launch (N <= 24): the partial
// product of 64 features (blockIdx.x) and tasks t0 .. t0 + tc - 1 over the
// samples of span blockIdx.y, into part [spans, p, kMmaT]. VEC: bytes a cp.async moves of X
// (16 when rows are 16-byte aligned, i.e. n even; else 8).
template <int VEC>
__global__ void __launch_bounds__(kMmaThreads)
    block_mma_kernel(const double* __restrict__ Xt, const double* __restrict__ R,
                     double* __restrict__ part, int n, int p, int nt, int t0, int tc,
                     int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* xs = reinterpret_cast<double*>(smem_raw);  // [2][kMmaM][kMmaXS]
  double* rs = xs + 2 * kMmaM * kMmaXS;              // [2][kMmaK][kMmaRS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long f0 = (long long)blockIdx.x * kMmaM;
  const int i_begin = blockIdx.y * span;
  const int i_end = min(n, i_begin + span);
  constexpr int XV = VEC / 8;                  // values a copy
  constexpr int XCOPIES = kMmaM * kMmaK / XV;  // copies of an X tile
  auto load = [&](int buf, int k0) {
    double* xb = xs + buf * kMmaM * kMmaXS;
    for (int c = tid; c < XCOPIES; c += kMmaThreads) {
      const int row = c / (kMmaK / XV), col = (c % (kMmaK / XV)) * XV;
      const long long j = f0 + row;
      const int i = k0 + col;
      const bool ok = j < p && i < i_end;
      cp_async<VEC>(xb + row * kMmaXS + col, ok ? Xt + j * n + i : Xt, ok ? VEC : 0);
    }
    double* rb = rs + buf * kMmaK * kMmaRS;
    for (int c = tid; c < kMmaK * kMmaT; c += kMmaThreads) {
      const int r = c / kMmaT, t = c % kMmaT;
      const int i = k0 + r;
      const bool ok = i < i_end && t < tc;
      cp_async<8>(rb + r * kMmaRS + t, ok ? R + (long long)i * nt + t0 + t : R, ok ? 8 : 0);
    }
    cp_async_commit();
  };
  double acc[2][3][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[m][q][0] = acc[m][q][1] = 0.0;
  if (i_begin < i_end) load(0, i_begin);
  int buf = 0;
  for (int k0 = i_begin; k0 < i_end; k0 += kMmaK, buf ^= 1) {
    if (k0 + kMmaK < i_end) {
      load(buf ^ 1, k0 + kMmaK);  // in flight during this tile's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const double* xb = xs + buf * kMmaM * kMmaXS + (warp * 16 + gid) * kMmaXS + tig;
    const double* rb = rs + buf * kMmaK * kMmaRS + tig * kMmaRS + gid;
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 4) {
      const double a0 = xb[kk], a1 = xb[8 * kMmaXS + kk];
      const double b0 = rb[kk * kMmaRS], b1 = rb[kk * kMmaRS + 8], b2 = rb[kk * kMmaRS + 16];
      dmma(acc[0][0][0], acc[0][0][1], a0, b0);
      dmma(acc[0][1][0], acc[0][1][1], a0, b1);
      dmma(acc[0][2][0], acc[0][2][1], a0, b2);
      dmma(acc[1][0][0], acc[1][0][1], a1, b0);
      dmma(acc[1][1][0], acc[1][1][1], a1, b1);
      dmma(acc[1][2][0], acc[1][2][1], a1, b2);
    }
    __syncthreads();  // this buffer is free before it is loaded again
  }
  double* out = part + (long long)blockIdx.y * p * kMmaT;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const long long j = f0 + warp * 16 + m * 8 + gid;
    if (j >= p) continue;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int t = q * 8 + 2 * tig;
      if (t < tc) out[j * kMmaT + t] = acc[m][q][0];
      if (t + 1 < tc) out[j * kMmaT + t + 1] = acc[m][q][1];
    }
  }
}

// The float64 tensor-core instructions: d += a b on an MM x 8 x KM tile
// (the wide product runs m16n8k4; the rate probe times all four).
// Fragments (gid = lane / 4, tig = lane % 4): a[e] = A[gid + 8 (e % (MM /
// 8))][tig + 4 (e / (MM / 8))], b[e] = B[tig + 4 e][gid], d[2 h + q] =
// D[gid + 8 h][2 tig + q]. m8n8k4 is sm_80's DMMA; the m16n8 shapes are
// sm_90's.
template <int MM, int KM>
struct Dmma;

template <>
struct Dmma<8, 4> {
  static constexpr int A = 1, B = 1, C = 2;
  static __device__ __forceinline__ void run(double* d, const double* a, const double* b) {
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  }
};

template <>
struct Dmma<16, 4> {
  static constexpr int A = 2, B = 1, C = 4;
  static __device__ __forceinline__ void run(double* d, const double* a, const double* b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }
};

template <>
struct Dmma<16, 8> {
  static constexpr int A = 4, B = 2, C = 4;
  static __device__ __forceinline__ void run(double* d, const double* a, const double* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

template <>
struct Dmma<16, 16> {
  static constexpr int A = 8, B = 4, C = 4;
  static __device__ __forceinline__ void run(double* d, const double* a, const double* b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// K3b, K3l and K3bl float64, the wide product launch: the partial product
// of kWideM features (blockIdx.y) and the column tile c0 .. c0 + bn - 1
// (blockIdx.x, bn a multiple of 8, at most kWideN) over the samples of span
// blockIdx.z, into part [spans, p, N]. Warp (wm, wn) of the WM x WN warps
// takes features wm * 32 .. + 31 (two m-tiles) and the n-tiles wn,
// wn + WN, ... of the tile; at each k-step of KM samples it loads all its
// A and B fragments, then issues its MMAs. The samples stream in stages of
// BK through an ST-stage cp.async ring (rows of X padded to kWideXS
// values, R to kWideRS: conflict-free half-warp fragment loads). A stage's
// copies are issued after the MMAs of the stage before, so that they
// overlap the tensor cores, from addresses set up once (a few adds a copy,
// the sample bound tested only on the span's last stage). x16 / r16: X / R
// rows allow 16-byte copies (n / N even, 16-byte aligned).
__global__ void __launch_bounds__(kWideThreads, kWidePerSM)
    wide_mma_kernel(const double* __restrict__ Xt, const double* __restrict__ R,
                    double* __restrict__ part, int n, int p, int N, int bn, int span, int x16,
                    int r16) {
  constexpr int MM = 16, KM = 4, WM = kWideWM, WN = kWideWN, BK = kWideK, ST = kWideStages;
  using M = Dmma<MM, KM>;
  constexpr int kThreads = kWideThreads, kBM = kWideM, kMT = 32 / MM;
  constexpr int kNT = kWideN / (8 * WN), kXS = kWideXS;
  // 16-byte copies a thread makes of a stage of X and of R (the widest
  // tile; 8-byte copies are twice as many)
  constexpr int kXC = kBM * BK / 2 / kThreads, kRC = BK * kWideN / 2 / kThreads;
  static_assert(kXC >= 1 && kBM * BK / 2 % kThreads == 0, "X copies a thread");
  static_assert(kRC >= 1 && BK * kWideN / 2 % kThreads == 0, "R copies a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* xs = reinterpret_cast<double*>(smem_raw);  // [ST][kBM][kXS]
  double* rs = xs + ST * kBM * kXS;                  // [ST][BK][kWideRS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % WM, wn = warp / WM;  // warps wm, wm + WM, ... of a
                                             // row share a scheduler
  const int c0 = blockIdx.x * bn;
  const long long f0 = (long long)blockIdx.y * kBM;
  const int i_begin = blockIdx.z * span;
  const int i_end = min(n, i_begin + span);
  const int ntl = (min(bn, N - c0) + 7) / 8;  // n-tiles holding real columns
  const int ktiles = i_end > i_begin ? (i_end - i_begin + BK - 1) / BK : 0;

  // this thread's copies of a stage: X rows xrow + r xstep at the stage's
  // samples xcol.. (xe a copy), R rows rrow + r rstep at columns rcol..
  // (re a copy) of the widest tile, those past the staged columns skipped
  const int xe = x16 ? 2 : 1, re = r16 ? 2 : 1;
  const int xper = BK / xe, rper = kWideN / re;
  const int xcol = (tid % xper) * xe, xrow = tid / xper, xstep = kThreads / xper;
  const int rcol = (tid % rper) * re, rrow = tid / rper, rstep = kThreads / rper;
  const int cx = kXC * (2 / xe), cr = rcol < ntl * 8 ? kRC * (2 / re) : 0;
  const int xrows = (int)min((long long)kBM, p - f0) - xrow;  // copy r: r xstep < xrows
  const bool rreal = c0 + rcol < N;
  const double* xsrc = Xt + (f0 + xrow) * n + i_begin + xcol;
  const long long xstep_g = (long long)xstep * n, rstep_g = (long long)rstep * N;
  const double* rsrc = R + (long long)(i_begin + rrow) * N + c0 + rcol;
  const int xoff = xrow * kXS + xcol, roff = rrow * kWideRS + rcol;
  auto copy_stage = [&](int kt) {
    const int slot = kt % ST, k0 = i_begin + kt * BK;
    const bool full = k0 + BK <= i_end;
    double* xd = xs + slot * kBM * kXS + xoff;
    const double* xg = xsrc + (long long)kt * BK;
    const bool xin = full || k0 + xcol < i_end;
    for (int r = 0; r < cx; ++r) {
      const bool ok = xin && r * xstep < xrows;
      const double* g = ok ? xg + r * xstep_g : Xt;
      if (x16)
        cp_async<16>(xd + r * xstep * kXS, g, ok ? 16 : 0);
      else
        cp_async<8>(xd + r * xstep * kXS, g, ok ? 8 : 0);
    }
    double* rd = rs + slot * BK * kWideRS + roff;
    const double* rg = rsrc + (long long)kt * BK * N;
    for (int r = 0; r < cr; ++r) {
      const bool ok = rreal && (full || k0 + rrow + r * rstep < i_end);
      const double* g = ok ? rg + r * rstep_g : R;
      if (r16)
        cp_async<16>(rd + r * rstep * kWideRS, g, ok ? 16 : 0);
      else
        cp_async<8>(rd + r * rstep * kWideRS, g, ok ? 8 : 0);
    }
  };

  double acc[kMT][kNT][M::C];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < M::C; ++e) acc[m][t][e] = 0.0;
  // the ring's first ST - 1 stages (a group each, empty past the span)
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ktiles) copy_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // one group a stage: after it the newest ST - 2 may stay in flight, so
    // stage kt is in; every warp is done with the slot of stage kt - 1
    cp_async_wait<ST - 2>();
    __syncthreads();
    const int st = kt % ST;
    const double* xb = xs + st * kBM * kXS + (wm * 32 + gid) * kXS + tig;
    const double* rb = rs + st * BK * kWideRS + tig * kWideRS + gid;
#pragma unroll
    for (int kk = 0; kk < BK; kk += KM) {
      double a[kMT][M::A], b[kNT][M::B];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int e = 0; e < M::A; ++e)
          a[m][e] = xb[(m * MM + 8 * (e % (MM / 8))) * kXS + kk + 4 * (e / (MM / 8))];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        if (WN * t + wn < ntl)
#pragma unroll
          for (int e = 0; e < M::B; ++e)
            b[t][e] = rb[(kk + 4 * e) * kWideRS + (WN * t + wn) * 8];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
        if (WN * t + wn < ntl)
#pragma unroll
          for (int m = 0; m < kMT; ++m) M::run(acc[m][t], a[m], b[t]);
    }
    // stage kt + ST - 1 into the slot of stage kt - 1
    if (kt + ST - 1 < ktiles) copy_stage(kt + ST - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  double* out = part + (long long)blockIdx.z * p * N;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int nt = WN * t + wn;
      if (nt >= ntl) continue;
      const int c = c0 + nt * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < MM / 8; ++h) {
        const long long j = f0 + wm * 32 + m * MM + 8 * h + gid;
        if (j >= p) continue;
        if (c < N) out[j * N + c] = acc[m][t][2 * h];
        if (c + 1 < N) out[j * N + c + 1] = acc[m][t][2 * h + 1];
      }
    }
}

// K3b, K3l and K3bl float64, the reduce and score launch: CTA blockIdx.x
// takes F consecutive features j, all S lanes of nt columns each (N = S
// nt). Its threads walk the block's F x N gradient values in memory order
// (the scratch rows of consecutive features are adjacent: coalesced), each
// the spans' partials summed in span order + offset_j, written to grad
// [S, p, nt]; after the CTA barrier one thread a (feature, lane) computes
// the score from that gradient row with the lane's beta [S, p, nt], L
// (lanes l_lane apart: p, or 0 for one shared row) and parameter row
// (prm_lane apart): the row score of a block penalty (BLOCK), or the
// scalar score (nt = 1); and the priority under its generalized support,
// written lane-major [S, p]. part: [spans, p, ld].
constexpr int kReduceThreads = 128;
constexpr int kReduceValues = 4096;  // the most gradient values a CTA sums
constexpr int kReduceCtas = 1024;    // ~8 CTAs an SM of the H100's 132, one wave

template <bool BLOCK>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_epilogue_kernel(const double* __restrict__ part, int spans, int ld,
                           const double* __restrict__ offset, const double* __restrict__ beta,
                           const double* __restrict__ L, int l_lane,
                           const uint8_t* __restrict__ gsupp, double* scores, double* grad,
                           double* pri, int p, int S, int nt, int F, int pen, int use_fp,
                           const double* __restrict__ prm, int prm_lane) {
  const int N = S * nt;
  const long long j0 = (long long)blockIdx.x * F;
  const int fn = (int)min((long long)F, p - j0);
  const long long span_stride = (long long)p * ld;
  for (int e = threadIdx.x; e < fn * N; e += blockDim.x) {
    const int f = e / N, c = e - f * N;
    const long long j = j0 + f;
    const double* src = part + j * ld + c;
    double sum = src[0];
    for (int k = 1; k < spans; ++k) sum += src[k * span_stride];
    const double g = sum + offset[j];
    const int s = c / nt;
    grad[((long long)s * p + j) * nt + (c - s * nt)] = g;
  }
  __syncthreads();  // the block's gradient rows are written and visible
  for (int q = threadIdx.x; q < fn * S; q += blockDim.x) {
    const int s = q / fn, f = q - s * fn;
    const long long j = j0 + f, e = (long long)s * p + j;
    const double* pr = prm + (long long)s * prm_lane;
    const double p0 = rt::param0<double>(pr), p1 = rt::param1<double>(pen, pr);
    const double Lj = L[(long long)s * l_lane + j];
    const double* g = grad + e * nt;
    double sc;
    if constexpr (BLOCK)
      sc = rt::block_violation_score(pen, use_fp, beta + e * nt, g, nt, Lj, p0, p1);
    else
      sc = rt::violation_score(pen, use_fp, beta[e], g[0], Lj, p0, p1);
    scores[e] = sc;
    pri[e] = (gsupp[e] ? (double)INFINITY : sc) + 0.0;  // +0 folds -0.0 into +0.0
  }
}

// The float64 tensor cores' rate without loads: each warp issues `iters`
// rounds of 8 MMAs of shape (MM, KM) on 8 independent accumulators from
// operands held in registers (out: a value a thread, so nothing is dropped)
template <int MM, int KM>
__global__ void dmma_rate_kernel(double* out, int iters) {
  using M = Dmma<MM, KM>;
  double a[M::A], b[M::B], acc[8][M::C];
#pragma unroll
  for (int e = 0; e < M::A; ++e) a[e] = 1e-3 * (threadIdx.x + e);
#pragma unroll
  for (int e = 0; e < M::B; ++e) b[e] = 1e-3 * (threadIdx.x - e);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < M::C; ++e) acc[t][e] = 0.0;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) M::run(acc[t], a, b);
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < M::C; ++e) s += acc[t][e];
  out[(long long)blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the float64 product launch, narrow (wide = 0, N <= kMmaT) or wide:
// part [spans, p, ld] (ld 24 narrow, N wide) = the spans' partial products
// Xt @ R; bn the wide column tile, span the samples a span (a multiple of
// the stage depth)
int launch_product(const double* Xt, const double* R, double* part, int n, int p, int N, int wide,
                   int bn, int spans, int span, cudaStream_t st) {
  if (wide < 0 || wide > 1 || p <= 0 || N <= 0 || spans < 1 || spans > kMmaMaxSplits ||
      span < 1 || (long long)span * spans < n)
    return (int)cudaErrorInvalidValue;
  const bool x16 = (n % 2 == 0) && ((uintptr_t)Xt % 16 == 0);
  cudaError_t err;
  if (!wide) {
    if (N > kMmaT || span % kMmaK != 0) return (int)cudaErrorInvalidValue;
    auto kernel = x16 ? block_mma_kernel<16> : block_mma_kernel<8>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMmaSmem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((p + kMmaM - 1) / kMmaM, spans), kMmaThreads, kMmaSmem, st>>>(
        Xt, R, part, n, p, N, 0, N, span);
    return (int)cudaGetLastError();
  }
  if (bn < 8 || bn > kWideN || bn % 8 != 0 || span % kWideK != 0)
    return (int)cudaErrorInvalidValue;
  const bool r16 = (N % 2 == 0) && ((uintptr_t)R % 16 == 0);
  err = cudaFuncSetAttribute(wide_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kWideSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + bn - 1) / bn, (p + kWideM - 1) / kWideM, spans);
  wide_mma_kernel<<<grid, kWideThreads, kWideSmem, st>>>(Xt, R, part, n, p, N, bn, span, x16,
                                                         r16);
  return (int)cudaGetLastError();
}

// the product, then the reduce and score launch over S lanes of nt
// columns (K3b: S = 1; K3l: nt = 1, scalar scores)
template <bool BLOCK>
int launch_product_scores(const double* Xt, const double* R, const double* beta, const double* L,
                          int l_lane, const double* offset, const uint8_t* gsupp, double* scores,
                          double* grad, double* pri, double* part, int wide, int bn, int spans,
                          int span, int n, int p, int S, int nt, int pen, int use_fp,
                          const double* prm, int prm_lane, cudaStream_t st) {
  if (S <= 0 || S > 65535 || nt <= 0) return (int)cudaErrorInvalidValue;
  const int rc = launch_product(Xt, R, part, n, p, S * nt, wide, bn, spans, span, st);
  if (rc != 0) return rc;
  const int ld = wide ? S * nt : kMmaT;
  // features a CTA: at most a (feature, lane) a thread for the scores and
  // kReduceValues gradient values (whole rows of S * nt), and few enough
  // that the grid has about kReduceCtas CTAs where p allows
  const int F = max(1, min(min(kReduceValues / (S * nt), kReduceThreads / S),
                           (p + kReduceCtas - 1) / kReduceCtas));
  reduce_epilogue_kernel<BLOCK><<<(unsigned)((p + F - 1) / F), kReduceThreads, 0, st>>>(
      part, spans, ld, offset, beta, L, l_lane, gsupp, scores, grad, pri, p, S, nt, F, pen, use_fp,
      prm, prm_lane);
  return (int)cudaGetLastError();
}

template <typename T, int A>
int launch_block_score_a(const T* Xt, const T* R, const T* beta, const T* L, const T* offset,
                         const uint8_t* gsupp, T* scores, T* grad, T* pri, int n, int p, int nt,
                         int pen, int use_fp, const double* prm, cudaStream_t st) {
  const size_t dyn = ((size_t)kBlkFeat * (kBlkN + 1) + (size_t)kBlkN * 8 * A) * sizeof(T);
  cudaFuncSetAttribute(block_score_kernel<T, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dyn);
  block_score_kernel<T, A><<<(p + kBlkFeat - 1) / kBlkFeat, kBlkThreads, dyn, st>>>(
      Xt, R, beta, L, offset, gsupp, scores, grad, pri, n, p, nt, pen, use_fp, prm);
  return (int)cudaGetLastError();
}

// A = ceil(T / 8) task slots for T <= 64, else passes of 64 tasks
template <typename T>
int launch_block_score(const T* Xt, const T* R, const T* beta, const T* L, const T* offset,
                       const uint8_t* gsupp, T* scores, T* grad, T* pri, int n, int p, int nt,
                       int pen, int use_fp, const double* prm, cudaStream_t st) {
  const int a = nt >= 64 ? 8 : (nt + 7) / 8;
#define RT_BLOCK_SCORE(A_)                                                                    \
  case A_:                                                                                    \
    return launch_block_score_a<T, A_>(Xt, R, beta, L, offset, gsupp, scores, grad, pri, n, \
                                       p, nt, pen, use_fp, prm, st);
  switch (a) {
    RT_BLOCK_SCORE(1)
    RT_BLOCK_SCORE(2)
    RT_BLOCK_SCORE(3)
    RT_BLOCK_SCORE(4)
    RT_BLOCK_SCORE(5)
    RT_BLOCK_SCORE(6)
    RT_BLOCK_SCORE(7)
    RT_BLOCK_SCORE(8)
  }
#undef RT_BLOCK_SCORE
  return (int)cudaErrorInvalidValue;
}

// the select launch of K3 and K3b on the priorities `pri`: one CTA a tile
template <typename T>
int launch_select(const T* pri, int* cand_idx, int p, int bp, int kc, cudaStream_t st,
                  int lanes = 1) {
  if (p <= 0 || bp <= 0 || kc <= 0 || kc > bp || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  int sortn = 1;
  while (sortn < bp) sortn <<= 1;
  const size_t dyn = (size_t)sortn * (sizeof(T) + sizeof(int));
  const int tiles = (p + bp - 1) / bp;
  cudaError_t err =
      cudaFuncSetAttribute(select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  select_kernel<T><<<dim3(tiles, lanes), kSelectThreads, dyn, st>>>(pri, cand_idx, p, bp, kc,
                                                                    sortn);
  return (int)cudaGetLastError();
}

// K3's merge launch: ws [K] from the priorities and the select launch's
// cand_idx; part [ctas, K] and, for K > kMergeSmemK, gbuf [ctas, 3, K] are
// the caller's scratch, counter one zeroed unsigned
template <typename T>
int launch_merge(const T* pri, const int* cand_idx, T* part_pri, int* part_idx, T* gbuf_pri,
                 int* gbuf_idx, unsigned* counter, long long* ws, int p, int bp, int kc, int K,
                 int ctas, cudaStream_t st, int lanes = 1) {
  const int tiles = (p + bp - 1) / bp;
  if (p <= 0 || K <= 0 || K > p || kc <= 0 || kc > bp || ctas <= 0 || ctas > tiles ||
      (K > kMergeSmemK) != (gbuf_pri != nullptr) || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const int per_cta = (tiles + ctas - 1) / ctas;
  const size_t dyn = K > kMergeSmemK ? 0 : (size_t)3 * K * (sizeof(T) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(ws_merge_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  ws_merge_kernel<T><<<dim3(ctas, lanes), kMergeThreads, dyn, st>>>(pri, cand_idx, part_pri,
                                                                    part_idx,
                                                       gbuf_pri, gbuf_idx, counter, ws, p, bp, kc,
                                                       K, per_cta);
  return (int)cudaGetLastError();
}

// the score launch of K3 (gsupp, grad and pri given) and K4 (w optional;
// gsupp, grad and pri null)
template <typename T>
int launch_score(const T* Xt, const T* r, const T* w, const T* beta, const T* L,
                 const T* offset, const uint8_t* gsupp, T* scores, T* grad, T* pri, int n, int p,
                 int pen, int use_fp, const double* prm, void* stream) {
  if (p <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_cta = kScoreThreads / 32;
  const int ctas = (p + per_cta - 1) / per_cta;
  if (w)
    score_kernel<T, true><<<ctas, kScoreThreads, 0, st>>>(
        Xt, r, w, beta, L, offset, gsupp, scores, grad, pri, n, p, pen, use_fp, prm);
  else
    score_kernel<T, false><<<ctas, kScoreThreads, 0, st>>>(
        Xt, r, nullptr, beta, L, offset, gsupp, scores, grad, pri, n, p, pen, use_fp, prm);
  return (int)cudaGetLastError();
}

// K3b: the score launches (float64: the product (narrow or wide) into
// `part` and the reduce and score launch; float32: the scalar product),
// then the select launch
template <typename T>
int launch_fused_block(const T* Xt, const T* R, const T* beta, const T* L, const T* offset,
                       const uint8_t* gsupp, T* scores, T* grad, T* pri, int* cand_idx,
                       T* part, int wide, int bn, int spans, int span, int n, int p, int nt,
                       int bp, int kc, int pen, int use_fp, const double* prm, void* stream) {
  if (p <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if constexpr (sizeof(T) == 8)
    rc = launch_product_scores<true>(Xt, R, beta, L, 0, offset, gsupp, scores, grad, pri, part,
                                     wide, bn, spans, span, n, p, 1, nt, pen, use_fp, prm, 0, st);
  else
    rc = launch_block_score(Xt, R, beta, L, offset, gsupp, scores, grad, pri, n, p, nt, pen,
                            use_fp, prm, st);
  if (rc != 0) return rc;
  return launch_select<T>(pri, cand_idx, p, bp, kc, st);
}

}  // namespace

extern "C" {

// K3's score launch and K4
int score_f64(const double* Xt, const double* r, const double* w, const double* beta,
              const double* L, const double* offset, const uint8_t* gsupp, double* scores,
              double* grad, double* pri, int n, int p, int pen, int use_fp, const double* prm,
              void* stream) {
  return launch_score<double>(Xt, r, w, beta, L, offset, gsupp, scores, grad, pri, n, p, pen,
                              use_fp, prm, stream);
}

int score_f32(const float* Xt, const float* r, const float* w, const float* beta,
              const float* L, const float* offset, const uint8_t* gsupp, float* scores,
              float* grad, float* pri, int n, int p, int pen, int use_fp, const double* prm,
              void* stream) {
  return launch_score<float>(Xt, r, w, beta, L, offset, gsupp, scores, grad, pri, n, p, pen,
                             use_fp, prm, stream);
}

// K3's merge launch
int merge_f64(const double* pri, const int* cand_idx, double* part_pri, int* part_idx,
              double* gbuf_pri, int* gbuf_idx, unsigned* counter, long long* ws, int p, int bp,
              int kc, int K, int ctas, void* stream) {
  return launch_merge<double>(pri, cand_idx, part_pri, part_idx, gbuf_pri, gbuf_idx, counter, ws,
                              p, bp, kc, K, ctas, (cudaStream_t)stream);
}

int merge_f32(const float* pri, const int* cand_idx, float* part_pri, int* part_idx,
              float* gbuf_pri, int* gbuf_idx, unsigned* counter, long long* ws, int p, int bp,
              int kc, int K, int ctas, void* stream) {
  return launch_merge<float>(pri, cand_idx, part_pri, part_idx, gbuf_pri, gbuf_idx, counter, ws,
                             p, bp, kc, K, ctas, (cudaStream_t)stream);
}

// K3's select launch
int select_f64(const double* pri, int* cand_idx, int p, int bp, int kc, void* stream) {
  return launch_select<double>(pri, cand_idx, p, bp, kc, (cudaStream_t)stream);
}

int select_f32(const float* pri, int* cand_idx, int p, int bp, int kc, void* stream) {
  return launch_select<float>(pri, cand_idx, p, bp, kc, (cudaStream_t)stream);
}

int fused_ws_block_f64(const double* Xt, const double* R, const double* beta, const double* L,
                       const double* offset, const uint8_t* gsupp, double* scores,
                       double* grad, double* pri, int* cand_idx, double* part, int wide, int bn,
                       int spans, int span, int n, int p, int nt, int bp, int kc, int pen,
                       int use_fp, const double* prm, void* stream) {
  return launch_fused_block<double>(Xt, R, beta, L, offset, gsupp, scores, grad, pri, cand_idx,
                                    part, wide, bn, spans, span, n, p, nt, bp, kc, pen, use_fp,
                                    prm, stream);
}

int fused_ws_block_f32(const float* Xt, const float* R, const float* beta, const float* L,
                       const float* offset, const uint8_t* gsupp, float* scores, float* grad,
                       float* pri, int* cand_idx, float* part, int wide, int bn, int spans,
                       int span, int n, int p, int nt, int bp, int kc, int pen, int use_fp,
                       const double* prm, void* stream) {
  return launch_fused_block<float>(Xt, R, beta, L, offset, gsupp, scores, grad, pri, cand_idx,
                                   part, wide, bn, spans, span, n, p, nt, bp, kc, pen, use_fp, prm,
                                   stream);
}

// K3l (float64): the product launch over the S columns, the reduce and
// score launch over the lanes, and the select launch over the lanes; the
// merge launch is merge_lanes_f64
int fused_ws_lanes_f64(const double* Xt, const double* R, const double* beta, const double* L,
                       int l_lane, const double* offset, const uint8_t* gsupp, double* scores,
                       double* grad, double* pri, int* cand_idx, double* part, int wide, int bn,
                       int spans, int span, int n, int p, int S, int bp, int kc, int pen,
                       int use_fp, const double* prm, int prm_lane, void* stream) {
  if (p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = launch_product_scores<false>(Xt, R, beta, L, l_lane, offset, gsupp, scores,
                                              grad, pri, part, wide, bn, spans, span, n, p, S, 1,
                                              pen, use_fp, prm, prm_lane, st);
  if (rc != 0) return rc;
  return launch_select<double>(pri, cand_idx, p, bp, kc, st, S);
}

// K3bl (float64): one product launch over the S * nt columns, the reduce
// and score launch over the lanes (grad [S, p, nt]), and the select launch
// over the lanes; the merge launch is merge_lanes_f64
int fused_ws_block_lanes_f64(const double* Xt, const double* R, const double* beta,
                             const double* L, int l_lane, const double* offset,
                             const uint8_t* gsupp, double* scores, double* grad, double* pri,
                             int* cand_idx, double* part, int wide, int bn, int spans, int span,
                             int n, int p, int S, int nt, int bp, int kc, int pen, int use_fp,
                             const double* prm, int prm_lane, void* stream) {
  if (p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = launch_product_scores<true>(Xt, R, beta, L, l_lane, offset, gsupp, scores, grad,
                                             pri, part, wide, bn, spans, span, n, p, S, nt, pen,
                                             use_fp, prm, prm_lane, st);
  if (rc != 0) return rc;
  return launch_select<double>(pri, cand_idx, p, bp, kc, st, S);
}

// The product launch alone (float64): part [spans, p, ld] = the spans'
// partial products Xt @ R, narrow or wide (the launch plan's fields)
int fused_ws_product_f64(const double* Xt, const double* R, double* part, int n, int p, int N,
                         int wide, int bn, int spans, int span, void* stream) {
  return launch_product(Xt, R, part, n, p, N, wide, bn, spans, span, (cudaStream_t)stream);
}

// K3's merge launch over `lanes` lanes (pri [lanes, p], cand_idx [lanes,
// tiles * kc], scratch and counters a lane each, ws [lanes, K])
int merge_lanes_f64(const double* pri, const int* cand_idx, double* part_pri, int* part_idx,
                    double* gbuf_pri, int* gbuf_idx, unsigned* counter, long long* ws, int p,
                    int bp, int kc, int K, int ctas, int lanes, void* stream) {
  return launch_merge<double>(pri, cand_idx, part_pri, part_idx, gbuf_pri, gbuf_idx, counter, ws,
                              p, bp, kc, K, ctas, (cudaStream_t)stream, lanes);
}

int merge_lanes_f32(const float* pri, const int* cand_idx, float* part_pri, int* part_idx,
                    float* gbuf_pri, int* gbuf_idx, unsigned* counter, long long* ws, int p,
                    int bp, int kc, int K, int ctas, int lanes, void* stream) {
  return launch_merge<float>(pri, cand_idx, part_pri, part_idx, gbuf_pri, gbuf_idx, counter, ws,
                             p, bp, kc, K, ctas, (cudaStream_t)stream, lanes);
}

// The DMMA rate probe: `ctas` CTAs of `threads` threads, shape 0..3 =
// m8n8k4, m16n8k4, m16n8k8, m16n8k16; out holds ctas * threads values
int dmma_rate_probe(int shape, int threads, int ctas, int iters, double* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (shape) {
    case 0:
      dmma_rate_kernel<8, 4><<<ctas, threads, 0, st>>>(out, iters);
      break;
    case 1:
      dmma_rate_kernel<16, 4><<<ctas, threads, 0, st>>>(out, iters);
      break;
    case 2:
      dmma_rate_kernel<16, 8><<<ctas, threads, 0, st>>>(out, iters);
      break;
    case 3:
      dmma_rate_kernel<16, 16><<<ctas, threads, 0, st>>>(out, iters);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A fact of the narrow (wide = 0) or wide product kernel on the current
// card: what = 0 its dynamic shared memory bytes, 1 its resident CTAs an
// SM (the occupancy query); -1 if wide or what is out of range or the card
// does not answer
int fused_ws_product_info(int wide, int what) {
  if (wide < 0 || wide > 1) return -1;
  const void* fn = wide ? (const void*)wide_mma_kernel : (const void*)block_mma_kernel<16>;
  const int threads = wide ? kWideThreads : kMmaThreads;
  const size_t smem = wide ? kWideSmem : kMmaSmem;
  if (what == 0) return (int)smem;
  if (what != 1) return -1;
  int per_sm = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem) != cudaSuccess)
    return -1;
  return per_sm;
}

}  // extern "C"
