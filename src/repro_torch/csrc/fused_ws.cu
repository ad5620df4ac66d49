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
//  1. product launch: mma.sync m8n8k4 f64 (DMMA). A CTA of 4 warps takes
//     64 features (a warp 16 = two m-tiles) x 24 tasks (three n-tiles of
//     8; T > 24 runs in passes) over one span of the samples. X [64, 32]
//     and R [32, 24] tiles stream into shared memory with cp.async, two
//     stages, so the next tile is in flight while the tensor cores work on
//     this one; rows are padded (36 and 28 values) so that the fragment
//     loads of a half-warp fall in 16 distinct banks. At ~51 KB of shared
//     memory four CTAs share an SM. The samples split into S spans, S
//     chosen so that (feature tiles x S) CTAs fill whole waves of the
//     card; each CTA writes its partial product, unreduced, to a scratch
//     [S, p, 24].
//  2. reduce launch: grad = the S partials summed in span order (the same
//     order on every run: the result is deterministic) + offset.
//  3. score launch: the row epilogue, one thread a feature (norms over T,
//     the block prox or subdifferential, the priority with the generalized
//     support pinned to +inf).
//  4. select launch: K3's tile sort (cand_idx).
// float32 keeps the scalar product (block_score_kernel): the tensor cores
// have no float32 path of this precision.
//
// K3l (fused_ws_lanes) is K3 over S lanes that share X, the chunked
// driver's dense head (fused_ws_pallas under the reference's vmap: one
// launch over all lanes). Each lane s has its raw gradient R[:, s], its
// beta, L, generalized support and row of the codec vector. Bound: bytes,
// X read once for every lane (S separate K3s would read it S times).
// Design, float64: K3b's product and reduce launches on R [n, S] give the
// gradient of every (feature, lane) into a [p, S] buffer; a lane epilogue
// (one thread a (feature, lane), lane = blockIdx.y) computes the scalar
// score, writes grad, score and priority lane-major [S, p]; K3's select
// and merge launches then run with the lane on their grids' y index.
//
// K3bl (fused_ws_block_lanes) is K3b over S lanes of multitask blocks that
// share X (the block branch of fused_ws_pallas under the reference's vmap).
// Lane s has its raw gradient R[:, s*T .. s*T + T - 1] (R [n, S*T],
// lane-major), its beta [p, T], L, generalized support and row of the
// codec vector. Bound: bytes at small S*T (X read once for every lane),
// the float64 tensor cores' operations at large S*T. Design, float64:
// K3b's product and reduce launches over the S*T columns (passes of kMmaT
// tasks, each pass reading X again) into a [p, S*T] buffer; a block lane
// epilogue (one thread a (feature, lane), lane = blockIdx.y) copies the
// lane's gradient row to grad [S, p, T], computes its row score from it
// with the lane's beta, L and parameter row, and writes score and priority
// lane-major [S, p]; K3's select and merge launches then run with the lane
// on their grids' y index.
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
// K3b float64 (DMMA): features and samples a CTA tile, tasks a pass, padded
// shared-memory rows, threads, the most sample spans and the fewest
// samples a span
constexpr int kMmaM = 64;
constexpr int kMmaK = 32;
constexpr int kMmaT = 24;
constexpr int kMmaXS = kMmaK + 4;
constexpr int kMmaRS = kMmaT + 4;
constexpr int kMmaThreads = 128;
constexpr int kMmaMaxSplits = 16;
constexpr int kMmaMinSpan = 512;
constexpr size_t kMmaSmem = 2 * (kMmaM * kMmaXS + kMmaK * kMmaRS) * sizeof(double);

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

// K3b float64, product launch: the partial product of 64 features
// (blockIdx.x) and tasks t0 .. t0 + tc - 1 over the samples of span
// blockIdx.y, into part [S, p, kMmaT]. VEC: bytes a cp.async moves of X
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

// K3b float64, reduce launch: grad[:, t0 .. t0 + tc - 1] = the S partials
// summed in span order + offset, one thread a (feature, task)
__global__ void block_reduce_kernel(const double* __restrict__ part,
                                    const double* __restrict__ offset, double* grad, int p,
                                    int nt, int t0, int tc, int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p * tc) return;
  const long long j = e / tc;
  const int t = (int)(e % tc);
  double sum = part[j * kMmaT + t];
  for (int s = 1; s < splits; ++s) sum += part[((long long)s * p + j) * kMmaT + t];
  grad[j * nt + t0 + t] = sum + offset[j];
}

// K3b, score launch: the row score and the selection priority of each
// feature from its gradient row, one thread a feature
template <typename T>
__global__ void block_epilogue_kernel(const T* __restrict__ beta, const T* __restrict__ grad,
                                      const T* __restrict__ L, const uint8_t* __restrict__ gsupp,
                                      T* scores, T* pri, int p, int nt, int pen, int use_fp,
                                      const double* __restrict__ prm) {
  const T p0 = rt::param0<T>(prm), p1 = rt::param1<T>(pen, prm);
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const T sc = rt::block_violation_score(pen, use_fp, beta + j * nt, grad + j * nt, nt, L[j],
                                         p0, p1);
  scores[j] = sc;
  pri[j] = (gsupp[j] ? (T)INFINITY : sc) + T(0);  // +0 folds -0.0 into +0.0
}

// The number of sample spans S of K3b's float64 product launch: the one
// (up to kMmaMaxSplits, spans of at least kMmaMinSpan samples) whose
// (feature tiles x S) CTAs fill the card's resident slots in the whole
// waves best, the fewest spans among equals.
int mma_splits(int n, int p) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  cudaFuncSetAttribute(block_mma_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kMmaSmem);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_mma_kernel<16>, kMmaThreads,
                                                    kMmaSmem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long slots = (long long)sms * per_sm;
  const long long tiles = (p + kMmaM - 1) / kMmaM;
  int best = 1;
  double best_fill = 0.0;
  for (int S = 1; S <= kMmaMaxSplits; ++S) {
    if (S > 1 && (long long)S * kMmaMinSpan > n) break;
    const long long ctas = tiles * S;
    const double fill = (double)ctas / (double)(((ctas + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) {
      best = S;
      best_fill = fill;
    }
  }
  return best;
}

// K3b and K3l float64: the product and reduce launches, grad [p, nt] =
// Xt @ R + offset (part: the scratch of `splits` spans from mma_splits)
int launch_mma_product(const double* Xt, const double* R, const double* offset, double* grad,
                       double* part, int splits, int n, int p, int nt, cudaStream_t st) {
  if (splits < 1 || splits > kMmaMaxSplits) return (int)cudaErrorInvalidValue;
  const int span = ((n + splits - 1) / splits + kMmaK - 1) / kMmaK * kMmaK;
  const bool aligned = (n % 2 == 0) && ((uintptr_t)Xt % 16 == 0);
  auto kernel = aligned ? block_mma_kernel<16> : block_mma_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p + kMmaM - 1) / kMmaM, splits);
  for (int t0 = 0; t0 < nt; t0 += kMmaT) {
    const int tc = min(kMmaT, nt - t0);
    kernel<<<grid, kMmaThreads, kMmaSmem, st>>>(Xt, R, part, n, p, nt, t0, tc, span);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long e = (long long)p * tc;
    block_reduce_kernel<<<(unsigned)((e + 255) / 256), 256, 0, st>>>(part, offset, grad, p, nt,
                                                                      t0, tc, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// K3b float64: the product, reduce and score launches
int launch_block_score_mma(const double* Xt, const double* R, const double* beta,
                           const double* L, const double* offset, const uint8_t* gsupp,
                           double* scores, double* grad, double* pri, double* part, int splits,
                           int n, int p, int nt, int pen, int use_fp, const double* prm,
                           cudaStream_t st) {
  const int rc = launch_mma_product(Xt, R, offset, grad, part, splits, n, p, nt, st);
  if (rc != 0) return rc;
  block_epilogue_kernel<double><<<(p + 255) / 256, 256, 0, st>>>(
      beta, grad, L, gsupp, scores, pri, p, nt, pen, use_fp, prm);
  return (int)cudaGetLastError();
}

// K3l, the lane epilogue: for feature j (blockIdx.x, threadIdx.x) of lane s
// (blockIdx.y), the gradient gradT[j, s] (the product's [p, S] layout), its
// scalar score with the lane's beta, L (lanes l_lane apart: p, or 0 for
// one shared row) and parameter row, and the priority under its
// generalized support, written lane-major [S, p]
template <typename T>
__global__ void lane_epilogue_kernel(const T* __restrict__ gradT, const T* __restrict__ beta,
                                     const T* __restrict__ L, int l_lane,
                                     const uint8_t* __restrict__ gsupp, T* scores, T* grad,
                                     T* pri, int p, int S, int pen, int use_fp,
                                     const double* __restrict__ prm, int prm_lane) {
  const int s = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const double* pr = prm + (long long)s * prm_lane;
  const T p0 = rt::param0<T>(pr), p1 = rt::param1<T>(pen, pr);
  const long long e = (long long)s * p + j;
  const T g = gradT[j * S + s];
  const T sc = rt::violation_score(pen, use_fp, beta[e], g, L[(long long)s * l_lane + j], p0, p1);
  scores[e] = sc;
  grad[e] = g;
  pri[e] = (gsupp[e] ? (T)INFINITY : sc) + T(0);  // +0 folds -0.0 into +0.0
}

// K3bl, the block lane epilogue: for feature j (blockIdx.x, threadIdx.x) of
// lane s (blockIdx.y), its gradient row gradT[j, s*nt .. s*nt + nt - 1]
// (the product's [p, S*nt] layout) copied to grad [S, p, nt], its row score
// with the lane's beta [S, p, nt], L (lanes l_lane apart: p, or 0 for one
// shared row) and parameter row, and the priority under its generalized
// support, written lane-major [S, p]
template <typename T>
__global__ void block_lane_epilogue_kernel(const T* __restrict__ gradT,
                                           const T* __restrict__ beta, const T* __restrict__ L,
                                           int l_lane, const uint8_t* __restrict__ gsupp,
                                           T* scores, T* grad, T* pri, int p, int S, int nt,
                                           int pen, int use_fp, const double* __restrict__ prm,
                                           int prm_lane) {
  const int s = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p) return;
  const double* pr = prm + (long long)s * prm_lane;
  const T p0 = rt::param0<T>(pr), p1 = rt::param1<T>(pen, pr);
  const long long e = (long long)s * p + j;
  const T* g = gradT + j * S * nt + (long long)s * nt;
  T* out = grad + e * nt;
  for (int t = 0; t < nt; ++t) out[t] = g[t];
  const T sc = rt::block_violation_score(pen, use_fp, beta + e * nt, g, nt,
                                         L[(long long)s * l_lane + j], p0, p1);
  scores[e] = sc;
  pri[e] = (gsupp[e] ? (T)INFINITY : sc) + T(0);  // +0 folds -0.0 into +0.0
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

// K3b: the score launches (DMMA in float64, with `part` the scratch of
// `splits` spans; the scalar product in float32), then the select launch
template <typename T>
int launch_fused_block(const T* Xt, const T* R, const T* beta, const T* L, const T* offset,
                       const uint8_t* gsupp, T* scores, T* grad, T* pri, int* cand_idx,
                       T* part, int splits, int n, int p, int nt, int bp, int kc, int pen,
                       int use_fp, const double* prm, void* stream) {
  if (p <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  if constexpr (sizeof(T) == 8)
    rc = launch_block_score_mma(Xt, R, beta, L, offset, gsupp, scores, grad, pri, part, splits,
                                n, p, nt, pen, use_fp, prm, st);
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
                       double* grad, double* pri, int* cand_idx, double* part, int splits,
                       int n, int p, int nt, int bp, int kc, int pen, int use_fp,
                       const double* prm, void* stream) {
  return launch_fused_block<double>(Xt, R, beta, L, offset, gsupp, scores, grad, pri,
                                    cand_idx, part, splits, n, p, nt, bp, kc, pen, use_fp, prm,
                                    stream);
}

int fused_ws_block_f32(const float* Xt, const float* R, const float* beta, const float* L,
                       const float* offset, const uint8_t* gsupp, float* scores, float* grad,
                       float* pri, int* cand_idx, float* part, int splits, int n, int p,
                       int nt, int bp, int kc, int pen, int use_fp, const double* prm,
                       void* stream) {
  return launch_fused_block<float>(Xt, R, beta, L, offset, gsupp, scores, grad, pri, cand_idx,
                                   part, splits, n, p, nt, bp, kc, pen, use_fp, prm, stream);
}

// K3l (float64): the product and reduce launches into gradT [p, S], the
// lane epilogue, and the select launch over the lanes; the merge launch is
// merge_lanes_f64
int fused_ws_lanes_f64(const double* Xt, const double* R, const double* beta, const double* L,
                       int l_lane, const double* offset, const uint8_t* gsupp, double* scores,
                       double* grad, double* pri, int* cand_idx, double* gradT, double* part,
                       int splits, int n, int p, int S, int bp, int kc, int pen, int use_fp,
                       const double* prm, int prm_lane, void* stream) {
  if (p <= 0 || S <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = launch_mma_product(Xt, R, offset, gradT, part, splits, n, p, S, st);
  if (rc != 0) return rc;
  lane_epilogue_kernel<double><<<dim3((p + 255) / 256, S), 256, 0, st>>>(
      gradT, beta, L, l_lane, gsupp, scores, grad, pri, p, S, pen, use_fp, prm, prm_lane);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_select<double>(pri, cand_idx, p, bp, kc, st, S);
}

// K3bl (float64): the product and reduce launches over the S * nt columns
// into gradT [p, S * nt], the block lane epilogue, and the select launch
// over the lanes; the merge launch is merge_lanes_f64
int fused_ws_block_lanes_f64(const double* Xt, const double* R, const double* beta,
                             const double* L, int l_lane, const double* offset,
                             const uint8_t* gsupp, double* scores, double* grad, double* pri,
                             int* cand_idx, double* gradT, double* part, int splits, int n, int p,
                             int S, int nt, int bp, int kc, int pen, int use_fp,
                             const double* prm, int prm_lane, void* stream) {
  if (p <= 0 || S <= 0 || S > 65535 || nt <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = launch_mma_product(Xt, R, offset, gradT, part, splits, n, p, S * nt, st);
  if (rc != 0) return rc;
  block_lane_epilogue_kernel<double><<<dim3((p + 255) / 256, S), 256, 0, st>>>(
      gradT, beta, L, l_lane, gsupp, scores, grad, pri, p, S, nt, pen, use_fp, prm, prm_lane);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_select<double>(pri, cand_idx, p, bp, kc, st, S);
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

// The sample spans of K3b's float64 product launch at (n, p), which size
// its scratch [S, p, 24] (-1 if the card cannot say)
int fused_ws_block_splits(int n, int p) { return mma_splits(n, p); }

}  // extern "C"
