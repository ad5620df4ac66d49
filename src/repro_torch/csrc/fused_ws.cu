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
// index p and a zero row), and copies those rows of Xt out as exact
// candidate columns.
//
// What bounds it on the H100: bytes. X is read once (p*n values) and the
// candidate rows are written once (tiles*kc*n values); the score, sort and
// index work is small beside that.
//
// Design: two launches on the caller's stream.
//  1. score pass: one warp per feature over p/8 CTAs, each lane streaming
//     contiguous elements of the feature's row with four independent
//     partial sums so loads stay in flight; the score epilogue runs in
//     registers on lane 0, which also writes the selection priority.
//  2. select + copy: a (tiles x parts) grid. Every CTA of a tile sorts the
//     tile's (priority, index) pairs in shared memory with a bitonic
//     network whose comparison is the lax.top_k total order (the sort is
//     repeated per CTA; it is small beside the copies), then copies its
//     share of the kc selected rows with coalesced loads and stores.
// The TPU kernel copies the candidate columns out of its VMEM-resident tile;
// an SM cannot hold a tile of X (bp*n*8 bytes), so here the selected rows
// are read again from device memory (or L2), kc*n values per tile.
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
constexpr int kTargetCtas = 528;     // 4 CTAs per SM on 132 SMs

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
                             int n, int p, int pen, int use_fp, T p0, T p1) {
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

template <typename T>
__global__ void select_kernel(const T* __restrict__ Xt, const T* __restrict__ pri_in,
                              int* cand_idx, T* cand_cols, int n, int p, int bp, int kc,
                              int sortn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pri = reinterpret_cast<T*>(smem_raw);
  int* idx = reinterpret_cast<int*>(pri + sortn);
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
  for (int k = blockIdx.y; k < kc; k += gridDim.y) {
    const int sel = idx[k];
    const long long j = base + sel;
    const bool valid = sel < bp && j < p;
    if (threadIdx.x == 0) cand_idx[row0 + k] = valid ? (int)j : p;
    T* dst = cand_cols + (row0 + k) * (long long)n;
    if (valid) {
      const T* src = Xt + j * (long long)n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = T(0);
    }
  }
}

template <typename T>
int launch_fused(const T* Xt, const T* r, const T* beta, const T* L, const T* offset,
                 const uint8_t* gsupp, T* scores, T* grad, T* pri, int* cand_idx,
                 T* cand_cols, int n, int p, int bp, int kc, int pen, int use_fp, double p0,
                 double p1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int per_cta = kScoreThreads / 32;
  score_kernel<T, false><<<(p + per_cta - 1) / per_cta, kScoreThreads, 0, st>>>(
      Xt, r, nullptr, beta, L, offset, gsupp, scores, grad, pri, n, p, pen, use_fp, (T)p0,
      (T)p1);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;

  int sortn = 1;
  while (sortn < bp) sortn <<= 1;
  const size_t dyn = (size_t)sortn * (sizeof(T) + sizeof(int));
  const int tiles = (p + bp - 1) / bp;
  int parts = (kTargetCtas + tiles - 1) / tiles;
  if (parts > kc) parts = kc;
  cudaFuncSetAttribute(select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  select_kernel<T><<<dim3(tiles, parts), kSelectThreads, dyn, st>>>(
      Xt, pri, cand_idx, cand_cols, n, p, bp, kc, sortn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ws_score(const T* Xt, const T* r, const T* w, const T* beta, const T* L,
                    const T* offset, T* scores, int n, int p, int pen, int use_fp, double p0,
                    double p1, void* stream) {
  if (p <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int per_cta = kScoreThreads / 32;
  const int ctas = (p + per_cta - 1) / per_cta;
  if (w) {
    score_kernel<T, true><<<ctas, kScoreThreads, 0, st>>>(
        Xt, r, w, beta, L, offset, nullptr, scores, nullptr, nullptr, n, p, pen, use_fp,
        (T)p0, (T)p1);
  } else {
    score_kernel<T, false><<<ctas, kScoreThreads, 0, st>>>(
        Xt, r, nullptr, beta, L, offset, nullptr, scores, nullptr, nullptr, n, p, pen,
        use_fp, (T)p0, (T)p1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ws_score_f64(const double* Xt, const double* r, const double* w, const double* beta,
                 const double* L, const double* offset, double* scores, int n, int p, int pen,
                 int use_fp, double p0, double p1, void* stream) {
  return launch_ws_score<double>(Xt, r, w, beta, L, offset, scores, n, p, pen, use_fp, p0,
                                 p1, stream);
}

int ws_score_f32(const float* Xt, const float* r, const float* w, const float* beta,
                 const float* L, const float* offset, float* scores, int n, int p, int pen,
                 int use_fp, double p0, double p1, void* stream) {
  return launch_ws_score<float>(Xt, r, w, beta, L, offset, scores, n, p, pen, use_fp, p0, p1,
                                stream);
}

int fused_ws_f64(const double* Xt, const double* r, const double* beta, const double* L,
                 const double* offset, const uint8_t* gsupp, double* scores, double* grad,
                 double* pri, int* cand_idx, double* cand_cols, int n, int p, int bp, int kc,
                 int pen, int use_fp, double p0, double p1, void* stream) {
  return launch_fused<double>(Xt, r, beta, L, offset, gsupp, scores, grad, pri, cand_idx,
                              cand_cols, n, p, bp, kc, pen, use_fp, p0, p1, stream);
}

int fused_ws_f32(const float* Xt, const float* r, const float* beta, const float* L,
                 const float* offset, const uint8_t* gsupp, float* scores, float* grad,
                 float* pri, int* cand_idx, float* cand_cols, int n, int p, int bp, int kc,
                 int pen, int use_fp, double p0, double p1, void* stream) {
  return launch_fused<float>(Xt, r, beta, L, offset, gsupp, scores, grad, pri, cand_idx,
                             cand_cols, n, p, bp, kc, pen, use_fp, p0, p1, stream);
}

}  // extern "C"
