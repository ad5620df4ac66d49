// K5 and K5s: the sparse score pass over a CSC design.
//
// Replaces repro/sparse/ops.py:csc_score_pallas (body _score_kernel) and its
// square-mode wrapper csc_weighted_col_sq_pallas, for a raw vector [n]. For
// every column j of X:
//   K5  (square = 0): out_j = sum_k x_kj * v[row_k]       (X.T @ raw)
//   K5s (square = 1): out_j = sum_k (x_kj * x_kj) * v[row_k]
//                                                 (sum_i w_i x_ij^2)
//
// Layout: the TPU kernel reads the ELL layout rows/vals [p, m], which Pallas
// needs for rectangular tiles. Here each column walks its own CSC segment
// data/indices[indptr[j] .. indptr[j+1]), so the kernel reads nnz entries
// and not p * m: on a power-law design (max column nnz m far above the
// median) that is many times fewer bytes.
//
// What bounds it on the H100: bytes. data and indices are read once (12
// bytes an entry in f64), v is gathered through L2 (n values; 400 KB at
// n = 50k, far under the 50 MB L2), and p values are written.
//
// Design: one warp per column, eight columns per CTA. Each lane walks the
// segment with a stride of 32 and accumulates in f64; the warp then sums
// its lanes by a fixed shuffle tree. The order of the sum depends only on
// the column's nnz, so the result is deterministic from run to run (unlike
// an atomic scatter). Short columns leave most lanes idle: on a power-law
// design most columns hold a few entries and a handful hold ~1000, so the
// load is uneven; balancing the work over nnz is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 columns per CTA

template <typename T>
__global__ void csc_score_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                                 const long long* __restrict__ indptr,
                                 const T* __restrict__ v, T* __restrict__ out, int p,
                                 int square) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= p) return;  // the whole warp leaves together
  const long long start = indptr[j], end = indptr[j + 1];
  double acc = 0.0;
  if (square) {
    for (long long k = start + lane; k < end; k += 32) {
      const T x = data[k];
      acc = acc + (double)((x * x) * v[indices[k]]);
    }
  } else {
    for (long long k = start + lane; k < end; k += 32)
      acc = acc + (double)(data[k] * v[indices[k]]);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) out[j] = (T)acc;
}

template <typename T>
int launch(const T* data, const int* indices, const long long* indptr, const T* v, T* out,
           int p, int square, void* stream) {
  if (p <= 0) return 0;
  const int per_cta = kThreads / 32;
  csc_score_kernel<T><<<(p + per_cta - 1) / per_cta, kThreads, 0, (cudaStream_t)stream>>>(
      data, indices, indptr, v, out, p, square);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int csc_score_f64(const double* data, const int* indices, const long long* indptr,
                  const double* v, double* out, int p, int square, void* stream) {
  return launch<double>(data, indices, indptr, v, out, p, square, stream);
}

int csc_score_f32(const float* data, const int* indices, const long long* indptr,
                  const float* v, float* out, int p, int square, void* stream) {
  return launch<float>(data, indices, indptr, v, out, p, square, stream);
}

}  // extern "C"
