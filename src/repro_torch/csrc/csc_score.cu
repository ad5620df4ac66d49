// K5, K5s and K5b: the sparse score pass over a CSC design.
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
//
// K5b replaces csc_score_pallas for a multitask raw gradient [n, T]
// (row-major): out[j, t] = sum_k x_kj * raw[row_k, t], out [p, T]. One warp
// per column again. Its lanes cover the tasks: a group of G lanes (G = 8,
// 16 or 32, the smallest >= min(T, 32)) reads the T-row raw[row_k, :] of one
// entry with neighbouring lanes on neighbouring addresses, and the 32 / G
// groups of the warp take the entries k = start + group, + 32 / G, ... .
// Tasks past 32 run in further passes of 32. Each lane sums in f64 in
// entry order; the groups are then summed by a fixed shuffle tree, so the
// result is deterministic. Bound: the HBM bytes are data and indices once,
// raw once and the [p, T] output; the raw rows are gathered through L2
// (T * 8 bytes per entry, 1.6 GB of L2 reads at sparse_fig2 with T = 20).
//
// l2_gather_probe times those gathers as this design makes them (it is no
// kernel of the solver): `gathers` reads of rows of WIDTH values at hashed
// (random, uniform) row indices of a buffer [rows, WIDTH] that stays in
// L2: a warp reads whole rows with neighbouring lanes on neighbouring
// values (at WIDTH = 20, 8 rows with 5 reads a lane; at WIDTH = 1, 128
// rows with 4), every lane keeping its reads in flight. Its time for nnz
// gathers of raw's rows is the floor of this CSC-walk design of K5
// (WIDTH = 1: a 32-byte sector an entry) and K5b (WIDTH = T), not a bound
// of the function: a design that blocks by rows could reuse raw on chip.
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void csc_score_block_kernel(const T* __restrict__ data,
                                       const int* __restrict__ indices,
                                       const long long* __restrict__ indptr,
                                       const T* __restrict__ raw, T* __restrict__ out, int p,
                                       int nt, int gsz) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (j >= p) return;  // the whole warp leaves together
  const int grp = lane / gsz, tl = lane % gsz, ngrp = 32 / gsz;
  const long long start = indptr[j], end = indptr[j + 1];
  for (int t0 = 0; t0 < nt; t0 += gsz) {
    const int t = t0 + tl;
    double acc = 0.0;
    if (t < nt) {
      for (long long k = start + grp; k < end; k += ngrp)
        acc = acc + (double)(data[k] * raw[(long long)indices[k] * nt + t]);
    }
    for (int o = 16; o >= gsz; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (grp == 0 && t < nt) out[j * nt + t] = (T)acc;
  }
}

template <typename T>
int launch_block(const T* data, const int* indices, const long long* indptr, const T* raw,
                 T* out, int p, int nt, void* stream) {
  if (p <= 0) return 0;
  if (nt <= 0) return (int)cudaErrorInvalidValue;
  const int gsz = nt <= 8 ? 8 : (nt <= 16 ? 16 : 32);
  const int per_cta = kThreads / 32;
  csc_score_block_kernel<T><<<(p + per_cta - 1) / per_cta, kThreads, 0, (cudaStream_t)stream>>>(
      data, indices, indptr, raw, out, p, nt, gsz);
  return (int)cudaGetLastError();
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

// a hashed row of [0, rows) for gather g: uniform and free of memory reads
__device__ __forceinline__ unsigned gather_row(unsigned long long g, unsigned rows) {
  unsigned h = (unsigned)g * 0x9E3779B1u + (unsigned)(g >> 32);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (unsigned)(((unsigned long long)h * rows) >> 32);
}

// M reads a lane an iteration: a warp reads 32 M / WIDTH whole rows
template <int WIDTH, int M>
__global__ void l2_gather_kernel(const double* __restrict__ buf, unsigned rows,
                                 long long gathers, double* out) {
  static_assert((32 * M) % WIDTH == 0, "a warp reads whole rows");
  constexpr int RPI = 32 * M / WIDTH;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  int rr[M], cc[M];  // this lane's row within the iteration and value in it
#pragma unroll
  for (int m = 0; m < M; ++m) {
    rr[m] = (lane + 32 * m) / WIDTH;
    cc[m] = (lane + 32 * m) % WIDTH;
  }
  double acc = 0.0;
  for (long long g0 = warp * RPI; g0 < gathers; g0 += warps * RPI) {
    double v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const long long g = g0 + rr[m];
      v[m] = g < gathers ? buf[(long long)gather_row(g, rows) * WIDTH + cc[m]] : 0.0;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) acc += v[m];
  }
  if (acc == -1.0) out[0] = acc;  // keeps the reads; buf holds no negatives
}

}  // namespace

extern "C" {

// `gathers` hashed row reads of buf [rows, width] (width 1 or 20) on
// `blocks` CTAs of 256 threads
int l2_gather_probe(const double* buf, int rows, int width, long long gathers, int blocks,
                    double* out, void* stream) {
  if (rows <= 0 || gathers < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 1)
    l2_gather_kernel<1, 4><<<blocks, 256, 0, st>>>(buf, (unsigned)rows, gathers, out);
  else if (width == 20)
    l2_gather_kernel<20, 5><<<blocks, 256, 0, st>>>(buf, (unsigned)rows, gathers, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int csc_score_f64(const double* data, const int* indices, const long long* indptr,
                  const double* v, double* out, int p, int square, void* stream) {
  return launch<double>(data, indices, indptr, v, out, p, square, stream);
}

int csc_score_f32(const float* data, const int* indices, const long long* indptr,
                  const float* v, float* out, int p, int square, void* stream) {
  return launch<float>(data, indices, indptr, v, out, p, square, stream);
}

int csc_score_block_f64(const double* data, const int* indices, const long long* indptr,
                        const double* raw, double* out, int p, int nt, void* stream) {
  return launch_block<double>(data, indices, indptr, raw, out, p, nt, stream);
}

int csc_score_block_f32(const float* data, const int* indices, const long long* indptr,
                        const float* raw, float* out, int p, int nt, void* stream) {
  return launch_block<float>(data, indices, indptr, raw, out, p, nt, stream);
}

}  // extern "C"
