// K5, K5s and K5b: the sparse score pass over a CSC design.
//
// Replaces repro/sparse/ops.py:csc_score_pallas (body _score_kernel) and its
// square-mode wrapper csc_weighted_col_sq_pallas. For every column j of X:
//   K5  (square = 0): out_j = sum_k x_kj * v[row_k]       (X.T @ raw)
//   K5s (square = 1): out_j = sum_k (x_kj * x_kj) * v[row_k]
//                                                 (sum_i w_i x_ij^2)
//   K5b:  out[j, t] = sum_k x_kj * raw[row_k, t]   (raw [n, T] row-major)
// The TPU kernel reads the ELL layout rows/vals [p, m]; here each column's
// entries are its CSC segment data/indices[indptr[j] .. indptr[j+1]), so
// the bytes read are nnz entries, not p * m. Products are rounded in the
// value type (built with -fmad=false), sums are taken in float64 and the
// result is rounded to the value type once.
//
// What bounds them on the H100: bytes. data and indices are read once (12
// bytes an entry in f64), raw once and the output written once. The TPU
// kernel holds raw whole in VMEM across its grid. Here raw's rows are
// gathered through L2 (a 32-byte sector an entry at T = 1, T values an
// entry for K5b: 1.6 GB of L2 reads at sparse_fig2 with T = 20), whose
// floor l2_gather_probe measures. Designs that staged raw in shared memory
// (row bands streamed by bulk copies through a ring shared by a cluster;
// raw held whole across a cluster, read over distributed shared memory)
// ran slower on the H100 than this walk at sparse_fig2's shapes (PERF.md
// section 6): they run one CTA an SM, and the walk's cost is the
// latency of each column's chain of loads, which 64 resident warps an SM
// hide and 16 to 32 do not.
//
// Design: a warp walks CSC columns, eight warps a CTA of 256 threads. K5
// and K5s (csc_walk1_kernel): L = 16 lanes a column, two columns a warp
// (the median column of sparse_fig2 holds 15 entries; at 32 lanes a
// column, the layout this kernel replaced, half the lanes idle and each
// column's chain of loads costs a whole warp). K5b (csc_walk_kernel): a group of G lanes reads an
// entry's row, V values a lane (16-byte loads at V = 2), and the warp
// takes E = 32 / G entries an iteration with four iterations' loads in
// flight a lane (kernels/csc_score.py: lane_plan; T = 20 gives V = 2,
// G = 10, E = 3: 30 lanes busy and twelve rows of raw in flight a warp,
// where the kernel it replaced had one). Tasks past 32 V run in further blocks.
//
// Summation order (kernels/csc_score.py: emulate mirrors it): slot e
// (0 <= e < E) of a task sums the products of entries indptr[j] + e,
// + e + E, ... in entry order from 0.0; the E slot sums are added in slot
// order, except at T = 1 (the E = L slots are a column's lanes), where a
// shuffle-down tree (offsets L / 2, ..., 2, 1) adds them. The order
// depends only on the column's entries and T. E = 1 (G = 32) is entry
// order.
//
// l2_gather_probe times the gathers as a walk makes them (it is no kernel
// of the solver): `gathers` reads of rows of WIDTH values at hashed
// (random, uniform) row indices of a buffer [rows, WIDTH] that stays in
// L2, a warp reading whole rows with neighbouring lanes on neighbouring
// values (at WIDTH = 20, 8 rows with 5 reads a lane; at WIDTH = 1, 128
// rows with 4), every lane keeping its reads in flight: the floor of the
// walk, not a bound of the function.
//
// K5r (csc_row_sum) is the transpose walk: the CSC scatters of the sparse
// design, X @ beta (CSCDesign.matvec) and the working set's incremental
// residual Xb + X_ws delta (CSCDesign.update_xb), as a sum over each row's
// entries in a fixed order. The reference adds them with a scatter-add
// (jax .at[].add); the port's plain version is index_add_, which adds with
// atomics on a CUDA device, so two runs could round differently. Here
// `order` lists the entries row by row (a stable sort of their row ids,
// kernels/csc_score.py: row_order) and ptr [rows + 1] bounds each row's
// run; one thread a (row, task) sums its run in that order from 0.0:
//   out[i, t] = base[i, t] + sum_e val[x_e] * coef[key(x_e), t]
// with x_e = order[e], key(x) = keys[x] (matvec: the entry's column) or
// x / kdiv (update_xb: the window's working-set slot). That is the order in
// which index_add_ adds on the CPU, so the two agree bit for bit. It
// replaces no TPU kernel: the reference's scatter is an XLA op. What
// bounds it: the gathers of each entry's order, value, key and coef (L2
// latency, several loads of each entry in flight a thread).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWalkWarps = 8;  // warps a CTA
// lanes a column of K5 and K5s (kernels/csc_score.py: K5_LANES)
constexpr int kK5Lanes = 16;

// V values of raw read as one load (16 bytes at V = 2 in float64)
template <typename T, int V>
struct alignas(V * sizeof(T)) Vals {
  T v[V];
};

// an entry's product, rounded in the value type: x v, or (x x) v for K5s
template <typename T>
__device__ __forceinline__ T product(T x, T v, int square) {
  return square ? (x * x) * v : x * v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kWalkWarps * 32)
    csc_walk_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                    const long long* __restrict__ indptr, const T* __restrict__ raw,
                    T* __restrict__ out, int p, int R, int G) {
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (j >= p) return;  // the whole warp leaves together
  const int E = 32 / G, slot = lane / G, q = lane % G;
  const long long s0 = indptr[j], s1 = indptr[j + 1];
  for (int t0 = 0; t0 < R; t0 += G * V) {
    const int t = t0 + q * V;  // this lane's first task
    const bool on = slot < E && t < R;
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
    for (long long k0 = s0 + slot; k0 < s1; k0 += 4LL * E) {
      int r[4];
      T x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long k = k0 + (long long)u * E;
        const bool ok = on && k < s1;
        r[u] = ok ? indices[k] : -1;
        x[u] = ok ? data[k] : (T)0;
      }
      Vals<T, V> g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r[u] >= 0) g[u] = *(const Vals<T, V>*)(raw + (long long)r[u] * R + t);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r[u] >= 0) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = acc[v] + (double)(x[u] * g[u].v[v]);
        }
    }
    // the E slot partials of a task sit on lanes q, q + G, ...: in slot order
#pragma unroll
    for (int v = 0; v < V; ++v) {
      double tot = acc[v];
      for (int e = 1; e < E; ++e) tot = tot + __shfl_sync(0xffffffffu, acc[v], lane + e * G);
      acc[v] = tot;
    }
    if (slot == 0 && t < R) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (t + v < R) out[j * R + t + v] = (T)acc[v];
    }
  }
}

// K5 and K5s (raw [n]): a warp walks 32 / L columns, L lanes each; lane l
// of a column sums its entries l, l + L, ... in entry order, and the L lane
// sums add by a shuffle-down tree (offsets L / 2, ..., 1). L = 32 would be
// the kernel and order this one replaced.
template <typename T, int L>
__global__ void __launch_bounds__(kWalkWarps * 32)
    csc_walk1_kernel(const T* __restrict__ data, const int* __restrict__ indices,
                     const long long* __restrict__ indptr, const T* __restrict__ v,
                     T* __restrict__ out, int p, int square) {
  const int lane = threadIdx.x & 31, sl = lane % L;
  const long long j =
      ((long long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5)) * (32 / L) + lane / L;
  long long s0 = 0, s1 = 0;
  if (j < p) {
    s0 = indptr[j];
    s1 = indptr[j + 1];
  }
  double acc = 0.0;
  for (long long k = s0 + sl; k < s1; k += L)
    acc = acc + (double)product(data[k], v[indices[k]], square);
  for (int o = L / 2; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o, L);
  if (sl == 0 && j < p) out[j] = (T)acc;
}

template <typename T>
int launch_walk1(const T* data, const int* indices, const long long* indptr, const T* v,
                 T* out, int p, int square, void* stream) {
  const int per_cta = kWalkWarps * (32 / kK5Lanes);
  csc_walk1_kernel<T, kK5Lanes><<<(p + per_cta - 1) / per_cta, kWalkWarps * 32, 0,
                                  (cudaStream_t)stream>>>(data, indices, indptr, v, out, p,
                                                          square);
  return (int)cudaGetLastError();
}

// V values a lane, G lanes an entry (kernels/csc_score.py: lane_plan): V
// divides R, G V <= 32 V covers a task block, raw 16-byte aligned
template <typename T>
int launch_walk(const T* data, const int* indices, const long long* indptr, const T* raw,
                T* out, int p, int R, int square, int V, int G, void* stream) {
  if (p <= 0) return 0;
  if (R == 1) {  // G is then the lanes a column
    if (V != 1 || G != kK5Lanes) return (int)cudaErrorInvalidValue;
    return launch_walk1<T>(data, indices, indptr, raw, out, p, square, stream);
  }
  if (G < 1 || G > 32 || (V != 1 && V != 2) || R % V || square ||
      ((uintptr_t)raw & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((p + kWalkWarps - 1) / kWalkWarps), block(kWalkWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (V == 2)
    csc_walk_kernel<T, 2><<<grid, block, 0, st>>>(data, indices, indptr, raw, out, p, R, G);
  else
    csc_walk_kernel<T, 1><<<grid, block, 0, st>>>(data, indices, indptr, raw, out, p, R, G);
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

// K5r: one thread a (row, task); four entries' loads in flight
template <typename T>
__global__ void __launch_bounds__(256)
    row_sum_kernel(const T* __restrict__ val, const int* __restrict__ order,
                   const int* __restrict__ keys, int kdiv, const long long* __restrict__ ptr,
                   const T* __restrict__ coef, const T* __restrict__ base, T* __restrict__ out,
                   int rows, int nt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * nt) return;
  const int i = (int)(idx / nt), t = (int)(idx - (long long)i * nt);
  const long long e1 = ptr[i + 1];
  long long e = ptr[i];
  T acc = T(0);
  for (; e + 4 <= e1; e += 4) {
    int x[4];
    long long c[4];
    T v[4], w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = order[e + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = val[x[u]];
      c[u] = keys ? keys[x[u]] : x[u] / kdiv;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = coef[c[u] * nt + t];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = acc + v[u] * w[u];
  }
  for (; e < e1; ++e) {
    const int x = order[e];
    const long long c = keys ? keys[x] : x / kdiv;
    acc = acc + val[x] * coef[c * nt + t];
  }
  out[idx] = base ? base[idx] + acc : acc;
}

template <typename T>
int launch_row_sum(const T* val, const int* order, const int* keys, int kdiv,
                   const long long* ptr, const T* coef, const T* base, T* out, int rows, int nt,
                   void* stream) {
  if (rows < 0 || nt < 1 || (!keys && kdiv < 1)) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)rows * nt;
  if (threads == 0) return 0;
  row_sum_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      val, order, keys, kdiv, ptr, coef, base, out, rows, nt);
  return (int)cudaGetLastError();
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

// K5, K5s and K5b with the wrapper's plan (kernels/csc_score.py: lane_plan):
// V values a lane, G lanes an entry
int csc_walk_f64(const double* data, const int* indices, const long long* indptr,
                 const double* raw, double* out, int p, int R, int square, int V, int G,
                 void* stream) {
  return launch_walk<double>(data, indices, indptr, raw, out, p, R, square, V, G, stream);
}

int csc_walk_f32(const float* data, const int* indices, const long long* indptr,
                 const float* raw, float* out, int p, int R, int square, int V, int G,
                 void* stream) {
  return launch_walk<float>(data, indices, indptr, raw, out, p, R, square, V, G, stream);
}

// K5r: out [rows, nt] = base + each row's entries summed in `order` (keys
// or x / kdiv the coef row of entry x; base may be null)
int csc_row_sum_f64(const double* val, const int* order, const int* keys, int kdiv,
                    const long long* ptr, const double* coef, const double* base, double* out,
                    int rows, int nt, void* stream) {
  return launch_row_sum<double>(val, order, keys, kdiv, ptr, coef, base, out, rows, nt, stream);
}

int csc_row_sum_f32(const float* val, const int* order, const int* keys, int kdiv,
                    const long long* ptr, const float* coef, const float* base, float* out,
                    int rows, int nt, void* stream) {
  return launch_row_sum<float>(val, order, keys, kdiv, ptr, coef, base, out, rows, nt, stream);
}

}  // extern "C"
