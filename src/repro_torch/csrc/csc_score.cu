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
// each row's entries are summed from 0.0 in the order index_add_ adds
// them on the CPU, so the two agree bit for bit:
//   out[i, t] = base[i, t] + sum_e val_e * coef[key_e, t]
// matvec: row i's entries by ascending column, key = the column;
// update_xb: the row's entries in working-set columns by ascending slot,
// key = slot[column] (entries whose column has no slot are left out). It
// replaces no TPU kernel: the reference's scatter is an XLA op.
//
// It walks a row-major copy of the design (kernels/csc_score.py:
// row_major, made once a design): vals, cols and ptr [rows + 1], zeros
// and padding left out. What bounds it on the H100: bytes, each entry's
// value and column read once (12 bytes in float64) and coef gathered
// through L2 (1.6 MB at p = 200,000), and the latency of each row's walk
// and chain of adds (the price of the fixed order: a row of L entries is
// L dependent adds). matvec at one task (row_matvec1_kernel,
// kernels/csc_score.py: matvec_plan): a thread a row walks its entries
// straight from the copy, no barrier, the next 8 loaded while this 8's
// coef is gathered and added. At T tasks (row_matvec_kernel): a CTA takes
// R rows (R T <= threads) and stages a slice of C entries of every row
// at a time, read by all threads; then thread (row, task) adds its row's
// slice onto its sum. update_xb (row_update_kernel, UPDATE_PLAN): a warp
// a row, straight from the copy: whether each entry's column is in the
// working set (a bitmap of the columns, read through L1), then for the
// kept entries alone the slot (the slot map) and the product or value,
// compacted by ballot; each kept entry is ranked among the row's by slot
// (counting the smaller slots: k^2 / 32 a lane for k kept, no sort) and
// lane 0 (or a lane a task) adds them in slot order. Staging a CTA's rows
// in shared memory and adding a thread a row loses to these at one task
// (cd_sweep.py k5r's layouts, PERF.md section 6: 0.14-0.23 ms a matvec
// against 0.10), set by the barriers and few busy lanes. A row
// of more than W entries (or, in update_xb, more kept than its warp's
// buffer) takes the long path: matvec stages it in chunks and one thread
// a task carries the sum; update_xb scans it once a window of slots,
// placing each kept entry at its slot (a row holds a column once) and
// adding the window in slot order.
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

// K5r's add modes over staged terms [a, b): every term, or the kept terms
// among holes (a long row's slot window: skip keys -1)
enum { kAll = 0, kHoles = 1 };

// acc plus the staged terms of [a, b) in order: one task (nt = 1) adds the
// staged products sv, T tasks the staged values times coef[key, t]
template <typename T, int MODE>
__device__ __forceinline__ T add_staged(T acc, const T* sv, const int* sk, int a, int b,
                                        const T* __restrict__ coef, int nt, int t) {
  for (int q = a; q < b; q += 4) {
    T x[4];
    bool on[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = q + u;
      const int k = i < b && (MODE != kAll || nt > 1) ? sk[i] : 0;
      on[u] = i < b && (MODE == kAll || k >= 0);
      x[u] = T(0);
      if (on[u]) x[u] = nt == 1 ? sv[i] : sv[i] * coef[(long long)k * nt + t];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (on[u]) acc = acc + x[u];
  }
  return acc;
}

// the store of one (row, task) sum
template <typename T>
__device__ __forceinline__ void put_row(T* __restrict__ out, const T* __restrict__ base,
                                        long long o, T acc) {
  out[o] = base ? base[o] + acc : acc;
}

// K5r's long path: row r, entries [s0, s1). matvec stages chunks of
// `budget` entries; update_xb stages a window of `budget` slots a scan of
// the row. One thread a task carries the sums.
template <typename T, bool UPD>
__device__ void row_sum_long(const T* __restrict__ val, const int* __restrict__ col,
                             const int* __restrict__ slot, const T* __restrict__ coef,
                             const T* __restrict__ base, T* __restrict__ out, T* sv, int* sk,
                             int r, long long s0, long long s1, int budget, int nt, int K) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const long long span = UPD ? K : s1 - s0;
  for (int t0 = 0; t0 < nt; t0 += nth) {
    const int t = t0 + tid;
    T acc = T(0);
    for (long long c0 = 0; c0 < span; c0 += budget) {
      const int m = (int)min((long long)budget, span - c0);
      __syncthreads();  // the previous chunk's adds are done
      if (UPD) {
        for (int j = tid; j < m; j += nth) sk[j] = -1;
        __syncthreads();
        for (long long e = s0 + tid; e < s1; e += nth) {
          const int s = slot[col[e]];
          if (s >= c0 && s < c0 + m) {
            const T v = val[e];
            sv[s - c0] = nt == 1 ? v * coef[s] : v;
            sk[s - c0] = s;
          }
        }
      } else {
        for (int j = tid; j < m; j += nth) {
          const T v = val[s0 + c0 + j];
          const int c = col[s0 + c0 + j];
          sv[j] = nt == 1 ? v * coef[c] : v;
          sk[j] = c;
        }
      }
      __syncthreads();
      if (t < nt) acc = add_staged<T, UPD ? kHoles : kAll>(acc, sv, sk, 0, m, coef, nt, t);
    }
    if (t < nt) put_row(out, base, (long long)r * nt + t, acc);
  }
}

// K5r's matvec (kernels/csc_score.py: matvec_plan): CTA c sums rows
// [c R, (c + 1) R) with R nt <= threads, a slice of C entries of every row
// at a time: all threads stage entries o0 .. o0 + C - 1 of each row
// (products at one task, else values and columns), then thread (row,
// task) adds its row's slice onto its sum, so every lane of the adds
// carries a row. Rows of more than `longer` entries take the long path
// after the slices. Dynamic shared memory: sv [R][C + 1] (T), sk [R][C +
// 1] (int), rs [R] (long long), rl [R] (int: a row's entries, -1 if long).
template <typename T>
__global__ void __launch_bounds__(512)
    row_matvec_kernel(const T* __restrict__ val, const int* __restrict__ col,
                      const long long* __restrict__ ptr, const T* __restrict__ coef,
                      const T* __restrict__ base, T* __restrict__ out, int rows, int R, int C,
                      int longer, int nt) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  const int ld = C + 1;
  T* sv = reinterpret_cast<T*>(row_smem);
  int* sk = reinterpret_cast<int*>(sv + R * ld);
  long long* rs = reinterpret_cast<long long*>(row_smem + ((size_t)R * ld * (sizeof(T) + 4) + 7) / 8 * 8);
  int* rl = reinterpret_cast<int*>(rs + R);
  __shared__ int most;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int r0 = blockIdx.x * R, nr = min(R, rows - r0);
  if (tid == 0) most = 0;
  __syncthreads();
  for (int r = tid; r < nr; r += nth) {
    const long long s0 = ptr[r0 + r];
    const int L = (int)min(ptr[r0 + r + 1] - s0, (long long)longer + 1);
    rs[r] = s0;
    rl[r] = L > longer ? -1 : L;
    if (L <= longer) atomicMax(&most, L);
  }
  __syncthreads();
  const int r = tid / nt, t = tid - (tid / nt) * nt;
  const bool mine = tid < nr * nt;
  T acc = T(0);
  for (int o0 = 0; o0 < most; o0 += C) {
    for (int i0 = tid; i0 < nr * C; i0 += 4 * nth) {
      T v[4];
      int c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nth, q = i / C, o = o0 + i - q * C;
        const bool on = i < nr * C && o < rl[q];
        v[u] = on ? val[rs[q] + o] : T(0);
        c[u] = on ? col[rs[q] + o] : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nth, q = i / C;
        if (c[u] < 0) continue;
        sv[q * ld + i - q * C] = nt == 1 ? v[u] * coef[c[u]] : v[u];
        sk[q * ld + i - q * C] = c[u];
      }
    }
    __syncthreads();
    if (mine) {
      const int m = min(C, rl[r] - o0);
      acc = add_staged<T, kAll>(acc, sv + r * ld, sk + r * ld, 0, m, coef, nt, t);
    }
    __syncthreads();
  }
  if (mine && rl[r] >= 0) put_row(out, base, (long long)(r0 + r) * nt + t, acc);
  for (int q = 0; q < nr; ++q)
    if (rl[q] < 0)
      row_sum_long<T, false>(val, col, nullptr, coef, base, out, sv, sk, r0 + q, rs[q],
                             ptr[r0 + q + 1], R * ld, nt, 0);
}

// K5r's matvec at one task (kernels/csc_score.py: matvec_plan, slice 0):
// a thread a row walks its entries straight from the copy, no barrier,
// 8 entries an iteration with the next iteration's values and columns
// loaded, and this one's coef gathered, before this one's adds; a warp's
// rows are consecutive, so each lane streams its own lines through L1.
// Rows of more than `longer` entries take the long path afterwards, with
// `budget` entries of dynamic shared memory: sv (T), sk (int).
constexpr int kMatvec1Budget = 512;  // entries a chunk of the long path
constexpr int kUpdateMaxRows = 256;  // rows a CTA of K5r's update, at most

template <typename T>
__global__ void __launch_bounds__(256)
    row_matvec1_kernel(const T* __restrict__ val, const int* __restrict__ col,
                       const long long* __restrict__ ptr, const T* __restrict__ coef,
                       const T* __restrict__ base, T* __restrict__ out, int rows, int longer,
                       int budget) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  constexpr int U = 8;
  const int r0 = blockIdx.x * blockDim.x, r = r0 + threadIdx.x;
  long long e = 0, s1 = 0;
  if (r < rows) {
    e = ptr[r];
    s1 = ptr[r + 1];
  }
  const bool lng = s1 - e > longer;
  if (lng) s1 = e;
  T v[U];
  int c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    v[u] = e + u < s1 ? val[e + u] : T(0);
    c[u] = e + u < s1 ? col[e + u] : -1;
  }
  T acc = T(0);
  for (; e < s1; e += U) {
    T w[U], nv[U];
    int nc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = c[u] >= 0 ? coef[c[u]] : T(0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = e + U + u;
      nv[u] = i < s1 ? val[i] : T(0);
      nc[u] = i < s1 ? col[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c[u] >= 0) acc = acc + v[u] * w[u];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      v[u] = nv[u];
      c[u] = nc[u];
    }
  }
  if (r < rows && !lng) put_row(out, base, r, acc);
  if (__syncthreads_or(lng)) {
    T* sv = reinterpret_cast<T*>(row_smem);
    int* sk = reinterpret_cast<int*>(sv + budget);
    for (int q = r0; q < min(r0 + (int)blockDim.x, rows); ++q)
      if (ptr[q + 1] - ptr[q] > longer)
        row_sum_long<T, false>(val, col, nullptr, coef, base, out, sv, sk, q, ptr[q], ptr[q + 1],
                               budget, 1, 0);
  }
}

// K5r's update (kernels/csc_score.py: UPDATE_PLAN): CTA c takes rows
// [c R, (c + 1) R), a warp a row at a time, straight from the copy with no
// CTA barrier: the lanes read 32 of the row's columns at a time (the next
// 32 already in flight), test the working set's bitmap (p / 8 bytes, held
// in L1) and compact the kept entries by ballot into the warp's buffer,
// reading the slot, the value and coef for the kept ones only (their slot
// and product at one task, or value); each lane then ranks its entries
// among the row's kept ones by slot (counting the smaller slots: no sort)
// into a second buffer, and lane 0 (one task) or a lane a task adds them
// in slot order. A row of more than `longer` entries, or with more than
// `kmax` kept, is left to the CTA's long path once the warps are done.
// Dynamic shared memory: a warp's values [2][kmax] (T) and keys [2][kmax]
// (int); the long path stages `budget` entries over the same bytes.
template <typename T>
__global__ void __launch_bounds__(256)
    row_update_kernel(const T* __restrict__ val, const int* __restrict__ col,
                      const long long* __restrict__ ptr, const int* __restrict__ slot,
                      const unsigned* __restrict__ bits, const T* __restrict__ coef,
                      const T* __restrict__ base, T* __restrict__ out, int rows, int R, int kmax,
                      int longer, int nt, int K) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  __shared__ int ndefer;
  __shared__ int deferred[kUpdateMaxRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  T* wv = reinterpret_cast<T*>(row_smem) + (size_t)warp * 2 * kmax;
  int* wk = reinterpret_cast<int*>(reinterpret_cast<T*>(row_smem) + (size_t)nw * 2 * kmax) +
            (size_t)warp * 2 * kmax;
  T* fv = wv + kmax;
  int* fk = wk + kmax;
  const int r0 = blockIdx.x * R, nr = min(R, rows - r0);
  if (tid == 0) ndefer = 0;
  __syncthreads();
  for (int q = warp; q < nr; q += nw) {
    const int row = r0 + q;
    const long long s0 = ptr[row], s1 = ptr[row + 1];
    bool defer = s1 - s0 > longer;
    int kept = 0;
    if (!defer) {
      int cn = s0 + lane < s1 ? col[s0 + lane] : -1;
      for (long long j0 = s0; j0 < s1; j0 += 32) {
        const long long j = j0 + lane;
        const int c = cn;
        cn = j + 32 < s1 ? col[j + 32] : -1;
        const bool on = c >= 0 && (__ldg(bits + (c >> 5)) >> (c & 31) & 1u);
        const unsigned m = __ballot_sync(0xffffffffu, on);
        const int at = kept + __popc(m & ((1u << lane) - 1u));
        if (on && at < kmax) {
          const int s = slot[c];
          const T v = val[j];
          wk[at] = s;
          wv[at] = nt == 1 ? v * coef[s] : v;
        }
        kept += __popc(m);
      }
      defer = kept > kmax;
    }
    if (defer) {  // warp-uniform
      if (lane == 0) deferred[atomicAdd(&ndefer, 1)] = row;
      continue;
    }
    __syncwarp();
    for (int i = lane; i < kept; i += 32) {
      const int s = wk[i];
      int rank = 0;
      for (int u = 0; u < kept; ++u) rank += wk[u] < s;
      fk[rank] = s;
      fv[rank] = wv[i];
    }
    __syncwarp();
    for (int t = lane; t < nt; t += 32)
      put_row(out, base, (long long)row * nt + t,
              add_staged<T, kAll>(T(0), fv, fk, 0, kept, coef, nt, t));
    __syncwarp();
  }
  __syncthreads();
  T* sv = reinterpret_cast<T*>(row_smem);
  const int budget = nw * kmax;  // the same bytes as the warps' buffers
  int* sk = reinterpret_cast<int*>(sv + budget);
  for (int i = 0; i < ndefer; ++i) {
    const int row = deferred[i];
    row_sum_long<T, true>(val, col, slot, coef, base, out, sv, sk, row, ptr[row], ptr[row + 1],
                          budget, nt, K);
  }
}

// K5r's update's slot map: pos[ws[k]] = k (pos is -1 elsewhere) and bit
// ws[k] of bits set, for ws [K] (int64, distinct features)
__global__ void slot_mark_kernel(const long long* __restrict__ ws, int* __restrict__ pos,
                                 unsigned* __restrict__ bits, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const long long j = ws[k];
  pos[j] = k;
  atomicOr(bits + (j >> 5), 1u << (j & 31));
}

// the dynamic shared memory of K5r's matvec CTA (R rows, slices of C)
template <typename T>
size_t row_matvec_smem(int R, int C) {
  return ((size_t)R * (C + 1) * (sizeof(T) + 4) + 7) / 8 * 8 + (size_t)R * 12;
}

// one task takes slice C = 0: row_matvec1_kernel, a thread a row (R rows
// a CTA); nt > 1 tasks take slices, C > 0: row_matvec_kernel. Other
// pairs are refused.
template <typename T>
int launch_row_matvec(const T* val, const int* col, const long long* ptr, const T* coef,
                      const T* base, T* out, int rows, int R, int C, int longer, int threads,
                      int nt, void* stream) {
  if (rows < 0 || R < 1 || C < 0 || longer < 1 || nt < 1 || threads < 32 || threads > 512 ||
      threads % 32 || R * nt > threads || (C == 0) != (nt == 1) ||
      (C == 0 && threads > 256))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (C == 0) {
    // the rows stream through L1: a small long-path stage, and most of
    // the SM's 256 KB left to L1
    const int budget = kMatvec1Budget;
    cudaError_t err = cudaFuncSetAttribute(
        row_matvec1_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout, 25);
    if (err != cudaSuccess) return (int)err;
    row_matvec1_kernel<T><<<(unsigned)((rows + R - 1) / R), R, budget * (sizeof(T) + 4),
                            (cudaStream_t)stream>>>(val, col, ptr, coef, base, out, rows, longer,
                                                    budget);
    return (int)cudaGetLastError();
  }
  const size_t dyn = row_matvec_smem<T>(R, C);
  if (dyn > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(row_matvec_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  row_matvec_kernel<T><<<(unsigned)((rows + R - 1) / R), threads, dyn, (cudaStream_t)stream>>>(
      val, col, ptr, coef, base, out, rows, R, C, longer, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_row_update(const T* val, const int* col, const long long* ptr, const int* slot,
                      const unsigned* bits, const T* coef, const T* base, T* out, int rows,
                      int R, int kmax, int longer, int threads, int nt, int K, void* stream) {
  if (rows < 0 || R < 1 || R > kUpdateMaxRows || kmax < 1 || longer < 1 || nt < 1 ||
      threads < 32 || threads > 256 || threads % 32 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const size_t dyn = (size_t)(threads / 32) * 2 * kmax * (sizeof(T) + sizeof(int));
  if (dyn > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(row_update_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  row_update_kernel<T><<<(unsigned)((rows + R - 1) / R), threads, dyn, (cudaStream_t)stream>>>(
      val, col, ptr, slot, bits, coef, base, out, rows, R, kmax, longer, nt, K);
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

// K5r's matvec over the row-major copy (val, col, ptr [rows + 1]) on
// kernels/csc_score.py: matvec_plan (R rows a CTA, slices of C, rows of
// more than `longer` entries long, threads a CTA): out [rows, nt] = base +
// each row's entries in column order times coef [P, nt]; base may be null
int csc_row_matvec_f64(const double* val, const int* col, const long long* ptr,
                       const double* coef, const double* base, double* out, int rows, int R,
                       int C, int longer, int threads, int nt, void* stream) {
  return launch_row_matvec<double>(val, col, ptr, coef, base, out, rows, R, C, longer, threads,
                                   nt, stream);
}

int csc_row_matvec_f32(const float* val, const int* col, const long long* ptr,
                       const float* coef, const float* base, float* out, int rows, int R, int C,
                       int longer, int threads, int nt, void* stream) {
  return launch_row_matvec<float>(val, col, ptr, coef, base, out, rows, R, C, longer, threads,
                                  nt, stream);
}

// K5r's update over the copy on kernels/csc_score.py: UPDATE_PLAN (R rows
// a CTA, kmax kept entries a row in a warp's buffer, rows of more than
// `longer` entries long, threads a CTA): out [rows, nt] = base + each
// row's entries whose column has a slot (slot [P] and its bitmap bits,
// csc_slot_map) by ascending slot times coef, the delta [K, nt]
int csc_row_update_f64(const double* val, const int* col, const long long* ptr, const int* slot,
                       const unsigned* bits, const double* coef, const double* base,
                       double* out, int rows, int R, int kmax, int longer, int threads, int nt,
                       int K, void* stream) {
  return launch_row_update<double>(val, col, ptr, slot, bits, coef, base, out, rows, R, kmax,
                                   longer, threads, nt, K, stream);
}

int csc_row_update_f32(const float* val, const int* col, const long long* ptr, const int* slot,
                       const unsigned* bits, const float* coef, const float* base, float* out,
                       int rows, int R, int kmax, int longer, int threads, int nt, int K,
                       void* stream) {
  return launch_row_update<float>(val, col, ptr, slot, bits, coef, base, out, rows, R, kmax,
                                  longer, threads, nt, K, stream);
}

// the slot map of ws [K] (int64, distinct features of [0, p)) for K5r's
// update: pos [p] = -1 but pos[ws[k]] = k, bits [ceil(p / 32)] its bitmap
// (two memsets and a mark launch)
int csc_slot_map(const long long* ws, int* pos, unsigned* bits, int p, int K, void* stream) {
  if (p <= 0 || K < 1 || K > p) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(pos, 0xff, (size_t)p * sizeof(int), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(bits, 0, (size_t)((p + 31) / 32) * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  slot_mark_kernel<<<(unsigned)((K + 255) / 256), 256, 0, st>>>(ws, pos, bits, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
