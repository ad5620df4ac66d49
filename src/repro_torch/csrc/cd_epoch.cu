// K1 and K2: cyclic coordinate-descent epochs on the working set.
//
// K1 (cd_gram_kernel) replaces repro/kernels/cd_epoch.py:cd_epoch_gram_pallas
// (body _cd_gram_kernel): `epochs` cyclic passes over a K-coordinate Gram
// subproblem. For each j: g = q_j - c_j, beta_j <- prox(beta_j - g/L_j,
// 1/L_j) (unchanged where L_j = 0), then q += delta * G[:, j].
//
// K1b (cd_gram_block_kernel, cd_gram_block_cluster_kernel) is K1 on
// multitask blocks: beta, q and c are [K, T] (row-major), the penalty is
// BlockL1 or BlockMCP. For each j: g = q_j - c_j (a T-row), beta_j <- block
// prox of beta_j - g/L_j (its norm is a reduction over T), unchanged where
// L_j = 0, then q += G[:, j] (x) delta_j. The TPU has no kernel for it: the
// reference runs its jax epoch (repro/core/cd.py:cd_epoch_gram with beta
// [K, T]) there.
//
// K2 (cd_xb_cluster_kernel) replaces cd_epoch_xb_pallas (body
// _cd_xb_kernel): the same epochs on the residual state Xb [n].
// g_j = x_j . raw(Xb) + off_j with the raw gradient of the datafit kind
// (quadratic, logistic, svc, with optional sample weights), then
// Xb += delta * x_j.
//
// What bounds them on the H100: the chain of dependent coordinate steps,
// not bytes or operations. Coordinate j+1 reads the state that coordinate j
// wrote, so an epoch is K serial steps, each a barrier-separated prox and
// an O(K) or O(n) vector update. The byte bound (G or X_ws read once) is
// far below that latency chain; what one step costs is set by how many SMs
// share its vector work and how far its state is from them.
//
// Single-CTA design (K1, and K1b at the small shapes where
// kernels/cd_epoch.py's plan keeps it): one CTA keeps the whole state on
// chip for all epochs of a launch, as the TPU kernel keeps it in VMEM. K1
// holds beta and q in shared memory while they fit (K <= ~12k in f64), else
// works in global memory with the same loop. K1b holds q in shared memory;
// warp 0 computes the row prox (lanes over the tasks, the norm by a fixed
// shuffle tree) and every thread walks its share of the flat [K, T] update,
// neighbouring threads on neighbouring q entries.
//
// Cluster design (K2 always, K1b past the plan's single-CTA shapes): one
// launch is one thread-block cluster of C CTAs on one GPC. CTA r owns the
// ragged slice [r*N/C, (r+1)*N/C) of the state (N = n samples for K2, K rows
// of q for K1b) and keeps it in its own shared memory for all epochs (in
// global memory, still C-way split, past the shared-memory capacity). The
// CTAs agree on each coordinate's step through distributed shared memory
// behind ONE hardware cluster barrier per coordinate (arrive.release +
// wait.acquire), with parity double-buffered slots: a CTA rewrites slot
// j & 1 only at coordinate j + 2, after barrier j + 1, which every CTA
// reaches only after reading the slots of j.
//   K2: each CTA reduces x_j[slice] . raw[slice] (raw kept per sample and
//   recomputed only where Xb moved, so coordinates with delta = 0 cost no
//   exp), publishes its partial, and after the barrier warp 0 of EVERY CTA
//   reads the C partials in rank order 0..C-1 and runs the same coordinate
//   step, so all CTAs hold the same delta bit for bit; each updates its own
//   slice. Each CTA keeps its own copy of beta (rank 0's is the output), so
//   no CTA reads another's beta. While the barrier completes, each thread
//   loads its samples of x_{j+1} into registers (the register path: 4
//   samples a thread) or, on longer slices, the CTA prefetches x_{j+1} into
//   L2; x_{j+2} is prefetched into L2, so the column read is off the chain.
//   K1b: the owner of row j runs the warp-0 row prox on its local q row and
//   publishes delta_j and a nonzero flag; after the barrier every CTA copies
//   delta_j from the owner and updates its own rows in the flat-walk order,
//   so q has no cross-CTA reduction and rounds exactly as on one CTA. On the
//   register path (8 entries a thread) each thread loads its entries'
//   G[:, j] values before the prox and the barrier; else it reads them in
//   the update.
// Every CTA reaches every barrier (the skips of the update sit inside the
// loop body), and a last cluster barrier keeps each CTA's shared memory
// alive until no other CTA can read it.
//
// The launch layout (cluster size, shared or global slices, dynamic shared
// bytes, threads, register path) is the wrapper's plan
// (kernels/cd_epoch.py: xb_plan, gram_block_plan); the launchers take it as
// given.
//
// Built with -fmad=false: every multiply and add rounds on its own, as the
// plain torch versions do, so the Gram axpy matches them exactly.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

// K1's dynamic shared memory budget (beyond it K1 works in global memory)
constexpr int kMaxSmem = 225 * 1024;
// returned when no GPC of the card can place the cluster
constexpr int kErrClusterUnplaceable = -1;

// the first index of rank r's slice of [0, total) split C ways (ragged)
__device__ __forceinline__ int split_lo(int total, int C, int r) {
  return (int)((long long)total * r / C);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];\n" ::"l"(p));
}

template <typename T>
__global__ void cd_gram_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                               const T* __restrict__ c, const T* __restrict__ L,
                               const T* __restrict__ beta0, const T* __restrict__ q0,
                               T* beta_out, T* q_out, int K, int epochs, int pen, T p0,
                               T p1, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_delta;
  T* beta = use_smem ? reinterpret_cast<T*>(smem_raw) : beta_out;
  T* q = use_smem ? reinterpret_cast<T*>(smem_raw) + K : q_out;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    beta[i] = beta0[i];
    q[i] = q0[i];
  }
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      if (threadIdx.x == 0) {
        const T bj = beta[j];
        const T nw = rt::coord_step(pen, bj, q[j] - c[j], L[j], p0, p1);
        s_delta = nw - bj;
        beta[j] = nw;
      }
      __syncthreads();
      const T d = s_delta;
      if (d != T(0)) {
        const T* col = G + (long long)j * s_col;
        for (int i = threadIdx.x; i < K; i += blockDim.x)
          q[i] = q[i] + col[(long long)i * s_row] * d;
      }
      __syncthreads();
    }
  }
  if (use_smem) {
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      beta_out[i] = beta[i];
      q_out[i] = q[i];
    }
  }
}

template <typename T>
__global__ void cd_gram_block_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                                     const T* __restrict__ c, const T* __restrict__ L,
                                     const T* __restrict__ beta0, const T* __restrict__ q0,
                                     T* beta, T* q_out, int K, int nt, int epochs, int pen, T p0,
                                     T p1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nz;
  T* s_delta = reinterpret_cast<T*>(smem_raw);  // [nt]
  T* q = s_delta + nt;                          // [K, nt]
  const int KT = K * nt;
  for (int e = threadIdx.x; e < KT; e += blockDim.x) {
    q[e] = q0[e];
    beta[e] = beta0[e];
  }
  // this thread's flat walk over [K, nt]: start (i, t), step (di, dt)
  const int i_start = threadIdx.x / nt, t_start = threadIdx.x % nt;
  const int di = blockDim.x / nt, dt = blockDim.x % nt;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      if (threadIdx.x < 32) {
        const T Lj = L[j];
        const T step = T(1.0) / rt::clamp_min(Lj, T(1e-30));
        T* bj = beta + (long long)j * nt;
        const T* qj = q + (long long)j * nt;
        const T* cj = c + (long long)j * nt;
        T part = T(0);
        for (int t = lane; t < nt; t += 32) {
          const T x = bj[t] - (qj[t] - cj[t]) * step;
          part = part + x * x;
        }
        for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
        const T nrm = sqrt(__shfl_sync(0xffffffffu, part, 0));
        const rt::BlockProx<T> bp = rt::block_prox(pen, nrm, step, p0, p1);
        int nz = 0;
        for (int t = lane; t < nt; t += 32) {
          const T b = bj[t];
          const T nw = (Lj > T(0)) ? bp.apply(b - (qj[t] - cj[t]) * step) : b;
          const T d = nw - b;
          s_delta[t] = d;
          bj[t] = nw;
          nz |= (d != T(0));
        }
        nz = __any_sync(0xffffffffu, nz);
        if (lane == 0) s_nz = nz;
      }
      __syncthreads();
      if (s_nz) {
        const T* col = G + (long long)j * s_col;
        int i = i_start, t = t_start;
        for (int k = threadIdx.x; k < KT; k += blockDim.x) {
          q[k] = q[k] + col[(long long)i * s_row] * s_delta[t];
          i += di;
          t += dt;
          if (t >= nt) {
            t -= nt;
            ++i;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int k = threadIdx.x; k < KT; k += blockDim.x) q_out[k] = q[k];
}

enum DatafitKind { KIND_QUADRATIC = 0, KIND_LOGISTIC = 1, KIND_SVC = 2 };

// the datafit's raw gradient at one sample, as repro_torch.core.datafits
template <typename T>
__device__ __forceinline__ T raw_grad(int kind, T xb, T y, const T* w, int i, T n) {
  if (kind == KIND_QUADRATIC) {
    const T d = xb - y;
    return (w ? d * w[i] : d) / n;
  }
  if (kind == KIND_LOGISTIC) {
    const T s = T(1.0) / (T(1.0) + exp(-((-y) * xb)));
    const T v = (-y) * s;
    return (w ? v * w[i] : v) / n;
  }
  return xb;  // svc
}

// sum over the block, the warp sums added by a fixed shuffle tree in warp 0
template <typename T>
__device__ T block_sum_tree(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid on thread 0 only
}

// values per thread that the register paths of the cluster kernels hold
// (K2's samples, K1b's q entries; the plan's `per`), and the largest CTA
// they run with (so that 85 registers a thread fit)
constexpr int kXbPer = 4;
constexpr int kGramPer = 8;
constexpr int kPerThreads = 768;

// K2 on a cluster. With PER > 0 every thread owns samples tid + k * bd
// (k < PER) of its CTA's slice and keeps their x_j values in registers: it
// loads x_{j+1}'s while the cluster barrier of j completes and reuses x_j's
// for the axpy. With PER = 0 (slices longer than PER * bd) the same steps
// read x_j from global memory twice. Dynamic shared memory holds the
// slices (Xb, raw, y, w: ceil(n / C) values each) on the shared branch and
// nothing on the global one.
template <typename T, int PER>
__global__ void __launch_bounds__(PER > 0 ? kPerThreads : 1024)
    cd_xb_cluster_kernel(const T* __restrict__ Xt, const T* __restrict__ y_in,
                         const T* __restrict__ w_in, const T* __restrict__ L,
                         const T* __restrict__ off, const T* __restrict__ beta0,
                         const T* __restrict__ Xb0, T* beta_out, T* Xb_out, T* scratch,
                         int K, int n, int epochs, int kind, int pen, T p0, T p1,
                         int use_smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lo = split_lo(n, C, rank), m = split_lo(n, C, rank + 1) - lo;
  const int tid = threadIdx.x, bd = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[2];  // this CTA's partial sum, by parity
  __shared__ T s_delta[1];
  __shared__ T red[32];
  // scratch: the beta copies of ranks 1..C-1 ([C-1, K]), then (global
  // branch) the raw gradient [n]
  T* beta = rank == 0 ? beta_out : scratch + (long long)(rank - 1) * K;
  T *xb, *raw;
  const T *y, *w = nullptr;
  if (use_smem) {
    T* a = reinterpret_cast<T*>(smem_raw);
    xb = a;
    raw = a + m;
    T* ys = a + 2 * m;
    for (int i = tid; i < m; i += bd) ys[i] = y_in[lo + i];
    y = ys;
    if (w_in) {
      T* ws = a + 3 * m;
      for (int i = tid; i < m; i += bd) ws[i] = w_in[lo + i];
      w = ws;
    }
    __syncthreads();
  } else {
    xb = Xb_out + lo;
    raw = scratch + (long long)(C - 1) * K + lo;
    y = y_in + lo;
    if (w_in) w = w_in + lo;
  }
  const T nn = T(n);
  for (int i = tid; i < m; i += bd) {
    const T v = Xb0[lo + i];
    xb[i] = v;
    raw[i] = raw_grad(kind, v, y[i], w, i, nn);
  }
  for (int i = tid; i < K; i += bd) beta[i] = beta0[i];
  constexpr int kLine = 128 / sizeof(T);
  T xc[PER > 0 ? PER : 1], xn[PER > 0 ? PER : 1];
  if constexpr (PER > 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * bd;
      xc[k] = i < m ? Xt[lo + i] : T(0);
    }
  }
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      const T* x = Xt + (long long)j * n + lo;
      T acc = T(0);
      if constexpr (PER > 0) {
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int i = tid + k * bd;
          if (i < m) acc = acc + xc[k] * raw[i];
        }
      } else {
        for (int i = tid; i < m; i += bd) acc = acc + x[i] * raw[i];
      }
      const T gsum = block_sum_tree(acc, red);
      const int par = j & 1;
      T bj = T(0), gj_off = T(0), Lj = T(0);
      if (tid == 0) {
        part[par] = gsum;
        bj = beta[j];
        gj_off = off[j];
        Lj = L[j];
      }
      cluster_arrive_release();
      // while the cluster gathers: x_{j+1}'s values into registers (or L2),
      // x_{j+2}'s slice into L2
      const long long step = (long long)e * K + j;
      const long long last = (long long)epochs * K;
      if (step + 1 < last) {
        const T* x1 = Xt + (long long)((j + 1) % K) * n + lo;
        if constexpr (PER > 0) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int i = tid + k * bd;
            xn[k] = i < m ? x1[i] : T(0);
          }
        } else {
          for (int i = tid * kLine; i < m; i += bd * kLine) prefetch_l2(x1 + i);
        }
      }
      if (PER > 0 && step + 2 < last) {
        const T* x2 = Xt + (long long)((j + 2) % K) * n + lo;
        for (int i = tid * kLine; i < m; i += bd * kLine) prefetch_l2(x2 + i);
      }
      cluster_wait_acquire();
      if (tid < 32) {
        // lane r fetches rank r's partial; the sum runs in rank order
        const T v = tid < C ? *cluster.map_shared_rank(part + par, tid) : T(0);
        T s = T(0);
        for (int r = 0; r < C; ++r) s = s + __shfl_sync(0xffffffffu, v, r);
        if (tid == 0) {
          const T nw = rt::coord_step(pen, bj, s + gj_off, Lj, p0, p1);
          s_delta[0] = nw - bj;
          beta[j] = nw;
        }
      }
      __syncthreads();
      const T d = s_delta[0];
      if constexpr (PER > 0) {
        if (d != T(0)) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int i = tid + k * bd;
            if (i < m) {
              const T v = xb[i] + xc[k] * d;
              xb[i] = v;
              raw[i] = raw_grad(kind, v, y[i], w, i, nn);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) xc[k] = xn[k];
      } else if (d != T(0)) {
        for (int i = tid; i < m; i += bd) {
          const T v = xb[i] + x[i] * d;
          xb[i] = v;
          raw[i] = raw_grad(kind, v, y[i], w, i, nn);
        }
      }
    }
  }
  if (use_smem) {
    for (int i = tid; i < m; i += bd) Xb_out[lo + i] = xb[i];
  }
  // no CTA leaves while another may still read its partial slots
  cluster_arrive_release();
  cluster_wait_acquire();
}

// K1b on a cluster. With PER > 0 every thread owns at most PER entries of
// its CTA's flat [rows, nt] walk and loads their G[:, j] values into
// registers before the owner's prox and the cluster barrier of j, so the
// column read overlaps them. With PER = 0 the update reads G after the
// barrier. Dynamic shared memory holds slot[2][nt + 1] (delta_j and the
// nonzero flag, by parity), the local copy s_delta[nt + 1] and, on the
// shared branch, the CTA's ceil(K / C) rows of q.
template <typename T, int PER>
__global__ void __launch_bounds__(PER > 0 ? kPerThreads : 1024)
    cd_gram_block_cluster_kernel(const T* __restrict__ G, long long s_row, long long s_col,
                                 const T* __restrict__ c, const T* __restrict__ L,
                                 const T* __restrict__ beta0, const T* __restrict__ q0,
                                 T* beta, T* q_out, int K, int nt, int epochs, int pen, T p0,
                                 T p1, int use_smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lo = split_lo(K, C, rank), rows = split_lo(K, C, rank + 1) - lo;
  const int tid = threadIdx.x, bd = blockDim.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slot = reinterpret_cast<T*>(smem_raw);  // [2][nt + 1]
  T* s_delta = slot + 2 * (nt + 1);          // [nt + 1]
  T* q = use_smem ? s_delta + (nt + 1) : q_out + (long long)lo * nt;
  const int MT = rows * nt;
  const long long base = (long long)lo * nt;
  for (int k = tid; k < MT; k += bd) {
    q[k] = q0[base + k];
    beta[base + k] = beta0[base + k];
  }
  // this thread's flat walk over the local [rows, nt]: start (i, t), step
  // (di, dt)
  const int i_start = tid / nt, t_start = tid % nt;
  const int di = bd / nt, dt = bd % nt;
  const int lane = tid & 31;
  T g[PER > 0 ? PER : 1];
  __syncthreads();
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      const T* col = G + (long long)j * s_col + (long long)lo * s_row;
      if constexpr (PER > 0) {
        int i = i_start, t = t_start;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          g[k] = tid + k * bd < MT ? col[(long long)i * s_row] : T(0);
          i += di;
          t += dt;
          if (t >= nt) {
            t -= nt;
            ++i;
          }
        }
      }
      // the rank whose slice holds row j
      const int owner = (int)(((long long)C * (j + 1) - 1) / K);
      const int par = j & 1;
      if (rank == owner && tid < 32) {
        T* out = slot + par * (nt + 1);
        const T Lj = L[j];
        const T step = T(1.0) / rt::clamp_min(Lj, T(1e-30));
        T* bj = beta + (long long)j * nt;
        const T* qj = q + (long long)(j - lo) * nt;
        const T* cj = c + (long long)j * nt;
        T part = T(0);
        for (int t = lane; t < nt; t += 32) {
          const T x = bj[t] - (qj[t] - cj[t]) * step;
          part = part + x * x;
        }
        for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o);
        const T nrm = sqrt(__shfl_sync(0xffffffffu, part, 0));
        const rt::BlockProx<T> bp = rt::block_prox(pen, nrm, step, p0, p1);
        int nz = 0;
        for (int t = lane; t < nt; t += 32) {
          const T b = bj[t];
          const T nw = (Lj > T(0)) ? bp.apply(b - (qj[t] - cj[t]) * step) : b;
          const T d = nw - b;
          out[t] = d;
          bj[t] = nw;
          nz |= (d != T(0));
        }
        nz = __any_sync(0xffffffffu, nz);
        if (lane == 0) out[nt] = nz ? T(1) : T(0);
      }
      cluster_arrive_release();
      cluster_wait_acquire();
      const T* src = cluster.map_shared_rank(slot + par * (nt + 1), owner);
      for (int t = tid; t <= nt; t += bd) s_delta[t] = src[t];
      __syncthreads();
      if (s_delta[nt] != T(0)) {
        int i = i_start, t = t_start;
        if constexpr (PER > 0) {
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int f = tid + k * bd;
            if (f < MT) q[f] = q[f] + g[k] * s_delta[t];
            i += di;
            t += dt;
            if (t >= nt) {
              t -= nt;
              ++i;
            }
          }
        } else {
          for (int k = tid; k < MT; k += bd) {
            q[k] = q[k] + col[(long long)i * s_row] * s_delta[t];
            i += di;
            t += dt;
            if (t >= nt) {
              t -= nt;
              ++i;
            }
          }
        }
      }
      // the next row's owner reads its q row after every thread's update
      // (s_delta is rewritten only after the next cluster barrier)
      const int jn = j + 1 < K ? j + 1 : 0;
      if (rank == (int)(((long long)C * (jn + 1) - 1) / K)) __syncthreads();
    }
  }
  if (use_smem) {
    for (int k = tid; k < MT; k += bd) q_out[base + k] = q[k];
  }
  // no CTA leaves while another may still read its delta slots
  cluster_arrive_release();
  cluster_wait_acquire();
}

// the chain floor: `iters` cluster barriers and nothing else
__global__ void cluster_barrier_loop_kernel(int iters) {
  for (int k = 0; k < iters; ++k) {
    cluster_arrive_release();
    cluster_wait_acquire();
  }
}

int threads_for(int m) {
  int t = ((m + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename T>
int launch_gram(const T* G, long long sr, long long sc, const T* c, const T* L, const T* beta0,
                const T* q0, T* beta, T* q, int K, int epochs, int pen, double p0, double p1,
                void* stream) {
  const size_t bytes = 2 * (size_t)K * sizeof(T);
  const int use_smem = bytes <= (size_t)kMaxSmem;
  const size_t dyn = use_smem ? bytes : 0;
  cudaFuncSetAttribute(cd_gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dyn);
  cd_gram_kernel<T><<<1, threads_for(K), dyn, (cudaStream_t)stream>>>(
      G, sr, sc, c, L, beta0, q0, beta, q, K, epochs, pen, (T)p0, (T)p1, use_smem);
  return (int)cudaGetLastError();
}

// Launch `kernel` as one cluster of C CTAs (grid = cluster = C) through
// cudaLaunchKernelEx. Refuses, with kErrClusterUnplaceable, a cluster that no
// GPC of the card can place with this shared memory per CTA; never falls
// back to another shape.
template <typename... ExpTypes, typename... ActTypes>
int launch_cluster(void (*kernel)(ExpTypes...), int C, int threads, size_t dyn, void* stream,
                   ActTypes&&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, (void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return kErrClusterUnplaceable;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<ActTypes>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K1b with the wrapper's plan (kernels/cd_epoch.py: gram_block_plan): one
// CTA (cluster == 1) or a cluster of `cluster` CTAs with q's rows in shared
// memory (use_smem) or global memory, `dyn` bytes of dynamic shared memory
// and the register path when per == kGramPer.
template <typename T>
int launch_gram_block(const T* G, long long sr, long long sc, const T* c, const T* L,
                      const T* beta0, const T* q0, T* beta, T* q, int K, int nt, int epochs,
                      int pen, double p0, double p1, int cluster, int use_smem, int dyn,
                      int threads, int per, void* stream) {
  if (cluster == 1) {
    cudaError_t err = cudaFuncSetAttribute(cd_gram_block_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    cd_gram_block_kernel<T><<<1, threads, dyn, (cudaStream_t)stream>>>(
        G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, (T)p0, (T)p1);
    return (int)cudaGetLastError();
  }
  if (per != 0 && per != kGramPer) return (int)cudaErrorInvalidValue;
  auto kernel = per ? cd_gram_block_cluster_kernel<T, kGramPer>
                    : cd_gram_block_cluster_kernel<T, 0>;
  return launch_cluster(kernel, cluster, threads, (size_t)dyn, stream, G, sr, sc, c, L, beta0,
                        q0, beta, q, K, nt, epochs, pen, (T)p0, (T)p1, use_smem);
}

// K2 with the wrapper's plan (kernels/cd_epoch.py: xb_plan): a cluster of
// `cluster` CTAs with the slices in shared memory (use_smem) or global
// memory, `dyn` bytes of dynamic shared memory and the register path when
// per == kXbPer. `scratch` holds (cluster - 1) * K values, plus n on the
// global branch.
template <typename T>
int launch_xb(const T* Xt, const T* y, const T* w, const T* L, const T* off, const T* beta0,
              const T* Xb0, T* beta, T* Xb, T* scratch, int K, int n, int epochs, int kind,
              int pen, double p0, double p1, int cluster, int use_smem, int dyn, int threads,
              int per, void* stream) {
  if (per != 0 && per != kXbPer) return (int)cudaErrorInvalidValue;
  auto kernel = per ? cd_xb_cluster_kernel<T, kXbPer> : cd_xb_cluster_kernel<T, 0>;
  return launch_cluster(kernel, cluster, threads, (size_t)dyn, stream, Xt, y, w, L, off, beta0,
                        Xb0, beta, Xb, scratch, K, n, epochs, kind, pen, (T)p0, (T)p1,
                        use_smem);
}

}  // namespace

extern "C" {

int cd_epoch_gram_f64(const double* G, long long sr, long long sc, const double* c,
                      const double* L, const double* beta0, const double* q0, double* beta,
                      double* q, int K, int epochs, int pen, double p0, double p1,
                      void* stream) {
  return launch_gram<double>(G, sr, sc, c, L, beta0, q0, beta, q, K, epochs, pen, p0, p1,
                             stream);
}

int cd_epoch_gram_f32(const float* G, long long sr, long long sc, const float* c,
                      const float* L, const float* beta0, const float* q0, float* beta,
                      float* q, int K, int epochs, int pen, double p0, double p1,
                      void* stream) {
  return launch_gram<float>(G, sr, sc, c, L, beta0, q0, beta, q, K, epochs, pen, p0, p1,
                            stream);
}

int cd_epoch_gram_block_f64(const double* G, long long sr, long long sc, const double* c,
                            const double* L, const double* beta0, const double* q0,
                            double* beta, double* q, int K, int nt, int epochs, int pen,
                            double p0, double p1, int cluster, int use_smem, int dyn,
                            int threads, int per, void* stream) {
  return launch_gram_block<double>(G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, p0,
                                   p1, cluster, use_smem, dyn, threads, per, stream);
}

int cd_epoch_gram_block_f32(const float* G, long long sr, long long sc, const float* c,
                            const float* L, const float* beta0, const float* q0, float* beta,
                            float* q, int K, int nt, int epochs, int pen, double p0, double p1,
                            int cluster, int use_smem, int dyn, int threads, int per,
                            void* stream) {
  return launch_gram_block<float>(G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, p0,
                                  p1, cluster, use_smem, dyn, threads, per, stream);
}

int cd_epoch_xb_f64(const double* Xt, const double* y, const double* w, const double* L,
                    const double* off, const double* beta0, const double* Xb0, double* beta,
                    double* Xb, double* scratch, int K, int n, int epochs, int kind, int pen,
                    double p0, double p1, int cluster, int use_smem, int dyn, int threads,
                    int per, void* stream) {
  return launch_xb<double>(Xt, y, w, L, off, beta0, Xb0, beta, Xb, scratch, K, n, epochs, kind,
                           pen, p0, p1, cluster, use_smem, dyn, threads, per, stream);
}

int cd_epoch_xb_f32(const float* Xt, const float* y, const float* w, const float* L,
                    const float* off, const float* beta0, const float* Xb0, float* beta,
                    float* Xb, float* scratch, int K, int n, int epochs, int kind, int pen,
                    double p0, double p1, int cluster, int use_smem, int dyn, int threads,
                    int per, void* stream) {
  return launch_xb<float>(Xt, y, w, L, off, beta0, Xb0, beta, Xb, scratch, K, n, epochs, kind,
                          pen, p0, p1, cluster, use_smem, dyn, threads, per, stream);
}

// `iters` cluster barriers on one cluster of C CTAs of `threads` threads:
// the chain floor of the cluster kernels
int cluster_barrier_loop(int cluster, int threads, int iters, void* stream) {
  return launch_cluster(cluster_barrier_loop_kernel, cluster, threads, 0, stream, iters);
}

}  // extern "C"
