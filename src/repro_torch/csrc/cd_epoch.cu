// K1 and K2: cyclic coordinate-descent epochs on the working set.
//
// K1 (cd_gram_kernel) replaces repro/kernels/cd_epoch.py:cd_epoch_gram_pallas
// (body _cd_gram_kernel): `epochs` cyclic passes over a K-coordinate Gram
// subproblem. For each j: g = q_j - c_j, beta_j <- prox(beta_j - g/L_j,
// 1/L_j) (unchanged where L_j = 0), then q += delta * G[:, j].
//
// K1b (cd_gram_block_kernel) is K1 on multitask blocks: beta, q and c are
// [K, T] (row-major), the penalty is BlockL1 or BlockMCP. For each j:
// g = q_j - c_j (a T-row), beta_j <- block prox of beta_j - g/L_j (its norm
// is a reduction over T), unchanged where L_j = 0, then q += G[:, j] (x)
// delta_j. The TPU has no kernel for it: the reference runs its jax epoch
// (repro/core/cd.py:cd_epoch_gram with beta [K, T]) there.
//
// K2 (cd_xb_kernel) replaces cd_epoch_xb_pallas (body _cd_xb_kernel): the
// same epochs on the residual state Xb [n]. g_j = x_j . raw(Xb) + off_j
// with the raw gradient of the datafit kind (quadratic, logistic, svc, with
// optional sample weights), then Xb += delta * x_j.
//
// What bounds them on the H100: the chain of dependent coordinate steps,
// not bytes or operations. Coordinate j+1 reads the state that coordinate j
// wrote, so an epoch is K serial steps, each a barrier-separated prox
// (one thread) and an O(K) or O(n) vector update. The byte bound (G or X_ws
// read once) is far below that latency chain.
//
// Design: one CTA keeps the whole state on chip for all epochs of a launch,
// as the TPU kernel keeps it in VMEM. K1 holds beta and q in shared memory
// while 2*K values fit (K <= ~12k in f64), else works in global memory with
// the same loop (L2-resident). G is read through explicit strides, so the
// caller can pass it column-major and the column j reads are coalesced. K2
// holds Xb, y (and w) in shared memory while they fit, else in global
// memory (L2-resident at n = 10k); each coordinate is one block reduction
// of x_j . raw over n, a prox on one thread, and an axpy. Coordinates whose
// delta is 0 skip the axpy. Splitting K2's n axis over a thread-block
// cluster (DSMEM) or a grid-wide sync is later work. K1b keeps q [K, T] in
// shared memory while K * T values fit (K = 1024 at T = 20 is 160 KB),
// else in global memory, and beta in global memory (one row is touched per
// coordinate). Per coordinate, warp 0 computes the row prox (lanes over the
// tasks, the norm by a fixed shuffle tree) and writes delta_j to shared
// memory; then every thread walks its share of the flat [K, T] update, so
// neighbouring threads touch neighbouring q entries.
//
// Built with -fmad=false: every multiply and add rounds on its own, as the
// plain torch versions do, so the Gram axpy matches them exactly.
#include <cuda_runtime.h>

#include "prox.cuh"

namespace {

constexpr int kMaxSmem = 225 * 1024;

template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    for (int i = 0; i < nw; ++i) s += red[i];
  }
  return s;  // valid on thread 0 only
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
                                     T p1, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_nz;
  T* s_delta = reinterpret_cast<T*>(smem_raw);  // [nt]
  T* q = use_smem ? s_delta + nt : q_out;       // [K, nt]
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
  if (use_smem) {
    for (int k = threadIdx.x; k < KT; k += blockDim.x) q_out[k] = q[k];
  }
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

template <typename T>
__global__ void cd_xb_kernel(const T* __restrict__ Xt, const T* __restrict__ y_in,
                             const T* __restrict__ w_in, const T* __restrict__ L,
                             const T* __restrict__ off, const T* __restrict__ beta0,
                             const T* __restrict__ Xb0, T* beta, T* Xb_out, int K, int n,
                             int epochs, int kind, int pen, T p0, T p1, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  __shared__ T s_delta;
  T* xb = Xb_out;
  const T* y = y_in;
  const T* w = w_in;
  if (use_smem) {
    T* s = reinterpret_cast<T*>(smem_raw);
    xb = s;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[n + i] = y_in[i];
    y = s + n;
    if (w_in) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) s[2 * n + i] = w_in[i];
      w = s + 2 * n;
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) xb[i] = Xb0[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) beta[i] = beta0[i];
  __syncthreads();
  const T nn = T(n);
  for (int e = 0; e < epochs; ++e) {
    for (int j = 0; j < K; ++j) {
      const T* x = Xt + (long long)j * n;
      T acc = T(0);
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        acc = acc + x[i] * raw_grad(kind, xb[i], y[i], w, i, nn);
      const T gsum = block_sum(acc, red);
      if (threadIdx.x == 0) {
        const T bj = beta[j];
        const T nw = rt::coord_step(pen, bj, gsum + off[j], L[j], p0, p1);
        s_delta = nw - bj;
        beta[j] = nw;
      }
      __syncthreads();
      const T d = s_delta;
      if (d != T(0)) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) xb[i] = xb[i] + x[i] * d;
      }
      __syncthreads();
    }
  }
  if (use_smem) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) Xb_out[i] = xb[i];
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

template <typename T>
int launch_gram_block(const T* G, long long sr, long long sc, const T* c, const T* L,
                      const T* beta0, const T* q0, T* beta, T* q, int K, int nt, int epochs,
                      int pen, double p0, double p1, void* stream) {
  if (K <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const size_t delta = (size_t)nt * sizeof(T);
  const size_t state = (size_t)K * nt * sizeof(T);
  const int use_smem = delta + state <= (size_t)kMaxSmem;
  const size_t dyn = use_smem ? delta + state : delta;
  cudaFuncSetAttribute(cd_gram_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dyn);
  cd_gram_block_kernel<T><<<1, threads_for(K * nt), dyn, (cudaStream_t)stream>>>(
      G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, (T)p0, (T)p1, use_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_xb(const T* Xt, const T* y, const T* w, const T* L, const T* off, const T* beta0,
              const T* Xb0, T* beta, T* Xb, int K, int n, int epochs, int kind, int pen,
              double p0, double p1, void* stream) {
  const size_t bytes = (size_t)n * sizeof(T) * (w ? 3 : 2);
  const int use_smem = bytes <= (size_t)kMaxSmem;
  const size_t dyn = use_smem ? bytes : 0;
  cudaFuncSetAttribute(cd_xb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  cd_xb_kernel<T><<<1, 1024, dyn, (cudaStream_t)stream>>>(
      Xt, y, w, L, off, beta0, Xb0, beta, Xb, K, n, epochs, kind, pen, (T)p0, (T)p1, use_smem);
  return (int)cudaGetLastError();
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
                            double p0, double p1, void* stream) {
  return launch_gram_block<double>(G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, p0,
                                   p1, stream);
}

int cd_epoch_gram_block_f32(const float* G, long long sr, long long sc, const float* c,
                            const float* L, const float* beta0, const float* q0, float* beta,
                            float* q, int K, int nt, int epochs, int pen, double p0, double p1,
                            void* stream) {
  return launch_gram_block<float>(G, sr, sc, c, L, beta0, q0, beta, q, K, nt, epochs, pen, p0,
                                  p1, stream);
}

int cd_epoch_xb_f64(const double* Xt, const double* y, const double* w, const double* L,
                    const double* off, const double* beta0, const double* Xb0, double* beta,
                    double* Xb, int K, int n, int epochs, int kind, int pen, double p0,
                    double p1, void* stream) {
  return launch_xb<double>(Xt, y, w, L, off, beta0, Xb0, beta, Xb, K, n, epochs, kind, pen, p0,
                           p1, stream);
}

int cd_epoch_xb_f32(const float* Xt, const float* y, const float* w, const float* L,
                    const float* off, const float* beta0, const float* Xb0, float* beta,
                    float* Xb, int K, int n, int epochs, int kind, int pen, double p0,
                    double p1, void* stream) {
  return launch_xb<float>(Xt, y, w, L, off, beta0, Xb0, beta, Xb, K, n, epochs, kind, pen, p0,
                          p1, stream);
}

}  // extern "C"
