// Thread-block clusters and mbarriers on the H100: the device and launch
// helpers of the cluster kernels (cd_epoch.cu: K1, K2, K1b), kept apart
// from any one kernel so that the next cluster kernel includes them rather
// than copying them.
//
// Device side: the hardware cluster barrier (arrive.release /
// wait.acquire), cp.async of one value, mbarriers (init, remote arrive
// with release at cluster scope, parity wait with acquire at cluster
// scope).
//
// Host side: the launch configuration of one C-CTA cluster, the card's
// answer to how many such clusters it can place at once
// (cudaOccupancyMaxActiveClusters), and the launch of one cluster, which
// refuses, with kErrClusterUnplaceable, a cluster that no GPC of the card
// can place: never another shape instead (the plans in kernels/cd_epoch.py
// step down beforehand).
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace {

// returned when no GPC of the card can place the cluster
constexpr int kErrClusterUnplaceable = -1;

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// arrive, with release at cluster scope, on the mbarrier `b` of cluster
// rank `rank` (b is the address of the same barrier in this CTA)
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* b, unsigned rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(b)),
      "r"(rank)
      : "memory");
}

// wait, with acquire at cluster scope, until the phase of parity `par` of
// this CTA's mbarrier `b` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned par) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(par)
        : "memory");
}

// The launch configuration of `lanes` clusters of C CTAs (grid = (C,
// lanes), cluster = C: the lane is blockIdx.y) of `kernel`, with `dyn` bytes
// of dynamic shared memory a CTA; `attr` holds the cluster attribute the
// configuration points to.
template <typename... ExpTypes>
cudaError_t cluster_config(void (*kernel)(ExpTypes...), int C, int threads, size_t dyn,
                           void* stream, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int lanes = 1) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dyn);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = dim3(C, lanes, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = dyn;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C CTAs of `kernel` the card can place at once.
template <typename... ExpTypes>
int cluster_capacity_of(void (*kernel)(ExpTypes...), int C, int threads, int dyn, int* active) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, threads, (size_t)dyn, nullptr, &cfg, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active, (void*)kernel, &cfg);
  return (int)err;
}

// Launch `kernel` as `lanes` clusters of C CTAs (grid = (C, lanes), cluster
// = C) through cudaLaunchKernelEx. Refuses, with kErrClusterUnplaceable, a
// cluster that no GPC of the card can place with this shared memory per
// CTA; never falls back to another shape (the plans step down beforehand:
// cluster_capacity).
template <typename... ExpTypes, typename... ActTypes>
int launch_cluster(void (*kernel)(ExpTypes...), int C, int threads, size_t dyn, void* stream,
                   int lanes, ActTypes&&... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, threads, dyn, stream, &cfg, &attr, lanes);
  if (err != cudaSuccess) return (int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, (void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return kErrClusterUnplaceable;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<ActTypes>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
