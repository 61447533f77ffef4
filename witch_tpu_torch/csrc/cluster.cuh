// Thread-block clusters (sm_90): the helpers of the kernels whose pair
// spans C CTAs on neighbouring SMs (oa.cu's oa_cluster instance,
// flank.cu's flank_cluster instance) and the barrier probe (cluster.cu).
//
// A pair's warps meet through distributed shared memory (DSMEM): each
// warp pushes its exchange record into the same offset of every CTA's
// shared memory of the cluster (lane r < C stores the copy of rank r),
// then the whole cluster crosses one barrier (barrier.cluster.arrive,
// release semantics, and barrier.cluster.wait, acquire), after which
// every CTA reads all records from its own shared memory. Reads are
// therefore local; only the stores cross SMs.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// the CTA's rank in its cluster
static __device__ __forceinline__ int cluster_rank() {
    return (int)cg::this_cluster().block_rank();
}

// every thread of every CTA of the cluster; release before, acquire after
static __device__ __forceinline__ void cluster_meet() { cg::this_cluster().sync(); }

// Lane `src`'s value v into local offset `at` of every CTA of the
// cluster (C of them). Called by all 32 lanes of the warp.
template <class T>
static __device__ __forceinline__ void put_all(T *at, T v, int src, int C) {
    const T x = __shfl_sync(0xffffffffu, v, src);
    const int lane = threadIdx.x & 31;
    if (lane < C) *cg::this_cluster().map_shared_rank(at, (unsigned)lane) = x;
}

// A value every lane already holds (warp-uniform), into every CTA.
template <class T>
static __device__ __forceinline__ void put_all_uniform(T *at, T v, int C) {
    const int lane = threadIdx.x & 31;
    if (lane < C) *cg::this_cluster().map_shared_rank(at, (unsigned)lane) = v;
}

// Launch `kernel` over `nclusters` clusters of C CTAs of `threads`
// threads with `smem` bytes of dynamic shared memory each; refused
// (an error code, nothing launched) when no cluster of that shape can
// be resident at once.
template <class... Params, class... Args>
static cudaError_t launch_cluster(void (*kernel)(Params...), int nclusters, int C,
                                  int threads, size_t smem, cudaStream_t st,
                                  Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(nclusters * C), 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (active < 1) return cudaErrorInvalidClusterSize;   // none co-resident
    if (nclusters < 1) return cudaSuccess;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// How many clusters of C CTAs of this kernel's shape the card holds at
// once (cudaOccupancyMaxActiveClusters), or a negative error code.
template <class... Params>
static int max_active_clusters(void (*kernel)(Params...), int C, int threads,
                               size_t smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    return err == cudaSuccess ? active : -(int)err;
}
