// Distributed shared memory of a thread block cluster (sm_90): this block's
// rank, the cluster address of a word in another block's shared memory, a
// load from such an address, and the barrier of the whole cluster.
//
// The kernels that run one ciphertext on a cluster of two blocks
// (blind_rotate_rns.cu and blind_rotate64.cu at N = 4096) read the peer
// block's buffers through these: `peer_address` maps a pointer into this
// block's shared memory to the same word in block `rank`'s, `ld_peer` reads
// it (ld.shared::cluster), and `cluster_sync` (barrier.cluster arrive.release
// / wait.acquire) makes the shared-memory writes of every block before it
// visible to every block after it. A block must not leave while its peer may
// still read its shared memory, so such a kernel ends with a cluster barrier.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dsmem {

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return int(r);
}

__device__ __forceinline__ uint32_t peer_address(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint32_t ld_peer(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The launch configuration (cudaLaunchKernelEx) of `clusters` clusters of
// two blocks along x, each block `threads` threads with `smem` bytes of
// dynamic shared memory. cfg points into the object: use it in place.
struct PairLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  PairLaunch(int clusters, int threads, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(2 * clusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  PairLaunch(const PairLaunch&) = delete;
  PairLaunch& operator=(const PairLaunch&) = delete;
};

}  // namespace dsmem
