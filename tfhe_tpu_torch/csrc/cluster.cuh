// Distributed shared memory of a thread block cluster (sm_90): this block's
// rank, the cluster address of a word in another block's shared memory, a
// load from such an address, the barrier of the whole cluster, the launch
// configuration of clusters of 2 or 4 blocks, and the register NTT's
// exchange between groups 0 and 1 when a polynomial spans two blocks.
//
// The kernels that run one ciphertext on a cluster (blind_rotate_rns.cu and
// blind_rotate64.cu at N = 4096 and 8192, blind_rotate.cu at N = 8192) read
// other blocks' buffers through these: `peer_address` maps a
// pointer into this block's shared memory to the same word in block
// `rank`'s, `ld_peer` reads it (ld.shared::cluster), and `cluster_sync`
// (barrier.cluster arrive.release / wait.acquire) makes the shared-memory
// writes of every block before it visible to every block after it. A block
// must not leave while another may still read its shared memory, so such a
// kernel ends with a cluster barrier.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "register_ntt.cuh"

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
// `blocks` blocks (2 or 4) along x, each block `threads` threads with `smem`
// bytes of dynamic shared memory. cfg points into the object: use it in place.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(int blocks, int clusters, int threads, size_t smem, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks * clusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// A polynomial of N = 8192 over two blocks of 512 threads: logical thread
// t = half * 512 + threadIdx.x, so `half`, thread bit 9, is bit 9 of j in
// the register NTT's group 0 and bit 12 in groups 1-4 (register_ntt.cuh).
// Only the exchange between groups 0 and 1 crosses the two blocks; the
// others run in the block's half of a buffer (S = 4096 words a polynomial).
// A polynomial of 64-bit words (blind_rotate64.cu) crosses as two u32
// polynomials, its low and high planes 4096 words apart
// (register_ntt64.cuh's split and join).

// The word of j (swizzled or not) in its owner's half when the owner is
// bit 9 of j: bit 9 dropped.
__device__ __forceinline__ int drop_bit9(int j) { return ((j >> 10) << 9) | (j & 511); }

// The exchange from group 0 (C = 12: j = t | k << 10, bit 9 = half) to
// group 1 (C = 9: j = tpart<9>(t) | k << 7, bit 12 = half) of NP
// polynomials. Each thread stores its group-0 values in its block's buffer
// `mine` ([NP][4096]) at drop_bit9(swz(j)); after the cluster barrier it
// reads group 1's, register k from half k / 4 (bit 9 of j is bit 2 of k),
// at cluster addresses `at[half]` of the same buffer in the two blocks.
template <int NP>
__device__ __forceinline__ void cross_forward(uint32_t (&x)[NP][8], uint32_t* __restrict__ mine,
                                              const uint32_t (&at)[2], int t) {
  constexpr int H = 4096;  // words a polynomial in a block's half
  const int wa = rntt::swz(t);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) mine[p * H + drop_bit9(wa ^ rntt::swz(k << 10))] = x[p][k];
  cluster_sync();
  const int ra = rntt::swz(rntt::tpart<9>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[p][k] = ld_peer(at[k >> 2] + 4 * (p * H + drop_bit9(ra ^ rntt::swz(k << 7))));
}

// The inverse's exchange from group 1 to group 0: group 1's values go to
// the block's buffer at swz(j) with bit 12 dropped, the words its own
// 2 -> 1 exchange read; after the cluster barrier group 0's register k
// comes from half k / 4 (bit 12 of j).
template <int NP>
__device__ __forceinline__ void cross_inverse(uint32_t (&x)[NP][8], uint32_t* __restrict__ mine,
                                              const uint32_t (&at)[2], int t) {
  constexpr int H = 4096;
  __syncwarp();  // the warp's reads of these words in the 2 -> 1 exchange are done
  const int wa = rntt::swz(rntt::tpart<9>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) mine[p * H + ((wa ^ rntt::swz(k << 7)) & (H - 1))] = x[p][k];
  cluster_sync();
  const int ra = rntt::swz(t);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[p][k] = ld_peer(at[k >> 2] + 4 * (p * H + ((ra ^ rntt::swz(k << 10)) & (H - 1))));
}

}  // namespace dsmem
