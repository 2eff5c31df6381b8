// Distributed shared memory of a thread block cluster (sm_90): this block's
// rank, the cluster address of a word in another block's shared memory, a
// load from such an address, the barrier of the whole cluster, the launch
// configuration of clusters of 2, 4 or 8 blocks, and the register NTT's
// exchange between groups 0 and 1 when a polynomial spans P = 2 or 4
// blocks.
//
// The kernels that run one ciphertext on a cluster (blind_rotate_rns.cu at
// N = 4096, 8192 and 16384, blind_rotate64.cu at N = 4096 and 8192,
// blind_rotate.cu at N = 8192) read
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
// `blocks` blocks (2, 4 or 8; 8 is the portable maximum) along x, each block `threads` threads with `smem`
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

// A polynomial of N = 4096 P words over P = 2 or 4 blocks of 512 threads
// (N = 8192 or 16384, LOGN = 12 + log2 P index bits): logical thread
// t = part * 512 + threadIdx.x, so `part`, thread bits 9 .. 8 + log2 P, is
// bits 9 .. 8 + log2 P of j in the register NTT's group 0 (C = LOGN - 1,
// j = t | k << (C - 2)) and the top log2 P bits of j in groups 1 and after
// (register_ntt.cuh). Only the exchange between groups 0 and 1 crosses the
// blocks; the others run in the block's part of a buffer (S = 4096 words a
// polynomial, the top bits dropped). A polynomial of 64-bit words
// (blind_rotate64.cu) crosses as two u32 polynomials, its low and high
// planes 4096 words apart (register_ntt64.cuh's split and join).

// log2 P: the rank bits of a polynomial over P = 2 or 4 blocks.
template <int P>
constexpr int kRankBits = P == 4 ? 2 : 1;

// The word of j (swizzled or not) in its owner's part when the owner is
// bits 9 .. 8 + log2 P of j: those bits dropped. The swizzle writes bits
// 0..4 only, so the dropped bits are j's own and the word keeps its bank.
template <int P>
__device__ __forceinline__ int drop_rank(int j) {
  return ((j >> (9 + kRankBits<P>)) << 9) | (j & 511);
}

// The exchange from group 0 (C0 = 11 + log2 P: j = t | k << (C0 - 2), bits
// 9 .. 8 + log2 P = part) to group 1 (C1 = C0 - 3: j = tpart<C1>(t) |
// k << (C1 - 2), the top bits = part) of NP polynomials. Each thread stores
// its group-0 values in its block's buffer `mine` ([NP][4096]) at
// drop_rank<P>(swz(j)); after the cluster barrier it reads group 1's,
// register k from block k >> (3 - log2 P) of the polynomial (j's bits
// 9 .. 8 + log2 P are k's top log2 P bits at C1), at cluster addresses
// `at[part]` of the same buffer in the P blocks.
template <int NP, int P>
__device__ __forceinline__ void cross_forward(uint32_t (&x)[NP][8], uint32_t* __restrict__ mine,
                                              const uint32_t (&at)[P], int t) {
  constexpr int H = 4096;  // words a polynomial in a block's part
  constexpr int LP = kRankBits<P>;
  constexpr int C0 = 11 + LP, C1 = C0 - 3;
  const int wa = rntt::swz(t);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) mine[p * H + drop_rank<P>(wa ^ rntt::swz(k << (C0 - 2)))] = x[p][k];
  cluster_sync();
  const int ra = rntt::swz(rntt::tpart<C1>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[p][k] = ld_peer(at[k >> (3 - LP)] +
                        4 * (p * H + drop_rank<P>(ra ^ rntt::swz(k << (C1 - 2)))));
}

// The inverse's exchange from group 1 to group 0: group 1's values go to
// the block's buffer at swz(j) with its top log2 P bits dropped, the words
// its own 2 -> 1 exchange read; after the cluster barrier group 0's
// register k comes from block k >> (3 - log2 P) (j's top bits are k's top
// bits at C0).
template <int NP, int P>
__device__ __forceinline__ void cross_inverse(uint32_t (&x)[NP][8], uint32_t* __restrict__ mine,
                                              const uint32_t (&at)[P], int t) {
  constexpr int H = 4096;
  constexpr int LP = kRankBits<P>;
  constexpr int C0 = 11 + LP, C1 = C0 - 3;
  __syncwarp();  // the warp's reads of these words in the 2 -> 1 exchange are done
  const int wa = rntt::swz(rntt::tpart<C1>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) mine[p * H + ((wa ^ rntt::swz(k << (C1 - 2))) & (H - 1))] = x[p][k];
  cluster_sync();
  const int ra = rntt::swz(t);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      x[p][k] = ld_peer(at[k >> (3 - LP)] + 4 * (p * H + ((ra ^ rntt::swz(k << (C0 - 2))) & (H - 1))));
}

}  // namespace dsmem
