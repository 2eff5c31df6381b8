// Register-resident negacyclic NTT over one prime q < 2^28, merged twiddles,
// for one group of N / 8 threads per polynomial (N = 2^LOGN, 256..16384).
//
// Forward: Cooley-Tukey stages with half-length N/2 .. 1 and the twiddle
// psi^brv(m) at index m + i (m = N / 2t blocks, i = the block), natural
// order in, the evaluation values out in the bit-reversed order of
// tfhe_tpu_torch/ops/ntt.py:forward. Inverse: Gentleman-Sande stages with
// half-length 1 .. N/2 and psi^-brv(m), N^-1 folded into the last stage:
// entry 0 of the inverse table holds N^-1 and entry 1 psi^-brv(1) N^-1. The
// stage of half-length 2^b reads entry (N | j) >> (b + 1) for the pair
// (j, j + 2^b). The tables are tfhe_tpu_torch/ops/ntt.py:merged_tables; the
// wrappers rotate_kernel._twiddles and rotate_rns_kernel._twiddles upload
// them with their 32-bit Shoup companions.
//
// Ownership. Each thread holds 8 coefficients of a polynomial in registers
// and runs three radix-2 stages on them, those of the bits C, C-1, C-2 of
// the index j: register k of thread t is
//   j = tpart<C>(t) | k << (C - 2),
// the three bits of k put into t's bits at C - 2. Group g runs the stages
// of bits top = LOGN - 1 - 3g down to C - 2 with C = max(top, 2); the last
// group (C = 2) owns 8 consecutive points, so a warp's evaluation values
// are 256 consecutive words of the key's layout. Between groups the values
// go through shared memory once. Only an exchange out of or into a group
// with C > 7 crosses warps and needs the block's barrier; the others stay
// inside a warp (__syncwarp): at N = 2048 the groups are C = 10, 7, 4, 2,
// three exchanges per transform, one of them block-wide; at N = 4096 they
// are C = 11, 8, 5, 2, and two of the three exchanges are block-wide. At
// N = 8192 they are C = 12, 9, 6, 3, 2: the 1024 threads of a polynomial
// are two blocks of a cluster (csrc/blind_rotate.cu, blind_rotate_rns.cu),
// thread bit 9 the block's rank, which is bit 9 of j in group 0 and bit 12
// in the others, so only the exchange between groups 0 and 1 crosses
// blocks; the others run in the block's half of the buffer (`S` = N/2
// words a polynomial, bit 12 dropped). At N = 16384 they are C = 13, 10,
// 7, 4, 2: the 2048 threads of a residue lane are four blocks
// (blind_rotate_rns.cu), thread bits 9-10 the block's rank, bits 9-10 of j
// in group 0 and bits 12-13 in the others; again only the 0 <-> 1 exchange
// crosses blocks (cluster.cuh), the others run in the block's quarter
// (`S` = N/4, bits 12-13 dropped).
//
// Shared memory holds a polynomial at word swz(j), an XOR swizzle of the
// bits 5..10 of j into the bank bits that makes every group's reads and
// writes free of bank conflicts at all seven ring sizes: bits 11 to 13 are
// register bits of group 0 and thread bits above a warp's of the others,
// constant across a warp's access in every group, so they need no term;
// the swizzle writes bits 0..4 only, so dropping any of the bits 9 to 13
// from a word (a block's part of a buffer) keeps its bank.
//
// Lazy ranges: the forward takes values < 4q and returns values < 4q
// (Harvey's butterfly); the inverse takes values < 2q and returns values
// < 2q. The products are lazy Shoup products (three 32-bit multiplies).

#pragma once

#include <cstdint>

namespace rntt {

__device__ __forceinline__ uint32_t mulmod_lazy(uint32_t a, uint32_t w,
                                                uint32_t w_sh, uint32_t q) {
  // (a * w mod q) + {0, q} for any a < 2^32, w < q, w_sh = floor(w 2^32 / q)
  return a * w - __umulhi(a, w_sh) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t c) {
  return min(x, x - c);  // x - c wraps above x when x < c (c <= 2^31)
}

// A coherent global load: unlike ld.global.nc (__ldg), the compiler may not
// move it above a barrier, so each group's twiddles are loaded where the
// group runs and not all at once ahead of the transform, which would not
// fit the registers.
__device__ __forceinline__ uint32_t ld_global(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 ld_global4(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Bank bits 2..4 from b0..b2, and bank bits 0..1 from b1..b2.
__host__ __device__ constexpr int pmask(int b) {
  return ((b << 2) & 28) ^ ((b >> 1) & 3);
}

// Word of index j: linear over GF(2), so swz(a ^ b) = swz(a) ^ swz(b).
__host__ __device__ constexpr int swz(int j) {
  return j ^ pmask((j >> 5) & 7) ^ pmask((j >> 8) & 7);
}

// The bits of j that thread t gives in the group with register bits C..C-2.
template <int C>
__device__ __forceinline__ int tpart(int t) {
  return ((t >> (C - 2)) << (C + 1)) | (t & ((1 << (C - 2)) - 1));
}

template <int LOGN, int G>
struct Group {
  static constexpr int top = LOGN - 1 - 3 * G;    // highest stage bit run
  static constexpr int C = top < 2 ? 2 : top;    // highest register bit
  static constexpr int lo = C - 2;               // lowest stage bit run
  static constexpr bool last = top <= 2;
};

// Forward stage of bit B on NP polynomials x[p][0..8) in group (C, top),
// then the group's lower stages.
template <int LOGN, int G, int B, int NP>
__device__ __forceinline__ void fwd_stages(uint32_t (&x)[NP][8], int base,
                                           const uint32_t* __restrict__ w,
                                           const uint32_t* __restrict__ ws,
                                           uint32_t q) {
  using Gr = Group<LOGN, G>;
  constexpr int r = B - Gr::lo;  // the stage's register bit
  const uint32_t two_q = 2 * q;
  // the registers above bit r pick the twiddle: 4 >> r of them per stage
#pragma unroll
  for (int hi = 0; hi < (4 >> r); ++hi) {
    const int idx = ((1 << LOGN) | base | (hi << (B + 1))) >> (B + 1);
    const uint32_t wv = ld_global(w + idx), wsv = ld_global(ws + idx);
#pragma unroll
    for (int lo = 0; lo < (1 << r); ++lo) {
      const int k = (hi << (r + 1)) | lo;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint32_t u = csub(x[p][k], two_q);
        const uint32_t v = mulmod_lazy(x[p][k | (1 << r)], wv, wsv, q);
        x[p][k] = u + v;
        x[p][k | (1 << r)] = u + two_q - v;
      }
    }
  }
  if constexpr (B > Gr::lo) fwd_stages<LOGN, G, B - 1, NP>(x, base, w, ws, q);
}

// Forward stages of group G.
template <int LOGN, int G, int NP>
__device__ __forceinline__ void fwd_pass(uint32_t (&x)[NP][8], int t,
                                         const uint32_t* __restrict__ w,
                                         const uint32_t* __restrict__ ws,
                                         uint32_t q) {
  fwd_stages<LOGN, G, Group<LOGN, G>::top, NP>(x, tpart<Group<LOGN, G>::C>(t), w, ws, q);
}

// Inverse stage of bit B in group (C, top), then the group's higher
// stages; the stage of bit LOGN - 1 multiplies both outputs by N^-1.
template <int LOGN, int G, int B, int NP>
__device__ __forceinline__ void inv_stages(uint32_t (&x)[NP][8], int base,
                                           const uint32_t* __restrict__ w,
                                           const uint32_t* __restrict__ ws,
                                           uint32_t q) {
  using Gr = Group<LOGN, G>;
  constexpr int r = B - Gr::lo;
  constexpr bool last = B == LOGN - 1;  // then idx = 1: psi^-brv(1) N^-1
  const uint32_t two_q = 2 * q;
#pragma unroll
  for (int hi = 0; hi < (4 >> r); ++hi) {
    const int idx = ((1 << LOGN) | base | (hi << (B + 1))) >> (B + 1);
    const uint32_t wv = ld_global(w + idx), wsv = ld_global(ws + idx);
    const uint32_t n_inv = last ? ld_global(w) : 0u;
    const uint32_t n_inv_sh = last ? ld_global(ws) : 0u;
#pragma unroll
    for (int lo = 0; lo < (1 << r); ++lo) {
      const int k = (hi << (r + 1)) | lo;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint32_t u = x[p][k], v = x[p][k | (1 << r)];
        x[p][k] = last ? mulmod_lazy(u + v, n_inv, n_inv_sh, q) : csub(u + v, two_q);
        x[p][k | (1 << r)] = mulmod_lazy(u + two_q - v, wv, wsv, q);
      }
    }
  }
  if constexpr (B < Gr::top) inv_stages<LOGN, G, B + 1, NP>(x, base, w, ws, q);
}

// Inverse stages of group G.
template <int LOGN, int G, int NP>
__device__ __forceinline__ void inv_pass(uint32_t (&x)[NP][8], int t,
                                         const uint32_t* __restrict__ w,
                                         const uint32_t* __restrict__ ws,
                                         uint32_t q) {
  inv_stages<LOGN, G, Group<LOGN, G>::lo, NP>(x, tpart<Group<LOGN, G>::C>(t), w, ws, q);
}

// The word of swizzled index s in a buffer of S words a polynomial: s
// itself, or s with its bits from log2(S) up dropped (a block's part of the
// buffer at N = 8192 or 16384, where those bits are the block's rank in
// groups 1 and after).
template <int LOGN, int S>
__device__ __forceinline__ int word(int s) {
  if constexpr (S == (1 << LOGN))
    return s;
  else
    return s & (S - 1);
}

// Registers of group GF -> shared (NP polynomials of S words at buf) ->
// registers of group GT. Block-wide when either group has C > 7.
template <int LOGN, int GF, int GT, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void exchange(uint32_t (&x)[NP][8],
                                         uint32_t* __restrict__ buf, int t) {
  constexpr int CF = Group<LOGN, GF>::C, CT = Group<LOGN, GT>::C;
  __syncwarp();  // the warp's earlier reads of its words are done
  const int wa = swz(tpart<CF>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      buf[p * S + word<LOGN, S>(wa ^ swz(k << (CF - 2)))] = x[p][k];
  if constexpr (CF > 7 || CT > 7)
    __syncthreads();
  else
    __syncwarp();
  const int ra = swz(tpart<CT>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) x[p][k] = buf[p * S + word<LOGN, S>(ra ^ swz(k << (CT - 2)))];
}

// Forward NTT from group G on: natural order in group 0's registers
// (register k of thread t is coefficient t + k N/8), evaluation values out
// in the last group's (point 8t + k). The exchanges go through S words a
// polynomial.
template <int LOGN, int G, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void forward(uint32_t (&x)[NP][8],
                                        uint32_t* __restrict__ buf, int t,
                                        const uint32_t* __restrict__ w,
                                        const uint32_t* __restrict__ ws,
                                        uint32_t q) {
  fwd_pass<LOGN, G, NP>(x, t, w, ws, q);
  if constexpr (!Group<LOGN, G>::last) {
    exchange<LOGN, G, G + 1, NP, S>(x, buf, t);
    forward<LOGN, G + 1, NP, S>(x, buf, t, w, ws, q);
  }
}

// The number of register groups of a transform.
template <int LOGN>
__host__ __device__ constexpr int groups() {
  return (LOGN + 2) / 3;
}

// Inverse NTT from group G down to group END: evaluation values in the
// last group's registers, coefficients out in group 0's when END = 0. The
// exchanges go through S words a polynomial.
template <int LOGN, int G, int NP, int S = (1 << LOGN), int END = 0>
__device__ __forceinline__ void inverse(uint32_t (&x)[NP][8],
                                        uint32_t* __restrict__ buf, int t,
                                        const uint32_t* __restrict__ w,
                                        const uint32_t* __restrict__ ws,
                                        uint32_t q) {
  inv_pass<LOGN, G, NP>(x, t, w, ws, q);
  if constexpr (G > END) {
    exchange<LOGN, G, G - 1, NP, S>(x, buf, t);
    inverse<LOGN, G - 1, NP, S, END>(x, buf, t, w, ws, q);
  }
}

}  // namespace rntt
