// Register-resident negacyclic NTT over one modulus q < 2^54 in 64-bit words,
// merged twiddles, for one group of N / 8 threads per polynomial (N = 2^LOGN,
// 256..8192): the 64-bit counterpart of register_ntt.cuh, whose index
// machinery (tpart, swz, Group, groups) it uses as it is, at 12 and 13 index
// bits too (groups of C = 11, 8, 5, 2 at N = 4096, two of the three exchanges
// block-wide; C = 12, 9, 6, 3, 2 at N = 8192, where the 1024 threads of a
// polynomial are two blocks of a cluster and only the exchange between
// groups 0 and 1 crosses them, cluster.cuh's cross_forward / cross_inverse).
//
// The transforms are register_ntt.cuh's: forward Cooley-Tukey stages with
// half-length N/2 .. 1 and the twiddle psi^brv(m) at index m + i, natural
// order in, bit-reversed evaluation order out (that of
// tfhe_tpu_torch/ops/ntt.py:forward); inverse Gentleman-Sande stages with
// psi^-brv(m), N^-1 folded into the last stage. Each thread holds 8
// coefficients of a polynomial and runs three radix-2 stages on them per
// register group; between groups the values go through shared memory once
// (`store`, then `load`), block-wide only where a group with C > 7 takes
// part.
//
// Words. A value is a u64; a lazy Shoup product a * w - hi64(a * w') * q lies
// in [0, 2q) for any a < 2^64 (w' = floor(w 2^64 / q)). The forward takes and
// returns values < 4q < 2^56 (Harvey's butterfly), the inverse values < 2q.
// The tables (tfhe_tpu_torch/ops/ntt.py:merged_tables with their 64-bit
// companions, uploaded by rotate64_kernel._twiddles) hold each entry beside
// its companion, [N][2] u64, so that one 16-byte load fetches both.
//
// Shared memory holds a polynomial as two u32 planes of S words, the low
// halves and then the high halves, each at word swz(j) (S = N), or at
// N = 8192 in a block's half of the buffer at swz(j) with bit 12 dropped
// (S = N/2: in groups 1-4 bit 12 of j is the block's half). Every access of
// a group is then the 32-bit kernels' access twice, free of bank conflicts
// by the same argument at every N up to 8192, the block's half at 8192
// included (tests/test_torch_ntt_merged.py,
// tests/test_torch_rotate64_merged.py; the high plane starts S words on, a
// multiple of the 32 banks). The same layout makes a u64 polynomial two
// u32 polynomials S words apart, low plane first, which is how the
// crossing of cluster.cuh moves it.

#pragma once

#include <cstdint>

#include "register_ntt.cuh"

namespace rntt64 {

typedef unsigned long long u64;

using rntt::Group;
using rntt::groups;
using rntt::swz;
using rntt::tpart;
using rntt::word;

__device__ __forceinline__ u64 mulmod_lazy(u64 a, u64 w, u64 w_sh, u64 q) {
  // (a * w mod q) + {0, q} for any a < 2^64, w < q, w_sh = floor(w 2^64 / q)
  return a * w - __umul64hi(a, w_sh) * q;
}

__device__ __forceinline__ u64 csub(u64 x, u64 c) {
  return min(x, x - c);  // x - c wraps above x when x < c
}

// A coherent 16-byte global load of two u64: unlike ld.global.nc it is not
// moved above a barrier (see rntt::ld_global).
__device__ __forceinline__ ulonglong2 ld_global2(const u64* p) {
  ulonglong2 v;
  asm volatile("ld.global.v2.u64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p));
  return v;
}

// Forward stage of bit B on NP polynomials x[p][0..8) in group (C, top),
// then the group's lower stages. w: the forward table, [N][2].
template <int LOGN, int G, int B, int NP>
__device__ __forceinline__ void fwd_stages(u64 (&x)[NP][8], int base,
                                           const u64* __restrict__ w, u64 q) {
  using Gr = Group<LOGN, G>;
  constexpr int r = B - Gr::lo;  // the stage's register bit
  const u64 two_q = 2 * q;
#pragma unroll
  for (int hi = 0; hi < (4 >> r); ++hi) {
    const int idx = ((1 << LOGN) | base | (hi << (B + 1))) >> (B + 1);
    const ulonglong2 wp = ld_global2(w + 2 * idx);
#pragma unroll
    for (int lo = 0; lo < (1 << r); ++lo) {
      const int k = (hi << (r + 1)) | lo;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const u64 u = csub(x[p][k], two_q);
        const u64 v = mulmod_lazy(x[p][k | (1 << r)], wp.x, wp.y, q);
        x[p][k] = u + v;
        x[p][k | (1 << r)] = u + two_q - v;
      }
    }
  }
  if constexpr (B > Gr::lo) fwd_stages<LOGN, G, B - 1, NP>(x, base, w, q);
}

// Inverse stage of bit B in group (C, top), then the group's higher stages;
// the stage of bit LOGN - 1 multiplies both outputs by N^-1 (entry 0).
template <int LOGN, int G, int B, int NP>
__device__ __forceinline__ void inv_stages(u64 (&x)[NP][8], int base,
                                           const u64* __restrict__ w, u64 q) {
  using Gr = Group<LOGN, G>;
  constexpr int r = B - Gr::lo;
  constexpr bool last = B == LOGN - 1;  // then idx = 1: psi^-brv(1) N^-1
  const u64 two_q = 2 * q;
#pragma unroll
  for (int hi = 0; hi < (4 >> r); ++hi) {
    const int idx = ((1 << LOGN) | base | (hi << (B + 1))) >> (B + 1);
    const ulonglong2 wp = ld_global2(w + 2 * idx);
    const ulonglong2 n_inv = last ? ld_global2(w) : make_ulonglong2(0, 0);
#pragma unroll
    for (int lo = 0; lo < (1 << r); ++lo) {
      const int k = (hi << (r + 1)) | lo;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const u64 u = x[p][k], v = x[p][k | (1 << r)];
        x[p][k] = last ? mulmod_lazy(u + v, n_inv.x, n_inv.y, q) : csub(u + v, two_q);
        x[p][k | (1 << r)] = mulmod_lazy(u + two_q - v, wp.x, wp.y, q);
      }
    }
  }
  if constexpr (B < Gr::top) inv_stages<LOGN, G, B + 1, NP>(x, base, w, q);
}

// Forward stages of group G.
template <int LOGN, int G, int NP>
__device__ __forceinline__ void fwd_pass(u64 (&x)[NP][8], int t,
                                         const u64* __restrict__ w, u64 q) {
  fwd_stages<LOGN, G, Group<LOGN, G>::top, NP>(x, tpart<Group<LOGN, G>::C>(t), w, q);
}

// Inverse stages of group G.
template <int LOGN, int G, int NP>
__device__ __forceinline__ void inv_pass(u64 (&x)[NP][8], int t,
                                         const u64* __restrict__ w, u64 q) {
  inv_stages<LOGN, G, Group<LOGN, G>::lo, NP>(x, tpart<Group<LOGN, G>::C>(t), w, q);
}

// Registers of group G -> NP polynomials of two S-word planes at buf.
template <int LOGN, int G, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void store(const u64 (&x)[NP][8], uint32_t* __restrict__ buf,
                                      int t) {
  constexpr int C = Group<LOGN, G>::C;
  const int wa = swz(tpart<C>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t* s = buf + 2 * p * S + word<LOGN, S>(wa ^ swz(k << (C - 2)));
      s[0] = uint32_t(x[p][k]);
      s[S] = uint32_t(x[p][k] >> 32);
    }
}

// NP polynomials of two S-word planes at buf -> registers of group G.
template <int LOGN, int G, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void load(u64 (&x)[NP][8], const uint32_t* __restrict__ buf,
                                     int t) {
  constexpr int C = Group<LOGN, G>::C;
  const int ra = swz(tpart<C>(t));
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t* s = buf + 2 * p * S + word<LOGN, S>(ra ^ swz(k << (C - 2)));
      x[p][k] = u64(s[0]) | (u64(s[S]) << 32);
    }
}

// Registers of group GF -> shared -> registers of group GT. Block-wide when
// either group has C > 7.
template <int LOGN, int GF, int GT, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void exchange(u64 (&x)[NP][8],
                                         uint32_t* __restrict__ buf, int t) {
  __syncwarp();  // the warp's earlier reads of its words are done
  store<LOGN, GF, NP, S>(x, buf, t);
  if constexpr (Group<LOGN, GF>::C > 7 || Group<LOGN, GT>::C > 7)
    __syncthreads();
  else
    __syncwarp();
  load<LOGN, GT, NP, S>(x, buf, t);
}

// Forward NTT from group G on: natural order in group 0's registers
// (register k of thread t is coefficient t + k N/8), evaluation values out
// in the last group's (point 8t + k). The exchanges go through S words a
// plane.
template <int LOGN, int G, int NP, int S = (1 << LOGN)>
__device__ __forceinline__ void forward(u64 (&x)[NP][8], uint32_t* __restrict__ buf,
                                        int t, const u64* __restrict__ w, u64 q) {
  fwd_pass<LOGN, G, NP>(x, t, w, q);
  if constexpr (!Group<LOGN, G>::last) {
    exchange<LOGN, G, G + 1, NP, S>(x, buf, t);
    forward<LOGN, G + 1, NP, S>(x, buf, t, w, q);
  }
}

// Inverse NTT from group G down to group END: evaluation values in the last
// group's registers, coefficients out in group 0's when END = 0. The
// exchanges go through S words a plane.
template <int LOGN, int G, int NP, int S = (1 << LOGN), int END = 0>
__device__ __forceinline__ void inverse(u64 (&x)[NP][8], uint32_t* __restrict__ buf,
                                        int t, const u64* __restrict__ w, u64 q) {
  inv_pass<LOGN, G, NP>(x, t, w, q);
  if constexpr (G > END) {
    exchange<LOGN, G, G - 1, NP, S>(x, buf, t);
    inverse<LOGN, G - 1, NP, S, END>(x, buf, t, w, q);
  }
}

// A u64 polynomial's registers as two u32 polynomials (low plane, then
// high), the form in which cluster.cuh's crossings move them, and back.
template <int NP>
__device__ __forceinline__ void split(const u64 (&x)[NP][8], uint32_t (&y)[2 * NP][8]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      y[2 * p][k] = uint32_t(x[p][k]);
      y[2 * p + 1][k] = uint32_t(x[p][k] >> 32);
    }
}

template <int NP>
__device__ __forceinline__ void join(const uint32_t (&y)[2 * NP][8], u64 (&x)[NP][8]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) x[p][k] = u64(y[2 * p][k]) | (u64(y[2 * p + 1][k]) << 32);
}

}  // namespace rntt64
