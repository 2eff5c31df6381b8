// Batched CGGI blind rotation for Hopper (sm_90a) mod one ring modulus
// Q < 2^54 in native 64-bit integers: the big-Q classic sets (STD192,
// STD128Q, STD192Q and their _OPT rows, STD256 with its 29-bit Q) and the
// accelerated sets at the reference's single 54-bit prime.
//
// Replaces the Pallas TPU kernel
// tfhe_tpu/ops/pallas_rotate64.py:build_pallas_rotate64 and computes what it
// computes, bit for bit: for each of n rounds, the accumulator centred
// (x >= Q/2 is negative), numDigitsToThrow balanced base-G digits dropped,
// each kept digit pair through the forward negacyclic NTT, the lazy external
// product with the round's +s and -s RGSW keys, one reduction, the inverse
// NTT, the (X^a - 1) and (X^-a - 1) monomials and the accumulation. Every
// step is exact modular arithmetic, so the result equals the plain torch
// version (tfhe_tpu_torch/ops/blindrotate64.py) and the JAX package exactly.
// The TPU's (lo, hi) u32-pair arithmetic is plain 64-bit arithmetic here.
//
// Design (N <= 2048): blind_rotate.cu's carried to 64-bit words, with each
// ciphertext's two polynomials on two halves of the block. One thread block
// of N/4 threads owns one ciphertext for all n rounds; the loop over rounds
// inside the block replaces the TPU's sequential `rounds` grid axis. Half h
// (N/8 threads) owns polynomial h of the accumulator, 8 coefficients a
// thread, coefficient t + k N/8 of thread t, in registers for all rounds,
// and runs the NTTs in registers (register_ntt64.cuh): merged twiddles, so
// no twist or untwist pass, N^-1 folded into the inverse's last stage, three
// radix-2 stages per register group (3 + 3 + 3 + 2 at N = 2048) with one
// block-wide exchange per transform through swizzled shared memory held as
// two u32 planes. A round:
// - each thread centres its 8 coefficients, drops the thrown digits once
//   and keeps the rest in int64 registers, from which each kept digit is
//   taken in turn: no digit is recomputed;
// - per kept digit: the forward NTT of polynomial h's digit, its values left
//   in the forward's buffer, where after one barrier the other half reads
//   them at the same points; then the lazy external product on the thread's
//   8 consecutive evaluation points for outputs ko = h (key +s) and 2 + h
//   (key -s) of output polynomial h (a warp reads 2 KB of each key row, in
//   16-byte loads). The key holds only the 64-bit companions b'
//   (pack_bsk64's layout); each value is rebuilt as hi64((b' + 1) Q). The
//   sums wait in shared memory;
// - the sums (< 2Q d2 < 2^62) reduced by one Shoup product with the
//   companion of 1 (forward entry 0), the inverse NTT of the half's two
//   outputs, written once and read back rotated for the monomials, the
//   accumulation (< 5Q) reduced by three min-based conditional
//   subtractions. No runtime `%`, no Barrett pass.
// Barriers per round at N >= 512: two per digit (the forward's block-wide
// exchange, the digit's crossing to the other half), one for the inverse's
// exchange, two around the monomials: 7 at d2 = 4 (about 40 before). Shared
// memory per half: the forward's buffer [2 parities][2 planes][N] u32,
// double-buffered by digit parity because the next digit's block-wide
// exchange would otherwise overwrite words a slower warp (or the other half)
// still reads, and the inverse's buffer [2][2 planes][N] u32, which also
// holds the waiting sums and the inverse's output ([2][N] u64, natural
// order): 64 N bytes a block, 128 KB at N = 2048, so one block of 512
// threads, 16 warps, per SM at 128 registers a thread. Splitting the
// polynomials over two halves is what buys those 16 warps: one thread for
// both polynomials (N/8 threads, 8 warps, 226-250 registers) took 1722.775
// ms at STD128Q, B = 4096, n = 1024, and 16 warps 1137.118 ms in the same
// call. Twiddles and keys are read with coherent loads and each transform
// takes the thread index anew from shared memory, so that ptxas does not
// hoist one transform's loads or addresses into another's registers.
// __launch_bounds__(N/4, 1): 128 registers at N = 2048, 146-152 below it
// (one to three blocks a SM), no spills at any N.
//
// What bounds it: counted as 32-bit multiplies (the lo and hi halves of a
// 32x32 product counted apart, as for the other two kernels), a 64-bit
// Shoup product costs 15: 7 for the high word of the 128-bit a * w', 4 each
// for the low words of a * w and q_hat * Q. A round at N = 2048 and d2 = 4
// needs 122880 of those products per ciphertext, 1.84e6 multiplies, so it is
// bound by operations: at STD128Q (B = 4096, n = 1024) 462.2 ms over 132 SMs
// x 64 lanes x the 1980 MHz maximum SM clock (chip_smoke.py). In SASS a
// lazy Shoup product is 17 instructions, 10 of them multiplies (6 of those
// IMAD.WIDE), and each key value rebuilt from its companion (16 N a round,
// not in the bound) 9.4 instructions, 4 of them multiplies
// (scripts/torch_profile_twolimb.py --kernel-only). Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (scripts/torch_profile_twolimb.py --kernel-only):
// 1137.118 ms at STD128Q, B = 4096, n = 1024, 40.6% of the bound; the
// earlier design (every NTT stage through shared memory, separate twist and
// untwist passes, digits recomputed from the start, a Barrett pass, about 40
// barriers a round, 16 warps) took 1743.611 ms there, 26.5%.
//
// N = 4096: a cluster of two blocks, one per polynomial. The block above
// would need N/4 = 1024 threads at 128 registers (twice an SM's 65536) and
// 64 N = 256 KB of shared memory (above the 227 KB a block may have). Its
// halves already cross only once a digit, so each ciphertext runs on a
// cluster of two blocks (the launch's cluster dimension 2) on two SMs, block
// rank = half h = polynomial h, each block the N/8 = 512 threads of one
// half with that half's buffers: the forward's [2 parities][2 planes][N] and
// the inverse's [2][2 planes][N] u32, 32 N bytes, 128 KB, one block of 16
// warps per SM. The digit's crossing is the one thing that leaves the block:
// after a cluster barrier (barrier.cluster arrive.release / wait.acquire,
// cluster.cuh) each block reads the other polynomial's forward values from
// the peer's forward buffer (ld.shared::cluster at a mapa address, two
// 32-bit loads a value since the planes are N words apart). Every other
// barrier (the forward's and the inverse's exchanges, the two around the
// monomials) stays in the block, so the round-end barriers no longer hold
// a block until its peer has read its buffer: the parity of the forward's
// buffer counts digits across rounds (r digits + l), so a block writes a
// parity again only after the next digit's cluster barrier, which its peer
// reaches after its read (with one kept digit, d2 = 2, the parity of l
// alone would be 0 every round). The kernel ends with a cluster barrier,
// so that no block leaves while its peer may still read it. N <= 2048 keeps
// the one-block layout, instantiated unchanged.
//
// N = 8192: a cluster of four blocks of 512 threads, two a polynomial. One
// polynomial at N = 8192 would need N/8 = 1024 threads at 128 registers and
// 32 N = 256 KB of shared memory, twice what an SM holds, so each polynomial
// spans two blocks as a residue lane does in blind_rotate_rns.cu at this
// ring: block rank = 2 poly + half, logical thread t = half * 512 +
// threadIdx.x of the polynomial's 1024, with the registers and ownership
// above (coefficient t + k N/8 of polynomial `poly`, group 0 of the register
// NTT at 13 index bits, C = 12, 9, 6, 3, 2). `half` is bit 9 of j in group 0
// and bit 12 in groups 1-4, so a block holds the half of each buffer whose
// owner bit is its half, S = N/2 words a plane (register_ntt64.cuh). Shared
// memory per block, in words: the inverse's buffer [2][2 planes][S] (with
// the waiting sums) at 0, the crossing's buffer [2 planes][S] at 4S, the
// forward's [2 planes][S] at 6S, the inverse's output [2][S] u64 (natural
// order, word drop_rank<2>(j)) at 6S, over the forward's buffer and the 2S
// words after it, and at 10S the remainders of the centred accumulator
// that the digits are taken from ([8][512] int64, the thread's own: a
// variant that kept them in registers, as below N = 8192, spilled 8-24
// bytes at 128 registers): 12 S words = 24 N bytes = 192 KB (of 227). The
// accumulator stays in registers, so no CRT and no round-end crossing.
// What crosses, and through which barrier (all cluster barriers):
// - the forward's exchange of groups 0 -> 1 crosses the polynomial's two
//   blocks (cluster.cuh's cross_forward on the u64 values as two u32
//   polynomials, low plane and high plane S words apart: local stores in
//   the crossing's buffer, a barrier B_l, four ld.shared::cluster words a
//   plane from each block), the inverse's 1 -> 0 alike (cross_inverse on
//   the two outputs' four planes in the inverse's buffer, barrier C); the
//   other exchanges stay in the block;
// - digit l: the forward's values are stored at the last group's words of
//   the forward's buffer, a barrier (A_l), then the other polynomial's block
//   of the same half (rank ^ 2), which owns the same points 8t + k, reads
//   them; each block reads only its half of the points' key rows;
// - the output is written, a barrier (E), and read rotated from the
//   polynomial's block that holds each coefficient (bit 9 of its index),
//   two ld.shared::cluster a u64.
// 2 digits + 2 cluster barriers a round, 6 at d2 = 4, 4 at d2 = 2, and one
// at the kernel's end. The hazards and what guards them:
// - one forward buffer, no parity: digit l + 1 writes it after B_{l+1},
//   which rank ^ 2 passes only after its reads of digit l;
// - one crossing buffer: digit l + 1's crossing is written after A_l,
//   which the polynomial's other block passes only after its reads of
//   digit l's; the crossing's buffer is not the forward's, which rank ^ 2
//   may still read while the crossing is written;
// - the output over the forward's buffer: written after C, which every
//   block passes only after its last reads of the forward's values; the
//   next round writes the forward's buffer only after B_0, which comes
//   after every block's rotated reads;
// - the output not over the inverse's buffer, which the polynomial's other
//   block still reads in the inverse's crossing after C, and not over the
//   crossing's, which the next round writes before B_0 while the other
//   block may still read the output rotated;
// - the sums and the inverse's buffer: the next round writes them after
//   A_0, and the other block read them before E;
// - no block leaves while another may read it: the final cluster barrier.
// The emulation in tests/test_torch_rotate64_merged.py keeps the four
// blocks' shared memory apart and lets one block run ahead to each cluster
// barrier: the crossing over the forward's buffer, the output over the
// inverse's or the crossing's, or a block barrier in place of A_l, B_l, C,
// E or the final barrier each give a wrong result there.
// Bound: at B = 1024, n = 1305, N = 8192 the operations bind, 667.546 ms at
// d2 = 4 and 461.392 ms at d2 = 2 (chip_smoke.bound, 15 multiplies a 64-bit
// Shoup product).

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "register_ntt64.cuh"

namespace {

using dsmem::cluster_rank;
using dsmem::cluster_sync;
using dsmem::drop_rank;
using dsmem::ld_peer;
using dsmem::peer_address;
using rntt64::csub;
using rntt64::ld_global2;
using rntt64::mulmod_lazy;
using rntt64::u64;

// Balanced base-2^g_bits digit of d; d becomes (d - digit) >> g_bits.
__device__ __forceinline__ int64_t extract(int64_t& d, int g_bits) {
  const int64_t base = int64_t(1) << g_bits;
  int64_t r = d & (base - 1);
  if (r >= (base >> 1)) r -= base;
  d = (d - r) >> g_bits;
  return r;
}

// Blocks a ciphertext: one two-half block up to N = 2048, a cluster of two
// one-polynomial blocks at 4096, of four blocks (two a polynomial, each half
// of its polynomial's words) at 8192.
template <int LOGN>
constexpr int kBlocks = LOGN > 12 ? 4 : LOGN > 11 ? 2 : 1;

template <int LOGN>
constexpr int kThreads = (1 << LOGN) / (4 * kBlocks<LOGN>);

// The peer block's forward values of the last group, read as `rntt64::load`
// reads its own: the two u32 planes (S words apart) of the words at cluster
// address buf.
template <int LOGN, int S>
__device__ __forceinline__ void load_peer(u64 (&x)[1][8], uint32_t buf, int t) {
  constexpr int C = rntt64::Group<LOGN, rntt64::groups<LOGN>() - 1>::C;
  const int ra = rntt64::swz(rntt64::tpart<C>(t));
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t a = buf + 4 * rntt::word<LOGN, S>(ra ^ rntt64::swz(k << (C - 2)));
    x[0][k] = u64(ld_peer(a)) | (u64(ld_peer(a + 4 * S)) << 32);
  }
}

// acc_in/acc_out: [B][2][N] residues mod Q. bsk: [n][4*d2][N], row
// (key*2 + out)*d2 + 2l + j, Shoup companions only, points in the forward
// NTT's order. tw: [2][N][2] u64, the forward and the inverse table of
// register_ntt64.cuh, each entry beside its companion; forward entry 0 is 1,
// so its companion floor(2^64 / Q) reduces the lazy sums. In a cluster,
// block kBlocks * b + rank of the grid runs ciphertext b: rank = polynomial
// at N = 4096, rank = 2 poly + half at N = 8192.
template <int LOGN>
__global__ void __launch_bounds__(kThreads<LOGN>, 1)
blind_rotate64_kernel(const u64* __restrict__ acc_in, u64* __restrict__ acc_out,
                      const int32_t* __restrict__ a_idx,
                      const u64* __restrict__ bsk, const u64* __restrict__ tw,
                      int n, u64 Q, int g_bits, int digits, int throw_digits) {
  constexpr int N = 1 << LOGN;
  constexpr int TG = N / 8;                 // threads per polynomial
  constexpr int G = rntt64::groups<LOGN>();
  constexpr bool CL = kBlocks<LOGN> > 1;
  constexpr bool HALF = kBlocks<LOGN> == 4; // a block holds half of its polynomial's words
  constexpr int S = HALF ? N / 2 : N;       // words a plane in a block
  extern __shared__ __align__(16) uint32_t smem[];
  // half h owns polynomial h of the accumulator, its digits' forward NTTs
  // and the outputs ko = h and 2 + h of the external product (at N = 8192
  // the two blocks of polynomial h each hold half of it)
  int h, t;
  size_t b;
  int rank = 0;                             // in the cluster (N = 8192)
  uint32_t peer = 0u;                       // the peer block's shared memory (N = 4096)
  if constexpr (HALF) {
    rank = cluster_rank();
    h = rank >> 1;
    t = (rank & 1) * (TG / 2) + threadIdx.x;
    b = blockIdx.x / 4;
  } else if constexpr (CL) {
    h = cluster_rank();
    t = threadIdx.x;
    b = blockIdx.x / 2;
    peer = peer_address(smem, h ^ 1);
  } else {
    h = threadIdx.x / TG;
    t = threadIdx.x % TG;
    b = blockIdx.x;
  }
  // word offsets of the buffers (the layouts in the note above)
  constexpr int I_AT = HALF ? 0 : CL ? 4 * N : 8 * N;   // the inverse's
  constexpr int X_AT = 4 * S;                            // the crossing's (N = 8192)
  constexpr int F_AT = HALF ? 6 * S : 0;                 // the forward's
  constexpr int D_AT = 10 * S;                           // the digits' remainders (N = 8192)
  const int slot = CL ? 0 : h;                           // the half's place in this block
  uint32_t* fbuf = smem + F_AT + 4 * N * slot;           // [2 parities][2 planes][N];
                                                         // at N = 8192 [2 planes][S]
  const uint32_t* fbuf_other = smem + 4 * N * (1 - h);   // one block only
  uint32_t* ibuf = smem + I_AT + 4 * N * slot;           // [2][2 planes][S]
  // the inverse's output [2][S] u64: over the inverse's buffer, or at
  // N = 8192 over the forward's buffer and the words after it
  u64* out = reinterpret_cast<u64*>(HALF ? smem + F_AT : ibuf);

  // at N = 8192, the cluster address of word w in the other polynomial's
  // block of this half (rank ^ 2), or in this polynomial's block of half
  // `half` ((rank & 2) | half), made where it is read (mapa), so that no
  // register holds one across a round
  auto other_poly = [&](int w) { return peer_address(smem + w, rank ^ 2); };
  auto this_poly = [&](int w, int half) { return peer_address(smem + w, (rank & 2) | half); };

  const int d2 = 2 * digits;
  const u64* fw = tw;
  const u64* iw = tw + 2 * N;
  const u64 red_sh = __ldg(fw + 1);         // floor(2^64 / Q)
  const u64 half_q = Q >> 1;

  // fresh(t) is t read anew from shared memory: the addresses each NTT makes
  // from it are made where it runs, not kept in registers from another
  // transform that made the same ones
  __shared__ int zero;
  auto fresh = [&](int v) { return v + *static_cast<volatile int*>(&zero); };

  // the accumulator stays in registers: coefficient t + k N/8 of
  // polynomial h in acc[k]
  u64 acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = acc_in[(b * 2 + h) * N + t + k * TG];
  if (threadIdx.x == 0) zero = 0;
  __syncthreads();

  // the lazy sums of the digits wait in the half's inverse buffer, among
  // the 256 words per plane that the warp's own first exchange of the
  // inverse writes: register k of output i at words 32k + (wt mod 32) of its
  // two planes, wt the thread's index among the block's words (t, or at
  // N = 8192 threadIdx.x), so one base and constant offsets address all of
  // them
  const int wt = HALF ? int(threadIdx.x) : t;
  uint32_t* sums = ibuf + 8 * (wt & ~31) + (wt & 31);

  for (int r = 0; r < n; ++r) {
    const u64* key = bsk + ((size_t)r * 4 * d2 + h * d2) * N + 8 * t;

    // the accumulator centred, the thrown digits dropped
    // (at N = 8192 they wait in shared memory between the digits, which
    // frees 16 registers during the transforms and the product)
    int64_t d[8];
    auto d_at = [&](int k) -> int64_t& {
      return reinterpret_cast<int64_t*>(smem + D_AT)[k * (TG / 2) + (fresh(t) & (TG / 2 - 1))];
    };
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const u64 a = acc[k];
      int64_t v = a < half_q ? int64_t(a) : int64_t(a) - int64_t(Q);
      for (int i = 0; i < throw_digits; ++i) extract(v, g_bits);
      if constexpr (HALF)
        d_at(k) = v;
      else
        d[k] = v;
    }

    // digit l of polynomial h through the forward NTT into x, and that of
    // polynomial 1 - h from the other half into y: point 8t + k. The values
    // cross through the forward's buffer, at the words of the thread's own
    // last group, which the other half reads after a block-wide barrier (in
    // a cluster: the peer's buffer, after the cluster's barrier; at
    // N = 4096 the parity counts digits across rounds, at 8192 one buffer)
    auto digit_forward = [&](int l, u64 (&x)[1][8], u64 (&y)[1][8]) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        int64_t rr;
        if constexpr (HALF) {
          int64_t& dk = d_at(k);
          int64_t v = dk;
          rr = extract(v, g_bits);
          dk = v;
        } else {
          rr = extract(d[k], g_bits);
        }
        x[0][k] = rr < 0 ? u64(rr + int64_t(Q)) : u64(rr);
      }
      const int par = HALF ? 0 : 2 * N * ((CL ? r * digits + l : l) & 1);
      if constexpr (HALF) {
        // group 0 here, its exchange to group 1 across the polynomial's two
        // blocks, the other groups in this block's half
        rntt64::fwd_pass<LOGN, 0, 1>(x, fresh(t), fw, Q);
        uint32_t xs[2][8];
        rntt64::split(x, xs);
        const uint32_t x_at[2] = {this_poly(X_AT, 0), this_poly(X_AT, 1)};
        dsmem::cross_forward(xs, smem + X_AT, x_at, fresh(t));
        rntt64::join(xs, x);
        rntt64::forward<LOGN, 1, 1, S>(x, fbuf, fresh(t), fw, Q);
      } else {
        rntt64::forward<LOGN, 0, 1>(x, fbuf + par, fresh(t), fw, Q);
      }
      __syncwarp();
      rntt64::store<LOGN, G - 1, 1, S>(x, fbuf + par, t);
      if constexpr (HALF) {
        cluster_sync();
        load_peer<LOGN, S>(y, other_poly(F_AT), t);
      } else if constexpr (CL) {
        cluster_sync();
        load_peer<LOGN, S>(y, peer + 4 * par, t);
      } else {
        __syncthreads();
        rntt64::load<LOGN, G - 1, 1>(y, fbuf_other + par, t);
      }
    };
    // the lazy external product of digit l for output ko = h + 2i:
    // p[k] = sum_j x_j K[key][out][2l + j] at point 8t + k, < 4Q; row
    // 2l + h holds the companions for x, 2l + 1 - h those for y
    auto product = [&](int l, int i, const u64 (&x)[8], const u64 (&y)[8], u64 (&p)[8]) {
      const u64* ks = key + (size_t)(2 * i * d2 + 2 * l) * N;
      const u64* k0 = ks + h * N;
      const u64* k1 = ks + (1 - h) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const ulonglong2 a = ld_global2(k0 + 2 * j), c = ld_global2(k1 + 2 * j);
        const u64 s0[2] = {a.x, a.y}, s1[2] = {c.x, c.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * j + e;
          const u64 v0 = __umul64hi(s0[e] + 1, Q), v1 = __umul64hi(s1[e] + 1, Q);
          p[k] = mulmod_lazy(x[k], v0, s0[e], Q) + mulmod_lazy(y[k], v1, s1[e], Q);
        }
      }
    };

    for (int l = 0; l < digits; ++l) {
      u64 x[1][8], y[1][8];
      digit_forward(l, x, y);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        u64 p[8];
        product(l, i, x[0], y[0], p);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint32_t* sp = sums + 2 * i * S + 32 * k;
          const u64 s = l == 0 ? p[k] : (u64(sp[0]) | (u64(sp[S]) << 32)) + p[k];
          sp[0] = uint32_t(s);
          sp[S] = uint32_t(s >> 32);
        }
      }
    }
    u64 u[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t* sp = sums + 2 * i * S + 32 * k;
        u[i][k] = u64(sp[0]) | (u64(sp[S]) << 32);
      }

    // one Shoup reduction of the lazy sums (< 2^62) to [0, 2Q), then the
    // inverse NTT of the half's two outputs, N^-1 folded in
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) u[i][k] -= __umul64hi(u[i][k], red_sh) * Q;
    if constexpr (HALF) {
      // groups 4 .. 1 in this block's half, the exchange to group 0 across
      // the polynomial's two blocks (the outputs' four planes)
      rntt64::inverse<LOGN, G - 1, 2, S, 1>(u, ibuf, fresh(t), iw, Q);
      uint32_t us[4][8];
      rntt64::split(u, us);
      const uint32_t i_at[2] = {this_poly(I_AT, 0), this_poly(I_AT, 1)};
      dsmem::cross_inverse(us, ibuf, i_at, fresh(t));
      rntt64::join(us, u);
      rntt64::inv_pass<LOGN, 0, 2>(u, fresh(t), iw, Q);
    } else {
      rntt64::inverse<LOGN, G - 1, 2>(u, ibuf, fresh(t), iw, Q);
      // the output lies over the inverse's buffer: write it when every
      // thread has read its last exchange
      __syncthreads();
    }

    // acc += (X^m_pos - 1) u[0] + (X^m_neg - 1) u[1] (outputs h and 2 + h:
    // keys +s and -s): write the inverse's output once and read it rotated
    // (at N = 8192 from the polynomial's block that holds the coefficient,
    // bit 9 of its index)
    const int wo = HALF ? fresh(t) & (TG / 2 - 1) : t;  // coefficient t's word: wo + k S/8
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[i][k] = csub(u[i][k], Q);
        out[i * S + wo + k * (S / 8)] = u[i][k];
      }
    if constexpr (HALF)
      cluster_sync();
    else
      __syncthreads();
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    auto output = [&](int i, int c) -> u64 {
      if constexpr (HALF) {
        const uint32_t a = this_poly(F_AT + 2 * (i * S + drop_rank<2>(c)), (c >> 9) & 1);
        return u64(ld_peer(a)) | (u64(ld_peer(a + 4)) << 32);
      } else {
        return out[i * N + c];
      }
    };
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = t + k * TG;
      const int r0 = (j - m_pos) & (2 * N - 1);
      const int r1 = (j - m_neg) & (2 * N - 1);
      const u64 c0 = output(0, r0 & (N - 1));
      const u64 c1 = output(1, r1 & (N - 1));
      const u64 v0 = r0 < N ? c0 : Q - c0;  // in [0, Q]
      const u64 v1 = r1 < N ? c1 : Q - c1;
      const u64 s = acc[k] + v0 + (Q - u[0][k]) + v1 + (Q - u[1][k]);
      acc[k] = csub(csub(csub(s, 4 * Q), 2 * Q), Q);  // s < 5Q
    }
    // the next round's sums and inverse overwrite the output only after its
    // first digit's exchange with the other half (a block-wide barrier, or
    // the cluster's); at N = 8192 its forward overwrites the output after
    // B_0
  }
  // no block of a cluster leaves while another may still read it
  if constexpr (CL) cluster_sync();

#pragma unroll
  for (int k = 0; k < 8; ++k) acc_out[(b * 2 + h) * N + t + k * TG] = acc[k];
}

// Dynamic shared memory of a block: 64 N bytes, 32 N in a two-block
// cluster, 24 N (12 S words) in a four-block one.
template <int LOGN>
constexpr size_t smem_bytes() {
  constexpr size_t N = size_t(1) << LOGN;
  return (kBlocks<LOGN> == 4 ? 6 * N : kBlocks<LOGN> == 2 ? 8 * N : 16 * N) *
         sizeof(uint32_t);
}

template <int LOGN>
cudaError_t launch(const void* acc_in, void* acc_out, const void* a_idx,
                   const void* bsk, const void* tw, int B, u64 Q, int n,
                   int g_bits, int digits, int throw_digits, cudaStream_t stream) {
  const size_t smem = smem_bytes<LOGN>();
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate64_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (kBlocks<LOGN> > 1) {
    dsmem::ClusterLaunch cl(kBlocks<LOGN>, B, kThreads<LOGN>, smem, stream);
    err = cudaLaunchKernelEx(
        &cl.cfg, blind_rotate64_kernel<LOGN>, static_cast<const u64*>(acc_in),
        static_cast<u64*>(acc_out), static_cast<const int32_t*>(a_idx),
        static_cast<const u64*>(bsk), static_cast<const u64*>(tw), n, Q, g_bits,
        digits, throw_digits);
    if (err != cudaSuccess) return err;
  } else {
    blind_rotate64_kernel<LOGN><<<B, kThreads<LOGN>, smem, stream>>>(
        static_cast<const u64*>(acc_in), static_cast<u64*>(acc_out),
        static_cast<const int32_t*>(a_idx), static_cast<const u64*>(bsk),
        static_cast<const u64*>(tw), n, Q, g_bits, digits, throw_digits);
  }
  return cudaGetLastError();
}

template <int LOGN>
cudaError_t clusters_of(int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate64_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<LOGN>());
  if (err != cudaSuccess) return err;
  dsmem::ClusterLaunch cl(kBlocks<LOGN>, 1, kThreads<LOGN>, smem_bytes<LOGN>(), 0);
  return cudaOccupancyMaxActiveClusters(clusters, blind_rotate64_kernel<LOGN>, &cl.cfg);
}

}  // namespace

// acc_in/acc_out [B][2][N] u64, a_idx [B][n] int32, bsk [n][4*d2][N] u64,
// tw [2][N][2] u64. bar_m and bar_s are not read: the lazy sums are reduced
// with the companion of forward entry 0 (they held a Barrett constant in an
// earlier design, and stay so that the entry point is unchanged). Returns the
// launch's cudaError_t (0 on success).
extern "C" int tfhe_blind_rotate64(const void* acc_in, void* acc_out,
                                   const void* a_idx, const void* bsk,
                                   const void* tw, int B, int N,
                                   unsigned long long Q,
                                   unsigned long long bar_m, int bar_s, int n,
                                   int g_bits, int digits, int throw_digits,
                                   void* stream) {
  (void)bar_m;
  (void)bar_s;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 256:
      return launch<8>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    case 512:
      return launch<9>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    case 1024:
      return launch<10>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    case 2048:
      return launch<11>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    case 4096:
      return launch<12>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    case 8192:
      return launch<13>(acc_in, acc_out, a_idx, bsk, tw, B, Q, n, g_bits, digits, throw_digits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of the ring-N cluster kernel (N = 4096 or 8192) the card
// holds at once (cudaOccupancyMaxActiveClusters), in *clusters. Returns the
// cudaError_t; cudaErrorInvalidValue for a ring without a cluster layout.
extern "C" int tfhe_blind_rotate64_clusters(int N, int* clusters) {
  switch (N) {
    case 4096:
      return clusters_of<12>(clusters);
    case 8192:
      return clusters_of<13>(clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
