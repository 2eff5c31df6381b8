// Batched CGGI blind rotation for Hopper (sm_90a) on the composite ring
// modulus Q = q1 * q2 of two primes q2 < q1 < 2^28, in two 32-bit residue
// lanes.
//
// Replaces the Pallas TPU kernel
// tfhe_tpu/ops/pallas_rotate_rns.py:build_pallas_rotate_rns and computes what
// it computes, bit for bit. Each of n rounds: Garner CRT of the two lanes
// gives the value mod Q, centred (x >= Q/2 is negative) in a native int64;
// numDigitsToThrow balanced base-G digits are dropped and the next ones are
// mapped into each lane. Per lane: the forward negacyclic NTT of each digit,
// the lazy external product with the round's +s and -s RGSW keys, one
// reduction, the inverse NTT, the (X^a - 1) and (X^-a - 1) monomials and the
// accumulation. Every step is exact modular arithmetic, so the result
// equals the plain torch version (tfhe_tpu_torch/ops/blindrotate_rns.py) and
// the JAX package exactly.
//
// Design. One thread block owns one ciphertext for all n rounds; the loop
// over rounds inside the block replaces the TPU's sequential `rounds` grid
// axis. The block has N/4 threads, N/8 per residue lane, so the two lanes
// run every step side by side and share each barrier. A thread owns R = 8
// coefficients of each polynomial and runs the NTTs in registers
// (register_ntt.cuh): merged twiddles, so no twist or untwist pass, N^-1
// folded into the inverse's last stage, three radix-2 stages per register
// group, 3 + 3 + 3 + 2 stages at N = 2048 with three exchanges through
// swizzled, conflict-free shared memory per transform, one of them
// block-wide. A round:
// - the CRT, the centring and the thrown digits of 8 coefficients, once:
//   lane 0's threads take polynomial 0, lane 1's polynomial 1, and keep the
//   rest in int64 registers;
// - per kept digit: each thread extracts its 8 signed digits and writes them
//   to shared memory (one barrier), reads the 16 digits of both polynomials
//   at its points into its lane, runs the lane's forward NTT of the two, and
//   the lazy external product on its 8 consecutive evaluation points (a
//   warp reads 1 KB of each key row, in 16-byte loads); the sums of the
//   digits before the last wait in shared memory, which frees 32 registers
//   during the NTTs;
// - the sums (< (2q - 1) d2 < 2^32) reduced by one Shoup product with the
//   companion of 1, the inverse NTT of the four, its output written once and
//   read back rotated for the monomials, the accumulation (< 5q) reduced by
//   three conditional subtractions. No runtime `%`.
// Barriers per round at N >= 512: two per digit (the digits' exchange and
// the forward's block-wide exchange), one for the inverse's, two around the
// monomials: 2 digits + 3, 7 at d2 = 4 (81 before). Shared memory: the
// accumulators [2][2][N], the forward's buffer [2][2][N], the digits
// [2][2][N] (double-buffered by digit parity; the two together also hold
// the inverse's output [2][4][N]) and the inverse's buffer [2][4][N] (also
// the waiting sums): 80 N bytes, 160 KB at N = 2048, so one block of 512
// threads per SM and at most 128 registers a thread
// (__launch_bounds__(N/4, 2048/N) at every N).
// ptxas keeps it at 128 registers without spills only if it cannot hoist:
// twiddles and keys are read with coherent loads, which it does not move
// above a barrier, and each transform takes the thread index anew from
// shared memory, so it does not keep one transform's addresses in registers
// for another. The key holds only the per-lane Shoup companions b'
// (pack_bsk_rns's layout), which halves the key stream; each value is
// rebuilt as hi32((b' + 1) q): for b' = floor(b 2^32 / q) with b < q,
// b 2^32 < (b' + 1) q <= b 2^32 + q, so that is b, the value the plain
// version's hi32(b' q) + (lo32(b' q) != 0) gives, in two instructions
// instead of four.
//
// Work per ciphertext and round at N = 2048, d2 = 4 (two digits), per
// lane: 2 x (22528 forward butterflies + 16384 key products) + 45056
// inverse butterflies = 122880 lazy Shoup products (three 32-bit multiplies
// each), 32768 key values rebuilt (one each) and 8192 reductions (two
// each); the CRT, 4 multiplies per coefficient. The function needs 245760
// Shoup products over both lanes and the CRT, so it is bound by
// operations: at B = 4096, n = 1305, d2 = 4 the bound (multiplies over 132
// SMs x 64 lanes x the 1980 MHz maximum SM clock) is 240.8 ms
// (chip_smoke.py). The key stream, 256 KB per round and block, comes from L2
// once per ciphertext: about 1.4 TB through L2 per launch at that shape.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 932.8 ms
// at B = 4096, n = 1305, d2 = 4, 25.8% of the bound (the earlier design, the
// lanes one after the other and every NTT stage through shared memory,
// took 1925.6 ms); 128 registers and no spills at every N. ncu could not
// profile where this was measured, so what holds it there is reckoned: each
// butterfly issues about as many additions, comparisons and selections as
// multiplies, and each shared access an XOR address, so the integer pipes
// carry about twice the bound's work, and 16 warps with 7 barriers a round
// stall for the rest. Cutting instructions (min-based subtractions, the
// two-instruction key rebuild) showed in the time; cutting a barrier per
// digit at the price of a second CRT did not. The key stream runs at 1.5
// TB/s, below what L2 delivers, so a block that reads each key word once
// for several ciphertexts would not be the first gain; it would also not
// fit one SM's shared memory and registers next to this design.
//
// N = 4096: a cluster of two blocks, one per residue lane. One lane's share
// at N = 4096 is what one block holds at N = 2048 twice over: the block
// above would need 80 N bytes of shared memory (320 KB, above the 227 KB a
// block may have) and N/4 = 1024 threads at 128 registers (twice an SM's
// 65536). So each ciphertext runs on a cluster of two blocks (the launch's
// cluster dimension 2) on two SMs, block rank = residue lane, each block
// the N/8 = 512 threads of one lane with that lane's buffers: the
// accumulator [2][N], the forward's buffer [2][N], its own polynomial's
// digits [2 parities][N], the inverse's output [4][N] and buffer [4][N],
// 56 N bytes, 224 KB, none aliased. This is the Hopper counterpart of the
// reference's multi-block bootstrap (cooperative blocks and grid.sync()).
// Only three things cross between the lanes, through distributed shared
// memory (ld.shared::cluster at a mapa address) and the cluster barrier
// (barrier.cluster arrive.release / wait.acquire):
// - the CRT reads the other lane's residue of its polynomial from the
//   peer's accumulator;
// - each block writes the digits of its own polynomial and reads the other
//   polynomial's from the peer, so the barrier after the write is the
//   cluster's; the parity double-buffering stays, since the peer may still
//   read digit l while this block writes digit l + 1;
// - the round's last barrier is the cluster's, since the next round's CRT
//   reads the peer's accumulator; it also keeps a block from leaving while
//   its peer still reads it.
// Every other barrier (the forward's and inverse's exchanges, the
// monomials) stays in the block: 1 + digits cluster barriers a round. The
// register NTT is the same 512-thread group at 12 index bits (groups of
// C = 11, 8, 5, 2; two block-wide exchanges per transform, register_ntt.cuh).
// N <= 2048 keeps the one-block layout above, instantiated unchanged.
//
// N = 8192: a cluster of four blocks of 512 threads, two a residue lane.
// One lane at N = 8192 would need 1024 threads at 128 registers and 56 N =
// 448 KB, twice what an SM holds, so each lane spans two blocks as one
// polynomial does in blind_rotate.cu at this ring: block rank = 2 lane +
// half, logical thread t = half * 512 + threadIdx.x of the lane's 1024,
// with the registers and ownership above (coefficient t + k N/8 of
// polynomial `lane` in the CRT and the digits, group 0 of the register NTT
// at 13 index bits, C = 12, 9, 6, 3, 2). `half` is bit 9 of j in group 0
// and bit 12 in groups 1-4, so each block holds the half of every buffer
// whose owner bit is its half, S = N/2 words a polynomial (word
// drop_bit9(j) in natural order): its thread's register k is word
// threadIdx.x + 512 k. Shared memory per block, in words: the accumulator
// [2][S] at 0, the digits [S] at 2S, the inverse's buffer [4][S] (with the
// waiting sums) at 3S, the crossing's buffer [2][S] at 7S, the forward's
// [2][S] at 9S, and the inverse's output [4][S] at 7S over the crossing's
// and the forward's buffers: 11 S words = 22 N bytes = 176 KB (of 227).
// What crosses, and through which barrier (all cluster barriers):
// - the CRT reads the other lane's residues from the other lane's block of
//   the same half (rank ^ 2), after the round's last barrier (F) or the
//   one after the load;
// - digit l: each block writes its polynomial's digits, a barrier (A_l),
//   then reads the other polynomial's from rank ^ 2;
// - the forward's exchange of groups 0 -> 1 crosses the lane's two blocks
//   (cluster.cuh's cross_forward: local stores, a barrier B_l, four
//   ld.shared::cluster words from each block), the inverse's 1 -> 0 alike
//   (cross_inverse, barrier C); the other exchanges stay in the block;
// - the output is written, a barrier (E), and read rotated from the lane's
//   block that holds each coefficient (bit 9 of its index);
// - the round ends with a barrier (F): the next CRT reads rank ^ 2's
//   accumulator, and no block leaves while another may read it.
// 2 digits + 3 cluster barriers a round, 7 at d2 = 4. The hazards and what
// guards them:
// - one digits buffer: digit l + 1 is written after B_l, which the other
//   lane's block passes only when its reads of digit l are done;
// - one crossing buffer: digit l + 1's crossing is written after A_{l+1},
//   which the lane's other block passes only after its reads of digit l's;
// - the output over the crossing's and forward's buffers: written after C,
//   which every block passes only after its last crossing reads and its
//   last forward; the next round writes either buffer only after F, which
//   comes after every block's rotated reads;
// - the output not over the inverse's buffer: after C the lane's other
//   block still reads this block's inverse's buffer in the crossing; the
//   next round's sums and inverse write it only after F;
// - the accumulator: written after E, and read by the other lane's block
//   only after F; no block reads another after the last F.
// The emulation in tests/test_torch_ntt_merged.py keeps the four blocks'
// shared memory apart and lets one run ahead to each cluster barrier: the
// output over the inverse's buffer, the digits over the crossing's buffer,
// or a block barrier in place of A_l or F each give a wrong result there.
// Bound: at B = 1024, n = 1305, N = 8192 the operations bind, 272.3 ms at
// d2 = 4 and 189.8 ms at d2 = 2 (chip_smoke.bound: 3 multiplies a Shoup
// product, 4 a CRT coefficient); the key, 1.37 GB at d2 = 4, streams each
// round's 512 KB a lane from L2 once per ciphertext, each block its half.
//
// N = 16384: a cluster of eight blocks of 512 threads, four a residue lane
// (eight is the portable cluster maximum). One lane needs N/8 = 2048
// threads at 128 registers, four SMs' registers, so the layout above is
// kept with P = 4 blocks a lane in place of 2: block rank = 4 lane +
// quarter, logical thread t = quarter * 512 + threadIdx.x of the lane's
// 2048. The register NTT runs at 14 index bits (C = 13, 10, 7, 4, 2);
// `quarter` is bits 9-10 of j in group 0 (j = t | k << 11) and bits 12-13
// in groups 1-4, so each block holds the quarter of every buffer whose
// owner bits are its quarter: S = N/4 = 4096 words a polynomial (word
// drop_rank<4>(j) = ((j >> 11) << 9) | (j & 511) in natural order), the
// same S as a half at N = 8192, so the same 11 S words, 176 KB a block,
// at the same offsets. What crosses, all through the same cluster
// barriers:
// - the CRT and digit l: the other lane's block of the same quarter,
//   rank ^ 4 (barriers F and A_l);
// - the forward's 0 -> 1 exchange (cross_forward<NP, 4>, barrier B_l):
//   group 1's register k reads block 4 lane + (k >> 1) of its lane, since
//   j's bits 9-10 are bits 1-2 of k at C = 10; the inverse's 1 -> 0
//   (cross_inverse<NP, 4>, barrier C): group 0's register k reads block
//   k >> 1, j's bits 12-13 being bits 1-2 of k at C = 13;
// - the rotated reads after E: each coefficient c from the lane's block of
//   c's bits 9-10 (`holder`, a 4-entry at[] of cluster addresses).
// 2 digits + 3 cluster barriers a round, as at N = 8192, and one at the
// end. The hazards are the ones listed above with "the lane's other
// blocks" for "the lane's other block": every barrier there is already
// the whole cluster's, so each guard holds for P = 4 as for P = 2, and
// none of the five can go (A_l, B_l, C and E each order a write before
// another block's read; F orders the accumulator's write before the other
// lane's CRT read and every block's rotated reads before the next round's
// writes of the crossing's and forward's buffers). The emulation in
// tests/test_torch_ntt_merged.py runs the eight-block layout alike.
// Bound: at B = 1024, n = 1305, N = 16384 the operations bind, 575.9 ms at
// d2 = 4 and 403.1 ms at d2 = 2 (chip_smoke.bound); the key, 2.74 GB at
// d2 = 4, streams each round's 1 MB a lane from L2 once per ciphertext,
// each block its quarter. Every key and accumulator address is a size_t
// (the key's byte offsets pass 2^31). Measured on an NVIDIA H100 80GB HBM3
// at 700.00 W (scripts/torch_check_ring4096.py --ring 16384): 3505.1 ms
// at d2 = 4 (16.4% of the bound) and 2488.6 ms at d2 = 2 (16.2%), against
// 17.0-17.5% for four blocks at N = 8192 in the same call; 124 registers,
// no spills; 15 eight-block clusters resident (120 of 132 SMs).
//
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "register_ntt.cuh"

namespace {

using dsmem::cluster_rank;
using dsmem::cluster_sync;
using dsmem::drop_rank;
using dsmem::ld_peer;
using dsmem::peer_address;
using rntt::csub;
using rntt::mulmod_lazy;

// Balanced base-2^g_bits digit of d; d becomes (d - digit) >> g_bits.
__device__ __forceinline__ int64_t extract(int64_t& d, int g_bits) {
  const int64_t base = int64_t(1) << g_bits;
  int64_t r = d & (base - 1);
  if (r >= (base >> 1)) r -= base;
  d = (d - r) >> g_bits;
  return r;
}

// Blocks a ciphertext: one two-lane block up to N = 2048, a cluster of two
// one-lane blocks at 4096, of four blocks (two a lane, each half of its
// lane's words) at 8192, of eight (four a lane, each a quarter) at 16384.
template <int LOGN>
constexpr int kBlocks = LOGN > 13 ? 8 : LOGN > 12 ? 4 : LOGN > 11 ? 2 : 1;

// Blocks a residue lane: P > 1 at N >= 8192, where a block holds 1/P of its
// lane's words.
template <int LOGN>
constexpr int kLaneBlocks = kBlocks<LOGN> > 2 ? kBlocks<LOGN> / 2 : 1;

template <int LOGN>
constexpr int kThreads = (1 << LOGN) / (4 * kBlocks<LOGN>);

// acc1/acc2: [B][2][N] residues mod q1 / q2. bsk: [n][8*d2][N] u32, rows
// lane*4*d2 + (key*2 + out)*d2 + 2l + j, Shoup companions only, points in
// the forward NTT's order. tw: [2 lanes][4][N] rows fwd, fwd', inv, inv'
// (register_ntt.cuh; x' = Shoup companion); fwd[0] = 1, so fwd'[0] =
// floor(2^32 / q) reduces the lazy sums. In a cluster, block
// kBlocks * b + rank of the grid runs ciphertext b: rank = lane at N = 4096,
// rank = P lane + part at N = 8192 (P = 2) and 16384 (P = 4).
template <int LOGN>
__global__ void __launch_bounds__(kThreads<LOGN>, kBlocks<LOGN> > 1 ? 1 : 2048 >> LOGN)
blind_rotate_rns_kernel(const uint32_t* __restrict__ acc1_in,
                        const uint32_t* __restrict__ acc2_in,
                        uint32_t* __restrict__ acc1_out,
                        uint32_t* __restrict__ acc2_out,
                        const int32_t* __restrict__ a_idx,
                        const uint32_t* __restrict__ bsk,
                        const uint32_t* __restrict__ tw, int n, uint32_t q1,
                        uint32_t q2, uint32_t c12, uint32_t c12_sh,
                        int g_bits, int digits, int throw_digits) {
  constexpr int N = 1 << LOGN;
  constexpr int TG = N / 8;                 // threads per lane
  constexpr int G = rntt::groups<LOGN>();
  constexpr bool CL = kBlocks<LOGN> > 1;
  constexpr int P = kLaneBlocks<LOGN>;      // blocks a lane
  constexpr bool PART = P > 1;              // a block holds 1/P of its lane's words
  constexpr int L = CL ? 1 : 2;             // lanes in this block
  constexpr int S = N / P;                  // words a polynomial in a block
  constexpr int WK = S / 8;                 // word step of a thread's registers k
  // word offsets of the buffers (the layouts in the note above); the
  // crossing's buffer exists only at N >= 8192
  constexpr int F_AT = PART ? 9 * S : 2 * L * N;              // forward's, swizzled
  constexpr int D_AT = PART ? 2 * S : 4 * L * N;              // digits
  constexpr int O_AT = PART ? 7 * S : CL ? 6 * N : 2 * L * N; // inverse's output
  constexpr int I_AT = PART ? 3 * S : CL ? 10 * N : 12 * N;   // inverse's, swizzled
  constexpr int X_AT = 7 * S;                                 // the crossing's
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc = smem;              // [L lanes][2][S], natural order
  uint32_t* fbuf = smem + F_AT;      // [L lanes][2][S]
  int32_t* digs = reinterpret_cast<int32_t*>(smem + D_AT);  // [parities][L][S]
  uint32_t* out = smem + O_AT;       // [L lanes][4][S], natural order
  uint32_t* ibuf = smem + I_AT;      // [L lanes][4][S]

  int lane, t, wt, part = 0;         // wt + k WK: the word of register k
  size_t b;
  // the cluster addresses of this block's shared memory in the other
  // lane's block of the same part (peer), and in this lane's P blocks
  // (at[0 .. P), N >= 8192)
  uint32_t peer = 0u;
  uint32_t at[P] = {};
  if constexpr (PART) {
    const int rank = cluster_rank();
    lane = rank / P;
    part = rank % P;
    t = part * kThreads<LOGN> + threadIdx.x;
    wt = threadIdx.x;
    b = blockIdx.x / kBlocks<LOGN>;
    peer = peer_address(smem, rank ^ P);
#pragma unroll
    for (int i = 0; i < P; ++i) at[i] = peer_address(smem, lane * P + i);
  } else if constexpr (CL) {
    lane = cluster_rank();
    t = wt = threadIdx.x;
    b = blockIdx.x / 2;
    peer = peer_address(smem, lane ^ 1);
  } else {
    lane = threadIdx.x / TG;                // TG >= 32: a warp is in one lane
    t = wt = threadIdx.x % TG;
    b = blockIdx.x;
  }
  const int slot = CL ? 0 : lane;           // the lane's place in this block's buffers
  const int d2 = 2 * digits;
  const uint32_t q = lane ? q2 : q1;
  const uint32_t* fw = tw + lane * 4 * N;
  const uint32_t* fws = fw + N;
  const uint32_t* iw = fw + 2 * N;
  const uint32_t* iws = fw + 3 * N;
  const uint32_t red_sh = __ldg(fws);       // floor(2^32 / q)
  const uint64_t Q = uint64_t(q1) * q2;
  const uint64_t half_Q = Q >> 1;
  uint32_t* my_acc = acc + slot * 2 * S;
  uint32_t* my_out = out + slot * 4 * S;
  // coefficient (polynomial, index) of word i of a block's [2][S]
  // accumulator: at N >= 8192 the block's words are those whose bits
  // 9 .. 8 + log2 P are its part
  auto coef = [&](int i) {
    if constexpr (PART)
      return (i / S) * N + ((((i >> 9) & 7) << (9 + dsmem::kRankBits<P>)) | (part << 9) |
                            (i & 511));
    else
      return i;
  };
  // the cluster address of this block's word `w` in the lane's block that
  // holds coefficient c (bits 9 .. 8 + log2 P of c), N >= 8192
  auto holder = [&](int c, int w) -> uint32_t {
    const int i = (c >> 9) & (P - 1);
    if constexpr (P == 4)
      return (i & 2 ? (i & 1 ? at[3] : at[2]) : (i & 1 ? at[1] : at[0])) + 4 * w;
    else if constexpr (P == 2)
      return (i ? at[1] : at[0]) + 4 * w;
    else
      return 0u;
  };

  // fresh(t) is t read anew from shared memory: the addresses each NTT makes
  // from it are made where it runs, not kept in registers from another
  // transform that made the same ones
  __shared__ int zero;
  auto fresh = [&](int v) { return v + *static_cast<volatile int*>(&zero); };

  if (threadIdx.x == 0) zero = 0;
  if constexpr (CL) {
    const uint32_t* in = (lane ? acc2_in : acc1_in) + b * 2 * N;
    for (int i = threadIdx.x; i < 2 * S; i += kThreads<LOGN>) acc[i] = in[coef(i)];
    cluster_sync();
  } else {
    for (int i = threadIdx.x; i < 2 * N; i += 2 * TG) {
      acc[i] = acc1_in[b * 2 * N + i];
      acc[2 * N + i] = acc2_in[b * 2 * N + i];
    }
    __syncthreads();
  }

  // the lazy sums of digits before the last wait in the inverse's buffer,
  // among the 256 words per polynomial that the warp's own first exchange of
  // the inverse writes: register k at word 32k + (wt mod 32), so one base and
  // constant offsets address all of them
  uint32_t* sums = ibuf + slot * 4 * S + 8 * (wt & ~31) + (wt & 31);

  for (int r = 0; r < n; ++r) {
    const uint32_t* key = bsk + ((size_t)r * 8 * d2 + lane * 4 * d2) * N + 8 * t;

    // Garner CRT x = r2 + q2 ((r1 - r2) q2^-1 mod q1) of coefficient
    // t + k N/8 of polynomial `lane` (each lane's threads take one of the
    // two), centred, the thrown digits dropped
    int64_t d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = lane * S + wt + k * WK;
      uint32_t r1, r2;
      if constexpr (CL) {  // this lane's residue here, the other's in the peer
        const uint32_t own = acc[j], other = ld_peer(peer + 4 * j);
        r1 = lane ? other : own;
        r2 = lane ? own : other;
      } else {
        r1 = acc[j];
        r2 = acc[2 * N + j];
      }
      const uint32_t diff = r1 >= r2 ? r1 - r2 : r1 + q1 - r2;
      const uint32_t c = csub(mulmod_lazy(diff, c12, c12_sh, q1), q1);
      const uint64_t xv = uint64_t(r2) + uint64_t(q2) * c;
      int64_t v = xv >= half_Q ? int64_t(xv) - int64_t(Q) : int64_t(xv);
      for (int i = 0; i < throw_digits; ++i) extract(v, g_bits);
      d[k] = v;
    }

    // digit l of both polynomials, through shared memory into this lane,
    // then the lane's forward NTT of the two: x[o][k] at point 8t + k
    auto digit_forward = [&](int l, uint32_t (&x)[2][8]) {
      const int par = PART ? 0 : (l & 1) * L * S;   // one buffer at N >= 8192
      int32_t* dg = digs + par;
#pragma unroll
      for (int k = 0; k < 8; ++k) dg[slot * S + wt + k * WK] = int32_t(extract(d[k], g_bits));
      if constexpr (CL) {
        cluster_sync();
        // this lane's polynomial here, the other one in the peer
        const uint32_t pdg = peer + 4 * (D_AT + par);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int32_t own = dg[wt + k * WK];
          const int32_t other = int32_t(ld_peer(pdg + 4 * (wt + k * WK)));
          const int32_t r0 = lane ? other : own, r1 = lane ? own : other;
          x[0][k] = r0 < 0 ? uint32_t(r0 + int32_t(q)) : uint32_t(r0);
          x[1][k] = r1 < 0 ? uint32_t(r1 + int32_t(q)) : uint32_t(r1);
        }
      } else {
        __syncthreads();
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int32_t rr = dg[o * N + t + k * TG];
            x[o][k] = rr < 0 ? uint32_t(rr + int32_t(q)) : uint32_t(rr);
          }
      }
      if constexpr (PART) {
        // group 0 here, its exchange to group 1 across the lane's P blocks
        rntt::fwd_pass<LOGN, 0, 2>(x, fresh(t), fw, fws, q);
        uint32_t x_at[P];
#pragma unroll
        for (int i = 0; i < P; ++i) x_at[i] = at[i] + 4 * X_AT;
        dsmem::cross_forward(x, smem + X_AT, x_at, fresh(t));
        rntt::forward<LOGN, 1, 2, S>(x, fbuf, fresh(t), fw, fws, q);
      } else {
        rntt::forward<LOGN, 0, 2>(x, fbuf + slot * 2 * N, fresh(t), fw, fws, q);
      }
    };
    // the lazy external product of digit l for output ko = key*2 + out:
    // p[k] = sum_j x_j K[key][out][2l + j] at point 8t + k, < 4q
    auto product = [&](int l, int ko, const uint32_t (&x)[2][8], uint32_t (&p)[8]) {
      const uint32_t* ks = key + (size_t)(ko * d2 + 2 * l) * N;
      const uint4 a0 = rntt::ld_global4(ks), a1 = rntt::ld_global4(ks + 4);
      const uint4 b0 = rntt::ld_global4(ks + N), b1 = rntt::ld_global4(ks + N + 4);
      const uint32_t s0[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t s1[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t v0 = __umulhi(s0[k] + 1, q), v1 = __umulhi(s1[k] + 1, q);
        p[k] = mulmod_lazy(x[0][k], v0, s0[k], q) + mulmod_lazy(x[1][k], v1, s1[k], q);
      }
    };

    for (int l = 0; l + 1 < digits; ++l) {
      uint32_t x[2][8];
      digit_forward(l, x);
#pragma unroll
      for (int ko = 0; ko < 4; ++ko) {
        uint32_t p[8];
        product(l, ko, x, p);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          uint32_t* sp = sums + ko * S + 32 * k;
          *sp = l == 0 ? p[k] : *sp + p[k];
        }
      }
    }
    uint32_t u[4][8];
    {
      const int l = digits - 1;
      uint32_t x[2][8];
      digit_forward(l, x);
#pragma unroll
      for (int ko = 0; ko < 4; ++ko) {
        uint32_t p[8];
        product(l, ko, x, p);
#pragma unroll
        for (int k = 0; k < 8; ++k) u[ko][k] = l == 0 ? p[k] : sums[ko * S + 32 * k] + p[k];
      }
    }

    // one Shoup reduction of the lazy sums (< 2^32) to [0, 2q), then the
    // inverse NTT of the four polynomials, N^-1 folded in
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) u[ko][k] -= __umulhi(u[ko][k], red_sh) * q;
    if constexpr (PART) {
      // groups 4 .. 1 in the block's part, the exchange to group 0 across
      // the lane's P blocks
      rntt::inverse<LOGN, G - 1, 4, S, 1>(u, ibuf, fresh(t), iw, iws, q);
      uint32_t i_at[P];
#pragma unroll
      for (int i = 0; i < P; ++i) i_at[i] = at[i] + 4 * I_AT;
      dsmem::cross_inverse(u, ibuf, i_at, fresh(t));
      rntt::inv_pass<LOGN, 0, 4>(u, fresh(t), iw, iws, q);
    } else {
      rntt::inverse<LOGN, G - 1, 4>(u, ibuf + slot * 4 * N, fresh(t), iw, iws, q);
    }

    // a[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o]: write the inverse's
    // output once, read it rotated. In one block it overwrites the other
    // lane's forward buffer and digits: below N = 512 no exchange of the
    // inverse was block-wide, so wait here for the other lane to be done
    // with them. (A cluster's block has its own output buffer at N = 4096;
    // at N >= 8192 it lies over the crossing's and the forward's buffers,
    // which the inverse's crossing barrier has freed.)
    if constexpr (LOGN < 9) __syncthreads();
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[ko][k] = csub(u[ko][k], q);
        my_out[ko * S + wt + k * WK] = u[ko][k];
      }
    if constexpr (PART)
      cluster_sync();  // the rotated reads cross the lane's P blocks
    else
      __syncthreads();
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    // the output's coefficient c of polynomial ko: at N >= 8192 in the
    // lane's block whose part is bits 9 .. 8 + log2 P of c
    auto output = [&](int ko, int c) -> uint32_t {
      if constexpr (PART)
        return ld_peer(holder(c, O_AT + ko * S + drop_rank<P>(c)));
      else
        return my_out[ko * N + c];
    };
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = t + k * TG;
        const int r0 = (j - m_pos) & (2 * N - 1);
        const int r1 = (j - m_neg) & (2 * N - 1);
        const uint32_t c0 = output(o, r0 & (N - 1));
        const uint32_t c1 = output(2 + o, r1 & (N - 1));
        const uint32_t v0 = r0 < N ? c0 : q - c0;  // in [0, q]
        const uint32_t v1 = r1 < N ? c1 : q - c1;
        uint32_t* a = my_acc + o * S + wt + k * WK;
        uint32_t s = *a + v0 + (q - u[o][k]) + v1 + (q - u[2 + o][k]);
        s = csub(csub(csub(s, 4 * q), 2 * q), q);  // s < 5q
        *a = s;
      }
    if constexpr (CL)
      cluster_sync();  // the next CRT reads the peer's accumulator
    else
      __syncthreads();
  }

  if constexpr (CL) {
    uint32_t* dst = (lane ? acc2_out : acc1_out) + b * 2 * N;
    for (int i = threadIdx.x; i < 2 * S; i += kThreads<LOGN>) dst[coef(i)] = acc[i];
  } else {
    for (int i = threadIdx.x; i < 2 * N; i += 2 * TG) {
      acc1_out[b * 2 * N + i] = acc[i];
      acc2_out[b * 2 * N + i] = acc[2 * N + i];
    }
  }
}

// Dynamic shared memory of a block: 80 N bytes, 56 N in a two-block
// cluster, 11 S words (S = N / P) in a four- or eight-block one: 176 KB.
template <int LOGN>
constexpr size_t smem_bytes() {
  constexpr size_t N = size_t(1) << LOGN;
  return (kBlocks<LOGN> >= 4 ? 11 * N / kLaneBlocks<LOGN> : kBlocks<LOGN> == 2 ? 14 * N
                                                                              : 20 * N) *
         sizeof(uint32_t);
}

template <int LOGN>
cudaError_t launch(const void* acc1_in, const void* acc2_in, void* acc1_out,
                   void* acc2_out, const void* a_idx, const void* bsk,
                   const void* tw, int B, int n, unsigned q1, unsigned q2,
                   unsigned c12, unsigned c12_sh, int g_bits, int digits,
                   int throw_digits, cudaStream_t stream) {
  const size_t smem = smem_bytes<LOGN>();
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_rns_kernel<LOGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const auto a1i = static_cast<const uint32_t*>(acc1_in);
  const auto a2i = static_cast<const uint32_t*>(acc2_in);
  const auto a1o = static_cast<uint32_t*>(acc1_out);
  const auto a2o = static_cast<uint32_t*>(acc2_out);
  const auto idx = static_cast<const int32_t*>(a_idx);
  const auto key = static_cast<const uint32_t*>(bsk);
  const auto twd = static_cast<const uint32_t*>(tw);
  if constexpr (kBlocks<LOGN> > 1) {
    dsmem::ClusterLaunch cl(kBlocks<LOGN>, B, kThreads<LOGN>, smem, stream);
    err = cudaLaunchKernelEx(&cl.cfg, blind_rotate_rns_kernel<LOGN>, a1i, a2i, a1o, a2o, idx,
                             key, twd, n, (uint32_t)q1, (uint32_t)q2, (uint32_t)c12,
                             (uint32_t)c12_sh, g_bits, digits, throw_digits);
    if (err != cudaSuccess) return err;
  } else {
    blind_rotate_rns_kernel<LOGN><<<B, kThreads<LOGN>, smem, stream>>>(
        a1i, a2i, a1o, a2o, idx, key, twd, n, q1, q2, c12, c12_sh, g_bits, digits,
        throw_digits);
  }
  return cudaGetLastError();
}

template <int LOGN>
cudaError_t clusters_of(int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_rns_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<LOGN>());
  if (err != cudaSuccess) return err;
  dsmem::ClusterLaunch cl(kBlocks<LOGN>, 1, kThreads<LOGN>, smem_bytes<LOGN>(), 0);
  return cudaOccupancyMaxActiveClusters(clusters, blind_rotate_rns_kernel<LOGN>, &cl.cfg);
}

}  // namespace

// acc*_in/acc*_out [B][2][N], a_idx [B][n] int32, bsk [n][8*d2][N],
// tw [2][4][N]. Returns the launch's cudaError_t (0 on success).
extern "C" int tfhe_blind_rotate_rns(const void* acc1_in, const void* acc2_in,
                                     void* acc1_out, void* acc2_out,
                                     const void* a_idx, const void* bsk,
                                     const void* tw, int B, int N, int n,
                                     unsigned q1, unsigned q2, unsigned c12,
                                     unsigned c12_sh, int g_bits, int digits,
                                     int throw_digits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 256:
      return launch<8>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 512:
      return launch<9>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 1024:
      return launch<10>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 2048:
      return launch<11>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 4096:
      return launch<12>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 8192:
      return launch<13>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    case 16384:
      return launch<14>(acc1_in, acc2_in, acc1_out, acc2_out, a_idx, bsk, tw, B, n, q1, q2, c12, c12_sh, g_bits, digits, throw_digits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of the ring-N cluster kernel (N = 4096, 8192 or 16384) the
// card holds at once (cudaOccupancyMaxActiveClusters), in *clusters. Returns
// the cudaError_t; cudaErrorInvalidValue for a ring without a cluster layout.
extern "C" int tfhe_blind_rotate_rns_clusters(int N, int* clusters) {
  switch (N) {
    case 4096:
      return clusters_of<12>(clusters);
    case 8192:
      return clusters_of<13>(clusters);
    case 16384:
      return clusters_of<14>(clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
