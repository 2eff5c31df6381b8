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
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "register_ntt.cuh"

namespace {

using dsmem::cluster_rank;
using dsmem::cluster_sync;
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

// The kernel runs as clusters of two one-lane blocks at N = 4096, as one
// two-lane block per ciphertext below.
template <int LOGN>
constexpr bool kCluster = LOGN > 11;

// acc1/acc2: [B][2][N] residues mod q1 / q2. bsk: [n][8*d2][N] u32, rows
// lane*4*d2 + (key*2 + out)*d2 + 2l + j, Shoup companions only, points in
// the forward NTT's order. tw: [2 lanes][4][N] rows fwd, fwd', inv, inv'
// (register_ntt.cuh; x' = Shoup companion); fwd[0] = 1, so fwd'[0] =
// floor(2^32 / q) reduces the lazy sums. With kCluster, block 2b + lane of
// the grid runs lane `lane` of ciphertext b.
template <int LOGN>
__global__ void __launch_bounds__((1 << LOGN) / (LOGN > 11 ? 8 : 4),
                                  LOGN > 11 ? 1 : 2048 >> LOGN)
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
  constexpr bool CL = kCluster<LOGN>;
  constexpr int L = CL ? 1 : 2;             // lanes in this block
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* acc = smem;              // [L lanes][2][N], natural order
  uint32_t* fbuf = acc + 2 * L * N;  // [L lanes][2][N], swizzled
  int32_t* digs = reinterpret_cast<int32_t*>(fbuf + 2 * L * N);  // [2 parities][L][N]
  uint32_t* out = CL ? fbuf + 4 * N  // the inverse's output [L lanes][4][N],
                     : fbuf;         // natural order; in one block over fbuf and digs
  uint32_t* ibuf = out + 4 * L * N;  // [L lanes][4][N], swizzled

  int lane, t;
  size_t b;
  if constexpr (CL) {
    lane = cluster_rank();
    t = threadIdx.x;
    b = blockIdx.x / 2;
  } else {
    lane = threadIdx.x / TG;                // TG >= 32: a warp is in one lane
    t = threadIdx.x % TG;
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
  uint32_t* my_acc = acc + slot * 2 * N;
  uint32_t* my_out = out + slot * 4 * N;
  // the peer block's shared memory (cluster address of its first word)
  const uint32_t peer = CL ? peer_address(smem, lane ^ 1) : 0u;

  // fresh(t) is t read anew from shared memory: the addresses each NTT makes
  // from it are made where it runs, not kept in registers from another
  // transform that made the same ones
  __shared__ int zero;
  auto fresh = [&](int v) { return v + *static_cast<volatile int*>(&zero); };

  if (threadIdx.x == 0) zero = 0;
  if constexpr (CL) {
    const uint32_t* in = lane ? acc2_in : acc1_in;
    for (int i = threadIdx.x; i < 2 * N; i += TG) acc[i] = in[b * 2 * N + i];
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
  // the inverse writes: register k at word 32k + (t mod 32), so one base and
  // constant offsets address all of them
  uint32_t* sums = ibuf + slot * 4 * N + 8 * (t & ~31) + (t & 31);

  for (int r = 0; r < n; ++r) {
    const uint32_t* key = bsk + ((size_t)r * 8 * d2 + lane * 4 * d2) * N + 8 * t;

    // Garner CRT x = r2 + q2 ((r1 - r2) q2^-1 mod q1) of coefficient
    // t + k N/8 of polynomial `lane` (each lane's threads take one of the
    // two), centred, the thrown digits dropped
    int64_t d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = lane * N + t + k * TG;
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
      int32_t* dg = digs + (l & 1) * L * N;
#pragma unroll
      for (int k = 0; k < 8; ++k) dg[slot * N + t + k * TG] = int32_t(extract(d[k], g_bits));
      if constexpr (CL) {
        cluster_sync();
        // this lane's polynomial here, the other one in the peer
        const uint32_t pdg = peer + 4 * (4 * N + (l & 1) * N);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int32_t own = dg[t + k * TG];
          const int32_t other = int32_t(ld_peer(pdg + 4 * (t + k * TG)));
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
      rntt::forward<LOGN, 0, 2>(x, fbuf + slot * 2 * N, fresh(t), fw, fws, q);
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
          uint32_t* sp = sums + ko * N + 32 * k;
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
        for (int k = 0; k < 8; ++k) u[ko][k] = l == 0 ? p[k] : sums[ko * N + 32 * k] + p[k];
      }
    }

    // one Shoup reduction of the lazy sums (< 2^32) to [0, 2q), then the
    // inverse NTT of the four polynomials, N^-1 folded in
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) u[ko][k] -= __umulhi(u[ko][k], red_sh) * q;
    rntt::inverse<LOGN, G - 1, 4>(u, ibuf + slot * 4 * N, fresh(t), iw, iws, q);

    // a[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o]: write the inverse's
    // output once, read it rotated. In one block it overwrites the other
    // lane's forward buffer and digits: below N = 512 no exchange of the
    // inverse was block-wide, so wait here for the other lane to be done
    // with them. (A cluster's block has its own output buffer.)
    if constexpr (LOGN < 9) __syncthreads();
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[ko][k] = csub(u[ko][k], q);
        my_out[ko * N + t + k * TG] = u[ko][k];
      }
    __syncthreads();
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = t + k * TG;
        const int r0 = (j - m_pos) & (2 * N - 1);
        const int r1 = (j - m_neg) & (2 * N - 1);
        const uint32_t c0 = my_out[o * N + (r0 & (N - 1))];
        const uint32_t c1 = my_out[(2 + o) * N + (r1 & (N - 1))];
        const uint32_t v0 = r0 < N ? c0 : q - c0;  // in [0, q]
        const uint32_t v1 = r1 < N ? c1 : q - c1;
        uint32_t s = my_acc[o * N + j] + v0 + (q - u[o][k]) + v1 + (q - u[2 + o][k]);
        s = csub(csub(csub(s, 4 * q), 2 * q), q);  // s < 5q
        my_acc[o * N + j] = s;
      }
    if constexpr (CL)
      cluster_sync();  // the next CRT reads the peer's accumulator
    else
      __syncthreads();
  }

  if constexpr (CL) {
    uint32_t* dst = lane ? acc2_out : acc1_out;
    for (int i = threadIdx.x; i < 2 * N; i += TG) dst[b * 2 * N + i] = acc[i];
  } else {
    for (int i = threadIdx.x; i < 2 * N; i += 2 * TG) {
      acc1_out[b * 2 * N + i] = acc[i];
      acc2_out[b * 2 * N + i] = acc[2 * N + i];
    }
  }
}

// Dynamic shared memory of a block: 80 N bytes, 56 N in a cluster.
template <int LOGN>
constexpr size_t smem_bytes() {
  return (kCluster<LOGN> ? 14 : 20) * (size_t(1) << LOGN) * sizeof(uint32_t);
}

template <int LOGN>
cudaError_t launch(const void* acc1_in, const void* acc2_in, void* acc1_out,
                   void* acc2_out, const void* a_idx, const void* bsk,
                   const void* tw, int B, int n, unsigned q1, unsigned q2,
                   unsigned c12, unsigned c12_sh, int g_bits, int digits,
                   int throw_digits, cudaStream_t stream) {
  const size_t N = size_t(1) << LOGN;
  const size_t smem = smem_bytes<LOGN>();
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_rns_kernel<LOGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (kCluster<LOGN>) {
    dsmem::PairLaunch cl(B, (1 << LOGN) / 8, smem, stream);
    err = cudaLaunchKernelEx(
        &cl.cfg, blind_rotate_rns_kernel<LOGN>,
        static_cast<const uint32_t*>(acc1_in), static_cast<const uint32_t*>(acc2_in),
        static_cast<uint32_t*>(acc1_out), static_cast<uint32_t*>(acc2_out),
        static_cast<const int32_t*>(a_idx), static_cast<const uint32_t*>(bsk),
        static_cast<const uint32_t*>(tw), n, (uint32_t)q1, (uint32_t)q2,
        (uint32_t)c12, (uint32_t)c12_sh, g_bits, digits, throw_digits);
    if (err != cudaSuccess) return err;
  } else {
    blind_rotate_rns_kernel<LOGN><<<B, N / 4, smem, stream>>>(
        static_cast<const uint32_t*>(acc1_in),
        static_cast<const uint32_t*>(acc2_in), static_cast<uint32_t*>(acc1_out),
        static_cast<uint32_t*>(acc2_out), static_cast<const int32_t*>(a_idx),
        static_cast<const uint32_t*>(bsk), static_cast<const uint32_t*>(tw), n,
        q1, q2, c12, c12_sh, g_bits, digits, throw_digits);
  }
  return cudaGetLastError();
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of the N = 4096 kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), in *clusters. Returns the cudaError_t.
extern "C" int tfhe_blind_rotate_rns_clusters(int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_rns_kernel<12>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<12>());
  if (err != cudaSuccess) return err;
  dsmem::PairLaunch cl(1, (1 << 12) / 8, smem_bytes<12>(), 0);
  return cudaOccupancyMaxActiveClusters(clusters, blind_rotate_rns_kernel<12>, &cl.cfg);
}
