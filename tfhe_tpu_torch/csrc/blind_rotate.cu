// Batched CGGI blind rotation for Hopper (sm_90a), single 32-bit limb,
// Q < 2^28 and (2Q - 1) * d2 < 2^32.
//
// Replaces the Pallas TPU kernel tfhe_tpu/ops/pallas_rotate.py:build_pallas_rotate
// and computes what it computes, bit for bit: for each of n rounds, the signed
// base-G digits of the accumulator (numDigitsToThrow dropped), their forward
// negacyclic NTT, the lazy external product with the round's +s and -s RGSW
// keys, one reduction, the inverse NTT, the (X^a - 1) and (X^-a - 1)
// monomials, and the accumulation. Every step is exact modular arithmetic, so
// the result equals the plain torch version (tfhe_tpu_torch/ops/blindrotate.py)
// and the JAX package exactly.
//
// Design. One thread block of N/8 threads owns one ciphertext for all n
// rounds; the loop over rounds inside the block replaces the TPU's sequential
// `rounds` grid axis. A thread owns 8 coefficients of each polynomial,
// coefficient t + k N/8 of thread t, keeps those of the accumulator in
// registers for all rounds, and runs the NTTs in registers
// (register_ntt.cuh): merged twiddles, so no twist or untwist pass, N^-1
// folded into the inverse's last stage, three radix-2 stages per register
// group (3 + 3 + 3 + 1 at N = 1024) with one block-wide exchange through
// swizzled, conflict-free shared memory per transform. A round:
// - each thread centres its 16 coefficients (x >= Q/2 is negative), drops
//   the thrown digits once and keeps the rest in int32 registers; a thread
//   holds both polynomials' coefficients, so digits need no exchange;
// - per kept digit: one balanced digit of the 16, the forward NTT of the
//   pair, and the lazy external product on the thread's 8 consecutive
//   evaluation points (a warp reads 1 KB of each key row, in 16-byte
//   loads). The key is read only in its companion rows b' (pack_bsk's
//   layout keeps values and companions; the values are not read) and each
//   value is rebuilt as hi32((b' + 1) Q), which halves the key stream. The
//   sums of the digits before the last wait in shared memory, which frees
//   32 registers during the NTTs;
// - the sums (< (2Q - 1) d2 < 2^32) reduced by one Shoup product with the
//   companion of 1, the inverse NTT of the four, its output written once
//   and read back rotated for the monomials, the accumulation (< 5Q)
//   reduced by three conditional subtractions. No runtime `%`.
// Barriers per round at N >= 512: one per digit (the forward's block-wide
// exchange), one for the inverse's, two around the monomials: 7 at d2 = 8
// (about 61 before). At N = 256 a block is one warp. Shared memory: the
// forward's buffer [2][2][N], double-buffered by digit parity because the
// next digit's block-wide exchange would otherwise overwrite words a slower
// warp still reads in this digit's warp-local ones, and the inverse's buffer
// [4][N], which also holds the waiting sums and the inverse's output: 32 N
// bytes, 32 KB at N = 1024, so 512 threads per SM and at most 128 registers
// a thread (__launch_bounds__(N/8, 4096/N) at every N; ptxas: 125-128, no
// spills). N = 4096 needs no other layout: one block of 512 threads and
// 128 KB, the register NTT at 12 index bits (two block-wide exchanges per
// transform, register_ntt.cuh).
//
// N = 8192: one block would need 1024 threads at 128 registers (twice an
// SM's 65,536) and 256 KB of shared memory, so a ciphertext runs on a
// cluster of two blocks of 512 threads (csrc/cluster.cuh). Logical thread
// t = rank * 512 + threadIdx.x keeps the registers and the ownership it has
// in one block; the register NTT has five groups (C = 12, 9, 6, 3, 2), and
// rank, thread bit 9, is bit 9 of j in group 0 and bit 12 in groups 1-4. So
// only the exchange between groups 0 and 1 crosses the cluster, once per
// digit in the forward and once in the inverse: the writer stores its
// values in its own shared memory (the half of the words whose owner bit,
// 9 or 12, is its rank), a cluster barrier, and each thread reads its eight
// words with ld.shared::cluster, four from each block (register k from
// block k / 4). The other exchanges stay in the block's half of the buffer.
// In group 4 each block holds the half of the points with bit 12 = rank,
// so it reads the contiguous half of every key row: no key word is read
// twice. The monomial step reads the inverse's output rotated by any m,
// about half of it from the peer. Shared memory per block: the crossing's
// buffer [2 parities][2][N/2], the block's forward buffer [2][N/2], the
// inverse's buffer [4][N/2] (with the waiting sums) and the output
// [4][N/2]: 28 N = 224 KB. Cluster barriers per round: one per kept digit,
// one in the inverse, one between writing the output and reading it
// rotated. The hazards and what guards them:
// - the crossing's buffer: digit c of the run (counted across rounds) is
//   written before barrier c and read after it; the next write of the same
//   parity, c + 2, comes after barrier c + 1, which the peer passes only
//   when its reads of c are done. One buffer would let a block overwrite
//   words its peer still reads. Between rounds the inverse's and the
//   output's barriers come between two digits as well, so a parity of l
//   alone would also be safe; the count is kept for symmetry with
//   blind_rotate64.cu;
// - the inverse's crossing writes the words the block's own 2 -> 1
//   exchange read (a __syncwarp suffices), and the peer reads them after
//   the barrier; the output goes to a buffer of its own, since writing it
//   over the inverse's buffer would overwrite words the peer still reads
//   in that crossing. The next round writes the output again only after a
//   crossing barrier of its forward, and its sums and inverse go to the
//   inverse's buffer, which the peer last read before the output barrier;
// - a block must not leave while its peer may read its shared memory: the
//   kernel ends with a cluster barrier.
// The emulation in tests/test_torch_rotate_merged.py keeps the two blocks'
// shared memory apart and lets one run ahead to each cluster barrier;
// there one forward buffer, the output over the inverse's buffer, or no
// final barrier each give a wrong result.
//
// As in blind_rotate_rns.cu, twiddles and keys are read with
// coherent loads and each transform takes the thread index anew from shared
// memory, so that ptxas does not hoist one transform's loads or addresses
// into another's registers.
//
// What bounds it: the work is 32-bit integer multiplies. The function needs,
// per ciphertext and round at N = 1024, d2 = 8, 94208 lazy Shoup products
// (three multiplies each): the digits' forward NTTs, the external product and
// the inverse NTT. At STD128 and B = 4096 the bound (multiplies over 132 SMs
// x 64 lanes x the 1980 MHz maximum SM clock, chip_smoke.py) is 35.4 ms. The
// kernel adds 32768 key values rebuilt (one multiply each) and 4096
// reductions (two each). The key stream is 128 KB per ciphertext and round,
// 275 GB through L2 per launch at that shape; the 134 MB key does not fit the
// 50 MB L2, and resident blocks walk the rounds close enough in step that
// device memory sees about one key per wave.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_profile_gate.py
// --kernel-only): 121.1 ms at B = 4096, n = 512, d2 = 8, 29.3% of the bound;
// the earlier design (every NTT stage through shared memory, separate twist
// and untwist passes, values and companions read, runtime `%`, ~61 barriers
// a round) took 245.621 ms, 14.4%. What holds it there is reckoned (ncu does
// not run where it was measured): beside its multiplies each butterfly
// issues about as many additions, selections and shared-memory addresses,
// and 16 warps a SM leave the rest as stalls. Whether the key stream through
// L2 binds is not measured.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "register_ntt.cuh"

namespace {

using dsmem::cluster_sync;
using dsmem::cross_forward;
using dsmem::cross_inverse;
using dsmem::drop_rank;
using dsmem::ld_peer;
using rntt::csub;
using rntt::mulmod_lazy;

// A ciphertext on a cluster of two blocks (N = 8192), or on one block.
template <int LOGN>
constexpr bool kCluster = LOGN > 12;

template <int LOGN>
constexpr int kThreads = (1 << LOGN) / (kCluster<LOGN> ? 16 : 8);

// Balanced base-2^g_bits digit of d; d becomes (d - digit) >> g_bits.
__device__ __forceinline__ int32_t extract(int32_t& d, int g_bits) {
  const int32_t base = int32_t(1) << g_bits;
  int32_t r = d & (base - 1);
  if (r >= (base >> 1)) r -= base;
  d = (d - r) >> g_bits;
  return r;
}

// acc: [B][2][N] residues mod Q. bsk: [n][8*d2][N] u32, row
// ((vs*2 + key)*2 + out)*d2 + 2l + j, vs 0 = value / 1 = Shoup companion,
// points in the forward NTT's order; only vs = 1 is read. tw: [4][N] rows
// fwd, fwd', inv, inv' (register_ntt.cuh; x' = Shoup companion); fwd[0] = 1,
// so fwd'[0] = floor(2^32 / Q) reduces the lazy sums. g_bits <= 28: a larger
// base gives the same digits (|x| < 2^27 is one digit). With kCluster,
// blocks 2b and 2b + 1 of the grid (one cluster) run ciphertext b.
template <int LOGN>
__global__ void __launch_bounds__(kThreads<LOGN>, kCluster<LOGN> ? 1 : 4096 >> LOGN)
blind_rotate_kernel(const uint32_t* __restrict__ acc_in,
                    uint32_t* __restrict__ acc_out,
                    const int32_t* __restrict__ a_idx,
                    const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tw, int n, uint32_t Q,
                    int g_bits, int digits, int throw_digits) {
  constexpr int N = 1 << LOGN;
  constexpr int TG = N / 8;                 // threads per polynomial
  constexpr int G = rntt::groups<LOGN>();
  constexpr bool CL = kCluster<LOGN>;
  constexpr int S = CL ? N / 2 : N;         // words a polynomial in a block
  extern __shared__ __align__(16) uint32_t smem[];
  // one block: fbuf [2 parities][2][N] and ibuf [4][N], swizzled, ibuf
  // also the inverse's output [4][N] in natural order. A cluster's block:
  // xbuf [2 parities][2][S] (the crossing), fbuf [2][S], ibuf [4][S] and
  // obuf [4][S] (the output), each the block's half of the words
  uint32_t* xbuf = smem;
  uint32_t* fbuf = CL ? smem + 4 * S : smem;
  uint32_t* ibuf = CL ? smem + 6 * S : smem + 4 * N;
  uint32_t* obuf = CL ? smem + 10 * S : ibuf;

  int t;
  size_t b;
  // the cluster address of this block's shared memory in either block
  uint32_t at[2] = {0u, 0u};
  if constexpr (CL) {
    const int rank = dsmem::cluster_rank();
    t = rank * (N / 16) + threadIdx.x;
    b = blockIdx.x / 2;
    at[0] = dsmem::peer_address(smem, 0);
    at[1] = dsmem::peer_address(smem, 1);
  } else {
    t = threadIdx.x;
    b = blockIdx.x;
  }
  const int d2 = 2 * digits;
  const uint32_t* fw = tw;
  const uint32_t* fws = tw + N;
  const uint32_t* iw = tw + 2 * N;
  const uint32_t* iws = tw + 3 * N;
  const uint32_t red_sh = __ldg(fws);       // floor(2^32 / Q)
  const uint32_t half_q = Q >> 1;

  // fresh(t) is t read anew from shared memory: the addresses each NTT makes
  // from it are made where it runs, not kept in registers from another
  // transform that made the same ones
  __shared__ int zero;
  auto fresh = [&](int v) { return v + *static_cast<volatile int*>(&zero); };

  // the accumulator stays in registers: coefficient t + k N/8 of
  // polynomial o in acc[o][k]
  uint32_t acc[2][8];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[o][k] = acc_in[b * 2 * N + o * N + t + k * TG];
  if (threadIdx.x == 0) zero = 0;
  __syncthreads();

  // the lazy sums of digits before the last wait in the inverse's buffer,
  // among the 256 words per polynomial that the warp's own first exchange of
  // the inverse writes: register k at word 32k + (t mod 32), so one base and
  // constant offsets address all of them
  uint32_t* sums = ibuf + 8 * (threadIdx.x & ~31) + (threadIdx.x & 31);

  for (int r = 0; r < n; ++r) {
    const uint32_t* key = bsk + ((size_t)r * 8 * d2 + 4 * d2) * N + 8 * t;

    // the accumulator centred, the thrown digits dropped
    int32_t d[2][8];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t a = acc[o][k];
        int32_t v = a < half_q ? int32_t(a) : int32_t(a) - int32_t(Q);
        for (int i = 0; i < throw_digits; ++i) extract(v, g_bits);
        d[o][k] = v;
      }

    // digit l of both polynomials and their forward NTT: x[o][k] at point
    // 8t + k
    auto digit_forward = [&](int l, uint32_t (&x)[2][8]) {
#pragma unroll
      for (int o = 0; o < 2; ++o)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int32_t rr = extract(d[o][k], g_bits);
          x[o][k] = rr < 0 ? uint32_t(rr + int32_t(Q)) : uint32_t(rr);
        }
      if constexpr (CL) {
        const int par = (r * digits + l) & 1;
        rntt::fwd_pass<LOGN, 0, 2>(x, fresh(t), fw, fws, Q);
        const uint32_t x_at[2] = {at[0] + 8 * S * par, at[1] + 8 * S * par};
        cross_forward(x, xbuf + 2 * S * par, x_at, fresh(t));
        rntt::forward<LOGN, 1, 2, S>(x, fbuf, fresh(t), fw, fws, Q);
      } else {
        rntt::forward<LOGN, 0, 2>(x, fbuf + (l & 1) * 2 * N, fresh(t), fw, fws, Q);
      }
    };
    // the lazy external product of digit l for output ko = key*2 + out:
    // p[k] = sum_j x_j K[key][out][2l + j] at point 8t + k, < 4Q
    auto product = [&](int l, int ko, const uint32_t (&x)[2][8], uint32_t (&p)[8]) {
      const uint32_t* ks = key + (size_t)(ko * d2 + 2 * l) * N;
      const uint4 a0 = rntt::ld_global4(ks), a1 = rntt::ld_global4(ks + 4);
      const uint4 b0 = rntt::ld_global4(ks + N), b1 = rntt::ld_global4(ks + N + 4);
      const uint32_t s0[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t s1[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t v0 = __umulhi(s0[k] + 1, Q), v1 = __umulhi(s1[k] + 1, Q);
        p[k] = mulmod_lazy(x[0][k], v0, s0[k], Q) + mulmod_lazy(x[1][k], v1, s1[k], Q);
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

    // one Shoup reduction of the lazy sums (< 2^32) to [0, 2Q), then the
    // inverse NTT of the four polynomials, N^-1 folded in
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) u[ko][k] -= __umulhi(u[ko][k], red_sh) * Q;
    if constexpr (CL) {
      rntt::inverse<LOGN, G - 1, 4, S, 1>(u, ibuf, fresh(t), iw, iws, Q);
      const uint32_t i_at[2] = {at[0] + 24 * S, at[1] + 24 * S};
      cross_inverse(u, ibuf, i_at, fresh(t));
      rntt::inv_pass<LOGN, 0, 4>(u, fresh(t), iw, iws, Q);
    } else {
      rntt::inverse<LOGN, G - 1, 4>(u, ibuf, fresh(t), iw, iws, Q);
    }

    // acc[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o]: write the
    // inverse's output once, in one block over its buffer when every thread
    // has read its last exchange, and read it rotated. In a cluster each
    // block writes the coefficients of its group-0 registers (bit 9 of j is
    // its rank) to its own output buffer, and reads the rotated ones from
    // the block that holds them.
    if constexpr (!CL) __syncthreads();
#pragma unroll
    for (int ko = 0; ko < 4; ++ko)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[ko][k] = csub(u[ko][k], Q);
        obuf[ko * S + (CL ? drop_rank<2>(t + k * TG) : t + k * TG)] = u[ko][k];
      }
    if constexpr (CL)
      cluster_sync();
    else
      __syncthreads();
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    // the output's coefficient c of polynomial ko
    auto output = [&](int ko, int c) -> uint32_t {
      if constexpr (CL)
        return ld_peer(((c >> 9) & 1 ? at[1] : at[0]) + 4 * (10 * S + ko * S + drop_rank<2>(c)));
      else
        return obuf[ko * N + c];
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
        const uint32_t v0 = r0 < N ? c0 : Q - c0;  // in [0, Q]
        const uint32_t v1 = r1 < N ? c1 : Q - c1;
        const uint32_t s = acc[o][k] + v0 + (Q - u[o][k]) + v1 + (Q - u[2 + o][k]);
        acc[o][k] = csub(csub(csub(s, 4 * Q), 2 * Q), Q);  // s < 5Q
      }
    // the next round's sums and inverse overwrite the output only after its
    // first forward's block-wide exchange (N >= 512; at N = 256 the block is
    // one warp and every exchange a __syncwarp); in a cluster the output is
    // written again only after the next round's first crossing barrier
  }
  // no block of a cluster leaves while its peer may still read it
  if constexpr (CL) cluster_sync();

#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_out[b * 2 * N + o * N + t + k * TG] = acc[o][k];
}

// Dynamic shared memory of a block: 32 N bytes, 28 N in a cluster.
template <int LOGN>
constexpr size_t smem_bytes() {
  return (kCluster<LOGN> ? 7 : 8) * (size_t(1) << LOGN) * sizeof(uint32_t);
}

template <int LOGN>
cudaError_t launch(const void* acc_in, void* acc_out, const void* a_idx,
                   const void* bsk, const void* tw, int B, int n, int Q,
                   int g_bits, int digits, int throw_digits,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<LOGN>();
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const auto acc_i = static_cast<const uint32_t*>(acc_in);
  const auto acc_o = static_cast<uint32_t*>(acc_out);
  const auto idx = static_cast<const int32_t*>(a_idx);
  const auto key = static_cast<const uint32_t*>(bsk);
  const auto twd = static_cast<const uint32_t*>(tw);
  const int gb = g_bits < 28 ? g_bits : 28;
  constexpr int threads = kThreads<LOGN>;
  if constexpr (kCluster<LOGN>) {
    dsmem::ClusterLaunch cl(2, B, threads, smem, stream);
    err = cudaLaunchKernelEx(&cl.cfg, blind_rotate_kernel<LOGN>, acc_i, acc_o, idx, key, twd,
                             n, (uint32_t)Q, gb, digits, throw_digits);
    if (err != cudaSuccess) return err;
  } else {
    blind_rotate_kernel<LOGN><<<B, threads, smem, stream>>>(
        acc_i, acc_o, idx, key, twd, n, (uint32_t)Q, gb, digits, throw_digits);
  }
  return cudaGetLastError();
}

}  // namespace

// acc_in/acc_out [B][2][N], a_idx [B][n] int32, bsk [n][8*d2][N], tw [4][N].
// Returns the launch's cudaError_t (0 on success).
extern "C" int tfhe_blind_rotate(const void* acc_in, void* acc_out,
                                 const void* a_idx, const void* bsk,
                                 const void* tw, int B, int N, int n, int Q,
                                 int g_bits, int digits, int throw_digits,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 256:
      return launch<8>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    case 512:
      return launch<9>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    case 1024:
      return launch<10>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    case 2048:
      return launch<11>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    case 4096:
      return launch<12>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    case 8192:
      return launch<13>(acc_in, acc_out, a_idx, bsk, tw, B, n, Q, g_bits, digits, throw_digits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The most clusters of the ring-N cluster kernel (N = 8192) the card holds
// at once (cudaOccupancyMaxActiveClusters), in *clusters. Returns the
// cudaError_t; cudaErrorInvalidValue for a ring without a cluster layout.
extern "C" int tfhe_blind_rotate_clusters(int N, int* clusters) {
  if (N != 8192) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<13>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<13>());
  if (err != cudaSuccess) return err;
  dsmem::ClusterLaunch cl(2, 1, kThreads<13>, smem_bytes<13>(), 0);
  return cudaOccupancyMaxActiveClusters(clusters, blind_rotate_kernel<13>, &cl.cfg);
}
