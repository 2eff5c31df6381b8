// Batched CGGI blind rotation for Hopper (sm_90a) mod one ring modulus
// Q < 2^54 in native 64-bit integers: the big-Q classic sets (STD192,
// STD128Q, STD192Q and their _OPT rows, STD256 with its 29-bit Q) and the
// accelerated sets at the reference's single 54-bit prime.
//
// Replaces the Pallas TPU kernel
// tfhe_tpu/ops/pallas_rotate64.py:build_pallas_rotate64 and computes what it
// computes, bit for bit. Each of n rounds: the accumulator centred (x >= Q/2
// is negative), numDigitsToThrow balanced base-G digits dropped, each next
// digit pair through the forward negacyclic NTT, the lazy external product
// with the round's +s and -s RGSW keys, one exact reduction, the inverse
// NTT, the (X^a - 1) and (X^-a - 1) monomials and the accumulation. Every
// step is exact modular arithmetic, so the result equals the plain torch
// version (tfhe_tpu_torch/ops/blindrotate64.py) and the JAX package exactly.
//
// Design. As in blind_rotate.cu, one thread block owns one ciphertext for
// all n rounds, and the loop over rounds inside the block replaces the TPU's
// sequential `rounds` grid axis. The TPU's (lo, hi) u32-pair arithmetic
// (_mul64_full, _mulmod_shoup64_lazy, _csub, sra64) is plain 64-bit integer
// arithmetic here: a lazy Shoup product is a * w - __umul64hi(a, w') * Q in
// wrapping u64, in [0, 2Q) for any 64-bit a. Values stay below 2Q through
// the forward NTT; a digit's four external-product terms add two products
// each, so after d2/2 digits a sum is below 2Q * d2 < 2^62, and one Barrett
// step (the constant floor(2^(64+s) / Q), s = bits(Q) - 1, and one
// conditional subtract) makes it canonical before the inverse NTT, whose
// values stay below 2Q until the untwist. No 64-bit `%`, which the GPU
// emulates. Shared memory at N = 2048: the accumulator [2][N], one digit
// pair [2][N] and the four lazy sums [4][N], all u64: 128 KB, one block per
// SM. The twiddles and their companions ([8][N] u64, 128 KB) are read
// through the read-only cache. The key holds only the 64-bit companions b'
// (the layout of pack_bsk64, bit-reversed evaluation order); each value is
// rebuilt as hi64(b' Q) + (lo64(b' Q) != 0), which halves the key stream:
// 8 B x 4 d2 x N per round, 256 KB at d2 = 4.
//
// What bounds it: counted as 32-bit multiplies (the lo and hi halves of a
// 32x32 product counted apart, as for the other two kernels), a 64-bit
// Shoup product costs 15: 7 for the high word of the 128-bit a * w', 4
// each for the low words of a * w and q_hat * Q. A round at N = 2048 and
// d2 = 4 needs 122880 of those products per ciphertext (no separate twist
// or untwist with merged twiddles, no key values rebuilt in a layout that
// stores them), 1.84e6 multiplies. So it is bound by operations: at STD128Q
// (B = 4096, n = 1024) the bound over 132 SMs x 64 lanes x the 1980 MHz
// maximum SM clock is 462.2 ms, and the kernel took 1754.1 ms, 26% of it
// (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W), against 12-14% for
// the 32-bit kernels. That a 32x32 -> 64 product is one instruction
// (IMAD.WIDE.U32) where the count takes two may explain part of the gap;
// neither that nor what keeps the kernel at its share (one block per SM,
// barriers, shared-memory traffic) is measured.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 512;  // threads per block

__device__ __forceinline__ u64 mulmod_lazy(u64 a, u64 w, u64 w_sh, u64 q) {
  // (a * w mod q) + {0, q} for any a < 2^64, w < q, w_sh = floor(w 2^64 / q)
  return a * w - __umul64hi(a, w_sh) * q;
}

__device__ __forceinline__ u64 csub(u64 x, u64 c) {
  return x >= c ? x - c : x;
}

// Balanced base-2^g_bits digit of d; d becomes (d - digit) >> g_bits.
__device__ __forceinline__ int64_t extract(int64_t& d, int g_bits) {
  const int64_t base = int64_t(1) << g_bits;
  int64_t r = d & (base - 1);
  if (r >= (base >> 1)) r -= base;
  d = (d - r) >> g_bits;
  return r;
}

// acc_in/acc_out: [B][2][N] residues mod Q. bsk: [n][4*d2][N], row
// (key*2 + out)*d2 + 2l + j, Shoup companions only. tw: [8][N] rows twist,
// fwd, inv, untwist, then twist', fwd', inv', untwist' (x' = Shoup
// companion), as `ntt.tables_on` holds them.
// bar_m, bar_s: Barrett constant floor(2^(64+bar_s) / Q), bar_s = bits(Q)-1.
template <int LOGN>
__global__ void __launch_bounds__(NT, 1)
blind_rotate64_kernel(const u64* __restrict__ acc_in, u64* __restrict__ acc_out,
                      const int32_t* __restrict__ a_idx,
                      const u64* __restrict__ bsk, const u64* __restrict__ tw,
                      int n, u64 Q, u64 bar_m, int bar_s, int g_bits,
                      int digits, int throw_digits) {
  constexpr int N = 1 << LOGN;
  constexpr int HALF = N / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* acc = reinterpret_cast<u64*>(smem_raw);  // [2][N]
  u64* x = acc + 2 * N;                         // [2][N]
  u64* u = x + 2 * N;                           // [4][N]

  const u64* twist = tw;
  const u64* fwd = tw + N;
  const u64* inv = tw + 2 * N;
  const u64* untwist = tw + 3 * N;
  const u64* twist_sh = tw + 4 * N;
  const u64* fwd_sh = tw + 5 * N;
  const u64* inv_sh = tw + 6 * N;
  const u64* untwist_sh = tw + 7 * N;

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int d2 = 2 * digits;
  const u64 two_q = 2 * Q;
  const u64 half_q = Q >> 1;

  for (int i = tid; i < 2 * N; i += NT) acc[i] = acc_in[b * 2 * N + i];
  __syncthreads();

  for (int r = 0; r < n; ++r) {
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    const u64* key = bsk + (size_t)r * 4 * d2 * N;

    for (int l = 0; l < digits; ++l) {
      // digit l of both polynomials, twisted on the way into x
      for (int i = tid; i < 2 * N; i += NT) {
        const u64 a = acc[i];
        int64_t d = a >= half_q ? int64_t(a) - int64_t(Q) : int64_t(a);
        int64_t rr = 0;
        for (int k = 0; k <= throw_digits + l; ++k) rr = extract(d, g_bits);
        const u64 dig = rr < 0 ? u64(rr + int64_t(Q)) : u64(rr);
        const int j = i & (N - 1);
        x[i] = mulmod_lazy(dig, __ldg(twist + j), __ldg(twist_sh + j), Q);
      }
      __syncthreads();
      // Gentleman-Sande stages, values lazy in [0, 2Q)
      for (int h = HALF; h >= 1; h >>= 1) {
        for (int s = tid; s < 2 * HALF; s += NT) {
          u64* y = x + (s >> (LOGN - 1)) * N;
          const int k = s & (HALF - 1);
          const int lo = k & (h - 1);
          const int p = ((k - lo) << 1) | lo;
          const u64 a0 = y[p], c = y[p + h];
          y[p] = csub(a0 + c, two_q);
          y[p + h] = mulmod_lazy(a0 + two_q - c, __ldg(fwd + h + lo),
                                 __ldg(fwd_sh + h + lo), Q);
        }
        __syncthreads();
      }
      // lazy external product: u[key*2 + out] += sum_j x_j * K[key][out][2l + j]
      for (int i = tid; i < N; i += NT) {
        const u64 x0 = x[i], x1 = x[N + i];
        for (int ko = 0; ko < 4; ++ko) {
          const u64* ks = key + (size_t)(ko * d2 + 2 * l) * N + i;
          const u64 s0 = __ldg(ks), s1 = __ldg(ks + N);
          const u64 v0 = __umul64hi(s0, Q) + (s0 * Q != 0ull);
          const u64 v1 = __umul64hi(s1, Q) + (s1 * Q != 0ull);
          const u64 p = mulmod_lazy(x0, v0, s0, Q) + mulmod_lazy(x1, v1, s1, Q);
          u[ko * N + i] = l == 0 ? p : u[ko * N + i] + p;
        }
      }
      __syncthreads();
    }

    // exact reduction of the lazy sums (< 2Q d2 < 2^62): the Barrett
    // quotient is floor(v / Q) or one less, so one subtract finishes it
    for (int i = tid; i < 4 * N; i += NT) {
      const u64 v = u[i];
      const u64 t = __umul64hi(v, bar_m) >> bar_s;
      u[i] = csub(v - t * Q, Q);
    }
    __syncthreads();
    // Cooley-Tukey stages, values lazy in [0, 2Q)
    for (int h = 1; h < N; h <<= 1) {
      for (int s = tid; s < 4 * HALF; s += NT) {
        u64* y = u + (s >> (LOGN - 1)) * N;
        const int k = s & (HALF - 1);
        const int lo = k & (h - 1);
        const int p = ((k - lo) << 1) | lo;
        const u64 a0 = y[p];
        const u64 c = mulmod_lazy(y[p + h], __ldg(inv + h + lo),
                                  __ldg(inv_sh + h + lo), Q);
        y[p] = csub(a0 + c, two_q);
        y[p + h] = csub(a0 + two_q - c, two_q);
      }
      __syncthreads();
    }
    for (int i = tid; i < 4 * N; i += NT) {
      const int j = i & (N - 1);
      u[i] = csub(mulmod_lazy(u[i], __ldg(untwist + j), __ldg(untwist_sh + j), Q), Q);
    }
    __syncthreads();

    // acc[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o], each partial
    // sum below 2Q before its conditional subtract
    for (int i = tid; i < 2 * N; i += NT) {
      const int o = i >> LOGN;
      const int j = i & (N - 1);
      const u64* c0 = u + o * N;
      const u64* c1 = u + (2 + o) * N;
      const int r0 = (j - m_pos) & (2 * N - 1);
      const int r1 = (j - m_neg) & (2 * N - 1);
      const u64 v0 = r0 < N ? c0[r0] : Q - c0[r0 - N];  // in [0, Q]
      const u64 v1 = r1 < N ? c1[r1] : Q - c1[r1 - N];
      u64 t = csub(acc[i] + v0, Q);
      t = csub(t + (Q - c0[j]), Q);
      t = csub(t + v1, Q);
      acc[i] = csub(t + (Q - c1[j]), Q);
    }
    __syncthreads();
  }

  for (int i = tid; i < 2 * N; i += NT) acc_out[b * 2 * N + i] = acc[i];
}

template <int LOGN>
cudaError_t launch(const void* acc_in, void* acc_out, const void* a_idx,
                   const void* bsk, const void* tw, int B, u64 Q, u64 bar_m,
                   int bar_s, int n, int g_bits, int digits, int throw_digits,
                   cudaStream_t stream) {
  const size_t smem = 8 * (size_t(1) << LOGN) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate64_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  blind_rotate64_kernel<LOGN><<<B, NT, smem, stream>>>(
      static_cast<const u64*>(acc_in), static_cast<u64*>(acc_out),
      static_cast<const int32_t*>(a_idx), static_cast<const u64*>(bsk),
      static_cast<const u64*>(tw), n, Q, bar_m, bar_s, g_bits, digits,
      throw_digits);
  return cudaGetLastError();
}

}  // namespace

// acc_in/acc_out [B][2][N] u64, a_idx [B][n] int32, bsk [n][4*d2][N] u64,
// tw [8][N] u64. Returns the launch's cudaError_t (0 on success).
extern "C" int tfhe_blind_rotate64(const void* acc_in, void* acc_out,
                                   const void* a_idx, const void* bsk,
                                   const void* tw, int B, int N,
                                   unsigned long long Q,
                                   unsigned long long bar_m, int bar_s, int n,
                                   int g_bits, int digits, int throw_digits,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 256:
      return launch<8>(acc_in, acc_out, a_idx, bsk, tw, B, Q, bar_m, bar_s, n, g_bits, digits, throw_digits, s);
    case 512:
      return launch<9>(acc_in, acc_out, a_idx, bsk, tw, B, Q, bar_m, bar_s, n, g_bits, digits, throw_digits, s);
    case 1024:
      return launch<10>(acc_in, acc_out, a_idx, bsk, tw, B, Q, bar_m, bar_s, n, g_bits, digits, throw_digits, s);
    case 2048:
      return launch<11>(acc_in, acc_out, a_idx, bsk, tw, B, Q, bar_m, bar_s, n, g_bits, digits, throw_digits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
