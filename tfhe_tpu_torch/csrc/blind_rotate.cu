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
// Design. One thread block owns one ciphertext for all n rounds; the loop over
// rounds inside the block replaces the TPU's sequential `rounds` grid axis.
// Shared memory holds the accumulator [2][N], one digit pair [2][N] in the NTT
// domain and the four lazy product sums [4][N]: 32 KB at N = 1024. Digits are
// handled one at a time, as the Pallas body does. Butterflies index shared
// memory directly, and X^m is index arithmetic: the TPU's roll-and-select
// stages and bit-decomposed rolls have no counterpart here. Twiddles come from
// tfhe_tpu_torch/ops/ntt_sched.py:schedule (compacted, see ops/ntt.py),
// so the kernel's evaluation order is the packed key's; they carry plain
// 32-bit Shoup companions and multiply with __umulhi.
//
// What bounds it: the work is 32-bit integer multiplies. A round costs each
// ciphertext 106496 lazy Shoup products (three multiplies each), 2/3 of them
// in the NTTs. The function needs 94208 of them: the separate twist and
// untwist passes (12288) fall away in a negacyclic NTT with merged twiddles.
// By those the least time is set by operations: at STD128 and B = 4096 the
// bound (multiplies over 132 SMs x 64 lanes x the 1980 MHz maximum SM
// clock) is 35.4 ms, and the kernel took 245.9 ms, 14% of it
// (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W). What keeps it there
// (occupancy, shared-memory traffic, the ~60 barriers of a round) is not
// measured. The key stream is 256 KB per round (64 rows of N words), 128 MB
// per ciphertext over 512 rounds; the whole 134 MB key does not fit in the
// 50 MB L2. The design assumes, without a measurement, that resident blocks
// walk the rounds close enough in step for one round's slice to come from
// device memory once and from L2 after that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block; N is a multiple of NT

__device__ __forceinline__ uint32_t mulmod_lazy(uint32_t a, uint32_t w,
                                                uint32_t w_sh, uint32_t Q) {
  // (a * w mod Q) + {0, Q} for any a < 2^32, w < Q, w_sh = floor(w 2^32 / Q)
  return a * w - __umulhi(a, w_sh) * Q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t c) {
  return x >= c ? x - c : x;
}

// tw: [8][N] u32 rows twist, twist', fwd, fwd', inv, inv', untwist, untwist'
// (x' = Shoup companion). bsk: [n][8*d2][N] u32, row
// ((vs*2 + key)*2 + out)*d2 + 2l + j, vs 0 = value / 1 = companion.
template <int LOGN>
__global__ void __launch_bounds__(NT)
blind_rotate_kernel(const uint32_t* __restrict__ acc_in,
                    uint32_t* __restrict__ acc_out,
                    const int32_t* __restrict__ a_idx,
                    const uint32_t* __restrict__ bsk,
                    const uint32_t* __restrict__ tw, int n, uint32_t Q,
                    int g_bits, int digits, int throw_digits) {
  constexpr int N = 1 << LOGN;
  constexpr int HALF = N / 2;
  extern __shared__ uint32_t smem[];
  uint32_t* acc = smem;        // [2][N]
  uint32_t* x = smem + 2 * N;  // [2][N]
  uint32_t* u = smem + 4 * N;  // [4][N]

  const uint32_t* twist = tw;
  const uint32_t* twist_sh = tw + N;
  const uint32_t* fwd = tw + 2 * N;
  const uint32_t* fwd_sh = tw + 3 * N;
  const uint32_t* inv = tw + 4 * N;
  const uint32_t* inv_sh = tw + 5 * N;
  const uint32_t* untwist = tw + 6 * N;
  const uint32_t* untwist_sh = tw + 7 * N;

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int d2 = 2 * digits;
  const uint32_t two_q = 2 * Q;
  const uint32_t half_q = Q >> 1;
  const int32_t base = 1 << g_bits;
  const int32_t g_mask = base - 1;
  const int32_t g_half = base >> 1;

  for (int i = tid; i < 2 * N; i += NT) acc[i] = acc_in[b * 2 * N + i];
  __syncthreads();

  for (int r = 0; r < n; ++r) {
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    const uint32_t* key = bsk + (size_t)r * 8 * d2 * N;

    for (int l = 0; l < digits; ++l) {
      // digit l of both polynomials, twisted on the way into x
      for (int i = tid; i < 2 * N; i += NT) {
        const uint32_t a = acc[i];
        int32_t d = a < half_q ? (int32_t)a : (int32_t)a - (int32_t)Q;
        int32_t rr = 0;
        for (int k = 0; k <= throw_digits + l; ++k) {
          rr = d & g_mask;
          if (rr >= g_half) rr -= base;
          d = (d - rr) >> g_bits;
        }
        const uint32_t dig = rr < 0 ? (uint32_t)(rr + (int32_t)Q) : (uint32_t)rr;
        const int j = i & (N - 1);
        x[i] = mulmod_lazy(dig, twist[j], twist_sh[j], Q);
      }
      __syncthreads();
      // Gentleman-Sande stages, values lazy in [0, 2Q)
      for (int h = HALF; h >= 1; h >>= 1) {
        for (int t = tid; t < 2 * HALF; t += NT) {
          uint32_t* y = x + (t >> (LOGN - 1)) * N;
          const int k = t & (HALF - 1);
          const int lo = k & (h - 1);
          const int p = ((k - lo) << 1) | lo;
          const uint32_t a = y[p], c = y[p + h];
          y[p] = csub(a + c, two_q);
          y[p + h] = mulmod_lazy(a + two_q - c, fwd[h + lo], fwd_sh[h + lo], Q);
        }
        __syncthreads();
      }
      // lazy external product: u[key*2 + out] += sum_j x_j * K[key][out][2l + j]
      for (int i = tid; i < N; i += NT) {
        const uint32_t x0 = x[i], x1 = x[N + i];
        for (int ko = 0; ko < 4; ++ko) {
          const uint32_t* kv = key + (size_t)(ko * d2 + 2 * l) * N + i;
          const uint32_t* ks = kv + (size_t)4 * d2 * N;
          const uint32_t p = mulmod_lazy(x0, __ldg(kv), __ldg(ks), Q) +
                             mulmod_lazy(x1, __ldg(kv + N), __ldg(ks + N), Q);
          u[ko * N + i] = l == 0 ? p : u[ko * N + i] + p;
        }
      }
      __syncthreads();
    }

    // one reduction of the lazy sums, then Cooley-Tukey stages
    for (int i = tid; i < 4 * N; i += NT) u[i] %= Q;
    __syncthreads();
    for (int h = 1; h < N; h <<= 1) {
      for (int t = tid; t < 4 * HALF; t += NT) {
        uint32_t* y = u + (t >> (LOGN - 1)) * N;
        const int k = t & (HALF - 1);
        const int lo = k & (h - 1);
        const int p = ((k - lo) << 1) | lo;
        const uint32_t a = y[p];
        const uint32_t c = mulmod_lazy(y[p + h], inv[h + lo], inv_sh[h + lo], Q);
        y[p] = csub(a + c, two_q);
        y[p + h] = csub(a + two_q - c, two_q);
      }
      __syncthreads();
    }
    for (int i = tid; i < 4 * N; i += NT) {
      const int j = i & (N - 1);
      u[i] = csub(mulmod_lazy(u[i], untwist[j], untwist_sh[j], Q), Q);
    }
    __syncthreads();

    // acc[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o]
    for (int i = tid; i < 2 * N; i += NT) {
      const int o = i >> LOGN;
      const int j = i & (N - 1);
      const uint32_t* c0 = u + o * N;
      const uint32_t* c1 = u + (2 + o) * N;
      const int r0 = (j - m_pos) & (2 * N - 1);
      const int r1 = (j - m_neg) & (2 * N - 1);
      const uint32_t v0 = r0 < N ? c0[r0] : Q - c0[r0 - N];  // in [0, Q]
      const uint32_t v1 = r1 < N ? c1[r1] : Q - c1[r1 - N];
      acc[i] = (acc[i] + v0 + (Q - c0[j]) + v1 + (Q - c1[j])) % Q;  // < 5Q
    }
    __syncthreads();
  }

  for (int i = tid; i < 2 * N; i += NT) acc_out[b * 2 * N + i] = acc[i];
}

template <int LOGN>
cudaError_t launch(const void* acc_in, void* acc_out, const void* a_idx,
                   const void* bsk, const void* tw, int B, int n, int Q,
                   int g_bits, int digits, int throw_digits,
                   cudaStream_t stream) {
  const size_t smem = 8 * (size_t(1) << LOGN) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  blind_rotate_kernel<LOGN><<<B, NT, smem, stream>>>(
      static_cast<const uint32_t*>(acc_in), static_cast<uint32_t*>(acc_out),
      static_cast<const int32_t*>(a_idx), static_cast<const uint32_t*>(bsk),
      static_cast<const uint32_t*>(tw), n, (uint32_t)Q, g_bits, digits,
      throw_digits);
  return cudaGetLastError();
}

}  // namespace

// acc_in/acc_out [B][2][N], a_idx [B][n] int32, bsk [n][8*d2][N], tw [8][N].
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}
