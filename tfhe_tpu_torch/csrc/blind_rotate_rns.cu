// Batched CGGI blind rotation for Hopper (sm_90a) on the composite ring
// modulus Q = q1 * q2 of two primes q2 < q1 < 2^28, in two 32-bit residue
// lanes.
//
// Replaces the Pallas TPU kernel
// tfhe_tpu/ops/pallas_rotate_rns.py:build_pallas_rotate_rns and computes what
// it computes, bit for bit. Each of n rounds: Garner CRT of the two lanes
// gives the value mod Q, centred (x >= Q/2 is negative) in a native int64;
// numDigitsToThrow balanced base-G digits are dropped and the next ones are
// mapped into each lane. Per lane, as in blind_rotate.cu: the forward
// negacyclic NTT of each digit, the lazy external product with the round's
// +s and -s RGSW keys, one reduction, the inverse NTT, the (X^a - 1) and
// (X^-a - 1) monomials and the accumulation. Every step is exact modular
// arithmetic, so the result equals the plain torch version
// (tfhe_tpu_torch/ops/blindrotate_rns.py) and the JAX package exactly.
//
// Design. One thread block owns one ciphertext for all n rounds; the loop
// over rounds inside the block replaces the TPU's sequential `rounds` grid
// axis. The TPU kernel's u32-pair arithmetic for the CRT and the digits
// (_addc, _sub64, sra64) is plain 64-bit integer arithmetic here. A round
// first writes each coefficient's centred value, after the thrown digits,
// to shared memory; the two lanes then run one after the other, each taking
// its digits from that buffer, so both see the round's starting
// accumulator. Shared memory at N = 2048: the centred values [2][N] int64
// (32 KB), both lanes' accumulators [2][2][N] (32 KB), one digit pair [2][N]
// (16 KB) and one lane's four lazy sums [4][N] (32 KB): 112 KB, so two
// blocks fit an SM. The key holds only the per-lane Shoup companions b'
// (the layout of pack_bsk_rns, bit-reversed evaluation order); each value
// is rebuilt as hi32(b' q) + (lo32(b' q) != 0), which halves the key
// stream. Twiddles are the single-lane kernel's, one table per prime, with
// plain 32-bit companions multiplied with __umulhi.
//
// Work per ciphertext and round at N = 2048 and d2 = 4 (two digits): per
// lane, 2 x (4096 twist + 22528 forward butterflies + 16384 key products)
// + 45056 inverse butterflies + 8192 untwists = 139264 lazy Shoup products
// (three 32-bit multiplies each) and 32768 key values rebuilt (two
// multiplies each); over both lanes 278528 Shoup products, 9.7e5 32-bit
// multiplies, about 3 times a STD128 round of blind_rotate.cu. The function
// needs 245760 of those products (no separate twist or untwist with merged
// twiddles) and 4 multiplies per coefficient for the CRT, 7.5e5 in all; the
// rebuilt values are this layout's price for half the key stream, 256 KB
// per round and 342 MB per ciphertext over 1305 rounds (values and
// companions would be twice that). By the multiply count it is bound by
// operations: at B = 4096, n = 1305, d2 = 4 the bound (multiplies over 132
// SMs x 64 lanes x the 1980 MHz maximum SM clock) is 240.8 ms, and the
// kernel took 1927.9 ms, 12% of it (chip_smoke.py on an NVIDIA H100 80GB
// HBM3, 700 W). What keeps it there is not measured.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;  // threads per block

__device__ __forceinline__ uint32_t mulmod_lazy(uint32_t a, uint32_t w,
                                                uint32_t w_sh, uint32_t q) {
  // (a * w mod q) + {0, q} for any a < 2^32, w < q, w_sh = floor(w 2^32 / q)
  return a * w - __umulhi(a, w_sh) * q;
}

__device__ __forceinline__ uint32_t csub(uint32_t x, uint32_t c) {
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

// acc1/acc2: [B][2][N] residues mod q1 / q2. bsk: [n][8*d2][N] u32, rows
// lane*4*d2 + (key*2 + out)*d2 + 2l + j, Shoup companions only.
// tw: [2 lanes][8][N] rows twist, twist', fwd, fwd', inv, inv', untwist,
// untwist' (x' = Shoup companion).
template <int LOGN>
__global__ void __launch_bounds__(NT, 2)
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
  constexpr int HALF = N / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int64_t* dval = reinterpret_cast<int64_t*>(smem_raw);        // [2][N]
  uint32_t* acc = reinterpret_cast<uint32_t*>(dval + 2 * N);   // [2][2][N]
  uint32_t* x = acc + 4 * N;                                   // [2][N]
  uint32_t* u = x + 2 * N;                                     // [4][N]

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int d2 = 2 * digits;
  const uint64_t Q = uint64_t(q1) * q2;
  const uint64_t half_Q = Q >> 1;

  for (int i = tid; i < 2 * N; i += NT) {
    acc[i] = acc1_in[b * 2 * N + i];
    acc[2 * N + i] = acc2_in[b * 2 * N + i];
  }
  __syncthreads();

  for (int r = 0; r < n; ++r) {
    const int m_pos = a_idx[b * n + r];
    const int m_neg = (2 * N - m_pos) & (2 * N - 1);
    const uint32_t* key_r = bsk + (size_t)r * 8 * d2 * N;

    // Garner CRT x = r2 + q2 ((r1 - r2) q2^-1 mod q1), centred, throw
    for (int i = tid; i < 2 * N; i += NT) {
      const uint32_t r1 = acc[i], r2 = acc[2 * N + i];
      const uint32_t diff = r1 >= r2 ? r1 - r2 : r1 + q1 - r2;
      const uint32_t t = csub(mulmod_lazy(diff, c12, c12_sh, q1), q1);
      const uint64_t xv = uint64_t(r2) + uint64_t(q2) * t;
      int64_t d = xv >= half_Q ? int64_t(xv) - int64_t(Q) : int64_t(xv);
      for (int k = 0; k < throw_digits; ++k) extract(d, g_bits);
      dval[i] = d;
    }
    __syncthreads();

    for (int lane = 0; lane < 2; ++lane) {
      const uint32_t q = lane ? q2 : q1;
      const uint32_t two_q = 2 * q;
      const uint32_t* t = tw + lane * 8 * N;
      const uint32_t* twist = t;
      const uint32_t* twist_sh = t + N;
      const uint32_t* fwd = t + 2 * N;
      const uint32_t* fwd_sh = t + 3 * N;
      const uint32_t* inv = t + 4 * N;
      const uint32_t* inv_sh = t + 5 * N;
      const uint32_t* untwist = t + 6 * N;
      const uint32_t* untwist_sh = t + 7 * N;
      const uint32_t* key = key_r + (size_t)lane * 4 * d2 * N;
      uint32_t* a = acc + lane * 2 * N;

      for (int l = 0; l < digits; ++l) {
        // digit l of both polynomials into this lane, twisted on the way
        for (int i = tid; i < 2 * N; i += NT) {
          int64_t d = dval[i];
          int64_t rr = 0;
          for (int k = 0; k <= l; ++k) rr = extract(d, g_bits);
          const uint32_t dig = rr < 0 ? uint32_t(rr + q) : uint32_t(rr);
          const int j = i & (N - 1);
          x[i] = mulmod_lazy(dig, twist[j], twist_sh[j], q);
        }
        __syncthreads();
        // Gentleman-Sande stages, values lazy in [0, 2q)
        for (int h = HALF; h >= 1; h >>= 1) {
          for (int s = tid; s < 2 * HALF; s += NT) {
            uint32_t* y = x + (s >> (LOGN - 1)) * N;
            const int k = s & (HALF - 1);
            const int lo = k & (h - 1);
            const int p = ((k - lo) << 1) | lo;
            const uint32_t a0 = y[p], c = y[p + h];
            y[p] = csub(a0 + c, two_q);
            y[p + h] = mulmod_lazy(a0 + two_q - c, fwd[h + lo], fwd_sh[h + lo], q);
          }
          __syncthreads();
        }
        // lazy external product: u[key*2 + out] += sum_j x_j * K[key][out][2l + j]
        for (int i = tid; i < N; i += NT) {
          const uint32_t x0 = x[i], x1 = x[N + i];
          for (int ko = 0; ko < 4; ++ko) {
            const uint32_t* ks = key + (size_t)(ko * d2 + 2 * l) * N + i;
            const uint32_t s0 = __ldg(ks), s1 = __ldg(ks + N);
            const uint32_t v0 = __umulhi(s0, q) + (s0 * q != 0u);
            const uint32_t v1 = __umulhi(s1, q) + (s1 * q != 0u);
            const uint32_t p = mulmod_lazy(x0, v0, s0, q) + mulmod_lazy(x1, v1, s1, q);
            u[ko * N + i] = l == 0 ? p : u[ko * N + i] + p;
          }
        }
        __syncthreads();
      }

      // one reduction of the lazy sums, then Cooley-Tukey stages
      for (int i = tid; i < 4 * N; i += NT) u[i] %= q;
      __syncthreads();
      for (int h = 1; h < N; h <<= 1) {
        for (int s = tid; s < 4 * HALF; s += NT) {
          uint32_t* y = u + (s >> (LOGN - 1)) * N;
          const int k = s & (HALF - 1);
          const int lo = k & (h - 1);
          const int p = ((k - lo) << 1) | lo;
          const uint32_t a0 = y[p];
          const uint32_t c = mulmod_lazy(y[p + h], inv[h + lo], inv_sh[h + lo], q);
          y[p] = csub(a0 + c, two_q);
          y[p + h] = csub(a0 + two_q - c, two_q);
        }
        __syncthreads();
      }
      for (int i = tid; i < 4 * N; i += NT) {
        const int j = i & (N - 1);
        u[i] = csub(mulmod_lazy(u[i], untwist[j], untwist_sh[j], q), q);
      }
      __syncthreads();

      // a[o] += (X^m_pos - 1) u[o] + (X^m_neg - 1) u[2 + o]
      for (int i = tid; i < 2 * N; i += NT) {
        const int o = i >> LOGN;
        const int j = i & (N - 1);
        const uint32_t* c0 = u + o * N;
        const uint32_t* c1 = u + (2 + o) * N;
        const int r0 = (j - m_pos) & (2 * N - 1);
        const int r1 = (j - m_neg) & (2 * N - 1);
        const uint32_t v0 = r0 < N ? c0[r0] : q - c0[r0 - N];  // in [0, q]
        const uint32_t v1 = r1 < N ? c1[r1] : q - c1[r1 - N];
        a[i] = (a[i] + v0 + (q - c0[j]) + v1 + (q - c1[j])) % q;  // < 5q
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < 2 * N; i += NT) {
    acc1_out[b * 2 * N + i] = acc[i];
    acc2_out[b * 2 * N + i] = acc[2 * N + i];
  }
}

template <int LOGN>
cudaError_t launch(const void* acc1_in, const void* acc2_in, void* acc1_out,
                   void* acc2_out, const void* a_idx, const void* bsk,
                   const void* tw, int B, int n, unsigned q1, unsigned q2,
                   unsigned c12, unsigned c12_sh, int g_bits, int digits,
                   int throw_digits, cudaStream_t stream) {
  const size_t N = size_t(1) << LOGN;
  const size_t smem = 2 * N * sizeof(int64_t) + 10 * N * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_rns_kernel<LOGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  blind_rotate_rns_kernel<LOGN><<<B, NT, smem, stream>>>(
      static_cast<const uint32_t*>(acc1_in),
      static_cast<const uint32_t*>(acc2_in), static_cast<uint32_t*>(acc1_out),
      static_cast<uint32_t*>(acc2_out), static_cast<const int32_t*>(a_idx),
      static_cast<const uint32_t*>(bsk), static_cast<const uint32_t*>(tw), n,
      q1, q2, c12, c12_sh, g_bits, digits, throw_digits);
  return cudaGetLastError();
}

}  // namespace

// acc*_in/acc*_out [B][2][N], a_idx [B][n] int32, bsk [n][8*d2][N],
// tw [2][8][N]. Returns the launch's cudaError_t (0 on success).
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}
