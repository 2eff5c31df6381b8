// Native host math core for tfhe_tpu — the C++ analogue of the reference's
// CPU math layer (`src/core/include/math/hal/intnat/transformnat-impl.h`:
// ChineseRemainderTransformFTTNat with Shoup-preconditioned twiddles).
//
// Exposed over a plain C ABI and loaded with ctypes (no pybind11 in the
// image). All routines are bit-exact mirrors of tfhe_tpu/ref/ntt.py:
// the same radix-2 schedule (bit-reverse + Cooley-Tukey stages), the same
// twist/untwist vectors, driven by the *same* primitive root psi passed in
// from Python, so evaluation-domain data is interchangeable between the
// numpy oracle, this module, and the JAX device backends.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC hostmath.cpp
//        (tfhe_tpu/native/__init__.py compiles on first import and caches
//         the .so next to this file).

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef unsigned __int128 u128;
typedef std::uint64_t u64;
typedef std::int64_t i64;

namespace {

inline u64 mulmod(u64 a, u64 b, u64 q) { return (u64)((u128)a * b % q); }

inline u64 powmod(u64 a, u64 e, u64 q) {
    u64 r = 1;
    a %= q;
    while (e) {
        if (e & 1) r = mulmod(r, a, q);
        a = mulmod(a, a, q);
        e >>= 1;
    }
    return r;
}

inline u64 shoup(u64 b, u64 q) { return (u64)(((u128)b << 64) / q); }

// modular inverse by extended Euclid — valid for composite moduli too (the
// RNS ring modulus Q = q1*q2 of the accelerated sets is not prime)
inline u64 invmod(u64 a, u64 q) {
    i64 t = 0, newt = 1;
    i64 r = (i64)q, newr = (i64)(a % q);
    while (newr != 0) {
        i64 quot = r / newr;
        i64 tmp = t - quot * newt; t = newt; newt = tmp;
        tmp = r - quot * newr; r = newr; newr = tmp;
    }
    if (t < 0) t += (i64)q;
    return (u64)t;
}

// (a * b) mod q with precomputed b_sh = floor(b * 2^64 / q); a < q required.
inline u64 mulmod_shoup(u64 a, u64 b, u64 b_sh, u64 q) {
    u64 t = (u64)(((u128)a * b_sh) >> 64);
    u64 r = a * b - t * q;  // wrapping
    return r >= q ? r - q : r;
}

struct Tables {
    i64 N;
    u64 Q;
    std::vector<i64> bitrev;
    std::vector<u64> twist, twist_sh;       // psi^j
    std::vector<u64> untwist, untwist_sh;   // psi^-j / N
    // per stage (length = 2,4,..,N): twiddles w^(t*N/length), t < length/2
    std::vector<std::vector<u64>> fwd, fwd_sh, inv, inv_sh;
};

std::mutex g_mu;
std::map<std::pair<u64, u64>, Tables*> g_tables;

Tables* get_tables(i64 N, u64 Q, u64 psi) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto key = std::make_pair((u64)N, Q);
    auto it = g_tables.find(key);
    if (it != g_tables.end()) return it->second;

    Tables* t = new Tables;
    t->N = N;
    t->Q = Q;
    u64 psi_inv = invmod(psi, Q);
    u64 omega = mulmod(psi, psi, Q);
    u64 omega_inv = invmod(omega, Q);
    u64 n_inv = invmod((u64)N, Q);

    int logn = 0;
    while ((i64(1) << logn) < N) logn++;

    t->bitrev.resize(N);
    for (i64 i = 0; i < N; i++) {
        i64 r = 0, x = i;
        for (int b = 0; b < logn; b++) { r = (r << 1) | (x & 1); x >>= 1; }
        t->bitrev[i] = r;
    }

    t->twist.resize(N); t->twist_sh.resize(N);
    t->untwist.resize(N); t->untwist_sh.resize(N);
    u64 p = 1, pi = 1;
    for (i64 j = 0; j < N; j++) {
        t->twist[j] = p;
        t->twist_sh[j] = shoup(p, Q);
        u64 u = mulmod(pi, n_inv, Q);
        t->untwist[j] = u;
        t->untwist_sh[j] = shoup(u, Q);
        p = mulmod(p, psi, Q);
        pi = mulmod(pi, psi_inv, Q);
    }

    for (int dir = 0; dir < 2; dir++) {
        u64 w0 = dir == 0 ? omega : omega_inv;
        auto& stages = dir == 0 ? t->fwd : t->inv;
        auto& stages_sh = dir == 0 ? t->fwd_sh : t->inv_sh;
        for (i64 length = 2; length <= N; length *= 2) {
            u64 wl = powmod(w0, (u64)(N / length), Q);
            std::vector<u64> tw(length / 2), tw_sh(length / 2);
            u64 cur = 1;
            for (i64 k = 0; k < length / 2; k++) {
                tw[k] = cur;
                tw_sh[k] = shoup(cur, Q);
                cur = mulmod(cur, wl, Q);
            }
            stages.push_back(std::move(tw));
            stages_sh.push_back(std::move(tw_sh));
        }
    }
    g_tables[key] = t;
    return t;
}

// In-place cyclic NTT of one row (bitrev + CT stages), matching
// ref/ntt.py::_cyclic_ntt bit for bit.
void cyclic_one(u64* x, const Tables* t, bool inverse, u64* scratch) {
    const i64 N = t->N;
    const u64 Q = t->Q;
    for (i64 i = 0; i < N; i++) scratch[i] = x[t->bitrev[i]];
    std::memcpy(x, scratch, N * sizeof(u64));
    const auto& stages = inverse ? t->inv : t->fwd;
    const auto& stages_sh = inverse ? t->inv_sh : t->fwd_sh;
    i64 length = 2;
    for (size_t s = 0; s < stages.size(); s++, length *= 2) {
        const u64* tw = stages[s].data();
        const u64* tw_sh = stages_sh[s].data();
        const i64 half = length / 2;
        for (i64 blk = 0; blk < N; blk += length) {
            for (i64 k = 0; k < half; k++) {
                u64 even = x[blk + k];
                u64 odd = mulmod_shoup(x[blk + k + half] % Q, tw[k], tw_sh[k], Q);
                u64 a = even + odd;
                if (a >= Q) a -= Q;
                u64 b = even + Q - odd;
                if (b >= Q) b -= Q;
                x[blk + k] = a;
                x[blk + k + half] = b;
            }
        }
    }
}

}  // namespace

extern "C" {

// Negacyclic forward NTT over the last axis: data [batch, N] uint64 mod Q,
// in place. psi = primitive 2N-th root of unity used by the Python tables.
void tfhe_ntt_forward(u64* data, i64 batch, i64 N, u64 Q, u64 psi) {
    Tables* t = get_tables(N, Q, psi);
#pragma omp parallel
    {
        std::vector<u64> scratch(N);
#pragma omp for schedule(static)
        for (i64 b = 0; b < batch; b++) {
            u64* row = data + b * N;
            for (i64 j = 0; j < N; j++)
                row[j] = mulmod_shoup(row[j] % Q, t->twist[j], t->twist_sh[j], Q);
            cyclic_one(row, t, false, scratch.data());
        }
    }
}

void tfhe_ntt_inverse(u64* data, i64 batch, i64 N, u64 Q, u64 psi) {
    Tables* t = get_tables(N, Q, psi);
#pragma omp parallel
    {
        std::vector<u64> scratch(N);
#pragma omp for schedule(static)
        for (i64 b = 0; b < batch; b++) {
            u64* row = data + b * N;
            cyclic_one(row, t, true, scratch.data());
            for (i64 j = 0; j < N; j++)
                row[j] = mulmod_shoup(row[j], t->untwist[j], t->untwist_sh[j], Q);
        }
    }
}

// Pointwise (a * b) mod Q over flat arrays (for eval-domain products).
void tfhe_pointwise_mulmod(u64* a, const u64* b, i64 count, u64 Q) {
#pragma omp parallel for schedule(static)
    for (i64 i = 0; i < count; i++) a[i] = mulmod(a[i], b[i], Q);
}

// The steps of one CGGI round on one ciphertext (rgsw-acc-cggi.cpp:246-307),
// each over independent data: the signed digits of each coefficient
// (rgsw-acc.cpp:57-111), the forward NTT of each digit row, the product with
// the key at each coefficient, the inverse NTT of each (key, output) pair,
// and the update of each accumulator coefficient. Sums mod Q do not depend on their order, so
// the update adds key 0's term, then key 1's, at each coefficient.
struct CggiRound {
    const Tables* t;
    i64 N, d2, g_bits, digits_eff, throw_digits;
    u64 Q;

    void digits_at(const u64* acc_b, i64 k, u64* const* dct) const {
        const i64 half = i64(1) << (g_bits - 1), base_g = i64(1) << g_bits;
        const u64 v0 = acc_b[k], v1 = acc_b[N + k];
        i64 d0 = v0 < (Q >> 1) ? (i64)v0 : (i64)v0 - (i64)Q;
        i64 d1 = v1 < (Q >> 1) ? (i64)v1 : (i64)v1 - (i64)Q;
        for (i64 l = -throw_digits; l < digits_eff; l++) {
            i64 r0 = d0 & (base_g - 1);
            if (r0 >= half) r0 -= base_g;
            d0 = (d0 - r0) >> g_bits;
            i64 r1 = d1 & (base_g - 1);
            if (r1 >= half) r1 -= base_g;
            d1 = (d1 - r1) >> g_bits;
            if (l >= 0) {
                dct[2 * l][k] = r0 < 0 ? Q + (u64)r0 : (u64)r0;
                dct[2 * l + 1][k] = r1 < 0 ? Q + (u64)r1 : (u64)r1;
            }
        }
    }

    void forward_row(u64* row, u64* scratch) const {
        for (i64 k = 0; k < N; k++)
            row[k] = mulmod_shoup(row[k], t->twist[k], t->twist_sh[k], Q);
        cyclic_one(row, t, false, scratch);
    }

    // cs[2 key + j][k] = sum_l dct_hat[l][k] * ek[key][l][j][k]
    void product_at(const u64* ek_r, i64 k, u64* const* dct, u64* const* cs) const {
        for (i64 kj = 0; kj < 4; kj++) {
            const u64* ek = ek_r + ((kj >> 1) * d2 * 2 + (kj & 1)) * N + k;
            u64 c = 0;
            for (i64 l = 0; l < d2; l++) {
                u64 s = c + mulmod(dct[l][k], ek[l * 2 * N], Q);
                c = s >= Q ? s - Q : s;
            }
            cs[kj][k] = c;
        }
    }

    void inverse_row(u64* c, u64* scratch) const {
        cyclic_one(c, t, true, scratch);
        for (i64 k = 0; k < N; k++)
            c[k] = mulmod_shoup(c[k], t->untwist[k], t->untwist_sh[k], Q);
    }

    // acc[j][k] += X^idx c - c for key 0 (idx = the round's exponent) and
    // key 1 (its negation), cs[2 key + j] (the negacyclic monomial)
    void update_at(u64* acc_b, i64 k, i64 a, u64* const* cs) const {
        const i64 M = 2 * N;
        const i64 idx_pos = ((a % M) + M) % M;
        const i64 idx_neg = (M - idx_pos) % M;
        for (int key = 0; key < 2; key++) {
            i64 sft = key == 0 ? idx_pos : idx_neg;
            bool neg = false;
            if (sft >= N) { sft -= N; neg = true; }
            i64 src = k - sft;
            bool flip = neg;
            if (src < 0) { src += N; flip = !flip; }
            for (int j = 0; j < 2; j++) {
                const u64* c = cs[2 * key + j];
                u64 v = c[src];
                if (flip && v) v = Q - v;
                u64 s = acc_b[j * N + k] + v;  // acc += v - c[k]  (mod Q)
                if (s >= Q) s -= Q;
                s += Q - c[k];
                if (s >= Q) s -= Q;
                acc_b[j * N + k] = s;
            }
        }
    }
};

// Full CGGI blind rotation, batched over ciphertexts (OpenMP) — the C++
// mirror of ref/rgsw.py::eval_acc_cggi / add_to_acc_cggi
// (rgsw-acc-cggi.cpp:143-307), bit-exact with the numpy oracle. A batch at
// least as large as the thread count runs a ciphertext a thread; at
// N >= 4096 a smaller one (the host oracle runs one row a call) runs its
// ciphertexts one after another, each round's steps shared by all threads
// (`omp for` over the coefficients, the digit rows or the four (key,
// output) pairs, a barrier after each). Below N = 4096 a step is too short
// to be worth its barrier.
//
// acc:      [batch, 2, N] residues mod Q, coefficient domain, in place
// a_scaled: [batch, n] monomial exponents in [0, 2N) (already 2N/q-scaled)
// bsk_hat:  [n, 2(key), d2, 2(out), N] evaluation domain
void tfhe_cggi_rotate(u64* acc, const i64* a_scaled, const u64* bsk_hat,
                      i64 batch, i64 n, i64 N, u64 Q, u64 psi,
                      i64 g_bits, i64 digits_eff, i64 throw_digits) {
    const CggiRound rd{get_tables(N, Q, psi), N, 2 * digits_eff, g_bits, digits_eff,
                       throw_digits, Q};
    const i64 d2 = rd.d2;
    auto rows = [&](std::vector<std::vector<u64>>& v, std::vector<u64*>& p, i64 count) {
        v.assign(count, std::vector<u64>(N));
        p.resize(count);
        for (i64 i = 0; i < count; i++) p[i] = v[i].data();
    };
#ifdef _OPENMP
    const bool inner = batch < omp_get_max_threads() && N >= 4096;
#else
    const bool inner = false;
#endif
    if (!inner) {
#pragma omp parallel
        {
            std::vector<u64> scratch(N);
            std::vector<std::vector<u64>> dv, cv;
            std::vector<u64*> dct, cs;
            rows(dv, dct, d2);
            rows(cv, cs, 4);
#pragma omp for schedule(static)
            for (i64 b = 0; b < batch; b++) {
                u64* acc_b = acc + b * 2 * N;
                for (i64 r = 0; r < n; r++) {
                    const u64* ek_r = bsk_hat + r * 2 * d2 * 2 * N;
                    for (i64 k = 0; k < N; k++) rd.digits_at(acc_b, k, dct.data());
                    for (i64 l = 0; l < d2; l++) rd.forward_row(dct[l], scratch.data());
                    for (i64 k = 0; k < N; k++) rd.product_at(ek_r, k, dct.data(), cs.data());
                    for (i64 kj = 0; kj < 4; kj++) rd.inverse_row(cs[kj], scratch.data());
                    for (i64 k = 0; k < N; k++) rd.update_at(acc_b, k, a_scaled[b * n + r], cs.data());
                }
            }
        }
        return;
    }
    std::vector<std::vector<u64>> dv, cv;
    std::vector<u64*> dct, cs;
    rows(dv, dct, d2);
    rows(cv, cs, 4);
#pragma omp parallel
    {
        std::vector<u64> scratch(N);
        for (i64 b = 0; b < batch; b++) {
            u64* acc_b = acc + b * 2 * N;
            for (i64 r = 0; r < n; r++) {
                const u64* ek_r = bsk_hat + r * 2 * d2 * 2 * N;
#pragma omp for schedule(static)
                for (i64 k = 0; k < N; k++) rd.digits_at(acc_b, k, dct.data());
#pragma omp for schedule(static)
                for (i64 l = 0; l < d2; l++) rd.forward_row(dct[l], scratch.data());
#pragma omp for schedule(static)
                for (i64 k = 0; k < N; k++) rd.product_at(ek_r, k, dct.data(), cs.data());
#pragma omp for schedule(static)
                for (i64 kj = 0; kj < 4; kj++) rd.inverse_row(cs[kj], scratch.data());
#pragma omp for schedule(static)
                for (i64 k = 0; k < N; k++) rd.update_at(acc_b, k, a_scaled[b * n + r], cs.data());
            }
        }
    }
}

int tfhe_hostmath_version() { return 1; }

}  // extern "C"
