"""LWE scheme: key generation, encryption, decryption, homomorphic helpers,
modulus switching and key switching (host/numpy; vectorized over batches).

Mirrors `LWEEncryptionScheme` (`src/binfhe/lib/lwe-pke.cpp:41-338`) and the data
types `LWECiphertextImpl` / `LWEPrivateKeyImpl` / `LWESwitchingKeyImpl`
(`src/binfhe/include/lwe-*.h`). All values are residues in uint64 numpy arrays
(every LWE-level modulus fits in 36 bits); secret keys are kept as signed
ternary arrays plus their nominal modulus tag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .params import LWEParams
from .ref import modmath
from .utils import threefry
from .utils.rng import BinFHERng


@dataclass
class LWECiphertext:
    """(a, b) with b = <a, s> + e + m*(mod/p). `a` has shape [..., n]; `b` matches
    a.shape[:-1]. (lwe-ciphertext.h:48-56)"""
    a: np.ndarray
    b: np.ndarray | int
    modulus: int

    def copy(self) -> "LWECiphertext":
        return LWECiphertext(self.a.copy(), np.copy(self.b), self.modulus)

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def set_modulus(self, new_mod: int) -> None:
        """Raw modulus retag (the reference's `SetModulus` on the `a` vector does
        not re-reduce values; used for the modulus-raise trick in EvalFunc)."""
        self.modulus = new_mod


@dataclass
class LWEPrivateKey:
    """Ternary secret; `s` holds signed values in {-1, 0, 1}. (lwe-privatekey.h)"""
    s: np.ndarray
    modulus: int

    def residues(self, modulus: int | None = None) -> np.ndarray:
        m = self.modulus if modulus is None else modulus
        return modmath.from_signed(self.s, m)


@dataclass
class LWESwitchingKey:
    """Key-switching key: A[N, baseKS, digitCount, n], B[N, baseKS, digitCount],
    all mod qKS. (lwe-keyswitchkey.h:55-84)"""
    A: np.ndarray
    B: np.ndarray


class SeededSwitchingKey:
    """Key-switching key in seeded form, for the accelerated power-of-two
    qKS sets: the uniform A block (~5 GB at STD128) is never stored. It is
    regenerated from the JAX package's counter-based stream (threefry2x32,
    `utils/threefry.py`, `KSK_ROW_CHUNK` rows a chunk) wherever it is
    needed: on the device into the switching table
    (`ops/keyswitch.seeded_ksk_table`), and lazily on the host through the
    `.A` property for the oracle. Only B ([N, baseKS, dc] u64) is stored.
    The same seed gives the JAX package's key bit for bit."""

    def __init__(self, seed: int, N: int, base_ks: int, digit_count: int,
                 n: int, q_ks: int, B: np.ndarray):
        if q_ks & (q_ks - 1):
            raise ValueError("SeededSwitchingKey requires power-of-two qKS")
        self.seed = int(seed)
        self.N, self.base_ks, self.digit_count = N, base_ks, digit_count
        self.n, self.q_ks = n, q_ks
        self.B = B
        self._A: np.ndarray | None = None
        self._rows: SeededRows | None = None

    @property
    def rows(self) -> int:
        return self.N * self.base_ks * self.digit_count

    @property
    def A(self):
        """Materialized A [N, baseKS, dc, n] u64 (host, lazy, cached), or
        after `select_rows_on` a `SeededRows` view that draws only the rows
        it is indexed at."""
        if self._A is None and self._rows is not None:
            return self._rows
        return self.materialize("cpu")

    def select_rows_on(self, device) -> None:
        """Let `.A` give, at each read, only the rows the reader selects,
        drawn on `device` (`SeededRows`), where the whole block would not
        fit the host or would take long to copy there (38.3 GB at N =
        16384, n = 1305). The words are the materialized block's."""
        self._rows = SeededRows(self, device)

    def materialize(self, device="cpu") -> np.ndarray:
        """`.A` on the host, its rows drawn on `device` where it is not
        cached yet: the stream is the same on every device, and a card
        draws the 1.2e9 words of an N = 4096 key in seconds where the
        host's CPU takes minutes."""
        if self._A is None:
            a = np.empty((self.rows, self.n), dtype=np.uint64)
            for r0, r1 in seeded_blocks(self.rows, self.n, device):
                # residues < qKS: the int64 words are their u64 values
                a[r0:r1] = seeded_rows(self.seed, self.n, self.q_ks, r0, r1,
                                       device).cpu().numpy().view(np.uint64)
            self._A = a.reshape(self.N, self.base_ks, self.digit_count,
                                self.n)
        return self._A


# Rows of one chunk of the seeded stream. Chunk c draws with the key
# fold_in(PRNGKey(seed), c) and always KSK_ROW_CHUNK full rows (a ragged
# last chunk is sliced): part of the stream's definition, the JAX
# package's `lwe.KSK_ROW_CHUNK`.
KSK_ROW_CHUNK = 57344

# Words of one generated block: small enough to stay in cache on the host,
# large enough to keep the card busy.
_BLOCK_WORDS = {"cpu": 1 << 16, "cuda": 1 << 24}


def seeded_blocks(R: int, n: int, device) -> list[tuple[int, int]]:
    """Row ranges [r0, r1) that cover R rows of n words in blocks of about
    `_BLOCK_WORDS` words, none crossing a chunk boundary."""
    step = max(1, _BLOCK_WORDS[torch.device(device).type] // n)
    out = []
    for c0 in range(0, R, KSK_ROW_CHUNK):
        c1 = min(R, c0 + KSK_ROW_CHUNK)
        out += [(r, min(c1, r + step)) for r in range(c0, c1, step)]
    return out


def _chunk_words(key_c: tuple[int, int], ctr: torch.Tensor, n: int,
                 q_ks: int) -> torch.Tensor:
    """The residues mod the power-of-two q_ks at the plane-0 counters `ctr`
    (consumed) of a chunk's draw under key_c: for q_ks <= 2^32 the plane-0
    word, masked; above, the low word from plane 0 and the high word,
    masked, from plane 1 (counter + C n)."""
    ks_bits = q_ks.bit_length() - 1
    lo = threefry.bits(key_c, ctr)
    if ks_bits < 32:
        lo.bitwise_and_(q_ks - 1)
    elif ks_bits > 32:
        hi = threefry.bits(key_c, ctr.add_(KSK_ROW_CHUNK * n))
        hi.bitwise_and_((1 << (ks_bits - 32)) - 1)
        lo.bitwise_or_(hi.bitwise_left_shift_(32))
    return lo


def seeded_rows(seed: int, n: int, q_ks: int, r0: int, r1: int,
                device) -> torch.Tensor:
    """Rows r0..r1-1 of the seeded A block, int64 [r1 - r0, n] residues mod
    the power-of-two q_ks, generated on `device`. For q_ks <= 2^32 a row is
    one u32 plane of the chunk's draw bits(key_c, (C, n)); above, the low
    word comes from plane 0 and the high word, masked, from plane 1 of
    bits(key_c, (2, C, n)): counter C*n + r*n + j."""
    key = threefry.prng_key(seed)
    parts = []
    while r0 < r1:
        c = r0 // KSK_ROW_CHUNK
        stop = min(r1, (c + 1) * KSK_ROW_CHUNK)
        local = r0 - c * KSK_ROW_CHUNK
        ctr = torch.arange(local * n, (local + stop - r0) * n,
                           dtype=torch.int64, device=device)
        parts.append(_chunk_words(threefry.fold_in(key, c), ctr, n, q_ks).view(stop - r0, n))
        r0 = stop
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def seeded_select(seed: int, n: int, q_ks: int, rows: torch.Tensor,
                  device) -> torch.Tensor:
    """The rows `rows` (int64, any order) of the seeded A block, int64
    [len(rows), n], generated on `device`: `seeded_rows`' words, each row
    drawn from its own counters, one draw per chunk the rows touch."""
    rows = rows.to(device)
    out = torch.empty((rows.shape[0], n), dtype=torch.int64, device=device)
    key, chunk = threefry.prng_key(seed), rows // KSK_ROW_CHUNK
    cols = torch.arange(n, dtype=torch.int64, device=device)
    for c in torch.unique(chunk).tolist():
        sel = torch.nonzero(chunk == c).squeeze(1)
        ctr = ((rows[sel] - c * KSK_ROW_CHUNK)[:, None] * n + cols).reshape(-1)
        out[sel] = _chunk_words(threefry.fold_in(key, c), ctr, n, q_ks).view(-1, n)
    return out


class SeededRows:
    """The A block of a SeededSwitchingKey as the host key switch indexes
    it, A[i, a0, j] -> [..., N, n] u64 for index arrays i, a0 [..., N] and a
    digit j, without the block: each read draws the distinct rows it needs
    on `device` (`seeded_select`) and copies only those to the host."""

    def __init__(self, key: SeededSwitchingKey, device):
        self.key, self.device = key, device

    def __getitem__(self, index) -> np.ndarray:
        i, a0, j = index
        k = self.key
        flat = (np.asarray(i, dtype=np.int64) * k.base_ks
                + np.asarray(a0, dtype=np.int64)) * k.digit_count + int(j)
        uniq, inv = np.unique(flat, return_inverse=True)
        words = seeded_select(k.seed, k.n, k.q_ks, torch.from_numpy(uniq), self.device)
        return words.cpu().numpy().view(np.uint64)[inv.reshape(flat.shape)]


def key_switch_gen_seeded(rng: BinFHERng, params: LWEParams,
                          sk: LWEPrivateKey, sk_n: LWEPrivateKey,
                          device="cuda") -> SeededSwitchingKey:
    """key_switch_gen with a regenerated A block (see SeededSwitchingKey):
    the JAX package's `lwe.key_switch_gen_seeded`, the same draws of `rng`
    in the same order (the seed, then the Gaussian noise). <A, s> mod qKS
    is summed block by block on `device`, so on the card the A block never
    exists on the host; a float64 sum of ternary products of values below
    2^40 is exact at every n below 2^13."""
    n, N = params.n, params.N
    q_ks, base_ks = params.q_ks, params.base_ks
    digit_count = params.digit_count_ks
    if q_ks & (q_ks - 1):
        raise ValueError("seeded key switch requires power-of-two qKS")
    R = N * base_ks * digit_count
    seed = int(rng.discrete_uniform(1, 1 << 31)[0])

    s = torch.as_tensor(sk.s, dtype=torch.float64, device=device)
    inner = torch.empty(R, dtype=torch.int64, device=device)
    for r0, r1 in seeded_blocks(R, n, device):
        a = seeded_rows(seed, n, q_ks, r0, r1, device).to(torch.float64)
        inner[r0:r1] = (a @ s).to(torch.int64)
    inner = inner.remainder_(q_ks).cpu().numpy()

    # messages + noise: identical to key_switch_gen
    digits = np.array([pow(base_ks, k) for k in range(digit_count)],
                      dtype=np.uint64)
    j_idx = np.arange(base_ks, dtype=np.uint64)
    jk = (j_idx[:, None] * digits[None, :]) % np.uint64(q_ks)
    sv_n = sk_n.s
    msg = np.where(sv_n[:, None, None] == 1, jk[None],
                   np.where(sv_n[:, None, None] == -1,
                            (np.uint64(q_ks) - jk[None]) % np.uint64(q_ks), 0))
    e = rng.discrete_gaussian_signed(R, params.std).reshape(
        N, base_ks, digit_count).astype(np.int64)
    B = (msg.astype(np.int64) + e
         + inner.reshape(N, base_ks, digit_count)) % np.int64(q_ks)
    return SeededSwitchingKey(seed, N, base_ks, digit_count, n, q_ks,
                              np.uint64(B))


def key_gen(rng: BinFHERng, size: int, modulus: int) -> LWEPrivateKey:
    """Ternary uniform secret (lwe-pke.cpp:48-51)."""
    return LWEPrivateKey(rng.ternary_uniform_signed(size), modulus)


def _inner_ternary(a: np.ndarray, s_signed: np.ndarray, mod: int) -> np.ndarray:
    """<a, s> mod `mod` for ternary signed s — no 64x64 products needed.

    Fast path: when every |partial sum| fits in the 53-bit f64 mantissa
    (n * (mod-1) < 2^53, true for all LWE-level moduli up to 2^40 at n <= 2^12)
    the inner product is an exact float64 BLAS matmul."""
    n = a.shape[-1]
    if n * (mod - 1) < (1 << 24):
        # partial sums fit the f32 mantissa exactly -> single-precision BLAS
        # (half the memory traffic; dominant cost of key_switch_gen at the
        # classic qKS = 2^14 sets)
        acc = a.astype(np.float32) @ s_signed.astype(np.float32)
        return np.uint64(acc.astype(np.int64) % np.int64(mod))
    if mod & (mod - 1) == 0:
        # power-of-two modulus (the accelerated sets' qKS = 2^35): 64-bit
        # wraparound IS reduction mod 2^k (2^64 is a multiple of the modulus),
        # so one int64 product in the key's words, with no float upcast of
        # the ~5 GB key-switch A block
        words = a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)
        acc = (words @ np.asarray(s_signed, dtype=np.int64)).view(np.uint64)
        return acc & np.uint64(mod - 1)
    if n * (mod - 1) < (1 << 53):
        acc = a.astype(np.float64) @ s_signed.astype(np.float64)
        return np.uint64(acc.astype(np.int64) % np.int64(mod))
    acc = np.where(s_signed == 1, a.astype(np.int64), 0).sum(axis=-1)
    acc -= np.where(s_signed == -1, a.astype(np.int64), 0).sum(axis=-1)
    return np.uint64(acc % np.int64(mod))


def encrypt(rng: BinFHERng, params: LWEParams, sk: LWEPrivateKey, m, p: int = 4,
            mod: int | None = None) -> LWECiphertext:
    """b = <a,s> + e + (m mod p) * (mod/p) (lwe-pke.cpp:56-87). Batched when `m`
    is an array."""
    mod = params.q if mod is None else mod
    m_arr = np.asarray(m, dtype=np.int64)
    shape = m_arr.shape
    n = len(sk.s)
    e = rng.discrete_gaussian_signed(int(np.prod(shape, dtype=np.int64)) if shape else 1,
                                     params.std).reshape(shape)
    a = rng.discrete_uniform(int(np.prod(shape, dtype=np.int64) * n) if shape else n,
                             mod).reshape(shape + (n,))
    b = (m_arr % p) * (mod // p) + e
    b = (b + _inner_ternary(a, sk.s, mod).astype(np.int64)) % np.int64(mod)
    b = np.uint64(b) if shape else np.uint64(b)
    return LWECiphertext(a, b, mod)


def _reduced_a(ct: LWECiphertext) -> np.ndarray:
    """ct.a reduced mod ct.modulus. Raw retags (EvalDecomp digits, the
    EvalFunc modulus raise) carry values larger than the tag; reducing is a
    congruence no-op for decryption but REQUIRED for _inner_ternary's
    magnitude-bounded fast paths (an f32 inner product over unreduced 2^23
    values silently loses ~7 bits — enough to flip borderline digits)."""
    mod = np.uint64(ct.modulus)
    a = np.asarray(ct.a, dtype=np.uint64)
    return a % mod


def decrypt(params: LWEParams, sk: LWEPrivateKey, ct: LWECiphertext, p: int = 4):
    """round((p/mod) * (b - <a,s>)) via r += mod/(2p); result = p*r // mod
    (lwe-pke.cpp:91-134)."""
    mod = ct.modulus
    inner = _inner_ternary(_reduced_a(ct), sk.s, mod)
    r = (np.uint64(ct.b) % np.uint64(mod) + np.uint64(mod) - inner) % np.uint64(mod)
    r = (r + np.uint64(mod // (p * 2))) % np.uint64(mod)
    return (np.uint64(p) * r) // np.uint64(mod)


def decrypt_without_scale(params: LWEParams, sk: LWEPrivateKey, ct: LWECiphertext, p: int = 4):
    """b - <a,s> without the plaintext rescale (lwe-pke.cpp:136-173)."""
    mod = ct.modulus
    inner = _inner_ternary(_reduced_a(ct), sk.s, mod)
    return (np.uint64(ct.b) % np.uint64(mod) + np.uint64(mod) - inner) % np.uint64(mod)


# ---- homomorphic helpers (lwe-pke.cpp:175-201) -----------------------------
# Note: `a` components may be stored narrower than u64 (the fused device gate
# path returns u16 for q <= 2^16), so sums are formed with an explicit u64
# result dtype before reduction.

def add_eq(ct1: LWECiphertext, ct2: LWECiphertext) -> None:
    m = np.uint64(ct1.modulus)
    ct1.a = np.add(ct1.a, ct2.a, dtype=np.uint64) % m
    ct1.b = (np.uint64(ct1.b) + np.uint64(ct2.b)) % m


def add_const_eq(ct: LWECiphertext, cnst: int) -> None:
    ct.b = (np.uint64(ct.b) + np.uint64(cnst)) % np.uint64(ct.modulus)


def sub_eq(ct1: LWECiphertext, ct2: LWECiphertext) -> None:
    m = np.uint64(ct1.modulus)
    ct1.a = (ct1.a + m - ct2.a) % m
    ct1.b = (np.uint64(ct1.b) + m - np.uint64(ct2.b)) % m


def sub_eq2(ct1: LWECiphertext, ct2: LWECiphertext) -> None:
    """ct2 = ct1 - ct2 (lwe-pke.cpp:189-192)."""
    m = np.uint64(ct2.modulus)
    ct2.a = (ct1.a + m - ct2.a) % m
    ct2.b = (np.uint64(ct1.b) + m - np.uint64(ct2.b)) % m


def sub_const_eq(ct: LWECiphertext, cnst: int) -> None:
    ct.b = (np.uint64(ct.b) + np.uint64(ct.modulus) - np.uint64(cnst)) % np.uint64(ct.modulus)


def mult_const_eq(ct: LWECiphertext, cnst: int) -> None:
    m = np.uint64(ct.modulus)
    ct.a = (ct.a * np.uint64(cnst)) % m
    ct.b = (np.uint64(ct.b) * np.uint64(cnst)) % m


def mod_switch(new_mod: int, ct: LWECiphertext) -> LWECiphertext:
    """Scale-and-round every component from ct.modulus to new_mod (lwe-pke.cpp:204-215)."""
    Q = ct.modulus
    a = modmath.round_q_Q(ct.a, new_mod, Q)
    b = modmath.round_q_Q(np.asarray(ct.b), new_mod, Q) if isinstance(ct.b, np.ndarray) \
        else modmath.round_q_Q(int(ct.b), new_mod, Q)
    return LWECiphertext(a, b, new_mod)


def key_switch_gen(rng: BinFHERng, params: LWEParams, sk: LWEPrivateKey,
                   sk_n: LWEPrivateKey) -> LWESwitchingKey:
    """N x baseKS x digitCount LWE encryptions of svN[i] * j * baseKS^k
    (lwe-pke.cpp:218-295)."""
    n, N = params.n, params.N
    q_ks, base_ks = params.q_ks, params.base_ks
    digit_count = params.digit_count_ks
    digits = np.array([pow(base_ks, k) for k in range(digit_count)], dtype=np.uint64)

    sv = sk.s          # signed ternary, length n
    sv_n = sk_n.s      # signed ternary, length N

    # messages: svN[i] * j * baseKS^k mod qKS, shape [N, baseKS, digitCount]
    j_idx = np.arange(base_ks, dtype=np.uint64)
    jk = (j_idx[:, None] * digits[None, :]) % np.uint64(q_ks)        # [baseKS, digitCount]
    msg = np.where(sv_n[:, None, None] == 1, jk[None],
                   np.where(sv_n[:, None, None] == -1, (np.uint64(q_ks) - jk[None]) % np.uint64(q_ks), 0))

    e = rng.discrete_gaussian_signed(N * base_ks * digit_count, params.std)
    e = e.reshape(N, base_ks, digit_count).astype(np.int64)
    # store A at the narrowest width that holds qKS (the [N, baseKS, dc, n]
    # block is ~10^8 entries at production sizes; u16 storage for the classic
    # qKS = 2^14 sets cuts keygen's memory traffic 4x)
    adt = np.uint16 if q_ks <= (1 << 16) else \
        np.uint32 if q_ks <= (1 << 32) else np.uint64
    A = rng.discrete_uniform(N * base_ks * digit_count * n, q_ks,
                             dtype=adt).reshape(N, base_ks, digit_count, n)
    inner = _inner_ternary(A, sv, q_ks)
    B = (msg.astype(np.int64) + e + inner.astype(np.int64)) % np.int64(q_ks)
    return LWESwitchingKey(A=A, B=np.uint64(B))


def key_switch(params: LWEParams, K: LWESwitchingKey, ct_qn: LWECiphertext) -> LWECiphertext:
    """Digit-decompose a (base baseKS), subtract the matching key rows
    (lwe-pke.cpp:299-321). Batched over leading dims of ct_qn."""
    n, N = params.n, params.N
    q_ks, base_ks = params.q_ks, params.base_ks
    digit_count = params.digit_count_ks
    mQ = np.uint64(q_ks)

    a_in = np.asarray(ct_qn.a).astype(np.uint64)          # [..., N]
    batch_shape = a_in.shape[:-1]
    a_out = np.zeros(batch_shape + (n,), dtype=np.uint64)
    b_out = np.asarray(ct_qn.b).astype(np.uint64)

    atmp = a_in.copy()
    bK = np.uint64(base_ks)
    i_idx = np.broadcast_to(np.arange(N), a_in.shape)
    for j in range(digit_count):
        a0 = (atmp % bK).astype(np.int64)                 # digit values [..., N]
        rows_a = K.A[i_idx, a0, j]                        # [..., N, n]
        rows_b = K.B[i_idx, a0, j]                        # [..., N]
        a_out = (a_out + (mQ * np.uint64(n))
                 - rows_a.sum(axis=-2, dtype=np.uint64) % mQ) % mQ
        b_out = (b_out + (mQ * np.uint64(N))
                 - rows_b.sum(axis=-1, dtype=np.uint64) % mQ) % mQ
        atmp = atmp // bK
    return LWECiphertext(a_out % mQ, b_out % mQ, q_ks)


def noiseless_embedding(params: LWEParams, m: int) -> LWECiphertext:
    """a = 0, b = m * (q/4) (lwe-pke.cpp:326-338)."""
    q = params.q
    a = np.zeros(params.n, dtype=np.uint64)
    return LWECiphertext(a, np.uint64((m * (q >> 2)) % q), q)
