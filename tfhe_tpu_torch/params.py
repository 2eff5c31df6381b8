"""Parameter sets and derivations for the TPU BinFHE scheme.

Mirrors the reference's three `GenerateBinFHEContext` overloads
(`src/binfhe/lib/binfhecontext.cpp:42-181`) and the parameter containers
`LWECryptoParams` (lwe-cryptoparameters.h) / `RingGSWCryptoParams`
(rgsw-cryptoparameters.h:71-160):

- the 17-entry classic table (binfhecontext.cpp:137-156),
- the GPU-era constructor `(set, arbFunc, logQ, N, method, timeOptimization,
  baseG, numDigitsToThrow)` that derives Q', ring dimension, q, qKS, n and the
  default baseG schedule (binfhecontext.cpp:51-113),
- gate constants, gadget powers (including the 3-base sign-eval map), digit
  counts, and `change_base_g` (rgsw-cryptoparameters.h:104-137, 276-282).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from enum import IntEnum

from .utils.numtheory import is_prime, ntt_prime, previous_prime, root_of_unity
from .utils.stdlattice import find_ring_dim


class Method(IntEnum):
    AP = 1    # Ducas-Micciancio (DM / FHEW) variant
    GINX = 2  # Chillotti-Gama-Georgieva-Izabachene (CGGI / TFHE) variant


class Gate(IntEnum):
    # order matters: indexes the gate-constant table (binfhe-constants.h:101)
    OR = 0
    AND = 1
    NOR = 2
    NAND = 3
    XOR_FAST = 4
    XNOR_FAST = 5
    XOR = 6
    XNOR = 7


class ParamSet(IntEnum):
    TOY = 0
    MEDIUM = 1
    STD128_AP = 2
    STD128_APOPT = 3
    STD128 = 4
    STD128_OPT = 5
    STD192 = 6
    STD192_OPT = 7
    STD256 = 8
    STD256_OPT = 9
    STD128Q = 10
    STD128Q_OPT = 11
    STD192Q = 12
    STD192Q_OPT = 13
    STD256Q = 14
    STD256Q_OPT = 15
    SIGNED_MOD_TEST = 16


STD_DEV = 3.19
PRIME = 0  # sentinel: use the ring modulus Q for the key-switching modulus

# numberBits | cyclOrder | latticeParam(n) | mod(q) | modKS | stdDev | baseKS | gadgetBase | baseRK | numDigitsToThrow
# (binfhecontext.cpp:137-156)
_CLASSIC_TABLE = {
    ParamSet.TOY:             (27, 1024, 64, 512, PRIME, STD_DEV, 25, 1 << 9, 23, 0),
    ParamSet.MEDIUM:          (28, 2048, 422, 1024, 1 << 14, STD_DEV, 1 << 7, 1 << 10, 32, 0),
    ParamSet.STD128_AP:       (27, 2048, 512, 1024, 1 << 14, STD_DEV, 1 << 7, 1 << 9, 32, 0),
    ParamSet.STD128_APOPT:    (27, 2048, 502, 1024, 1 << 14, STD_DEV, 1 << 7, 1 << 9, 32, 0),
    ParamSet.STD128:          (27, 2048, 512, 1024, 1 << 14, STD_DEV, 1 << 7, 1 << 7, 32, 0),
    ParamSet.STD128_OPT:      (27, 2048, 502, 1024, 1 << 14, STD_DEV, 1 << 7, 1 << 7, 32, 0),
    ParamSet.STD192:          (37, 4096, 1024, 1024, 1 << 19, STD_DEV, 28, 1 << 14, 32, 0),
    ParamSet.STD192_OPT:      (37, 4096, 805, 1024, 1 << 15, STD_DEV, 32, 1 << 13, 32, 0),
    ParamSet.STD256:          (29, 4096, 1024, 2048, 1 << 14, STD_DEV, 1 << 7, 1 << 8, 46, 0),
    ParamSet.STD256_OPT:      (29, 4096, 990, 2048, 1 << 14, STD_DEV, 1 << 7, 1 << 8, 46, 0),
    ParamSet.STD128Q:         (50, 4096, 1024, 1024, 1 << 25, STD_DEV, 32, 1 << 25, 32, 0),
    ParamSet.STD128Q_OPT:     (50, 4096, 585, 1024, 1 << 15, STD_DEV, 32, 1 << 25, 32, 0),
    ParamSet.STD192Q:         (35, 4096, 1024, 1024, 1 << 17, STD_DEV, 64, 1 << 14, 32, 0),
    ParamSet.STD192Q_OPT:     (35, 4096, 875, 1024, 1 << 15, STD_DEV, 32, 1 << 12, 32, 0),
    ParamSet.STD256Q:         (27, 4096, 2048, 2048, 1 << 16, STD_DEV, 16, 1 << 7, 46, 0),
    ParamSet.STD256Q_OPT:     (27, 4096, 1225, 1024, 1 << 16, STD_DEV, 16, 1 << 7, 32, 0),
    ParamSet.SIGNED_MOD_TEST: (28, 2048, 512, 1024, PRIME, STD_DEV, 25, 1 << 7, 23, 0),
}

# Gadget bases available for dynamic base switching in sign evaluation
# (rgsw-cryptoparameters.h:106)
SIGN_EVAL_BASES = (1 << 14, 1 << 18, 1 << 27)

BETA = 128  # fixed noise bound used by functional bootstrapping (binfhecontext.h:348-350)


@functools.lru_cache(maxsize=None)
def _rns_factors(Q: int) -> tuple[int, int] | None:
    if Q < (1 << 31) or is_prime(Q):
        return None
    from .utils.numtheory import _factorize
    factors = _factorize(Q)
    if len(factors) == 2 and factors[0] * factors[1] == Q and factors[1] < (1 << 28):
        return (factors[1], factors[0])  # (larger, smaller)
    return None


def _digit_count(modulus: int, base: int) -> int:
    """ceil(log(modulus)/log(base)) computed in float64, exactly as the reference
    does with std::ceil/std::log (lwe-pke.cpp:226, rgsw-cryptoparameters.h:87)."""
    return int(math.ceil(math.log(float(modulus)) / math.log(float(base))))


@dataclass(frozen=True)
class LWEParams:
    """LWECryptoParams (lwe-cryptoparameters.h:66-142)."""
    n: int            # LWE dimension
    N: int            # ring dimension
    q: int            # additive-LWE / ciphertext modulus
    Q: int            # ring (RLWE/RGSW) modulus, NTT-friendly prime
    q_ks: int         # key-switching modulus
    std: float        # noise std for encryption and key material
    base_ks: int      # key-switching decomposition base

    @property
    def digit_count_ks(self) -> int:
        return _digit_count(self.q_ks, self.base_ks)


@dataclass
class RGSWParams:
    """RingGSWCryptoParams (rgsw-cryptoparameters.h:71-160)."""
    N: int
    Q: int
    q: int
    base_g: int
    base_r: int
    method: Method
    std: float
    sign_eval: bool = False
    num_digits_to_throw: int = 0
    # derived
    digits_g: int = field(init=False)
    root: int = field(init=False)

    def __post_init__(self):
        if self.base_g & (self.base_g - 1):
            raise ValueError("Gadget base should be a power of two.")
        self.digits_g = _digit_count(self.Q, self.base_g)
        if self.digits_g - self.num_digits_to_throw < 1:
            raise ValueError("Number of digits to throw should leave at least 1 digit in G.")
        self.root = root_of_unity(2 * self.N, self.Q)
        # gadget powers baseG^i mod Q; with sign_eval, one vector per base in
        # SIGN_EVAL_BASES (rgsw-cryptoparameters.h:104-127)
        self.g_power_map: dict[int, list[int]] = {}
        if self.sign_eval:
            for b in SIGN_EVAL_BASES:
                d = _digit_count(self.Q, b)
                self.g_power_map[b] = [pow(b, i, self.Q) for i in range(d)]
            if self.base_g not in self.g_power_map:
                d = self.digits_g
                self.g_power_map[self.base_g] = [pow(self.base_g, i, self.Q) for i in range(d)]
        else:
            self.g_power_map[self.base_g] = [pow(self.base_g, i, self.Q) for i in range(self.digits_g)]
        # AP refreshing-key digit scale factors baseR^k < q (rgsw-cryptoparameters.h:88-97)
        self.digits_r: list[int] = []
        if self.method == Method.AP:
            d_r = _digit_count(self.q, self.base_r)
            self.digits_r = [self.base_r**k for k in range(d_r)]

    @property
    def g_power(self) -> list[int]:
        return self.g_power_map[self.base_g]

    @property
    def rns_primes(self) -> tuple[int, int] | None:
        """(q1, q2) with q1 > q2 when Q is a two-prime RNS composite (each
        factor < 2^28 so single-limb u32 device lanes apply), else None."""
        return _rns_factors(self.Q)

    @property
    def digits_g2(self) -> int:
        return (self.digits_g - self.num_digits_to_throw) * 2

    def gate_const(self, gate: Gate) -> int:
        # {OR:5, AND:7, NOR:1, NAND:3, XOR_FAST:5, XNOR_FAST:1} * (q/8)
        # (rgsw-cryptoparameters.h:130-137)
        mult = (5, 7, 1, 3, 5, 1)[int(gate)]
        return mult * (self.q >> 3)

    def change_base_g(self, base_g: int) -> None:
        """Swap the gadget base (dynamic sign-eval optimization,
        rgsw-cryptoparameters.h:276-282)."""
        if self.base_g != base_g:
            if base_g not in self.g_power_map:
                raise KeyError(f"No gadget powers precomputed for base {base_g}")
            self.base_g = base_g
            self.digits_g = _digit_count(self.Q, base_g)


@dataclass
class BinFHEParams:
    """BinFHECryptoParams: the LWE + RingGSW parameter bundle."""
    lwe: LWEParams
    rgsw: RGSWParams
    time_optimization: bool = False

    @property
    def beta(self) -> int:
        return BETA

    @property
    def max_plaintext_space(self) -> int:
        # q / (2 * beta)  (binfhecontext.h:343-350)
        return self.lwe.q // (2 * BETA)


def from_param_set(param_set: ParamSet, method: Method = Method.GINX) -> BinFHEParams:
    """Classic parameter-table constructor (binfhecontext.cpp:115-181)."""
    (nbits, cycl_order, n, q, mod_ks, std, base_ks, base_g, base_r, throw) = _CLASSIC_TABLE[param_set]
    Q = ntt_prime(nbits, cycl_order)
    N = cycl_order // 2
    q_ks = Q if mod_ks == PRIME else mod_ks
    lwe = LWEParams(n=n, N=N, q=q, Q=Q, q_ks=q_ks, std=std, base_ks=base_ks)
    rgsw = RGSWParams(N=N, Q=Q, q=q, base_g=base_g, base_r=base_r, method=method,
                      std=std, sign_eval=False, num_digits_to_throw=throw)
    return BinFHEParams(lwe=lwe, rgsw=rgsw)


def from_gpu_style(param_set: ParamSet, arb_func: bool = False, log_q: int = 11,
                   N: int = 0, method: Method = Method.GINX,
                   time_optimization: bool = False, base_g: int = 0,
                   num_digits_to_throw: int = 0,
                   rns_modulus: bool | None = None) -> BinFHEParams:
    """The batched/accelerated constructor (binfhecontext.cpp:51-113).

    Derives a 54-bit ring modulus (27-bit when logQ == 11), the minimum
    standard ring dimension for 128-bit classic security, q = 2*ringDim
    (ringDim when arbFunc), qKS = 2^35, and n = 1305 (32 for TOY).

    TPU-native deviation (documented in docs/PARITY.md): by default the 54-bit
    ring modulus is the *composite* Q = q1*q2 of the two largest 27-bit NTT
    primes ≡ 1 (mod 2N), not the reference's single 54-bit prime
    (binfhecontext.cpp:95). The scheme only needs Q's magnitude and a 2N-th
    root of unity (which exists mod q1*q2 by CRT), and the RNS form lets the
    TPU run the entire blind rotation in single-limb u32 lanes instead of
    emulated 64-bit pairs — ~4x faster. Pass rns_modulus=False for the
    reference's single-prime modulus.
    """
    if method != Method.GINX:
        raise NotImplementedError("CGGI is the only supported method")
    if param_set not in (ParamSet.STD128, ParamSet.TOY):
        raise NotImplementedError("STD128 and TOY are the only supported sets")
    if log_q > 29:
        raise NotImplementedError("logQ > 29 is not supported")
    if log_q < 11:
        raise NotImplementedError("logQ < 11 is not supported")

    log_q_prime = 54
    if base_g == 0:
        if log_q > 25:
            base_g = 1 << 14
        elif log_q > 16:
            base_g = 1 << 18
        elif log_q > 11:
            base_g = 1 << 27
        else:  # log_q == 11
            base_g = 1 << 5
            log_q_prime = 27

    ring_dim = find_ring_dim("128_classic", log_q_prime)
    if N >= ring_dim:
        ring_dim = N
    if rns_modulus is None:
        rns_modulus = log_q_prime == 54
    if rns_modulus and log_q_prime == 54:
        q1 = ntt_prime(27, 2 * ring_dim)
        q2 = previous_prime(q1, 2 * ring_dim)
        Q = q1 * q2
    else:
        Q = ntt_prime(log_q_prime, 2 * ring_dim)
    q = ring_dim if arb_func else 2 * ring_dim
    q_ks = 1 << 35
    n = 32 if param_set == ParamSet.TOY else 1305

    lwe = LWEParams(n=n, N=ring_dim, q=q, Q=Q, q_ks=q_ks, std=STD_DEV, base_ks=32)
    rgsw = RGSWParams(N=ring_dim, Q=Q, q=q, base_g=base_g, base_r=23, method=method,
                      std=STD_DEV, sign_eval=((log_q != 11) and time_optimization),
                      num_digits_to_throw=num_digits_to_throw)
    return BinFHEParams(lwe=lwe, rgsw=rgsw, time_optimization=time_optimization)


def from_custom(n: int, N: int, q: int, Q: int, std: float, base_ks: int,
                base_g: int, base_r: int, method: Method = Method.GINX) -> BinFHEParams:
    """Fully custom constructor (binfhecontext.cpp:42-49). Note qKS = Q here."""
    lwe = LWEParams(n=n, N=N, q=q, Q=Q, q_ks=Q, std=std, base_ks=base_ks)
    rgsw = RGSWParams(N=N, Q=Q, q=q, base_g=base_g, base_r=base_r, method=method,
                      std=std, sign_eval=True)
    return BinFHEParams(lwe=lwe, rgsw=rgsw)
