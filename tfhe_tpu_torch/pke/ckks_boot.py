"""CKKS bootstrapping: ModRaise -> CoeffsToSlots -> EvalMod -> SlotsToCoeffs.

Port of `tfhe_tpu/pke/ckks_boot.py`, host numpy as there (the device
bootstraps, `ckks_boot_device.py` and `ckks_boot_fft_device.py`, use its
ModRaise, precomputations and rotation plans). Counterpart of the
reference's `ckksrns-fhe.cpp` (EvalBootstrapSetup /
EvalBootstrapKeyGen / EvalBootstrap, src/pke/lib/scheme/ckksrns/
ckksrns-fhe.cpp:1-2451), re-designed for this exact-arithmetic host CKKS
(pke/ckks.py):

- **ModRaise**: the exhausted single-limb ciphertext's coefficients are
  re-embedded into the full RNS chain; the plaintext becomes Delta*m + q0*I
  with a small integer polynomial I, i.e. the CKKS value m + r*I with
  r = q0/Delta (~1 since limb bits == scale bits).
- **CoeffsToSlots / SlotsToCoeffs**: homomorphic DFT expressed as slot-space
  linear transforms  w = A z + B conj(z)  evaluated by rotations +
  diagonal plaintext multiplications (full packing, slots = N/2; the
  reference's FFT-factored/BSGS variants are an optimization of the same
  map, ckksrns-fhe.cpp CoeffsToSlots).
- **EvalMod**: x mod r via the scaled-sine Chebyshev approximation
  (r/2pi)*sin(2pi x / r), evaluated with the T_{k+1} = 2t*T_k - T_{k-1}
  recurrence. Depth is linear in the degree — affordable here because the
  host chain is exact big-int arithmetic and the limb budget is just a
  parameter; the reference's Paterson-Stockmeyer variant
  (EvalChebyshevSeriesPS) is the production-scale optimization.

Precision: the result carries the usual CKKS bootstrapping approximation
error O(|m|^3/r^2 + eps_cheb); tests pin a documented bound. Messages must be
small relative to 1 (|m| <~ 0.05) exactly as the reference requires messages
small relative to q0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ckks import CKKSCiphertext, CKKSContext, encode, _at_level
from .dcrt import DCRTParams, DCRTPoly
from .encoding import apply_automorphism_coeff


# -- automorphisms ----------------------------------------------------------

def galois_element(rot: int, N: int) -> int:
    """Slot rotation by `rot` corresponds to X -> X^(5^rot mod 2N)."""
    return pow(5, rot % (2 * N), 2 * N)


def conj_element(N: int) -> int:
    return 2 * N - 1


def automorphism_dcrt(poly: DCRTPoly, k: int) -> DCRTPoly:
    """a(X) -> a(X^k) on a residue tower (coefficient-domain per limb)."""
    p = poly.to_coeff()
    rns = np.stack([apply_automorphism_coeff(p.rns[i], k, m)
                    for i, m in enumerate(p.params.moduli)])
    return DCRTPoly(p.params, rns, eval_form=False).to_eval()


def galois_key_gen(ctx: CKKSContext, sk, k: int) -> tuple[list, list]:
    """Key-switching key from s(X^k) to s: windowed gadget encryptions of
    T^d * s(X^k), same structure as relin_key_gen (keyswitch-bv.cpp)."""
    _, s_signed = sk
    d = ctx.params.dcrt
    N = ctx.params.N
    # automorphism of the signed secret: coefficient permutation with sign
    idx = (np.arange(N) * k) % (2 * N)
    tgt = idx % N
    sign = np.where(idx >= N, -1, 1)
    sk_auto = np.zeros(N, dtype=np.int64)
    sk_auto[tgt] = sign * np.asarray(s_signed, dtype=np.int64)
    s = ctx._sk_at(sk, d)
    s_k = DCRTPoly.from_signed(d, sk_auto, eval_form=True)
    T = 1 << ctx.params.relin_window
    n_digits = (ctx.params.Q.bit_length() + ctx.params.relin_window - 1) \
        // ctx.params.relin_window
    bs, as_ = [], []
    for dd in range(n_digits):
        a_d = ctx._uniform(d)
        e_d = ctx._gaussian(d)
        bs.append(-(a_d * s + e_d) + s_k.mul_scalar(pow(T, dd, ctx.params.Q)))
        as_.append(a_d)
    return bs, as_


def eval_automorphism(ctx: CKKSContext, ct: CKKSCiphertext, k: int,
                      gk) -> CKKSCiphertext:
    """Apply X -> X^k to a 2-poly ciphertext and switch back to s."""
    assert len(ct.polys) == 2
    lp = ct.level_params
    c0 = automorphism_dcrt(ct.polys[0], k)
    c1 = automorphism_dcrt(ct.polys[1], k)
    from .keyswitch import HybridKSKey, hybrid_key_switch
    if isinstance(gk, HybridKSKey):
        d0, d1 = hybrid_key_switch(gk, c1, lp)
        return CKKSCiphertext([c0 + d0, d1], ct.scale, ct.params)
    # key switch c1 (digit decomposition against the galois key)
    bs, as_ = gk
    w = ctx.params.relin_window
    T = 1 << w
    c1_big = c1.to_bigint()
    out0, out1 = c0, DCRTPoly.zero(lp)
    n_digits = (lp.Q.bit_length() + w - 1) // w
    for dd in range(n_digits):
        digit = [(c >> (w * dd)) & (T - 1) for c in c1_big]
        dp = DCRTPoly.from_bigint(lp, digit).to_eval()
        out0 = out0 + _at_level(bs[dd], lp) * dp
        out1 = out1 + _at_level(as_[dd], lp) * dp
    return CKKSCiphertext([out0, out1], ct.scale, ct.params)


def eval_rotate(ctx: CKKSContext, ct: CKKSCiphertext, rot: int,
                keys: dict) -> CKKSCiphertext:
    if rot % ctx.params.slots == 0:
        return ct
    k = galois_element(rot, ctx.params.N)
    return eval_automorphism(ctx, ct, k, keys[k])


def eval_conjugate(ctx: CKKSContext, ct: CKKSCiphertext,
                   keys: dict) -> CKKSCiphertext:
    k = conj_element(ctx.params.N)
    return eval_automorphism(ctx, ct, k, keys[k])


# -- level/scale-aligned helpers -------------------------------------------

def _drop_to(ct: CKKSCiphertext, lp: DCRTParams) -> CKKSCiphertext:
    """Level reduction: restricting the tower to fewer limbs leaves the
    plaintext (and scale) unchanged."""
    if ct.level_params.moduli == lp.moduli:
        return ct
    return CKKSCiphertext([_at_level(p, lp) for p in ct.polys],
                          ct.scale, ct.params)


def _align(a: CKKSCiphertext, b: CKKSCiphertext):
    la, lb = a.level_params, b.level_params
    lp = la if la.L <= lb.L else lb
    a2, b2 = _drop_to(a, lp), _drop_to(b, lp)
    rel = abs(a2.scale - b2.scale) / max(a2.scale, b2.scale)
    assert rel < 1e-4, f"scale drift too large to add: {rel}"
    return a2, b2, lp


def add_ct(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a2, b2, _ = _align(a, b)
    n = max(len(a2.polys), len(b2.polys))
    polys = []
    for i in range(n):
        if i < len(a2.polys) and i < len(b2.polys):
            polys.append(a2.polys[i] + b2.polys[i])
        else:
            polys.append((a2.polys if i < len(a2.polys) else b2.polys)[i])
    return CKKSCiphertext(polys, max(a2.scale, b2.scale), a.params)


def sub_ct(a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
    a2, b2, _ = _align(a, b)
    return CKKSCiphertext([x - y for x, y in zip(a2.polys, b2.polys)],
                          max(a2.scale, b2.scale), a.params)


def mult_const(ctx: CKKSContext, ct: CKKSCiphertext, c: float,
               rescale: bool = True,
               plain_scale: float | None = None) -> CKKSCiphertext:
    """Multiply every slot by a real constant (integer-scaled, then rescale).
    `plain_scale` overrides the constant's encoding scale — the
    FLEXIBLEAUTO-style lever for landing the product at an exact target scale
    (pass q_last * target / ct.scale)."""
    lp = ct.level_params
    delta = ctx.params.scale if plain_scale is None else plain_scale
    k = int(round(c * delta))
    out = CKKSCiphertext([p.mul_scalar(k % lp.Q) for p in ct.polys],
                         ct.scale * delta, ct.params)
    return ctx.rescale(out) if rescale else out


def mult_plain_vec(ctx: CKKSContext, ct: CKKSCiphertext, vec,
                   rescale: bool = True,
                   plain_scale: float | None = None) -> CKKSCiphertext:
    """Slotwise multiply by a complex vector (encoded at scale Delta, or at
    `plain_scale` to steer the product onto an exact scale)."""
    lp = ct.level_params
    sc = ctx.params.scale if plain_scale is None else plain_scale
    m = encode(ctx.params, vec, sc)
    dm = DCRTPoly.from_signed(lp, m, eval_form=True)
    out = CKKSCiphertext([p * dm for p in ct.polys],
                         ct.scale * sc, ct.params)
    return ctx.rescale(out) if rescale else out


def mult_ct(ctx: CKKSContext, a: CKKSCiphertext, b: CKKSCiphertext,
            rlk) -> CKKSCiphertext:
    a2, b2, _ = _align(a, b)
    return ctx.eval_mult(a2, b2, rlk=rlk, rescale=True)


def mod_raise(ctx: CKKSContext, ct: CKKSCiphertext) -> CKKSCiphertext:
    """ModRaise: re-embed the exhausted (level-1) ciphertext's centered
    coefficients into the full chain. The plaintext becomes
    Delta*m + q0*I with small integer I (EvalBootstrap "RAISING THE
    MODULUS", ckksrns-fhe.cpp) — shared by every bootstrap driver."""
    p = ctx.params
    full = p.dcrt
    assert ct.level_params.L == 1, "bootstrap expects a level-1 ciphertext"
    assert len(ct.polys) == 2
    raised = []
    for poly in ct.polys:
        c = poly.to_centered_bigint()
        raised.append(DCRTPoly.from_bigint(
            full, [x % full.Q for x in c]).to_eval())
    return CKKSCiphertext(raised, ct.scale, p)


# -- bootstrap precomputation ----------------------------------------------

@dataclass
class BootstrapPrecom:
    cts_A: np.ndarray       # [s, s] coeffs->slots
    cts_B: np.ndarray
    stc_A: np.ndarray       # [s, s] slots->coeffs
    stc_B: np.ndarray
    cheb_coeffs: np.ndarray  # Chebyshev series of cos((2piK t - pi/2)/2^g)
    K: float                # |x| bound in units of r
    r: float                # q0 / Delta
    q0: int
    double_angles: int      # g


def eval_bootstrap_setup(ctx: CKKSContext, K: float = 8.0,
                         cheb_deg: int = 22,
                         double_angles: int = 3) -> BootstrapPrecom:
    """Precompute the CTS/STC matrices and the Chebyshev series of the
    base cosine for the double-angle EvalMod (EvalBootstrapSetup,
    ckksrns-fhe.cpp — which likewise approximates a cosine and applies
    double-angle iterations)."""
    p = ctx.params
    N, s = p.N, p.slots
    from .ckks import _slot_exponents
    zeta = np.exp(1j * np.pi * _slot_exponents(N) / N)      # per-slot root
    k_idx = np.arange(s)
    # CTS: w_k = m_k + i m_{k+s} = sum_j A[k,j] z_j + B[k,j] conj(z_j)
    cts_A = (zeta[None, :] ** (-k_idx[:, None])
             + 1j * zeta[None, :] ** (-(k_idx[:, None] + s))) / N
    cts_B = (zeta[None, :] ** (k_idx[:, None])
             + 1j * zeta[None, :] ** (k_idx[:, None] + s)) / N
    # STC: y_j = sum_k A'[j,k] w_k + B'[j,k] conj(w_k)
    stc_A = (zeta[:, None] ** k_idx[None, :]
             - 1j * zeta[:, None] ** (k_idx[None, :] + s)) / 2
    stc_B = (zeta[:, None] ** k_idx[None, :]
             + 1j * zeta[:, None] ** (k_idx[None, :] + s)) / 2

    q0 = p.dcrt.moduli[0]
    r = q0 / p.scale
    g = double_angles
    # base angle: after g double-angle steps, cos(2pi K t - pi/2) = sin(2pi K t)
    a, b = 2 * np.pi * K / (1 << g), -np.pi / 2 / (1 << g)

    def base(t):
        return np.cos(a * np.asarray(t) + b)

    cheb = np.polynomial.chebyshev.chebinterpolate(base, cheb_deg)
    return BootstrapPrecom(cts_A, cts_B, stc_A, stc_B, cheb, K, r, q0, g)


def eval_bootstrap_keygen(ctx: CKKSContext, sk) -> dict:
    """All Galois keys the linear transforms need: every slot rotation plus
    conjugation (EvalBootstrapKeyGen; the reference generates the same index
    set from its rotation plan)."""
    N, s = ctx.params.N, ctx.params.slots
    keys = {}
    for rot in range(1, s):
        k = galois_element(rot, N)
        if k not in keys:
            keys[k] = galois_key_gen(ctx, sk, k)
    kc = conj_element(N)
    keys[kc] = galois_key_gen(ctx, sk, kc)
    return keys


def _auto_slot_action(N: int, a: int) -> tuple[np.ndarray, np.ndarray]:
    """Slot action of X -> X^a in the 5-orbit root ordering used by
    encode(): slot j of sigma_a(m) holds z_u (flag True) or conj(z_u)
    (flag False), where e_j*a mod 2N = e_u or 2N-e_u (e_j = 5^j). For
    a = 5^r this is exactly the cyclic shift u = j+r, all flags plain."""
    from .ckks import _slot_exponents
    e = _slot_exponents(N)
    pos = {int(ei): u for u, ei in enumerate(e)}
    out_e = (e * a) % (2 * N)
    plain = np.array([int(x) in pos for x in out_e])
    u = np.array([pos[int(x)] if p else pos[2 * N - int(x)]
                  for x, p in zip(out_e, plain)], dtype=np.int64)
    return u, plain


def eval_linear_transform(ctx: CKKSContext, ct: CKKSCiphertext,
                          A: np.ndarray, B: np.ndarray,
                          keys: dict) -> CKKSCiphertext:
    """w = A z + B conj(z) on slots, decomposed along the orbits of the
    automorphism group: out = sum_r dP_r . sigma_{5^r}(z) + dC_r .
    sigma_{5^r}(conj z). In the natural slot ordering sigma_{5^r} is a signed
    permutation (not a cyclic shift), so the generalized diagonals are read
    off its explicit action — the same map the reference's CoeffsToSlots
    rotation plan computes in its 5^j packing order (ckksrns-fhe.cpp)."""
    p = ctx.params
    N, s = p.N, p.slots
    j = np.arange(s)
    ct_c = eval_conjugate(ctx, ct, keys)
    acc = None
    for r in range(s):
        a = galois_element(r, N)
        u, plain = _auto_slot_action(N, a)
        # sigma_a(z)_j      = z_u (plain) | conj(z_u)   -> coeff A | B
        # sigma_a(conj z)_j = conj(z_u)   | z_u         -> coeff B | A
        dP = np.where(plain, A[j, u], B[j, u])
        dC = np.where(plain, B[j, u], A[j, u])
        rot = ct if r == 0 else eval_automorphism(ctx, ct, a, keys[a])
        rot_c = ct_c if r == 0 else eval_automorphism(ctx, ct_c, a, keys[a])
        term = mult_plain_vec(ctx, rot, dP)
        term = add_ct(term, mult_plain_vec(ctx, rot_c, dC))
        acc = term if acc is None else add_ct(acc, term)
    return acc


def eval_chebyshev(ctx: CKKSContext, t: CKKSCiphertext, coeffs: np.ndarray,
                   rlk) -> CKKSCiphertext:
    """sum_k c_k T_k(t) by the three-term recurrence (linear depth; the
    reference's Paterson-Stockmeyer version is the production-scale path)."""
    deg = len(coeffs) - 1
    # T_0 = 1 handled as the constant term added at the end
    T_prev = None            # T_0 contribution folded into the constant
    T_cur = t                # T_1
    acc = mult_const(ctx, t, float(coeffs[1])) if deg >= 1 else None
    two_t = scale_int(t, 2)  # exact doubling, no level cost
    for k in range(2, deg + 1):
        if T_prev is None:
            # T_2 = 2 t^2 - 1
            t2 = mult_ct(ctx, two_t, t, rlk)
            T_next = add_const(ctx, t2, -1.0)
        else:
            T_next = sub_ct(mult_ct(ctx, two_t, T_cur, rlk), T_prev)
        if abs(float(coeffs[k])) > 0:
            acc = add_ct(acc, mult_const(ctx, T_next, float(coeffs[k])))
        T_prev, T_cur = T_cur, T_next
    return add_const(ctx, acc, float(coeffs[0]))


def add_const(ctx: CKKSContext, ct: CKKSCiphertext, c: float) -> CKKSCiphertext:
    """Add a real constant to every slot (constant polynomial at the
    ciphertext's scale)."""
    lp = ct.level_params
    k = int(round(c * ct.scale))
    const = np.zeros(ctx.params.N, dtype=np.int64)
    const[0] = k
    dm = DCRTPoly.from_signed(lp, const, eval_form=True)
    return CKKSCiphertext([ct.polys[0] + dm] + list(ct.polys[1:]),
                          ct.scale, ct.params)


def scale_int(ct: CKKSCiphertext, k: int) -> CKKSCiphertext:
    """Multiply the value by a small integer exactly (no scale change)."""
    lp = ct.level_params
    return CKKSCiphertext([p.mul_scalar(k % lp.Q) for p in ct.polys],
                          ct.scale, ct.params)


def eval_mod(ctx: CKKSContext, t: CKKSCiphertext, pre: BootstrapPrecom,
             rlk) -> CKKSCiphertext:
    """x mod r on slots given t = x/(K r) in [-1, 1]: Chebyshev base cosine
    followed by `g` double-angle squarings, scaled by r/2pi — the same
    cosine/double-angle construction as the reference's EvalMod."""
    w = eval_chebyshev(ctx, t, pre.cheb_coeffs, rlk)
    for _ in range(pre.double_angles):
        w = add_const(ctx, scale_int(mult_ct(ctx, w, w, rlk), 2), -1.0)
    return mult_const(ctx, w, pre.r / (2 * np.pi))


def eval_bootstrap(ctx: CKKSContext, ct: CKKSCiphertext, pre: BootstrapPrecom,
                   keys: dict, rlk) -> CKKSCiphertext:
    """Refresh a depth-exhausted ciphertext back to (nearly) the full chain
    (EvalBootstrap, ckksrns-fhe.cpp)."""
    p = ctx.params

    # 1. ModRaise: plaintext becomes Delta*m + q0*I -> value m + r*I
    ct1 = mod_raise(ctx, ct)

    # 2. CoeffsToSlots, with the EvalMod normalization 1/(K*r) folded into
    #    the transform matrices (slots w_k = (coeff_k + i coeff_{k+s})/(K*r))
    norm = 1.0 / (pre.K * pre.r)
    ct_slots = eval_linear_transform(ctx, ct1, pre.cts_A * norm,
                                     pre.cts_B * norm, keys)

    # 3. EvalMod on real and imaginary parts separately:
    #    re = (w + conj w)/2, im = (w - conj w)/2i
    w_c = eval_conjugate(ctx, ct_slots, keys)
    ct_re = mult_const(ctx, add_ct(ct_slots, w_c), 0.5)
    ct_im = mult_plain_vec(ctx, sub_ct(ct_slots, w_c),
                           np.full(p.slots, -0.5j))
    m_re = eval_mod(ctx, ct_re, pre, rlk)
    m_im = eval_mod(ctx, ct_im, pre, rlk)
    recomb = add_ct(m_re, mult_plain_vec(ctx, m_im, np.full(p.slots, 1j)))

    # 4. SlotsToCoeffs
    return eval_linear_transform(ctx, recomb, pre.stc_A, pre.stc_B, keys)


# -- production-scale path: BSGS transforms + Paterson-Stockmeyer ----------
#
# The components the reference ships for real ring dimensions
# (ckksrns-fhe.cpp CoeffsToSlots rotation batching; ckksrns-advancedshe.cpp
# EvalChebyshevSeriesPS / LongDivisionChebyshev): O(sqrt(slots)) Galois keys
# and rotations per linear transform instead of O(slots), and O(sqrt(deg))
# ciphertext multiplications with O(log deg) depth instead of O(deg)/O(deg).


def _bsgs_split(s: int) -> tuple[int, int]:
    """Baby/giant sizes b, g with b*g >= s, b ~ sqrt(s)."""
    b = max(1, int(np.ceil(np.sqrt(s))))
    return b, (s + b - 1) // b


def bsgs_key_indices(N: int, slots: int) -> list[int]:
    """The Galois elements the BSGS transforms need: baby rotations 1..b-1,
    giant rotations b, 2b, ..., and conjugation — 2*sqrt(s) keys instead of
    the dense transform's s (the reference's rotation-plan index set)."""
    b, g = _bsgs_split(slots)
    ks = {conj_element(N)}
    for r in range(1, b):
        ks.add(galois_element(r, N))
    for i in range(1, g):
        ks.add(galois_element(i * b, N))
    return sorted(ks)


def eval_bootstrap_keygen_bsgs(ctx: CKKSContext, sk, dnum: int = 3,
                               ks_limb_bits: int = 40) -> dict:
    """Hybrid Galois keys for the BSGS index set (EvalBootstrapKeyGen with
    the rotation plan; keys are hybrid/GHS so one key serves every level)."""
    from .keyswitch import galois_key_gen_hybrid
    keys = {}
    for k in bsgs_key_indices(ctx.params.N, ctx.params.slots):
        keys[k] = galois_key_gen_hybrid(ctx.rng, ctx.params.dcrt, sk[1], k,
                                        dnum, limb_bits=ks_limb_bits)
    return keys


def eval_linear_transform_bsgs(ctx: CKKSContext, ct: CKKSCiphertext,
                               A: np.ndarray, B: np.ndarray,
                               keys: dict,
                               plain_scale: float | None = None
                               ) -> CKKSCiphertext:
    """w = A z + B conj(z) by baby-step/giant-step diagonal decomposition.

    In the 5-orbit slot ordering sigma_r(z)_j = z_{j+r}, so
    A z = sum_r diag_r(A) . sigma_r(z) with diag_r(A)[j] = A[j, (j+r) mod s],
    and with r = i*b + k:
        A z = sum_i sigma_{ib}( sum_k roll(diag_{ib+k}, ib) . sigma_k(z) ).
    Costs b-1 baby + g-1 giant rotations + 1 conjugation (2 sqrt(s) keyswitch
    ops) and one rescale level — the same restructuring as the reference's
    CoeffsToSlots rotation batching (ckksrns-fhe.cpp)."""
    p = ctx.params
    N, s = p.N, p.slots
    b, g = _bsgs_split(s)
    j = np.arange(s)
    ct_c = eval_conjugate(ctx, ct, keys)
    bab = [ct]
    bab_c = [ct_c]
    for k in range(1, b):
        a = galois_element(k, N)
        bab.append(eval_automorphism(ctx, ct, a, keys[a]))
        bab_c.append(eval_automorphism(ctx, ct_c, a, keys[a]))
    acc = None
    for i in range(g):
        inner = None
        for k in range(b):
            r = i * b + k
            if r >= s:
                break
            dP = A[j, (j + r) % s]
            dC = B[j, (j + r) % s]
            for d, src in ((dP, bab[k]), (dC, bab_c[k])):
                if not np.any(np.abs(d) > 1e-14):
                    continue
                term = mult_plain_vec(ctx, src, np.roll(d, i * b),
                                      rescale=False,
                                      plain_scale=plain_scale)
                inner = term if inner is None else add_ct(inner, term)
        if inner is None:
            continue
        inner = ctx.rescale(inner)
        if i > 0:
            a = galois_element(i * b, N)
            inner = eval_automorphism(ctx, inner, a, keys[a])
        acc = inner if acc is None else add_ct(acc, inner)
    return acc


def _cheb_divmod_T(c: np.ndarray, e: int) -> tuple[np.ndarray, np.ndarray]:
    """Chebyshev-basis long division f = q*T_e + r with deg f < 2e,
    deg r < e (LongDivisionChebyshev, ckksrns-advancedshe.cpp): uses
    T_d T_e = (T_{e+d} + T_{e-d}) / 2."""
    n = len(c) - 1
    assert n < 2 * e, "divisor must satisfy deg f < 2e"
    r = np.array(c, dtype=np.float64)
    if n < e:
        return np.zeros(1), r
    q = np.zeros(n - e + 1)
    for d in range(n - e, 0, -1):
        q[d] = 2.0 * r[e + d]
        r[e + d] = 0.0
        r[e - d] -= q[d] / 2.0
    q[0] = r[e]
    r[e] = 0.0
    return q, r[:e]


def _cheb_apply(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Plain (numpy) Chebyshev series evaluation, for tests/validation."""
    return np.polynomial.chebyshev.chebval(x, coeffs)


class _PSEvaluator:
    """Paterson-Stockmeyer evaluation of a Chebyshev series on a ciphertext
    (EvalChebyshevSeriesPS): baby powers T_1..T_k, giant powers T_{k*2^i}
    by double-angle, then recursive f = q*T_e + r splitting. O(sqrt(deg))
    ciphertext mults, O(log deg) depth."""

    def __init__(self, ctx: CKKSContext, t: CKKSCiphertext, rlk, k: int):
        self.ctx, self.rlk, self.k = ctx, rlk, k
        self.T: dict[int, CKKSCiphertext] = {1: t}

    def _baby(self, jj: int) -> CKKSCiphertext:
        if jj not in self.T:
            hi, lo = (jj + 1) // 2, jj // 2
            prod2 = scale_int(mult_ct(self.ctx, self._baby(hi),
                                      self._baby(lo), self.rlk), 2)
            if jj % 2 == 0:
                self.T[jj] = add_const(self.ctx, prod2, -1.0)   # 2T_a^2 - 1
            else:
                self.T[jj] = sub_ct(prod2, self._baby(1))       # 2T_aT_{a+1}-T_1
        return self.T[jj]

    def giant(self, e: int) -> CKKSCiphertext:
        if e not in self.T:
            if e <= self.k:
                return self._baby(e)
            half = self.giant(e // 2)
            self.T[e] = add_const(
                self.ctx, scale_int(mult_ct(self.ctx, half, half, self.rlk), 2),
                -1.0)
        return self.T[e]

    def run(self, coeffs: np.ndarray):
        ct, const = self._eval(np.asarray(coeffs, dtype=np.float64))
        return add_const(self.ctx, ct, const) if abs(const) > 1e-14 else ct

    def _eval(self, c: np.ndarray):
        """Returns (ciphertext | None, float const): value = ct + const."""
        n = len(c) - 1
        while n > 0 and abs(c[n]) < 1e-14:
            n -= 1
        c = c[:n + 1]
        if n < self.k:                       # leaf: baby linear combination
            acc = None
            for jj in range(1, n + 1):
                if abs(c[jj]) < 1e-14:
                    continue
                term = mult_const(self.ctx, self._baby(jj), float(c[jj]))
                acc = term if acc is None else add_ct(acc, term)
            return acc, float(c[0])
        e = self.k
        while 2 * e <= n:
            e *= 2
        q, r = _cheb_divmod_T(c, e)
        q_ct, q_const = self._eval(q)
        r_ct, r_const = self._eval(r)
        Te = self.giant(e)
        parts = []
        if q_ct is not None:
            parts.append(mult_ct(self.ctx, q_ct, Te, self.rlk))
        if abs(q_const) > 1e-14:
            parts.append(mult_const(self.ctx, Te, q_const))
        if r_ct is not None:
            parts.append(r_ct)
        acc = parts[0]
        for pt in parts[1:]:
            acc = add_ct(acc, pt)
        return acc, r_const


def eval_chebyshev_ps(ctx: CKKSContext, t: CKKSCiphertext, coeffs: np.ndarray,
                      rlk, k: int | None = None) -> CKKSCiphertext:
    """sum_j c_j T_j(t) via Paterson-Stockmeyer (EvalChebyshevSeriesPS)."""
    deg = len(coeffs) - 1
    if k is None:
        k = max(2, 1 << int(np.ceil(np.log2(max(2.0, np.sqrt(deg / 2))))))
    return _PSEvaluator(ctx, t, rlk, k).run(coeffs)


def eval_mod_ps(ctx: CKKSContext, t: CKKSCiphertext, pre: BootstrapPrecom,
                rlk) -> CKKSCiphertext:
    """eval_mod with the Paterson-Stockmeyer Chebyshev core."""
    w = eval_chebyshev_ps(ctx, t, pre.cheb_coeffs, rlk)
    for _ in range(pre.double_angles):
        w = add_const(ctx, scale_int(mult_ct(ctx, w, w, rlk), 2), -1.0)
    return mult_const(ctx, w, pre.r / (2 * np.pi))


def eval_bootstrap_iterative(ctx: CKKSContext, ct: CKKSCiphertext,
                             pre: BootstrapPrecom, keys: dict, rlk,
                             num_iterations: int = 2,
                             precision: int = 4) -> CKKSCiphertext:
    """Iterative (Meta-style) bootstrapping — EvalBootstrap(ct, numIterations,
    precision), ckksrns-fhe.cpp:229-303. One bootstrap leaves error e1; the
    residual is scaled up by 2^precision, bootstrapped on its own, and
    subtracted back down, shrinking the final error by ~2^precision:

      b1  = Boot(ct)                       ~ m + e1
      err = 2^p * b1 (at the base modulus) - 2^p * ct        -> Delta*2^p*e1
      b2  = Boot(err)                      ~ 2^p*e1 + e2
      out = b1 - b2/2^p                    ~ m - e2/2^p

    The scaled error 2^p*e1 must stay inside EvalMod's small-message range,
    which bounds the useful precision (the reference asserts deg <= its
    correction factor for the same reason)."""
    if num_iterations not in (1, 2):
        raise ValueError("CKKS iterative bootstrapping supports 1 or 2 "
                         "iterations (ckksrns-fhe.cpp:240-242)")
    if not 1 <= precision <= 8:
        # 2^precision * e1 must stay inside EvalMod's small-message range;
        # past ~2^8 the scaled residual leaves the sine's linear regime and
        # the correction silently corrupts the output (the reference bounds
        # precision by its correction factor for the same reason)
        raise ValueError(f"precision {precision} out of the supported "
                         "range [1, 8]")
    b1 = eval_bootstrap_bsgs(ctx, ct, pre, keys, rlk)
    if num_iterations == 1:
        return b1
    P = 1 << precision
    # residual at the input's (base) modulus: multiples of q0 in the
    # plaintext are exactly what the second bootstrap strips again
    b1_down = _drop_to(scale_int(b1, P), ct.level_params)
    err = sub_ct(b1_down, scale_int(ct, P))
    b2 = eval_bootstrap_bsgs(ctx, err, pre, keys, rlk)
    # 1/2^p at the scale that lands the correction on exactly b1's scale
    q_last = b2.level_params.moduli[-1]
    ps = float(q_last) * b1.scale / b2.scale
    return sub_ct(b1, mult_const(ctx, b2, 1.0 / P, plain_scale=ps))


def eval_bootstrap_bsgs(ctx: CKKSContext, ct: CKKSCiphertext,
                        pre: BootstrapPrecom, keys: dict,
                        rlk) -> CKKSCiphertext:
    """EvalBootstrap with the production-scale internals: BSGS CoeffsToSlots
    / SlotsToCoeffs (O(sqrt(s)) keys + rotations) and Paterson-Stockmeyer
    EvalMod (O(sqrt(deg)) mults, O(log deg) depth) — the configuration the
    reference ships for large rings (ckksrns-fhe.cpp + EvalChebyshevSeriesPS)."""
    p = ctx.params
    ct1 = mod_raise(ctx, ct)

    norm = 1.0 / (pre.K * pre.r)
    ct_slots = eval_linear_transform_bsgs(ctx, ct1, pre.cts_A * norm,
                                          pre.cts_B * norm, keys)

    w_c = eval_conjugate(ctx, ct_slots, keys)
    ct_re = mult_const(ctx, add_ct(ct_slots, w_c), 0.5)
    ct_im = mult_plain_vec(ctx, sub_ct(ct_slots, w_c),
                           np.full(p.slots, -0.5j))
    m_re = eval_mod_ps(ctx, ct_re, pre, rlk)
    m_im = eval_mod_ps(ctx, ct_im, pre, rlk)
    recomb = add_ct(m_re, mult_plain_vec(ctx, m_im, np.full(p.slots, 1j)))

    # encode the STC plaintexts at the scale that lands the output on
    # exactly Delta (the rescale divisors q_l are only ~Delta, so without
    # this the refreshed scale drifts ~1e-4 — FLEXIBLEAUTO's correction)
    q_last = recomb.level_params.moduli[-1]
    ps = float(q_last) * p.scale / recomb.scale
    return eval_linear_transform_bsgs(ctx, recomb, pre.stc_A, pre.stc_B, keys,
                                      plain_scale=ps)
