"""Pure-RNS CKKS core: no big-integer round trips anywhere in the hot path.

Port of `tfhe_tpu/pke/ckks_rns.py`. The exactness-first host CKKS
(pke/ckks.py) routes multiplication and rescaling through exact CRT
interpolation; this module is the production-form counterpart (the
reference's rns-*.cpp / keyswitch-hybrid.cpp machinery): every operation is
a per-limb vectorized numpy kernel over [L, N] residue towers, and
`pke/ckks_device.py` runs the same steps on the device, tower for tower.

- `rescale_rns`: c' = (c - [c]_{q_L}) / q_L per remaining limb — one
  subtract and one Shoup multiply per limb (rns-leveledshe.cpp ModReduce).
- `fast_base_convert`: HPS approximate base extension
  x -> sum_i [x * (D/q_i)^{-1}]_{q_i} * (D/q_i) - alpha*D with alpha in
  integer fixed point (BEHZ/HPS; base-extension core of rns-*.cpp).
- `hybrid keyswitch`: dnum digit groups extended to the PQ basis by FBC,
  inner products with the key tower, ModDown by P — the same algorithm as
  pke/keyswitch.py but with every step staying in RNS.

`CKKSRnsContext.eval_mult_limb` runs the multiplication with the ring
dimension sharded over a `("limb",)` device mesh (`parallel/limb_ntt.py`),
tower for tower equal to `eval_mult`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..ref import modmath
from .dcrt import DCRTParams, DCRTPoly, _moduli_chain


# -- per-limb primitives ----------------------------------------------------

def rescale_rns(poly: DCRTPoly) -> DCRTPoly:
    """Drop the last limb, scaling by 1/q_last in pure RNS:
    c'_i = (c_i - c_last) * q_last^{-1} mod q_i (ModReduce; the centered
    correction is absorbed into CKKS noise exactly as in the reference)."""
    lp = poly.params
    assert lp.L > 1
    q_last = lp.moduli[-1]
    new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])
    p = poly.to_coeff()
    c_last = p.rns[-1]                                   # [N] mod q_last
    # center the q_last residue so the division error is <= 1/2
    half = np.uint64(q_last // 2)
    rows = []
    for i, m in enumerate(new_lp.moduli):
        # centered residue: (c_last - q_last) mod m for the upper half, with
        # both operands reduced mod m first so nothing wraps in uint64 when
        # m < q_last (limbs of different bit widths).
        q_last_m = np.uint64(q_last % m)
        cl_m = c_last % np.uint64(m)
        cl = np.where(c_last > half,
                      (cl_m + np.uint64(m) - q_last_m) % np.uint64(m),
                      cl_m)
        diff = (p.rns[i] + np.uint64(m) - cl) % np.uint64(m)
        rows.append(modmath.mul(diff,
                                np.uint64(pow(q_last, -1, m)), m))
    return DCRTPoly(new_lp, np.stack(rows), eval_form=False).to_eval()


@lru_cache(maxsize=None)
def alpha_fixed_tables(src: tuple):
    """Fixed-point reciprocals for the FBC correction term
    alpha = round(sum_i y_i / q_i): returns (F, shifts s_i, t_i) with
    t_i = floor(2^(F+s_i) / q_i) and s_i = max(0, bits(q_i) - 31), so each
    term is (y_i >> s_i) * t_i < 2^F regardless of limb width.

    Integer fixed point (not float) so host numpy, the JAX package's u32
    device code and this port's int64 device code (pke/ckks_device.py)
    compute the IDENTICAL alpha on every input — device towers stay
    bit-identical to host towers through key switching. F is capped at
    31 + min_bits so t_i < 2^32 whenever every limb is a device limb
    (< 2^31, where s_i = 0); the s-term sum stays < 2^57 (u64 here, int64
    on the device). Per-term error < 2^-21 + 2^-30, so the
    rounding matches the real value except in a ~2^-16 tie band, where either
    rounding is a valid HPS representative (error still one multiple of D)."""
    b_min = min(q.bit_length() for q in src)
    F = min(31 + b_min, 52)
    shifts = tuple(max(0, q.bit_length() - 31) for q in src)
    t = tuple((1 << (F + s)) // q for s, q in zip(shifts, src))
    return F, shifts, t


def _fbc_alpha(y: np.ndarray, src: tuple) -> np.ndarray:
    """alpha = round(sum_i y_i/q_i) in shared fixed point (see above)."""
    F, shifts, t = alpha_fixed_tables(tuple(src))
    acc = np.zeros(y.shape[-1], dtype=np.uint64)
    for i in range(len(src)):
        acc = acc + (y[i] >> np.uint64(shifts[i])) * np.uint64(t[i])
    return ((acc + np.uint64(1 << (F - 1))) >> np.uint64(F)).astype(np.int64)


@lru_cache(maxsize=None)
def _fbc_tables(src: tuple, dst: tuple):
    """Precompute for FBC from basis `src` (product D) to basis `dst`:
    (D/q_i)^{-1} mod q_i, (D/q_i) mod each dst prime, D mod each dst prime."""
    D = 1
    for q in src:
        D *= q
    inv = np.array([pow((D // q) % q, -1, q) for q in src], dtype=np.uint64)
    dhat_dst = np.array([[(D // q) % m for q in src] for m in dst],
                        dtype=np.uint64)
    d_dst = np.array([D % m for m in dst], dtype=np.uint64)
    return inv, dhat_dst, d_dst


def fast_base_convert(rns_src: np.ndarray, src: tuple, dst: tuple) -> np.ndarray:
    """HPS fast base conversion of [len(src), N] residues (value x in [0, D))
    to the dst basis: sum_i y_i*(D/q_i) - alpha*D with y_i = [x*(D/q_i)^-1]_q_i
    and alpha = round(sum_i y_i/q_i) in shared fixed point. Error: represents
    x + e*D with |e| <= 1 — the standard approximate extension."""
    inv, dhat_dst, d_dst = _fbc_tables(tuple(src), tuple(dst))
    y = np.stack([modmath.mul(rns_src[i], inv[i], src[i])
                  for i in range(len(src))])             # [s, N]
    alpha = _fbc_alpha(y, src)
    out = []
    for j, m in enumerate(dst):
        acc = np.zeros(rns_src.shape[-1], dtype=np.uint64)
        for i in range(len(src)):
            acc = (acc + modmath.mul(y[i] % np.uint64(m), dhat_dst[j, i], m)) \
                % np.uint64(m)
        corr = modmath.mul((alpha % np.int64(m)).astype(np.uint64), d_dst[j], m)
        out.append((acc + np.uint64(m) - corr) % np.uint64(m))
    return np.stack(out)


# -- hybrid key switching, pure RNS ----------------------------------------

@dataclass
class RnsHybridKey:
    bs: list                 # dnum towers over the PQ chain (EVAL form)
    as_: list
    pq_params: DCRTParams
    q_moduli: tuple
    p_moduli: tuple
    groups: list             # (start, end) limb ranges of Q
    t: int = 1               # plaintext modulus of the t-scaled-noise (BGV)
                             # variant; 1 = CKKS/BFV plain-noise keys


def rns_hybrid_ks_gen(rng, q_params: DCRTParams, s_from_signed, s_to_signed,
                      dnum: int = 2, std: float = 3.19,
                      limb_bits: int = 40, t: int = 1) -> RnsHybridKey:
    """Hybrid (GHS) key-switch keys in pure RNS. With `t` > 1 the key noise
    is t-scaled (BGV keys, bgvrns KeySwitchGen) and the special-modulus
    primes are chosen = 1 mod t so ModDown preserves the message mod t."""
    per = (q_params.L + dnum - 1) // dnum
    groups = [(i, min(i + per, q_params.L)) for i in range(0, q_params.L, per)]
    # size P by BITS: chain limbs can be wider than the special limbs, and
    # P < max digit group blows the key-switch noise up by D/P
    group_bits = max(sum(q_params.moduli[i].bit_length()
                         for i in range(s, e)) for s, e in groups)
    n_p = (group_bits + limb_bits - 1) // limb_bits + 1
    p_moduli = _moduli_chain(q_params.N, n_p, limb_bits, skip=q_params.L,
                             extra_mod=t)
    pq = DCRTParams(N=q_params.N, moduli=q_params.moduli + tuple(p_moduli))
    P = 1
    for m in p_moduli:
        P *= m
    Q = q_params.Q
    N = q_params.N
    s_to = DCRTPoly.from_signed(pq, s_to_signed, eval_form=True)
    s_from = DCRTPoly.from_signed(pq, s_from_signed, eval_form=True)
    bs, as_ = [], []
    for (g0, g1) in groups:
        D = 1
        for m in q_params.moduli[g0:g1]:
            D *= m
        # digits are the raw group residues x_j = c2 mod D_j, so the key
        # carries the CRT recomposition factor Q~_j = (Q/D_j)*[(Q/D_j)^-1]_Dj
        # (sum_j x_j * Q~_j == c2 mod Q); the FBC representation error e*D_j
        # vanishes against P*Q~_j mod PQ because D_j*Q~_j == 0 mod Q
        qhat = Q // D
        factor = (qhat * pow(qhat % D, -1, D)) % Q * P
        a = DCRTPoly(pq, np.stack([rng.discrete_uniform(N, m)
                                   for m in pq.moduli]).astype(np.uint64),
                     eval_form=False).to_eval()
        e = DCRTPoly.from_signed(pq, rng.discrete_gaussian_signed(N, std),
                                 eval_form=True)
        if t > 1:
            e = e.mul_scalar(t)
        bs.append(-(a * s_to + e) + s_from.mul_scalar(factor % pq.Q))
        as_.append(a)
    return RnsHybridKey(bs, as_, pq, q_params.moduli, tuple(p_moduli),
                        groups, t)


def _ks_level_view(ksk: RnsHybridKey, lvl: tuple):
    """(pq_params, clipped groups, key row indices) for a prefix chain."""
    n_l = len(lvl)
    assert ksk.q_moduli[:n_l] == lvl, \
        "level chain must be a prefix of the key's chain"
    full_q = len(ksk.q_moduli)
    p_len = len(ksk.p_moduli)
    if n_l == full_q:
        return ksk.pq_params, ksk.groups, None
    pq_params = DCRTParams(N=ksk.pq_params.N,
                           moduli=lvl + tuple(ksk.p_moduli))
    groups = [(g0, min(g1, n_l)) for (g0, g1) in ksk.groups if g0 < n_l]
    row_idx = np.array(list(range(n_l))
                       + list(range(full_q, full_q + p_len)))
    return pq_params, groups, row_idx


def ks_digits_precompute(ksk: RnsHybridKey, c2: DCRTPoly,
                         level_moduli: tuple) -> list:
    """The expensive half of the hybrid key switch, separable from the key:
    per digit group, take c2's group residues and FBC-extend them to the PQ
    basis, NTT'd to eval form (EvalKeySwitchPrecomputeCore,
    keyswitch-hybrid.cpp). The result can be consumed by ANY key with the
    same group layout — the hoisting precompute of EvalFastRotation."""
    lvl = tuple(level_moduli)
    pq_params, groups, _ = _ks_level_view(ksk, lvl)
    pq_mods = pq_params.moduli
    c2c = c2.to_coeff()
    dps = []
    for (g0, g1) in groups:
        src = ksk.q_moduli[g0:g1]
        ext = fast_base_convert(c2c.rns[g0:g1], src, pq_mods)
        dps.append(DCRTPoly(pq_params, ext, eval_form=False).to_eval())
    return dps


def rns_hybrid_key_switch(ksk: RnsHybridKey, c2: DCRTPoly,
                          level_moduli: tuple,
                          precomp: list | None = None
                          ) -> tuple[DCRTPoly, DCRTPoly]:
    """(delta0, delta1) over the working chain — digits taken per group from
    c2's own residues, FBC-extended to the full PQ basis, inner product with
    the key towers, then ModDown by P. Everything stays in RNS. With
    `precomp` (from ks_digits_precompute) the decompose/extend half is
    skipped — the hoisted path.

    BGV keys (ksk.t > 1) use the t-exact ModDown: the subtracted correction
    is t*FBC([x*t^-1]_P) — congruent to x mod P and to 0 mod t — so the
    result stays = x mod t after the exact division by P (P = 1 mod t by
    key construction; keyswitch-hybrid.cpp ModDown's BGV branch).

    LEVEL-AWARE: `level_moduli` may be any PREFIX of the key's chain. The
    full-chain key restricted to the level's limbs IS the level key — the
    CRT recomposition factor B_j = (Q/D_j)*[(Q/D_j)^-1]_{D_j} satisfies
    B_j = 1 mod D_j^l, 0 mod D_i^l when reduced mod Q_l, which defines
    B_j^l; and P*B_j mod P*Q_l = P*(B_j mod Q_l). So ONE key serves every
    level by row slicing + group clipping (the reference's level-aware
    PartQlHat design, keyswitch-hybrid.cpp) — no per-level key material
    needed."""
    lvl = tuple(level_moduli)
    pq_params, groups, row_idx = _ks_level_view(ksk, lvl)
    if precomp is None:
        precomp = ks_digits_precompute(ksk, c2, lvl)
    N = pq_params.N
    acc0 = acc1 = None
    for dp, b, a in zip(precomp, ksk.bs, ksk.as_):
        if row_idx is not None:
            b = DCRTPoly(pq_params, b.rns[row_idx], eval_form=True)
            a = DCRTPoly(pq_params, a.rns[row_idx], eval_form=True)
        t0, t1 = b * dp, a * dp
        acc0 = t0 if acc0 is None else acc0 + t0
        acc1 = t1 if acc1 is None else acc1 + t1
    # ModDown: x -> (x - FBC([x]_P)) * P^{-1} over the level chain
    out = []
    new_lp = DCRTParams(N=N, moduli=lvl)
    p_mods = ksk.p_moduli
    n_q = len(lvl)
    t = ksk.t
    for acc in (acc0, acc1):
        ac = acc.to_coeff()
        x_p = ac.rns[n_q:]                              # residues mod P limbs
        if t > 1:
            x_p = np.stack([modmath.mul(x_p[j],
                                        np.uint64(pow(t, -1, p)), p)
                            for j, p in enumerate(p_mods)])
        conv = fast_base_convert(x_p, p_mods, lvl)
        P_inv = [pow(_prod(p_mods) % m, -1, m) for m in lvl]
        rows = []
        for i, m in enumerate(lvl):
            corr = conv[i] if t == 1 else modmath.mul(
                conv[i], np.uint64(t % m), m)
            diff = (ac.rns[i] + np.uint64(m) - corr) % np.uint64(m)
            rows.append(modmath.mul(diff, np.uint64(P_inv[i]), m))
        out.append(DCRTPoly(new_lp, np.stack(rows), eval_form=False).to_eval())
    return out[0], out[1]


def _prod(xs) -> int:
    r = 1
    for x in xs:
        r *= int(x)
    return r


# -- hoisted rotations (EvalFastRotation) ------------------------------------

@lru_cache(maxsize=None)
def eval_auto_perm(N: int, k: int, modulus: int) -> np.ndarray:
    """Index permutation pi with NTT(a(X^k)) = NTT(a)[pi] (mod `modulus`).

    The negacyclic NTT evaluates at a fixed pattern of primitive 2N-th
    roots; X -> X^k (k odd) permutes those evaluation points, so the
    automorphism acts on EVAL-form rows as a pure gather. Derived
    empirically from the transform of X (all evaluation values are distinct
    roots, so value matching is exact) — robust to the transform's internal
    ordering. This is what makes hoisting pay: the per-rotation work on a
    precomputed digit is a permutation instead of an NTT."""
    from ..ref import ntt as ref_ntt
    from .encoding import apply_automorphism_coeff
    x1 = np.zeros(N, dtype=np.uint64)
    x1[1] = 1
    e1 = ref_ntt.forward(x1[None], modulus)[0]
    ek = ref_ntt.forward(
        apply_automorphism_coeff(x1, k, modulus)[None], modulus)[0]
    pos = {int(v): j for j, v in enumerate(e1)}
    return np.array([pos[int(v)] for v in ek], dtype=np.int64)


def _auto_eval(poly: DCRTPoly, k: int) -> DCRTPoly:
    """Automorphism a(X) -> a(X^k) applied directly in EVAL form (one gather
    per limb, no NTTs)."""
    assert poly.eval_form
    rows = np.stack([poly.rns[i][eval_auto_perm(poly.params.N, k, m)]
                     for i, m in enumerate(poly.params.moduli)])
    return DCRTPoly(poly.params, rows, eval_form=True)


# -- RNS CKKS context -------------------------------------------------------

class CKKSRnsContext:
    """CKKS with every homomorphic operation in pure RNS (per-limb numpy,
    device-offload-ready). Encode/decode and encryption reuse pke/ckks.py.

    `ks_limb_bits` sets the special-modulus limb width of the hybrid keys —
    pass <= 30 when the chain is destined for the device
    (pke/ckks_device.py), which needs every PQ limb below 2^31."""

    def __init__(self, base_ctx, dnum: int = 2, ks_limb_bits: int = 40):
        from .ckks import CKKSContext
        assert isinstance(base_ctx, CKKSContext)
        self.ctx = base_ctx
        self.params = base_ctx.params
        self.dnum = dnum
        self.ks_limb_bits = ks_limb_bits

    def relin_key_gen(self, sk) -> dict:
        """One hybrid key per level chain (length L down to 2) — the
        level-aware PartQlHat precomputation of the reference collapses to
        per-level keys here; key material is L-1 towers instead of one."""
        from .keyswitch import negacyclic_square_signed
        s_signed = sk[1]
        s2 = negacyclic_square_signed(s_signed)
        return self._per_level_keys(s2, s_signed)

    def _per_level_keys(self, s_from_signed, s_to_signed) -> dict:
        full = self.params.dcrt
        keys = {}
        for lvl_len in range(2, full.L + 1):
            qp = DCRTParams(N=full.N, moduli=full.moduli[:lvl_len])
            keys[lvl_len] = rns_hybrid_ks_gen(
                self.ctx.rng, qp, s_from_signed, s_to_signed, self.dnum,
                limb_bits=self.ks_limb_bits)
        return keys

    def galois_key_gen(self, sk, steps: int) -> dict:
        """Per-level hybrid keys switching s(X^k) -> s for the slot rotation
        by `steps` (the RNS form of EvalRotateKeyGen)."""
        from .encoding import rotation_automorphism_index
        from .keyswitch import automorph_signed
        k = rotation_automorphism_index(self.params.N, steps)
        keys = self._per_level_keys(automorph_signed(sk[1], k), sk[1])
        for key in keys.values():
            key.galois_k = k
        return keys

    def relin_key_gen_single(self, sk) -> RnsHybridKey:
        """ONE full-chain relin key serving every level (level-aware
        restriction, see rns_hybrid_key_switch) — L x less key material and
        keygen than the per-level dict."""
        from .keyswitch import negacyclic_square_signed
        return rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            negacyclic_square_signed(sk[1]), sk[1], self.dnum,
            limb_bits=self.ks_limb_bits)

    def galois_key_gen_single(self, sk, steps: int = 0,
                              k: int | None = None) -> RnsHybridKey:
        """ONE full-chain Galois key for rotation by `steps` (or a raw
        Galois element `k`), valid at every level."""
        from .encoding import rotation_automorphism_index
        from .keyswitch import automorph_signed
        if k is None:
            k = rotation_automorphism_index(self.params.N, steps)
        key = rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            automorph_signed(sk[1], k), sk[1], self.dnum,
            limb_bits=self.ks_limb_bits)
        key.galois_k = k
        return key

    def eval_rotate(self, ct, steps: int, gk: dict):
        """Packed slot rotation in pure RNS: coefficient-domain automorphism
        of both polys, then hybrid key switch of the automorphed c1."""
        from .ckks import CKKSCiphertext
        from .encoding import (apply_automorphism_coeff,
                               rotation_automorphism_index)
        k = rotation_automorphism_index(self.params.N, steps)
        lp = ct.polys[0].params

        def auto(p: DCRTPoly) -> DCRTPoly:
            c = p.to_coeff()
            rows = np.stack([apply_automorphism_coeff(c.rns[i], k, m)
                             for i, m in enumerate(lp.moduli)])
            return DCRTPoly(lp, rows, eval_form=False).to_eval()

        c0a, c1a = auto(ct.polys[0]), auto(ct.polys[1])
        key = gk[lp.L] if isinstance(gk, dict) else gk
        d0, d1 = rns_hybrid_key_switch(key, c1a, lp.moduli)
        return CKKSCiphertext([c0a + d0, d1], ct.scale, self.params)

    def rotation_precompute(self, ct, key) -> list:
        """EvalFastRotationPrecompute (keyswitch-hybrid.cpp
        EvalKeySwitchPrecomputeCore / the HS18 hoisting trick): digit-
        decompose + FBC-extend ct's c1 ONCE. The result serves every
        rotation of `ct` whose Galois key shares `key`'s group layout
        (all keys from one context do) — digit decomposition and base
        extension are coefficient-wise, so they commute with the
        automorphism, which acts on the precomputed EVAL towers as a pure
        per-limb gather (eval_auto_perm)."""
        lp = ct.polys[0].params
        k = key[lp.L] if isinstance(key, dict) else key
        return ks_digits_precompute(k, ct.polys[1], lp.moduli)

    def eval_rotate_hoisted(self, ct, steps: int, gk, precomp: list):
        """EvalFastRotation: slot rotation reusing a rotation_precompute.
        Per-rotation cost is one gather per digit tower + the key inner
        product + ModDown — no per-rotation inverse NTT, decompose, FBC, or
        forward NTTs. Bit-identical to eval_rotate."""
        from .ckks import CKKSCiphertext
        from .encoding import rotation_automorphism_index
        k = rotation_automorphism_index(self.params.N, steps)
        lp = ct.polys[0].params
        key = gk[lp.L] if isinstance(gk, dict) else gk
        assert getattr(key, "galois_k", k) == k, \
            "galois key does not match the requested rotation"
        dps_k = [_auto_eval(dp, k) for dp in precomp]
        d0, d1 = rns_hybrid_key_switch(key, None, lp.moduli, precomp=dps_k)
        c0a = _auto_eval(ct.polys[0], k)
        return CKKSCiphertext([c0a + d0, d1], ct.scale, self.params)

    def eval_rotations(self, ct, steps_list, gks: dict) -> dict:
        """Many rotations of ONE ciphertext from one hoisting precompute
        (the EvalFastRotation pattern of EvalSum / BSGS transforms):
        {steps: rotated ct}. `gks` maps steps -> Galois key."""
        first = gks[steps_list[0]]
        pre = self.rotation_precompute(
            ct, first[ct.polys[0].params.L] if isinstance(first, dict)
            else first)
        return {s: self.eval_rotate_hoisted(ct, s, gks[s], pre)
                for s in steps_list}

    def eval_add(self, a, b):
        from .ckks import CKKSCiphertext
        assert abs(a.scale - b.scale) < 1e-6 * a.scale
        return CKKSCiphertext([a.polys[0] + b.polys[0],
                               a.polys[1] + b.polys[1]], a.scale, self.params)

    def eval_mult(self, a, b, rlk: RnsHybridKey, rescale: bool = True):
        """Tensor product directly in RNS eval form (no CRT interpolation),
        hybrid relinearization, RNS rescale."""
        from .ckks import CKKSCiphertext
        assert len(a.polys) == 2 and len(b.polys) == 2
        lp = a.polys[0].params
        assert b.polys[0].params.moduli == lp.moduli
        d0 = a.polys[0] * b.polys[0]
        d1 = a.polys[0] * b.polys[1] + a.polys[1] * b.polys[0]
        d2 = a.polys[1] * b.polys[1]
        key = rlk[lp.L] if isinstance(rlk, dict) else rlk
        s0, s1 = rns_hybrid_key_switch(key, d2, lp.moduli)
        ct = CKKSCiphertext([d0 + s0, d1 + s1], a.scale * b.scale,
                            self.params)
        if rescale:
            new = [rescale_rns(p) for p in ct.polys]
            ct = CKKSCiphertext(new, ct.scale / lp.moduli[-1], self.params)
        return ct

    def level_reduce(self, ct, levels: int = 1):
        """Drop the last `levels` towers WITHOUT rescaling — the ciphertext
        value mod the shorter chain still decrypts (message + noise are far
        below the remaining modulus), and the scale is unchanged
        (rns-leveledshe.cpp LevelReduceInternal / ckksrns-leveledshe.cpp
        LevelReduceInternalInPlace, which likewise just DropLastElements)."""
        from .ckks import CKKSCiphertext
        from .dcrt import DCRTParams
        lp = ct.polys[0].params
        assert 0 < levels < lp.L
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-levels])
        polys = [DCRTPoly(new_lp, p.rns[:-levels], p.eval_form)
                 for p in ct.polys]
        return CKKSCiphertext(polys, ct.scale, ct.params,
                              noise_deg=ct.noise_deg)

    def compress(self, ct, towers_left: int = 1):
        """Shrink a result ciphertext to `towers_left` towers before
        transmission/decryption (rns-leveledshe.cpp Compress): flush any
        deferred rescale (noise degree back to 1), then LevelReduce the
        rest away. Lossless for the decrypted message at the given scale;
        serialized size drops by L/towers_left."""
        from .ckks import CKKSCiphertext
        out = ct
        while out.noise_deg > 1:
            lp = out.polys[0].params
            out = CKKSCiphertext([rescale_rns(p) for p in out.polys],
                                 out.scale / lp.moduli[-1], self.params)
        L = out.polys[0].params.L
        if towers_left < L:
            out = self.level_reduce(out, L - towers_left)
        return out

    def eval_mult_limb(self, a, b, rlk, mesh, rescale: bool = True):
        """eval_mult with the RING DIMENSION sharded over a ("limb",) mesh
        (`parallel/limb_ntt.py`): every NTT runs as exchanges of shard
        tensors between the mesh's devices plus shard-local butterflies,
        and the pointwise math stays on each shard. When every PQ limb of
        the hybrid key is < 2^30 (`ks_limb_bits` <= 29) the whole
        multiplication, the key switch's base conversions and ModDown
        included, runs sharded (`build_limb_mult`); otherwise the tensor
        product and rescale are sharded and the key switch composes on the
        gathered d2 towers. Equal to eval_mult tower for tower either way.

        Requires limb moduli < 2^30 and N divisible by twice the mesh size
        (a power of two)."""
        from ..parallel.limb_ntt import (build_limb_ckks_kernels,
                                         build_limb_mult, join, scatter)
        from .ckks import CKKSCiphertext
        assert len(a.polys) == 2 and len(b.polys) == 2
        lp = a.polys[0].params
        assert b.polys[0].params.moduli == lp.moduli
        key = rlk[lp.L] if isinstance(rlk, dict) else rlk
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])

        def sharded(p):
            return scatter(mesh, p.to_coeff().rns)

        def poly(shards, params):
            rows = join(shards).numpy().astype(np.uint64)
            return DCRTPoly(params, rows, eval_form=False).to_eval()

        args = [sharded(p) for p in (a.polys[0], a.polys[1], b.polys[0], b.polys[1])]
        if (rescale and tuple(key.q_moduli) == tuple(lp.moduli)
                and all(m < (1 << 30) for m in key.pq_params.moduli)):
            mult, key_shards = build_limb_mult(lp, key, mesh)
            c0c, c1c = mult(*args, key_shards)
            return CKKSCiphertext([poly(c0c, new_lp), poly(c1c, new_lp)],
                                  a.scale * b.scale / lp.moduli[-1], self.params)
        ker = build_limb_ckks_kernels(lp, mesh)
        d0, d1, d2 = [poly(d, lp) for d in ker["tensor"](*args)]
        s0, s1 = rns_hybrid_key_switch(key, d2, lp.moduli)
        c0, c1 = d0 + s0, d1 + s1
        if not rescale:
            return CKKSCiphertext([c0, c1], a.scale * b.scale, self.params)
        outs = [poly(ker["rescale"](sharded(p)), new_lp) for p in (c0, c1)]
        return CKKSCiphertext(outs, a.scale * b.scale / lp.moduli[-1],
                              self.params)
