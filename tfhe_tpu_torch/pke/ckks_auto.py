"""Automatic CKKS rescaling and level management (scaling techniques).

Port of `tfhe_tpu/pke/ckks_auto.py`, the counterpart of the reference's
ScalingTechnique layer for CKKSrns (`ckksrns-leveledshe.cpp`):

- FIXEDMANUAL is the plain `CKKSRnsContext` — the user calls rescale.
- FIXEDAUTO / FLEXIBLEAUTO are implemented here: multiplication rescales
  depth-2 operands lazily (`EvalMultAuto`, ckksrns-leveledshe.cpp:88-93 —
  the product is left at noise degree 2 and the division by q happens just
  before the *next* use), and binary operations align mixed-level /
  mixed-depth operands automatically with one constant multiply plus a
  ModReduce / LevelReduce (`AdjustLevelsAndDepthInPlace`,
  ckksrns-leveledshe.cpp:475-608).
- FLEXIBLEAUTO tracks the exact per-level scaling factors
  sf_{l-1} = sf_l^2 / q_l (the canonical grid the rescales actually land
  on), so constants are always encoded at the scale the ciphertext really
  has; FIXEDAUTO steers everything back onto the fixed grid Delta^deg.

Design notes:

- Every ciphertext this layer produces sits exactly on the canonical grid:
  scale == sf[l] (degree 1) or sf[l]^2 (degree 2) for its chain length l.
  Two operands at the same (length, degree) therefore always have equal
  scales and add without adjustment — the reference maintains the same
  invariant implicitly via SetScalingFactor after each adjustment.
- Adjustment multiplies by round(d * sf[l]) and *declares* the canonical
  scale, exactly like the reference's EvalMultCoreInPlace + SetScalingFactor
  pair; the declared-vs-true gap is the integer rounding of the constant,
  a relative 2^-scale_bits — below the CKKS noise floor.
- Everything reduces to the pure-RNS primitives of `ckks_rns.py`
  (per-limb towers, no big-int hot path), so an auto-scaled program runs
  on the device exactly like a manually scaled one (`ckks_auto_device.py`).
"""

from __future__ import annotations

import numpy as np

from .ckks import CKKSCiphertext, CKKSContext, encode
from .ckks_rns import CKKSRnsContext, rescale_rns
from .dcrt import DCRTParams, DCRTPoly

__all__ = ["CKKSAutoContext"]

_TECHNIQUES = ("flexibleauto", "fixedauto")


def _chain_len(ct: CKKSCiphertext) -> int:
    return ct.polys[0].params.L


class CKKSAutoContext:
    """CKKS evaluator with automatic rescaling and level alignment.

    Wraps a `CKKSRnsContext`; `technique` picks the canonical scale grid:
    "flexibleauto" = exact per-level factors sf_{l-1} = sf_l^2 / q_l,
    "fixedauto" = the fixed grid Delta^deg. Because this framework tracks
    the ciphertext scale exactly and decodes by the tracked value, both
    techniques decode without the fixed-mode approximation drift the
    reference documents — the choice only affects which grid constants are
    encoded on.
    """

    def __init__(self, rns_ctx: CKKSRnsContext,
                 technique: str = "flexibleauto"):
        if technique not in _TECHNIQUES:
            raise ValueError(
                f"technique must be one of {_TECHNIQUES} (FIXEDMANUAL is the "
                f"plain CKKSRnsContext)")
        self.rns = rns_ctx
        self.ctx: CKKSContext = rns_ctx.ctx
        self.params = rns_ctx.params
        self.technique = technique
        full = self.params.dcrt
        if full.moduli[0] < 4 * self.params.scale:
            import warnings
            warnings.warn(
                "first chain modulus leaves <2 bits of last-level headroom "
                "over the encoding scale; messages evaluated down to the "
                "final level will wrap (use a wide first limb, e.g. "
                "first_mod_bits=60 — the reference's firstModSize rule)",
                stacklevel=2)
        sf = [0.0] * (full.L + 1)
        sf[full.L] = self.params.scale
        for l in range(full.L, 1, -1):
            if technique == "flexibleauto":
                # q_last of the length-l chain
                sf[l - 1] = sf[l] * sf[l] / full.moduli[l - 1]
            else:
                sf[l - 1] = self.params.scale
        self.sf = sf
        self.sf2 = [s * s for s in sf]

    # -- key plumbing (delegates) ------------------------------------------

    def key_gen(self):
        return self.ctx.key_gen()

    def relin_key_gen(self, sk):
        return self.rns.relin_key_gen_single(sk)

    def galois_key_gen(self, sk, steps: int):
        return self.rns.galois_key_gen_single(sk, steps)

    # -- encrypt / decrypt ---------------------------------------------------

    def encrypt(self, pk, z) -> CKKSCiphertext:
        ct = self.ctx.encrypt(pk, z, scale=self.sf[self.params.dcrt.L])
        ct.noise_deg = 1
        return ct

    def decrypt(self, sk, ct: CKKSCiphertext) -> np.ndarray:
        return self.ctx.decrypt(sk, ct)

    # -- canonical-state primitives -----------------------------------------

    def _stamp(self, ct: CKKSCiphertext, deg: int) -> CKKSCiphertext:
        l = _chain_len(ct)
        ct.noise_deg = deg
        ct.scale = self.sf[l] if deg == 1 else self.sf2[l]
        return ct

    def _rescale(self, ct: CKKSCiphertext) -> CKKSCiphertext:
        """ModReduceInternal: drop one limb, degree 2 -> 1
        (ckksrns-leveledshe.cpp:104-122)."""
        assert ct.noise_deg == 2, "canonical deg-1 cts are already rescaled"
        out = CKKSCiphertext([rescale_rns(p) for p in ct.polys],
                             ct.scale, ct.params)
        return self._stamp(out, 1)

    def _level_reduce(self, ct: CKKSCiphertext, k: int) -> CKKSCiphertext:
        """LevelReduceInternal: drop k trailing limbs with no scaling
        (valid per-limb in RNS; the scale is unchanged)."""
        lp = ct.polys[0].params
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:lp.L - k])
        polys = [DCRTPoly(new_lp, p.rns[:new_lp.L], p.eval_form)
                 for p in ct.polys]
        out = CKKSCiphertext(polys, ct.scale, ct.params)
        out.noise_deg = ct.noise_deg
        return out

    def _mult_const_core(self, ct: CKKSCiphertext, d: float) -> CKKSCiphertext:
        """EvalMultCoreInPlace(ct, double): multiply by round(d * sf[l])
        — the constant encoded at the level's canonical scale — raising the
        noise degree by one (ckksrns-leveledshe.cpp:86-101)."""
        l = _chain_len(ct)
        c = int(round(d * self.sf[l]))
        out = CKKSCiphertext([p.mul_scalar(c) for p in ct.polys],
                             ct.scale, ct.params)
        return self._stamp(out, ct.noise_deg + 1)

    def _bring_to(self, ct: CKKSCiphertext, target_len: int) -> CKKSCiphertext:
        """Lower `ct` to chain length `target_len` on the canonical grid —
        the single-operand core of AdjustLevelsAndDepthInPlace
        (ckksrns-leveledshe.cpp:475-608): spend the deferred rescale first,
        then one constant multiply + rescale + level-reduce."""
        l = _chain_len(ct)
        if l == target_len:
            return ct
        assert l > target_len, "operand below the target chain"
        if ct.noise_deg == 2:
            ct = self._rescale(ct)
            l -= 1
            if l == target_len:
                return ct
        # deg 1: adjust the scale so the single rescale lands on the target
        # grid (for flexibleauto with target == l-1 this d is exactly 1.0)
        q_drop = ct.polys[0].params.moduli[l - 1]
        d = self.sf[target_len] * q_drop / (self.sf[l] * self.sf[l])
        ct = self._mult_const_core(ct, d)
        ct = self._rescale(ct)
        if _chain_len(ct) > target_len:
            ct = self._level_reduce(ct, _chain_len(ct) - target_len)
        return self._stamp(ct, 1)

    def _adjust_for_add(self, a: CKKSCiphertext, b: CKKSCiphertext):
        target = min(_chain_len(a), _chain_len(b))
        a, b = self._bring_to(a, target), self._bring_to(b, target)
        # equal length; align degrees by raising the deg-1 operand with a
        # multiply by 1.0 (ckksrns-leveledshe.cpp:592-601)
        if a.noise_deg < b.noise_deg:
            a = self._mult_const_core(a, 1.0)
        elif b.noise_deg < a.noise_deg:
            b = self._mult_const_core(b, 1.0)
        return a, b

    def _adjust_for_mult(self, a: CKKSCiphertext, b: CKKSCiphertext):
        if a.noise_deg == 2:
            a = self._rescale(a)
        if b.noise_deg == 2:
            b = self._rescale(b)
        target = min(_chain_len(a), _chain_len(b))
        return self._bring_to(a, target), self._bring_to(b, target)

    # -- public evaluator -----------------------------------------------------

    def eval_add(self, a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = self.rns.eval_add(a, b)
        return self._stamp(out, a.noise_deg)

    def eval_sub(self, a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = CKKSCiphertext([a.polys[0] - b.polys[0],
                              a.polys[1] - b.polys[1]], a.scale, self.params)
        return self._stamp(out, a.noise_deg)

    def eval_mult(self, a: CKKSCiphertext, b: CKKSCiphertext,
                  rlk) -> CKKSCiphertext:
        """EvalMultAuto: operands auto-rescaled/aligned, product left at
        noise degree 2 (the rescale is deferred to the next use)."""
        a, b = self._adjust_for_mult(a, b)
        out = self.rns.eval_mult(a, b, rlk, rescale=False)
        return self._stamp(out, 2)

    def eval_square(self, a: CKKSCiphertext, rlk) -> CKKSCiphertext:
        return self.eval_mult(a, a, rlk)

    def _as_slots(self, z) -> np.ndarray:
        """Scalar -> every slot; vector -> as-is (0-d arrays count as scalar)."""
        z = np.asarray(z)
        if z.ndim == 0:
            return np.full(self.params.slots, complex(z))
        return z

    def eval_mult_plain(self, ct: CKKSCiphertext, z) -> CKKSCiphertext:
        """Multiply by a plaintext slot vector (or scalar), encoded at the
        ciphertext's canonical level scale (EvalMultAuto plaintext branch)."""
        if ct.noise_deg == 2:
            ct = self._rescale(ct)
        zarr = np.asarray(z)
        if zarr.ndim == 0 and np.isrealobj(zarr):
            return self._mult_const_core(ct, float(zarr))
        z = self._as_slots(z)
        l = _chain_len(ct)
        lp = ct.polys[0].params
        m = encode(self.params, z, scale=self.sf[l])
        dp = DCRTPoly.from_signed(lp, m, eval_form=True)
        out = CKKSCiphertext([p * dp for p in ct.polys], ct.scale, ct.params)
        return self._stamp(out, 2)

    def eval_add_plain(self, ct: CKKSCiphertext, z) -> CKKSCiphertext:
        """Add a plaintext slot vector (or scalar). Degree-2 ciphertexts are
        rescaled first so the plaintext encodes at a single-limb-safe scale
        (the reference instead encodes at the 128-bit 'big' scale —
        structurally unnecessary here since the rescale is free in RNS)."""
        if ct.noise_deg == 2:
            ct = self._rescale(ct)
        l = _chain_len(ct)
        lp = ct.polys[0].params
        z = self._as_slots(z)
        m = encode(self.params, z, scale=self.sf[l])
        dp = DCRTPoly.from_signed(lp, m, eval_form=True)
        out = CKKSCiphertext([ct.polys[0] + dp, ct.polys[1]],
                             ct.scale, ct.params)
        return self._stamp(out, 1)

    def eval_sub_plain(self, ct: CKKSCiphertext, z) -> CKKSCiphertext:
        return self.eval_add_plain(ct, -np.asarray(z))

    def eval_rotate(self, ct: CKKSCiphertext, steps: int,
                    gk) -> CKKSCiphertext:
        """Slot rotation; degree and scale are preserved by the key switch."""
        deg = ct.noise_deg
        out = self.rns.eval_rotate(ct, steps, gk)
        return self._stamp(out, deg)

    # convenience: evaluate a power x^k with no manual scale management
    def eval_power(self, ct: CKKSCiphertext, k: int, rlk) -> CKKSCiphertext:
        assert k >= 1
        result = None
        base = ct
        while k:
            if k & 1:
                result = base if result is None else \
                    self.eval_mult(result, base, rlk)
            k >>= 1
            if k:
                base = self.eval_mult(base, base, rlk)
        return result
