"""Pure-RNS BGV: leveled EvalMult / ModReduce / rotations with no big-int
round trips in the hot path.

Counterpart of the reference's `src/pke/lib/scheme/bgvrns` leveled operations
(rns-leveledshe.cpp ModReduce / EvalMultCore, keyswitch-hybrid.cpp) the same
way pke/ckks_rns.py is for ckksrns: every op is a per-limb vectorized numpy
kernel over [L, N] residue towers, and `pke/bgv_device.py` runs the same
steps on the device, tower for tower. A port of `tfhe_tpu/pke/bgv_rns.py`.

BGV differences from the CKKS RNS core, all threaded through the shared
machinery in ckks_rns.py rather than duplicated:

- key noise is t-scaled (`rns_hybrid_ks_gen(..., t=t)`), and the special
  modulus P is chosen = 1 mod t so ModDown preserves the message;
- ModDown subtracts t*FBC([x * t^-1]_P) — congruent to x mod P and 0 mod t —
  instead of FBC([x]_P) (the `ksk.t` branch of rns_hybrid_key_switch);
- ModReduce (`mod_reduce_rns`) adds the correction t*[-c * t^-1]_{q_last}
  (centered) before the exact division by q_last, so the result is an
  integer polynomial congruent to the original mod t (the chain's q_i = 1
  mod t, BGVParams.create, makes the 1/q_last scaling message-invariant).

Validated against the exact big-int BGV (tests/test_bgv_rns.py): mult +
ModReduce chains and packed rotations decrypt identically.
"""

from __future__ import annotations

import numpy as np

from ..ref import modmath
from .bfv import BFVCiphertext
from .bgv import BGVContext
from .ckks_rns import rns_hybrid_ks_gen, rns_hybrid_key_switch
from .dcrt import DCRTParams, DCRTPoly


def mod_reduce_rns(poly: DCRTPoly, t: int) -> DCRTPoly:
    """BGV ModReduce in pure RNS: drop the last limb, scaling by 1/q_last
    while preserving the message mod t.

    The correction is u = [-c_last * t^-1]_{q_last} centered to
    (-q_last/2, q_last/2]; c + t*u is divisible by q_last and congruent to
    c mod t, so c' = (c + t*u)/q_last — computed per remaining limb as
    (c_i + t*u) * q_last^-1 mod q_i — is exact (rns-leveledshe.cpp
    ModReduceInternal, BGV branch)."""
    lp = poly.params
    assert lp.L > 1, "no limbs left to switch away"
    q_last = lp.moduli[-1]
    new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])
    p = poly.to_coeff()
    c_last = p.rns[-1]                                   # [N] mod q_last
    uq = np.uint64(q_last)
    v = (uq - c_last) % uq                               # -c mod q_last
    u = modmath.mul(v, np.uint64(pow(t % q_last, -1, q_last)), q_last)
    half = np.uint64(q_last // 2)
    rows = []
    for i, m in enumerate(new_lp.moduli):
        um = np.uint64(m)
        # centered residue of u mod m (same reduction order as rescale_rns:
        # reduce both operands mod m first so nothing wraps in uint64)
        q_last_m = np.uint64(q_last % m)
        u_m = u % um
        u_c = np.where(u > half, (u_m + um - q_last_m) % um, u_m)
        w = modmath.mul(u_c, np.uint64(t % m), m)        # t*u mod m
        s = (p.rns[i] + w) % um
        rows.append(modmath.mul(s, np.uint64(pow(q_last % m, -1, m)), m))
    return DCRTPoly(new_lp, np.stack(rows), eval_form=False).to_eval()


class BGVRnsContext:
    """BGV with every homomorphic operation in pure RNS (per-limb numpy,
    device-offload-ready). Key generation, encryption, and decryption reuse
    the exactness-first pke/bgv.py context.

    `ks_limb_bits` sets the special-modulus limb width of the hybrid keys —
    pass <= 30 when the chain is destined for the device, which needs every
    PQ limb below 2^31."""

    def __init__(self, base_ctx: BGVContext, dnum: int = 2,
                 ks_limb_bits: int = 40):
        assert isinstance(base_ctx, BGVContext)
        self.ctx = base_ctx
        self.params = base_ctx.params
        self.dnum = dnum
        self.ks_limb_bits = ks_limb_bits

    # -- keys -----------------------------------------------------------------

    def _per_level_keys(self, s_from_signed, s_to_signed) -> dict:
        full = self.params.dcrt
        keys = {}
        for lvl_len in range(2, full.L + 1):
            qp = DCRTParams(N=full.N, moduli=full.moduli[:lvl_len])
            keys[lvl_len] = rns_hybrid_ks_gen(
                self.ctx.rng, qp, s_from_signed, s_to_signed, self.dnum,
                limb_bits=self.ks_limb_bits, t=self.params.t)
        return keys

    def relin_key_gen(self, sk) -> dict:
        """Per-level t-noise hybrid keys switching s^2 -> s (bgvrns
        EvalMultKeyGen with the hybrid gadget)."""
        from .keyswitch import negacyclic_square_signed
        return self._per_level_keys(negacyclic_square_signed(sk.s_signed),
                                    sk.s_signed)

    def relin_key_gen_single(self, sk):
        """ONE full-chain t-noise relin key serving every level (level-aware
        restriction, see ckks_rns.rns_hybrid_key_switch)."""
        from .keyswitch import negacyclic_square_signed
        return rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            negacyclic_square_signed(sk.s_signed), sk.s_signed, self.dnum,
            limb_bits=self.ks_limb_bits, t=self.params.t)

    def galois_key_gen_single(self, sk, steps: int):
        """ONE full-chain t-noise Galois key for rotation by `steps`."""
        from .encoding import rotation_automorphism_index
        from .keyswitch import automorph_signed
        k = rotation_automorphism_index(self.params.N, steps)
        key = rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            automorph_signed(sk.s_signed, k), sk.s_signed, self.dnum,
            limb_bits=self.ks_limb_bits, t=self.params.t)
        key.galois_k = k
        return key

    def galois_key_gen(self, sk, steps: int) -> dict:
        """Per-level hybrid keys switching s(X^k) -> s for the slot rotation
        by `steps` (EvalRotateKeyGen, BGV branch)."""
        from .encoding import rotation_automorphism_index
        from .keyswitch import automorph_signed
        k = rotation_automorphism_index(self.params.N, steps)
        keys = self._per_level_keys(automorph_signed(sk.s_signed, k),
                                    sk.s_signed)
        for key in keys.values():
            key.galois_k = k
        return keys

    # -- homomorphic ops -------------------------------------------------------

    def eval_add(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        assert a.polys[0].params.moduli == b.polys[0].params.moduli
        return BFVCiphertext([x + y for x, y in zip(a.polys, b.polys)],
                             a.params)

    def eval_mult(self, a: BFVCiphertext, b: BFVCiphertext, rlk,
                  reduce: bool = True) -> BFVCiphertext:
        """Tensor product directly in RNS eval form, hybrid relinearization,
        then ModReduce (one level consumed, as the reference's leveled BGV
        EvalMult does)."""
        assert len(a.polys) == 2 and len(b.polys) == 2
        lp = a.polys[0].params
        assert b.polys[0].params.moduli == lp.moduli
        d0 = a.polys[0] * b.polys[0]
        d1 = a.polys[0] * b.polys[1] + a.polys[1] * b.polys[0]
        d2 = a.polys[1] * b.polys[1]
        key = rlk[lp.L] if isinstance(rlk, dict) else rlk
        s0, s1 = rns_hybrid_key_switch(key, d2, lp.moduli)
        ct = BFVCiphertext([d0 + s0, d1 + s1], a.params)
        return self.mod_reduce(ct) if reduce else ct

    def mod_reduce(self, ct: BFVCiphertext) -> BFVCiphertext:
        t = self.params.t
        return BFVCiphertext([mod_reduce_rns(p, t) for p in ct.polys],
                             ct.params)

    def compress(self, ct: BFVCiphertext,
                 towers_left: int = 1) -> BFVCiphertext:
        """Shrink to `towers_left` towers before transmission
        (rns-leveledshe.cpp Compress): for BGV each dropped tower is a
        message-exact ModReduce, so decryption is unchanged mod t."""
        out = ct
        while out.polys[0].params.L > towers_left:
            out = self.mod_reduce(out)
        return out

    def eval_mult_plain(self, ct: BFVCiphertext, values) -> BFVCiphertext:
        """Slotwise multiply by an unencrypted packed vector (EvalMult's
        plaintext overload): ring-multiply both polys by the packed
        plaintext polynomial — no relinearization, no level cost."""
        from .encoding import pack
        lp = ct.polys[0].params
        coeffs = pack(values, self.params.t, self.params.N)
        pt = DCRTPoly.from_signed(lp, np.asarray(coeffs, dtype=np.int64),
                                  eval_form=True)
        return BFVCiphertext([p * pt for p in ct.polys], ct.params)

    def eval_rotate(self, ct: BFVCiphertext, steps: int,
                    gk: dict) -> BFVCiphertext:
        """Packed slot rotation in pure RNS: coefficient-domain automorphism
        of both polys, then t-noise hybrid key switch of the automorphed c1."""
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
        return BFVCiphertext([c0a + d0, d1], ct.params)
