"""Automatic BGV level management (the FLEXIBLEAUTO scaling technique).

Port of `tfhe_tpu/pke/bgv_auto.py`, the counterpart of the reference's
BGV auto modes (`bgvrns-leveledshe.cpp` EvalMultAuto / ModReduce
bookkeeping, `bgvrns-parametergeneration.cpp` FLEXIBLEAUTO):
multiplications defer their ModReduce (the product stays at noise degree 2
and the division by q_last happens lazily before the next multiplication),
and binary operations align operands at different chain lengths
automatically.

BGV here is strictly simpler than the CKKS version (`ckks_auto.py`): this
framework's ModReduce preserves the message mod t exactly (the correction in
`bgv.mod_switch` / `bgv_rns.mod_reduce_rns` is built with r = c(1 - q_last)
mod t, so c' = c mod t), which means there is NO plaintext scale factor to
track — the reference instead tracks per-ciphertext scale factors mod t
because its ModReduce multiplies the plaintext by q^{-1} mod t. The auto
layer therefore reduces to a (chain length, noise degree) state machine:

- eval_mult: ModReduce any degree-2 operand (shrinking its noise by ~q),
  LevelReduce to the common chain, multiply + relinearize lazily,
- eval_add/sub: LevelReduce-only alignment (exact, free — dropping RNS rows
  reduces the ciphertext mod the shorter chain, and the message + t-scaled
  noise is far below it), result degree = max of the operands.
"""

from __future__ import annotations

import numpy as np

from .bfv import BFVCiphertext
from .bgv_rns import BGVRnsContext
from .dcrt import DCRTParams, DCRTPoly

__all__ = ["BGVAutoContext"]


def _chain_len(ct: BFVCiphertext) -> int:
    return ct.polys[0].params.L


class BGVAutoContext:
    """BGV evaluator with automatic ModReduce / level alignment over the
    pure-RNS ops of `BGVRnsContext`."""

    def __init__(self, rns_ctx: BGVRnsContext):
        self.rns = rns_ctx
        self.ctx = rns_ctx.ctx
        self.params = rns_ctx.params

    # -- key / data plumbing -------------------------------------------------

    def key_gen(self):
        return self.ctx.key_gen()

    def relin_key_gen(self, sk):
        return self.rns.relin_key_gen_single(sk)

    def galois_key_gen(self, sk, steps: int):
        return self.rns.galois_key_gen_single(sk, steps)

    def encrypt(self, pk, values) -> BFVCiphertext:
        ct = self.ctx.encrypt_packed(pk, values)
        ct.noise_deg = 1
        return ct

    def decrypt(self, sk, ct: BFVCiphertext) -> np.ndarray:
        return self.ctx.decrypt_packed(sk, ct)

    # -- state machine ---------------------------------------------------------

    def _mod_reduce(self, ct: BFVCiphertext) -> BFVCiphertext:
        out = self.rns.mod_reduce(ct)
        out.noise_deg = max(1, ct.noise_deg - 1)
        return out

    def _level_reduce(self, ct: BFVCiphertext, k: int) -> BFVCiphertext:
        """Drop k trailing limbs (LevelReduce): exact mod-Q_l reduction —
        the message + t*e value is unchanged since it is far below Q_l."""
        lp = ct.polys[0].params
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:lp.L - k])
        polys = [DCRTPoly(new_lp, p.rns[:new_lp.L], p.eval_form)
                 for p in ct.polys]
        return BFVCiphertext(polys, ct.params, ct.noise_deg)

    def _bring_to(self, ct: BFVCiphertext, target_len: int,
                  spend_reduce: bool) -> BFVCiphertext:
        l = _chain_len(ct)
        if l == target_len:
            return ct
        assert l > target_len
        if spend_reduce and ct.noise_deg == 2:
            ct = self._mod_reduce(ct)
            l -= 1
        if l > target_len:
            ct = self._level_reduce(ct, l - target_len)
        return ct

    def _adjust_for_mult(self, a, b):
        if a.noise_deg == 2:
            a = self._mod_reduce(a)
        if b.noise_deg == 2:
            b = self._mod_reduce(b)
        target = min(_chain_len(a), _chain_len(b))
        return (self._bring_to(a, target, False),
                self._bring_to(b, target, False))

    def _adjust_for_add(self, a, b):
        target = min(_chain_len(a), _chain_len(b))
        return (self._bring_to(a, target, True),
                self._bring_to(b, target, True))

    # -- public evaluator --------------------------------------------------------

    def eval_mult(self, a: BFVCiphertext, b: BFVCiphertext,
                  rlk) -> BFVCiphertext:
        """EvalMultAuto: ModReduce owed operands, align, multiply +
        relinearize; the product's own ModReduce is deferred (deg 2)."""
        a, b = self._adjust_for_mult(a, b)
        out = self.rns.eval_mult(a, b, rlk, reduce=False)
        out.noise_deg = 2
        return out

    def eval_add(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = self.rns.eval_add(a, b)
        out.noise_deg = max(a.noise_deg, b.noise_deg)
        return out

    def eval_sub(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = BFVCiphertext([x - y for x, y in zip(a.polys, b.polys)],
                            a.params, max(a.noise_deg, b.noise_deg))
        return out

    def eval_mult_plain(self, ct: BFVCiphertext, values) -> BFVCiphertext:
        """Plaintext multiply: no level cost, degree unchanged."""
        out = self.rns.eval_mult_plain(ct, values)
        out.noise_deg = ct.noise_deg
        return out

    def eval_rotate(self, ct: BFVCiphertext, steps: int,
                    gk) -> BFVCiphertext:
        deg = ct.noise_deg
        out = self.rns.eval_rotate(ct, steps, gk)
        out.noise_deg = deg
        return out
