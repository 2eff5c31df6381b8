"""Host oracle backend: exact, slow, numpy-only implementation of the two
device stages (blind rotation + fused mod/key/mod switch).

This is the bit-exactness oracle standing in for the reference's CPU "NTT"
path (rgsw-acc-cggi.cpp EvalAcc mode "NTT"); the JAX/TPU backend must agree
with it bit-for-bit on identical keys and inputs.
"""

from __future__ import annotations

import numpy as np

from .. import lwe
from ..params import BinFHEParams, Method
from . import rgsw


class RefBackend:
    """Implements the `scheme.Backend` protocol on the host."""

    def __init__(self):
        self._eval_keys: dict[int, object] = {}

    def setup(self, params: BinFHEParams, key) -> None:
        self._get_eval_key(params, key)

    def _get_eval_key(self, params: BinFHEParams, key):
        cache_id = id(key.bsk_coeff)
        if cache_id not in self._eval_keys:
            if params.rgsw.method == Method.GINX:
                self._eval_keys[cache_id] = rgsw.to_eval_cggi(params.rgsw, key.bsk_coeff)
            else:
                self._eval_keys[cache_id] = rgsw.to_eval_dm(params.rgsw, key.bsk_coeff)
        return self._eval_keys[cache_id]

    def eval_acc(self, params: BinFHEParams, key, acc_init: np.ndarray,
                 a_batch: np.ndarray, a_modulus: int) -> np.ndarray:
        ek = self._get_eval_key(params, key)
        out = acc_init.copy()
        for idx in range(acc_init.shape[0]):
            if params.rgsw.method == Method.GINX:
                out[idx] = rgsw.eval_acc_cggi(params.rgsw, ek, out[idx],
                                              a_batch[idx], a_modulus)
            else:
                out[idx] = rgsw.eval_acc_dm(params.rgsw, ek, out[idx],
                                            a_batch[idx], a_modulus)
        return out

    def mkm_switch(self, params: BinFHEParams, key, a_ext: np.ndarray,
                   b_ext: np.ndarray, fmod: int) -> lwe.LWECiphertext:
        p = params.lwe
        ct_ext = lwe.LWECiphertext(a_ext, b_ext, p.Q)
        ct_ms = lwe.mod_switch(p.q_ks, ct_ext)
        ct_ks = lwe.key_switch(p, key.ksk, ct_ms)
        return lwe.mod_switch(fmod, ct_ks)
