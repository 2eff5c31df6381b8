"""Device-resident BEHZ BFV multiplication.

Port of `tfhe_tpu/pke/bfv_behz_device.py`. The BEHZ pipeline
(pke/bfv_behz.py) is the all-integer RNS variant: every step is a per-limb
modular multiply, a cross-basis dot product, or a centered select, with no
multi-word fixed-point rounding. This module runs the whole EvalMult
(Montgomery lift into Bsk, tensor product in both bases, FastRNSFloor by
t/Q, Shenoy-Kumaresan back-conversion, hybrid relinearization) in one call
over limb-stacked int64 [L, ..., N] towers, tower for tower equal to the
host BFVBehzContext and to the JAX package's device towers
(tests/test_torch_bfv.py). The reference's BEHZ path
(bfvrns-leveledshe.cpp EvalMult BEHZ branch + dcrtpoly.cpp
FastBaseConvqToBskMontgomery / FastRNSFloorq / FastBaseConvSK) is CPU-only.

The m~ = 2^16 channel: the JAX module sums u32 products that wrap mod 2^32,
which is consistent mod 2^16, and keeps the low 16 bits. In int64 the sum
of L products of a 16-bit residue and a 16-bit table entry is exact, and
both factors of the product with -Q^-1 mod 2^16 are masked to 16 bits
first, so it cannot pass 2^63 and its low 16 bits are the JAX value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import modmathv as mv
from ..ops.nttl import NTTL
from .bfv_behz import MTILDE, BFVBehzContext, _behz_tables
from .bfv_device import BFVDeviceContext, DeviceBFVCiphertext, _cross_terms
from .ckks_device import _make_keyswitch

_MT_MASK = MTILDE - 1


def _make_lift_bsk(q_mods: tuple, bsk_mods: tuple, t: int, device: str):
    """Device FastBaseConvqToBskMontgomery: coeff [L, ..., N] over Q ->
    [numb+1, ..., N] over Bsk (representative in (-Q, Q), like the host)."""
    tabs = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    (mqi, qhat_bsk, qhat_mt, neg_qinv_mt, q_bsk, mt_inv) = tabs[:6]
    if not all(m > MTILDE for m in bsk_mods):
        raise ValueError("Bsk moduli must exceed m~ = 2^16")
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_bsk = mv.LimbModuli(tuple(bsk_mods), device=device)
    mqi = mqi.astype(np.int64)
    mqi_t, mqi_sh = lm_q.tensor(mqi), lm_q.tensor(lm_q.shoup(mqi))
    qhat_bsk = qhat_bsk.astype(np.int64)                    # [bsk, L]
    qhat_bsk_t = lm_bsk.tensor(qhat_bsk)
    qhat_bsk_sh = lm_bsk.tensor(lm_bsk.shoup(qhat_bsk))
    qhat_mt_t = lm_q.tensor((qhat_mt & np.uint64(_MT_MASK)).astype(np.int64))
    negq = int(neg_qinv_mt) & _MT_MASK
    q_bsk = q_bsk.astype(np.int64)
    q_bsk_t, q_bsk_sh = lm_bsk.tensor(q_bsk), lm_bsk.tensor(lm_bsk.shoup(q_bsk))
    mt_inv = mt_inv.astype(np.int64)
    mt_inv_t, mt_inv_sh = lm_bsk.tensor(mt_inv), lm_bsk.tensor(lm_bsk.shoup(mt_inv))
    m_minus_mt = lm_bsk.q - MTILDE                          # centering offset

    def lift(rows):
        nd = rows.ndim
        y = mv.mulmod_shoup_v(rows, lm_q.bc(mqi_t, nd), lm_q.bc(mqi_sh, nd), lm_q)
        # r = -conv * Q^{-1} mod m~: the sum is exact, both factors of the
        # product are 16-bit, and the low 16 bits are the JAX module's
        r_m = ((y & _MT_MASK) * lm_q.bc(qhat_mt_t, nd)).sum(0)
        r_m = ((r_m & _MT_MASK) * negq) & _MT_MASK              # [..., N]
        high = r_m >= MTILDE // 2
        acc = _cross_terms(y, len(q_mods), qhat_bsk_t, qhat_bsk_sh, lm_bsk)
        r_c = torch.where(high[None], r_m[None] + lm_bsk.bc(m_minus_mt, nd),
                          r_m[None])                            # centered, < m
        acc = mv.addmod_v(acc, mv.mulmod_shoup_v(
            r_c, lm_bsk.bc(q_bsk_t, nd), lm_bsk.bc(q_bsk_sh, nd), lm_bsk), lm_bsk)
        return mv.mulmod_shoup_v(acc, lm_bsk.bc(mt_inv_t, nd),
                                 lm_bsk.bc(mt_inv_sh, nd), lm_bsk)

    return lift


def _make_floor(q_mods: tuple, bsk_mods: tuple, t: int, device: str):
    """Device FastRNSFloorq: coeff towers over Q and Bsk ->
    floor(t*x/Q) - u (u in [0, L)) over Bsk."""
    tabs = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    t_qhatinv_q, qinv_bsk, t_qinv_bsk = (a.astype(np.int64) for a in tabs[6:9])
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_bsk = mv.LimbModuli(tuple(bsk_mods), device=device)
    tq_t, tq_sh = lm_q.tensor(t_qhatinv_q), lm_q.tensor(lm_q.shoup(t_qhatinv_q))
    qi_t, qi_sh = lm_bsk.tensor(qinv_bsk), lm_bsk.tensor(lm_bsk.shoup(qinv_bsk))
    tqi_t, tqi_sh = lm_bsk.tensor(t_qinv_bsk), lm_bsk.tensor(lm_bsk.shoup(t_qinv_bsk))

    def floor(rows_q, rows_bsk):
        nd = rows_q.ndim
        y = mv.mulmod_shoup_v(rows_q, lm_q.bc(tq_t, nd), lm_q.bc(tq_sh, nd), lm_q)
        f = _cross_terms(y, len(q_mods), qi_t, qi_sh, lm_bsk)
        tx = mv.mulmod_shoup_v(rows_bsk, lm_bsk.bc(tqi_t, nd),
                               lm_bsk.bc(tqi_sh, nd), lm_bsk)
        return mv.submod_v(tx, f, lm_bsk)

    return floor


def _make_conv_sk(q_mods: tuple, bsk_mods: tuple, t: int, device: str):
    """Device FastBaseConvSK: coeff towers over Bsk -> over Q (exact for
    centered values in (-B*msk/2, B*msk/2))."""
    tabs = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    bhatinv_b, bhat_q, bhat_msk, binv_msk, b_mod_q = tabs[9:14]
    b_mods = tuple(bsk_mods[:-1])
    msk = int(bsk_mods[-1])
    numb = len(b_mods)
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_b = mv.LimbModuli(b_mods, device=device)
    lm_m = mv.LimbModuli((msk,), device=device)
    bi = bhatinv_b.astype(np.int64)
    bi_t, bi_sh = lm_b.tensor(bi), lm_b.tensor(lm_b.shoup(bi))
    bq = bhat_q.astype(np.int64)                            # [Lq, numb]
    bq_t, bq_sh = lm_q.tensor(bq), lm_q.tensor(lm_q.shoup(bq))
    bm = bhat_msk.astype(np.int64)[None, :]                 # [1, numb]
    bm_t, bm_sh = lm_m.tensor(bm), lm_m.tensor(lm_m.shoup(bm))
    binv = np.array([int(binv_msk)], dtype=np.int64)
    binv_t, binv_sh = lm_m.tensor(binv), lm_m.tensor(lm_m.shoup(binv))
    msk_q = np.array([msk % q for q in q_mods], dtype=np.int64)
    msk_q_t = lm_q.tensor(msk_q)
    bmodq = b_mod_q.astype(np.int64)
    bmodq_t, bmodq_sh = lm_q.tensor(bmodq), lm_q.tensor(lm_q.shoup(bmodq))
    half = msk // 2

    def conv(rows_bsk):
        nd = rows_bsk.ndim
        z = mv.mulmod_shoup_v(rows_bsk[:numb], lm_b.bc(bi_t, nd),
                              lm_b.bc(bi_sh, nd), lm_b)
        xq = _cross_terms(z, numb, bq_t, bq_sh, lm_q)
        w = _cross_terms(z, numb, bm_t, bm_sh, lm_m)            # [1, ..., N]
        alpha = mv.mulmod_shoup_v(mv.submod_v(w, rows_bsk[numb:numb + 1], lm_m),
                                  lm_m.bc(binv_t, nd), lm_m.bc(binv_sh, nd), lm_m)
        high = alpha[0] > half
        a_q = mv.mod_u32_v(alpha.expand_as(xq), lm_q)
        a_c = torch.where(high[None], mv.submod_v(a_q, lm_q.bc(msk_q_t, nd), lm_q),
                          a_q)
        corr = mv.mulmod_shoup_v(a_c, lm_q.bc(bmodq_t, nd), lm_q.bc(bmodq_sh, nd),
                                 lm_q)
        return mv.submod_v(xq, corr, lm_q)

    return conv


@functools.lru_cache(maxsize=None)
def build_bfv_behz_mult(N: int, q_mods: tuple, bsk_mods: tuple,
                        p_moduli: tuple, groups: tuple, t: int, *, device: str):
    """(a0,a1,b0,b1) eval [L,(B,)N] over Q + relin key towers -> (c0,c1).
    Lift into Bsk, tensor in Q and Bsk, t/Q floor, SK back to Q,
    relinearize (bfvrns-leveledshe.cpp EvalMult BEHZ branch, fused).
    Cached per chain, key layout and device."""
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_bsk = mv.LimbModuli(tuple(bsk_mods), device=device)
    ntt_q = NTTL(N, tuple(q_mods), device=device)
    ntt_bsk = NTTL(N, tuple(bsk_mods), device=device)
    lift = _make_lift_bsk(q_mods, bsk_mods, t, device)
    floor = _make_floor(q_mods, bsk_mods, t, device)
    conv_sk = _make_conv_sk(q_mods, bsk_mods, t, device)
    ks = _make_keyswitch(N, tuple(q_mods), p_moduli, groups, None, device)

    def mult(a0, a1, b0, b1, kb, kb_sh, ka, ka_sh):
        def extend(ev):
            """eval towers over Q -> (eval over Q, eval over Bsk)."""
            return ev, ntt_bsk.forward(lift(ntt_q.inverse(ev)))

        ea0, ea1 = extend(a0), extend(a1)
        eb0, eb1 = extend(b0), extend(b1)

        def tensor(x, y, z=None, w=None):
            pq = mv.barrett_mulmod_v(x[0], y[0], lm_q)
            pb = mv.barrett_mulmod_v(x[1], y[1], lm_bsk)
            if z is not None:
                pq = mv.addmod_v(pq, mv.barrett_mulmod_v(z[0], w[0], lm_q), lm_q)
                pb = mv.addmod_v(pb, mv.barrett_mulmod_v(z[1], w[1], lm_bsk), lm_bsk)
            return pq, pb

        def scale_back(pq, pb):
            return conv_sk(floor(ntt_q.inverse(pq), ntt_bsk.inverse(pb)))

        d0c = scale_back(*tensor(ea0, eb0))
        d1c = scale_back(*tensor(ea0, eb1, ea1, eb0))
        d2c = scale_back(*tensor(ea1, eb1))
        s0, s1 = ks(d2c, kb, kb_sh, ka, ka_sh)
        c0 = mv.addmod_v(d0c, s0, lm_q)
        c1 = mv.addmod_v(d1c, s1, lm_q)
        return ntt_q.forward(c0), ntt_q.forward(c1)

    return mult


class BFVBehzDeviceContext(BFVDeviceContext):
    """BFV device path with the BEHZ multiplication technique: wraps a
    BFVBehzContext; rotations, adds, and key residency are shared with the
    HPS device context (technique only reroutes EvalMult, like the
    reference). Runs on the card unless `device` names another torch
    device."""

    def __init__(self, behz_ctx: BFVBehzContext, device: str = "cuda"):
        if not isinstance(behz_ctx, BFVBehzContext):
            raise TypeError("BFVBehzDeviceContext wraps a BFVBehzContext")
        super().__init__(behz_ctx, device)
        if not all(m < (1 << 31) for m in behz_ctx.bsk_moduli):
            raise ValueError("device Bsk basis needs moduli < 2^31 "
                             "(use limb_bits <= 30)")

    def eval_mult(self, a: DeviceBFVCiphertext,
                  b: DeviceBFVCiphertext) -> DeviceBFVCiphertext:
        assert a.moduli == b.moduli and self._rlk is not None
        key = self._rlk
        fn = build_bfv_behz_mult(self.params.N, a.moduli,
                                 tuple(self.rns.bsk_moduli), key.p_moduli,
                                 key.groups, self.params.t, device=self.device)
        c0, c1 = fn(a.c0, a.c1, b.c0, b.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceBFVCiphertext(c0, c1, a.moduli)
