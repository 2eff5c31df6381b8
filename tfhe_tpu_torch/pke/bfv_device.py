"""Device-resident RNS-BFV: the HPS multiplication pipeline on torch tensors.

Port of `tfhe_tpu/pke/bfv_device.py`, the BFV counterpart of
pke/ckks_device.py: one call runs the whole EvalMult (exact centered
expansion Q -> QR, tensor product over the extended basis, t/Q
scale-and-round into R, exact switch back to Q, hybrid relinearization);
rotations and adds reuse the shared tower builders.

Every rounding step (the expansion alpha, the fractional nu) is the host's
32-bit-word integer fixed point (bfv_rns._fp_round_dot: F = 80 for alpha,
F = 64 for nu). The JAX module keeps (lo, hi) u32 pairs and detects carries
by wraparound; here the towers are int64 with every limb below 2^31, so
each product y * w of a residue and a 32-bit word is exact (< 2^63), its
low and high halves are summed per word column, and the carries are folded
after. Both compute the exact integer sum, so the folded words, the rounded
values and the device towers are the JAX package's bit for bit and the
host BFVRnsContext's tower for tower (tests/test_torch_bfv.py). The
reference's bfvrns stack (bfvrns-leveledshe.cpp ExpandCRTBasis /
ScaleAndRound) is CPU-only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import modmathv as mv
from ..ops.nttl import NTTL
from .bfv import BFVCiphertext
from .bfv_rns import (BFVRnsContext, _EXPAND_F, _NU_F, _expand_tables,
                      _scale_round_tables)
from .ckks_device import _PackedKey, _make_keyswitch, build_add, build_rotate
from .dcrt import DCRTParams, DCRTPoly
from .dcrt_device import to_device, to_host
from .encoding import rotation_automorphism_index

_MASK32 = 0xFFFFFFFF


def _word_tensors(words, lm: mv.LimbModuli) -> list:
    """The three 32-bit words of each fixed-point constant (bfv_rns._fp_split)
    as per-source-limb [s] int64 tensors on lm's device."""
    return [lm.tensor(np.asarray(w, dtype=np.int64)) for w in words]


def _fp_dot_words(y: torch.Tensor, words) -> list:
    """Word sums of sum_i y_i * t_i over the stacked source axis of y
    ([s, ..., N], every y_i < 2^31; t_i as three 32-bit words, [s] tensors
    from `_word_tensors`): the four folded 32-bit words of S, the top word
    reduced mod 2^32 as the JAX module's u32 pairs leave it. Each y * w is
    exact in int64, and s column sums of 32-bit halves stay far below 2^63,
    so the words are the exact S's (bfv_rns._fp_round_dot's)."""
    cols = [0, 0, 0, 0]
    for k, w in enumerate(words):
        p = y * mv.LimbModuli.bc(w, y.ndim)
        cols[k] = cols[k] + (p & _MASK32).sum(0)
        cols[k + 1] = cols[k + 1] + (p >> 32).sum(0)
    ws = []
    carry = 0
    for k in range(4):
        v = cols[k] + carry
        ws.append(v & _MASK32)
        carry = v >> 32
    return ws


def _fp_round_shift(ws, F: int):
    """+ 2^(F-1) then >> F on the folded words: the (lo, hi) 32-bit words of
    the rounded value, as the JAX module's u32 pair (hi is zero for every
    table here except nu's overflow word)."""
    ws = list(ws)
    k, r = divmod(F - 1, 32)
    inc = 1 << r
    for i in range(k, 3):
        v = ws[i] + inc
        ws[i] = v & _MASK32
        inc = v >> 32
    ws[3] = (ws[3] + inc) & _MASK32
    kq, rq = divmod(F, 32)
    if rq == 0:
        lo = ws[kq]
        hi = ws[kq + 1] if kq + 1 <= 3 else torch.zeros_like(ws[0])
    else:
        lo = ((ws[kq] >> rq) | (ws[kq + 1] << (32 - rq))) & _MASK32
        hi = (ws[kq + 1] >> rq) if kq + 2 > 3 else \
            ((ws[kq + 1] >> rq) | (ws[kq + 2] << (32 - rq))) & _MASK32
    return lo, hi


def _make_pair_mod(lm: mv.LimbModuli):
    """(hi*2^32 + lo) mod q per limb: a limb-axis-free 32-bit pair broadcast
    into the stacked dst basis."""
    two32 = np.array([(1 << 32) % m for m in lm.moduli], dtype=np.int64)
    two32_t, two32_sh = lm.tensor(two32), lm.tensor(lm.shoup(two32))

    def pair_mod(lo, hi, nd):
        h = mv.mulmod_shoup_v(mv.mod_u32_v(hi[None], lm),
                              lm.bc(two32_t, nd), lm.bc(two32_sh, nd), lm)
        return mv.addmod_v(h, mv.mod_u32_v(lo[None], lm), lm)

    return pair_mod


def _cross_terms(y, n_src: int, mat_t, mat_sh, lm: mv.LimbModuli, acc=None):
    """acc + sum_i (y_i mod m_j) * mat[j, i] mod m_j over the first n_src
    rows of y, as the JAX module's per-limb Shoup chain."""
    nd = y.ndim
    for i in range(n_src):
        term = mv.mulmod_shoup_v(mv.mod_u32_v(y[i][None], lm),
                                 lm.bc(mat_t[:, i], nd), lm.bc(mat_sh[:, i], nd), lm)
        acc = term if acc is None else mv.addmod_v(acc, term, lm)
    return acc


def _make_expand(src: tuple, dst: tuple, device: str):
    """Device exact-centered basis extension: stacked coeff [s, ..., N] rows
    -> [d, ..., N] (bfv_rns.expand_crt_basis, bit-identical)."""
    inv, alpha_words, dhat, d_dst = _expand_tables(tuple(src), tuple(dst))
    lm_s = mv.LimbModuli(tuple(src), device=device)
    lm_d = mv.LimbModuli(tuple(dst), device=device)
    inv = inv.astype(np.int64)
    inv_t, inv_sh = lm_s.tensor(inv), lm_s.tensor(lm_s.shoup(inv))
    dhat = dhat.astype(np.int64)                                  # [d, s]
    dhat_t, dhat_sh = lm_d.tensor(dhat), lm_d.tensor(lm_d.shoup(dhat))
    d_dst = d_dst.astype(np.int64)
    d_t, d_sh = lm_d.tensor(d_dst), lm_d.tensor(lm_d.shoup(d_dst))
    alpha_t = _word_tensors(alpha_words, lm_s)
    pair_mod = _make_pair_mod(lm_d)

    def expand(rows):
        nd = rows.ndim
        y = mv.mulmod_shoup_v(rows, lm_s.bc(inv_t, nd), lm_s.bc(inv_sh, nd), lm_s)
        a_lo, a_hi = _fp_round_shift(_fp_dot_words(y, alpha_t), _EXPAND_F)
        acc = _cross_terms(y, len(src), dhat_t, dhat_sh, lm_d)
        corr = mv.mulmod_shoup_v(pair_mod(a_lo, a_hi, nd), lm_d.bc(d_t, nd),
                                 lm_d.bc(d_sh, nd), lm_d)
        return mv.submod_v(acc, corr, lm_d)

    return expand


def _make_scale_round(q_mods: tuple, r_mods: tuple, t: int, device: str):
    """Device t/Q scale-and-round: coeff rows over QR -> rows over R
    (bfv_rns.scale_and_round, bit-identical)."""
    inv, omega, theta_words, t_rhat, t_r, alpha_words = _scale_round_tables(
        tuple(q_mods), tuple(r_mods), t)
    n_q, n_r = len(q_mods), len(r_mods)
    lm_all = mv.LimbModuli(tuple(q_mods) + tuple(r_mods), device=device)
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_r = mv.LimbModuli(tuple(r_mods), device=device)
    inv = inv.astype(np.int64)
    inv_t, inv_sh = lm_all.tensor(inv), lm_all.tensor(lm_all.shoup(inv))
    omega = np.array(omega, dtype=np.int64)                       # [r, q]
    omega_t, omega_sh = lm_r.tensor(omega), lm_r.tensor(lm_r.shoup(omega))
    rhat = np.array(t_rhat, dtype=np.int64)                       # [r, r]
    rhat_t, rhat_sh = lm_r.tensor(rhat), lm_r.tensor(lm_r.shoup(rhat))
    tr = np.array(t_r, dtype=np.int64)
    tr_t, tr_sh = lm_r.tensor(tr), lm_r.tensor(lm_r.shoup(tr))
    alpha_t = _word_tensors(alpha_words, lm_all)
    theta_t = _word_tensors(theta_words, lm_q)
    pair_mod = _make_pair_mod(lm_r)

    def scale_round(rows):
        nd = rows.ndim
        y = mv.mulmod_shoup_v(rows, lm_all.bc(inv_t, nd),
                              lm_all.bc(inv_sh, nd), lm_all)
        a_lo, a_hi = _fp_round_shift(_fp_dot_words(y, alpha_t), _EXPAND_F)
        n_lo, n_hi = _fp_round_shift(_fp_dot_words(y[:n_q], theta_t), _NU_F)
        acc = _cross_terms(y, n_q, omega_t, omega_sh, lm_r)
        acc = _cross_terms(y[n_q:], n_r, rhat_t, rhat_sh, lm_r, acc)
        corr = mv.mulmod_shoup_v(pair_mod(a_lo, a_hi, nd), lm_r.bc(tr_t, nd),
                                 lm_r.bc(tr_sh, nd), lm_r)
        acc = mv.submod_v(acc, corr, lm_r)
        return mv.addmod_v(acc, pair_mod(n_lo, n_hi, nd), lm_r)

    return scale_round


@functools.lru_cache(maxsize=None)
def build_bfv_mult(N: int, q_mods: tuple, r_mods: tuple, p_moduli: tuple,
                   groups: tuple, t: int, *, device: str):
    """(a0,a1,b0,b1) eval [L,(B,)N] over Q + relin key towers -> (c0,c1)
    eval. Expansion to QR, tensor product, t/Q scale-round, switch back to
    Q, relinearize (bfvrns-leveledshe.cpp EvalMult + keyswitch-hybrid.cpp,
    fused on the device). Cached per chain, key layout and device."""
    all_mods = tuple(q_mods) + tuple(r_mods)
    lm_q = mv.LimbModuli(tuple(q_mods), device=device)
    lm_qr = mv.LimbModuli(all_mods, device=device)
    ntt_q = NTTL(N, tuple(q_mods), device=device)
    ntt_r = NTTL(N, tuple(r_mods), device=device)
    ntt_qr = NTTL(N, all_mods, device=device)
    lift = _make_expand(q_mods, r_mods, device)
    scale_round = _make_scale_round(q_mods, r_mods, t, device)
    back = _make_expand(r_mods, q_mods, device)
    ks = _make_keyswitch(N, tuple(q_mods), p_moduli, groups, None, device)

    def mult(a0, a1, b0, b1, kb, kb_sh, ka, ka_sh):
        def extend(ev):
            """eval towers over Q -> eval towers over Q + R."""
            ext = lift(ntt_q.inverse(ev))
            return torch.cat([ev, ntt_r.forward(ext)], dim=0)

        ea0, ea1 = extend(a0), extend(a1)
        eb0, eb1 = extend(b0), extend(b1)

        def tensor(x, y, z, w):
            p = mv.barrett_mulmod_v(x, y, lm_qr)
            if z is not None:
                p = mv.addmod_v(p, mv.barrett_mulmod_v(z, w, lm_qr), lm_qr)
            return p

        def scale_back(d_ev):
            return back(scale_round(ntt_qr.inverse(d_ev)))

        d0c = scale_back(tensor(ea0, eb0, None, None))
        d1c = scale_back(tensor(ea0, eb1, ea1, eb0))
        d2c = scale_back(tensor(ea1, eb1, None, None))
        s0, s1 = ks(d2c, kb, kb_sh, ka, ka_sh)
        c0 = mv.addmod_v(d0c, s0, lm_q)
        c1 = mv.addmod_v(d1c, s1, lm_q)
        return ntt_q.forward(c0), ntt_q.forward(c1)

    return mult


@dataclass
class DeviceBFVCiphertext:
    """Ciphertext resident on the device: two int64 eval-form towers [L, N]
    (or [L, B, N] for a batch)."""
    c0: torch.Tensor
    c1: torch.Tensor
    moduli: tuple


class BFVDeviceContext:
    """Front door for the BFV device path: wraps a BFVRnsContext (which must
    carry a sub-2^31-limb chain and ks_limb_bits <= 30), keeps relin/galois
    keys device-resident, and runs mult/rotate/add chains without the towers
    ever visiting the host. Runs on the card unless `device` names another
    torch device (the tests pass "cpu")."""

    def __init__(self, rns_ctx: BFVRnsContext, device: str = "cuda"):
        if not all(m < (1 << 31) for m in rns_ctx.params.dcrt.moduli
                   + tuple(rns_ctx.r_moduli)):
            raise ValueError("device chain needs Q and R limb moduli < 2^31 "
                             "(use limb_bits <= 30)")
        self.rns = rns_ctx
        self.params = rns_ctx.params
        self.device = str(torch.device(device))
        self._rlk: _PackedKey | None = None
        self._gk: dict[int, _PackedKey] = {}

    def load_relin_key(self, key) -> None:
        self._rlk = _PackedKey(key, self.device)

    def load_galois_key(self, steps: int, key) -> None:
        self._gk[steps] = _PackedKey(key, self.device)

    # -- transfers ----------------------------------------------------------

    def upload(self, ct: BFVCiphertext) -> DeviceBFVCiphertext:
        lp = ct.polys[0].params
        return DeviceBFVCiphertext(
            to_device(ct.polys[0].to_eval().rns, self.device),
            to_device(ct.polys[1].to_eval().rns, self.device), lp.moduli)

    def download(self, dct: DeviceBFVCiphertext) -> BFVCiphertext:
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        return BFVCiphertext([DCRTPoly(lp, to_host(dct.c0), True),
                              DCRTPoly(lp, to_host(dct.c1), True)], self.params)

    def upload_batch(self, cts) -> DeviceBFVCiphertext:
        """Batch-first residency: towers stacked to [L, B, N]; every builder
        works on the last axis with any leading batch shape."""
        lp = cts[0].polys[0].params
        assert all(c.polys[0].params.moduli == lp.moduli for c in cts)

        def stack(k):
            return to_device(np.stack([c.polys[k].to_eval().rns for c in cts],
                                      axis=1), self.device)

        return DeviceBFVCiphertext(stack(0), stack(1), lp.moduli)

    def download_batch(self, dct: DeviceBFVCiphertext) -> list:
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        c0, c1 = to_host(dct.c0), to_host(dct.c1)
        return [BFVCiphertext([DCRTPoly(lp, c0[:, b], True),
                               DCRTPoly(lp, c1[:, b], True)], self.params)
                for b in range(c0.shape[1])]

    # -- homomorphic ops ----------------------------------------------------

    def eval_mult(self, a: DeviceBFVCiphertext,
                  b: DeviceBFVCiphertext) -> DeviceBFVCiphertext:
        assert a.moduli == b.moduli and self._rlk is not None
        key = self._rlk
        fn = build_bfv_mult(self.params.N, a.moduli, tuple(self.rns.r_moduli),
                            key.p_moduli, key.groups, self.params.t,
                            device=self.device)
        c0, c1 = fn(a.c0, a.c1, b.c0, b.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceBFVCiphertext(c0, c1, a.moduli)

    def eval_rotate(self, dct: DeviceBFVCiphertext,
                    steps: int) -> DeviceBFVCiphertext:
        key = self._gk[steps]
        k = rotation_automorphism_index(self.params.N, steps)
        fn = build_rotate(self.params.N, dct.moduli, key.p_moduli, key.groups,
                          k, device=self.device)
        c0, c1 = fn(dct.c0, dct.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceBFVCiphertext(c0, c1, dct.moduli)

    def eval_add(self, a: DeviceBFVCiphertext,
                 b: DeviceBFVCiphertext) -> DeviceBFVCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, device=self.device)(a.c0, a.c1, b.c0, b.c1)
        return DeviceBFVCiphertext(c0, c1, a.moduli)

    def eval_sub(self, a: DeviceBFVCiphertext,
                 b: DeviceBFVCiphertext) -> DeviceBFVCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, sub=True, device=self.device)(
            a.c0, a.c1, b.c0, b.c1)
        return DeviceBFVCiphertext(c0, c1, a.moduli)
