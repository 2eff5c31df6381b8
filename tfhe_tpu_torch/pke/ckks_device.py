"""Device-resident RNS-CKKS: the homomorphic hot loop on torch tensors.

Port of `tfhe_tpu/pke/ckks_device.py` (its mult, rotate, add, plaintext
and bootstrapping `build_*` functions and `CKKSDeviceContext`):

- `eval_mult`: tensor product -> hybrid key-switch relinearization (per-group
  HPS fast base conversion, inner product with the key towers, ModDown by P)
  -> RNS rescale, one call per level chain; the ciphertext towers never
  leave the device between operations.
- `eval_rotate`: coefficient-domain automorphism + hybrid key switch of the
  automorphed c1; `rotation_precompute` + `eval_rotate_hoisted`: the hoisted
  form, the automorphism applied as a gather in the evaluation domain.
- `eval_add/sub`: pointwise residue arithmetic.

Towers are int64 tensors [L, ..., N] (limbs stacked first, an optional
batch axis next: [L, B, N]), computed with exact integer arithmetic on limb
moduli < 2^31 (`ops/modmathv.py`, `ops/nttl.py`), and the FBC alpha
correction uses the same integer fixed point as the host
(ckks_rns.alpha_fixed_tables), so device towers are bit-identical to the
host CKKSRnsContext and to the JAX package's device towers on every input.

The JAX package's ops here are XLA graphs, not Pallas kernels; here they
are torch ops, each `build_*` cached per (chain, key layout, device). The
bootstrapping builders (`build_bsgs_inner`, `build_diag_inner`,
`build_diag_factor_lazy`) serve `ckks_boot_device.py` and
`ckks_boot_fft_device.py`. With `t` > 1 the key switch takes the BGV
t-exact ModDown and the rescale the BGV ModReduce (`bgv_device.py`); with
the default `t` = 1 they are the CKKS steps.

Reference parity anchors: rns-leveledshe.cpp (EvalMultCore/ModReduce),
keyswitch-hybrid.cpp:1-484 (KeySwitchCore/EvalKeySwitchPrecomputeCore),
ckksrns-leveledshe.cpp (EvalRotate).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import modmathv as mv
from ..ops.nttl import NTTL
from .ckks_rns import (CKKSRnsContext, RnsHybridKey, _fbc_tables,
                       alpha_fixed_tables, eval_auto_perm)
from .dcrt import DCRTParams, DCRTPoly
from .dcrt_device import to_device, to_host
from .encoding import rotation_automorphism_index


def _bc_key(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a per-limb [L, N] (or [L]) tensor against a stacked
    [L, ..., N] operand (`_bc_traced` of the JAX module)."""
    if x.ndim == 1:
        return x.reshape((x.shape[0],) + (1,) * (ndim - 1))
    return x.reshape((x.shape[0],) + (1,) * (ndim - 2) + (x.shape[-1],))


# -- building blocks ----------------------------------------------------------
#
# Every `build_*` operates on LIMB-STACKED towers [L, ..., N] with
# vector-modulus arithmetic and the limb-stacked NTT: the number of torch
# ops is O(log N + dnum * group) whatever the chain length L.

def _make_fbc(src: tuple, dst: tuple, device: str):
    """HPS fast base conversion: stacked [s, ..., N] rows over `src` ->
    [d, ..., N] over `dst`. Bit-identical to ckks_rns.fast_base_convert
    (shared integer fixed-point alpha)."""
    lm_s = mv.LimbModuli(tuple(src), device=device)
    lm_d = mv.LimbModuli(tuple(dst), device=device)
    F, _, t = alpha_fixed_tables(tuple(src))  # shifts are 0: limbs < 2^31
    # alpha's sum: each term y_i * t_i < 2^F, so s terms fit int64 exactly
    if len(src) << F >= 1 << 63:
        raise ValueError(f"{len(src)} source limbs overflow the int64 alpha sum")
    inv, dhat, d_dst = (np.asarray(a, dtype=np.int64)
                        for a in _fbc_tables(tuple(src), tuple(dst)))
    inv_t, inv_sh = lm_s.tensor(inv), lm_s.tensor(lm_s.shoup(inv))
    dhat_t, dhat_sh = lm_d.tensor(dhat), lm_d.tensor(lm_d.shoup(dhat))  # [d, s]
    d_t, d_sh = lm_d.tensor(d_dst), lm_d.tensor(lm_d.shoup(d_dst))

    def fbc(rows):
        nd = rows.ndim
        y = mv.mulmod_shoup_v(rows, lm_s.bc(inv_t, nd), lm_s.bc(inv_sh, nd), lm_s)
        # alpha = round(sum y_i/q_i) = (sum y_i*t_i + 2^(F-1)) >> F, the exact
        # integer the host computes in u64 and the JAX module in u32 pairs
        acc = y[0] * t[0]
        for i in range(1, len(src)):
            acc = acc + y[i] * t[i]
        alpha = (acc + (1 << (F - 1))) >> F
        out = None
        for i in range(len(src)):
            term = mv.mulmod_shoup_v(mv.mod_u32_v(y[i][None], lm_d),
                                     lm_d.bc(dhat_t[:, i], nd),
                                     lm_d.bc(dhat_sh[:, i], nd), lm_d)
            out = term if out is None else mv.addmod_v(out, term, lm_d)
        corr = mv.mulmod_shoup_v(alpha[None], lm_d.bc(d_t, nd),
                                 lm_d.bc(d_sh, nd), lm_d)
        return mv.submod_v(out, corr, lm_d)

    return fbc


def _make_keyswitch(N: int, lvl: tuple, p_moduli: tuple, groups: tuple,
                    key_rows: tuple | None, device: str, t: int = 1):
    """Hybrid key switch: coeff-form [L, ..., N] rows of the switched poly ->
    (delta0, delta1) coeff-form rows over `lvl`. The key towers arrive as
    [G, L_pq, N] tensors with Shoup companions. `key_rows` selects the
    level's limb rows out of a FULL-chain key tower (the level-aware
    single-key scheme: the full key restricted to the level's limbs is the
    level key). `t` > 1 selects the BGV t-exact ModDown: subtract
    t*FBC([x*t^-1]_P), congruent to x mod P and to 0 mod t (see
    ckks_rns.rns_hybrid_key_switch)."""
    pq = lvl + p_moduli
    n_q = len(lvl)
    lm_pq = mv.LimbModuli(tuple(pq), device=device)
    lm_lvl = mv.LimbModuli(tuple(lvl), device=device)
    ntt_pq = NTTL(N, tuple(pq), device=device)
    fbcs = [_make_fbc(lvl[g0:g1], pq, device) for (g0, g1) in groups]
    fbc_p = _make_fbc(p_moduli, lvl, device)
    P = 1
    for m in p_moduli:
        P *= m
    pinv = np.array([pow(P % m, -1, m) for m in lvl], dtype=np.int64)
    pinv_t, pinv_sh = lm_lvl.tensor(pinv), lm_lvl.tensor(lm_lvl.shoup(pinv))
    sel = None if key_rows is None else torch.as_tensor(key_rows, device=device)
    if t > 1:
        lm_p = mv.LimbModuli(tuple(p_moduli), device=device)
        tinv = np.array([pow(t % m, -1, m) for m in p_moduli], dtype=np.int64)
        tinv_t, tinv_sh = lm_p.tensor(tinv), lm_p.tensor(lm_p.shoup(tinv))
        t_l = np.array([t % m for m in lvl], dtype=np.int64)
        t_l_t, t_l_sh = lm_lvl.tensor(t_l), lm_lvl.tensor(lm_lvl.shoup(t_l))

    def moddown(rows):          # coeff [L_pq, ..., N] -> [L, ..., N]
        nd = rows.ndim
        x_p = rows[n_q:]
        if t > 1:
            x_p = mv.mulmod_shoup_v(x_p, lm_p.bc(tinv_t, nd),
                                    lm_p.bc(tinv_sh, nd), lm_p)
        corr = fbc_p(x_p)
        if t > 1:
            corr = mv.mulmod_shoup_v(corr, lm_lvl.bc(t_l_t, nd),
                                     lm_lvl.bc(t_l_sh, nd), lm_lvl)
        diff = mv.submod_v(rows[:n_q], corr, lm_lvl)
        return mv.mulmod_shoup_v(diff, lm_lvl.bc(pinv_t, nd),
                                 lm_lvl.bc(pinv_sh, nd), lm_lvl)

    def precompute(c2c):
        """Digit groups of coeff rows [L, ..., N], FBC-extended to PQ and
        NTT'd — the key-independent (hoistable) half of the switch."""
        return [ntt_pq.forward(fbcs[g](c2c[g0:g1]))
                for g, (g0, g1) in enumerate(groups)]

    def ip(dps, kb, kb_sh, ka, ka_sh):
        """Inner product of precomputed eval digits with the key towers —
        the result stays in the PQ basis, EVAL form (no ModDown)."""
        acc0 = acc1 = None
        for g in range(len(groups)):
            dp = dps[g]
            kbg, kbshg, kag, kashg = (
                (kb[g], kb_sh[g], ka[g], ka_sh[g]) if sel is None
                else (kb[g].index_select(0, sel), kb_sh[g].index_select(0, sel),
                      ka[g].index_select(0, sel), ka_sh[g].index_select(0, sel)))
            t0 = mv.mulmod_shoup_v(dp, _bc_key(kbg, dp.ndim),
                                   _bc_key(kbshg, dp.ndim), lm_pq)
            t1 = mv.mulmod_shoup_v(dp, _bc_key(kag, dp.ndim),
                                   _bc_key(kashg, dp.ndim), lm_pq)
            acc0 = t0 if acc0 is None else mv.addmod_v(acc0, t0, lm_pq)
            acc1 = t1 if acc1 is None else mv.addmod_v(acc1, t1, lm_pq)
        return acc0, acc1

    def finish(acc0, acc1):
        """PQ eval accumulators -> ModDown'd coeff rows over `lvl`."""
        return (moddown(ntt_pq.inverse(acc0)),
                moddown(ntt_pq.inverse(acc1)))

    def inner(dps, kb, kb_sh, ka, ka_sh):
        """Inner product + ModDown — the per-key half."""
        return finish(*ip(dps, kb, kb_sh, ka, ka_sh))

    def ks(c2c, kb, kb_sh, ka, ka_sh):
        return inner(precompute(c2c), kb, kb_sh, ka, ka_sh)

    ks.precompute = precompute
    ks.inner = inner
    ks.ip = ip
    ks.finish = finish
    ks.lm_pq = lm_pq
    return ks


def _make_rescale(lvl: tuple, device: str, t: int = 1):
    """Coeff-form [L] rows -> [L-1] rows, scaling by 1/q_last (RNS ModReduce
    with the centered correction; same math as ckks_rns.rescale_rns). With
    `t` > 1 this is the BGV ModReduce instead: add the centered correction
    t*[-c*t^-1]_{q_last} before the exact division, so the message mod t is
    preserved (bgv_rns.mod_reduce_rns)."""
    q_last = lvl[-1]
    keep = tuple(lvl[:-1])
    lm_k = mv.LimbModuli(keep, device=device)
    inv = np.array([pow(q_last, -1, m) for m in keep], dtype=np.int64)
    inv_t, inv_sh = lm_k.tensor(inv), lm_k.tensor(lm_k.shoup(inv))
    ql_mod = lm_k.tensor([q_last % m for m in keep])

    def centered(c, nd):
        """A row of residues mod q_last, centered, as residues mod keep."""
        c_m = mv.mod_u32_v(c, lm_k)
        return torch.where(c > q_last // 2,
                           mv.submod_v(c_m, lm_k.bc(ql_mod, nd), lm_k), c_m)

    if t == 1:
        def rescale(rows):
            nd = rows.ndim
            diff = mv.submod_v(rows[:-1], centered(rows[-1:], nd), lm_k)
            return mv.mulmod_shoup_v(diff, lm_k.bc(inv_t, nd),
                                     lm_k.bc(inv_sh, nd), lm_k)

        return rescale

    lm_l = mv.LimbModuli((q_last,), device=device)
    tinv = [pow(t % q_last, -1, q_last)]
    tinv_t, tinv_sh = lm_l.tensor(tinv), lm_l.tensor(lm_l.shoup(tinv))
    t_k = np.array([t % m for m in keep], dtype=np.int64)
    t_k_t, t_k_sh = lm_k.tensor(t_k), lm_k.tensor(lm_k.shoup(t_k))

    def modreduce(rows):
        nd = rows.ndim
        c_last = rows[-1:]
        v = torch.where(c_last == 0, c_last, q_last - c_last)   # -c mod q_last
        u = mv.mulmod_shoup_v(v, lm_l.bc(tinv_t, nd), lm_l.bc(tinv_sh, nd), lm_l)
        w = mv.mulmod_shoup_v(centered(u, nd), lm_k.bc(t_k_t, nd),
                              lm_k.bc(t_k_sh, nd), lm_k)
        s = mv.addmod_v(rows[:-1], w, lm_k)
        return mv.mulmod_shoup_v(s, lm_k.bc(inv_t, nd), lm_k.bc(inv_sh, nd), lm_k)

    return modreduce


@functools.lru_cache(maxsize=None)
def build_mult_relin_rescale(N: int, lvl: tuple, p_moduli: tuple,
                             groups: tuple, key_rows: tuple | None = None,
                             rescale: bool = True, *, t: int = 1, device: str):
    """(a0,a1,b0,b1) eval [L, ..., N] + relin key towers -> (c0,c1) eval
    [L-1, ..., N]: tensor product, relinearization, rescale, with no host
    round trip (rns-leveledshe.cpp EvalMultCore + keyswitch-hybrid.cpp +
    ModReduce). `t` > 1 selects the BGV variants of the ModDown and
    ModReduce steps. `rescale=False` keeps the product at [L, ..., N] /
    noise degree 2 — the lazy rescale of the automatic scaling techniques."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    ntt_out = NTTL(N, tuple(lvl[:-1]), device=device) if rescale else None
    ks = _make_keyswitch(N, lvl, p_moduli, groups, key_rows, device, t)
    resc = _make_rescale(lvl, device, t) if rescale else None

    def mult(a0, a1, b0, b1, kb, kb_sh, ka, ka_sh):
        d0 = mv.barrett_mulmod_v(a0, b0, lm)
        d1 = mv.addmod_v(mv.barrett_mulmod_v(a0, b1, lm),
                         mv.barrett_mulmod_v(a1, b0, lm), lm)
        d2 = mv.barrett_mulmod_v(a1, b1, lm)
        s0, s1 = ks(ntt.inverse(d2), kb, kb_sh, ka, ka_sh)
        c0 = mv.addmod_v(ntt.inverse(d0), s0, lm)
        c1 = mv.addmod_v(ntt.inverse(d1), s1, lm)
        if rescale:
            return ntt_out.forward(resc(c0)), ntt_out.forward(resc(c1))
        return ntt.forward(c0), ntt.forward(c1)

    return mult


def _automorphism(N: int, k: int, lm: mv.LimbModuli):
    """a(X) -> a(X^k) on coeff rows: out[(i*k) mod 2N] = +-a[i], as the
    inverse gather (source index per output slot) and the sign flips."""
    idx = (np.arange(N) * k) % (2 * N)
    tgt = idx % N
    src = np.zeros(N, dtype=np.int64)
    src[tgt] = np.arange(N)
    flip_at_tgt = np.zeros(N, dtype=bool)
    flip_at_tgt[tgt] = idx >= N
    src_t = torch.as_tensor(src, device=lm.device)
    flip = torch.as_tensor(flip_at_tgt, device=lm.device)

    def auto(rows):
        taken = rows.index_select(-1, src_t)
        q = lm.bc(lm.q, rows.ndim)
        return torch.where(flip & (taken != 0), q - taken, taken)

    return auto


@functools.lru_cache(maxsize=None)
def build_rotate(N: int, lvl: tuple, p_moduli: tuple, groups: tuple, k: int,
                 key_rows: tuple | None = None, *, t: int = 1, device: str):
    """Per (level chain, Galois element): (c0,c1) eval [L, ..., N] + galois
    key towers -> rotated (o0,o1) eval [L, ..., N]; `t` > 1 for BGV."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    ks = _make_keyswitch(N, lvl, p_moduli, groups, key_rows, device, t)
    auto = _automorphism(N, k, lm)

    def rot(c0, c1, kb, kb_sh, ka, ka_sh):
        c0a = auto(ntt.inverse(c0))
        c1a = auto(ntt.inverse(c1))
        d0, d1 = ks(c1a, kb, kb_sh, ka, ka_sh)
        o0 = mv.addmod_v(c0a, d0, lm)
        return ntt.forward(o0), ntt.forward(d1)

    return rot


@functools.lru_cache(maxsize=None)
def build_ks_precompute(N: int, lvl: tuple, p_moduli: tuple, groups: tuple,
                        *, device: str):
    """c1 eval towers [L, ..., N] -> stacked hoisting digits
    [G, L_pq, ..., N] (eval form over PQ) — EvalFastRotationPrecompute.
    Key-independent; reusable by every rotation of the same ciphertext."""
    ntt = NTTL(N, tuple(lvl), device=device)
    ks = _make_keyswitch(N, lvl, p_moduli, groups, None, device)

    def f(c1):
        return torch.stack(ks.precompute(ntt.inverse(c1)))

    return f


@functools.lru_cache(maxsize=None)
def build_rotate_hoisted(N: int, lvl: tuple, p_moduli: tuple, groups: tuple,
                         k: int, key_rows: tuple | None = None, *, t: int = 1,
                         device: str):
    """(c0, digits [G, L_pq, ..., N], key towers) -> rotated (c0', c1') eval
    towers. The automorphism is applied entirely in the evaluation domain
    as one static gather (the NTT-point permutation ckks_rns.eval_auto_perm,
    modulus-independent), so the per-rotation cost is gathers + the key
    inner product + ModDown (EvalFastRotation, HS18 hoisting); `t` > 1 for
    BGV."""
    perm = torch.as_tensor(eval_auto_perm(N, k, lvl[0]), device=device)
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    ks = _make_keyswitch(N, lvl, p_moduli, groups, key_rows, device, t)

    def f(c0, dps, kb, kb_sh, ka, ka_sh):
        dps_k = [dps[g].index_select(-1, perm) for g in range(len(groups))]
        d0, d1 = ks.inner(dps_k, kb, kb_sh, ka, ka_sh)
        c0a = c0.index_select(-1, perm)             # eval-domain automorphism
        return mv.addmod_v(c0a, ntt.forward(d0), lm), ntt.forward(d1)

    return f


@functools.lru_cache(maxsize=None)
def build_mult_plain(N: int, lvl: tuple, rescale: bool = True, *, device: str):
    """(c0, c1) eval towers x plaintext COEFF rows [L, N] -> plaintext-
    multiplied towers, optionally rescaled to [L-1] (EvalMultPlain +
    ModReduce). The plaintext NTT runs on the device, stacked. Towers may
    carry a batch axis [L, B, N]; the plaintext broadcasts."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    resc = _make_rescale(lvl, device) if rescale else None
    ntt_out = NTTL(N, tuple(lvl[:-1]), device=device) if rescale else None

    def f(c0, c1, pt_coeff):
        pt = ntt.forward(pt_coeff)
        out = []
        for c in (c0, c1):
            r = mv.barrett_mulmod_v(c, _bc_key(pt, c.ndim), lm)
            if rescale:
                r = ntt_out.forward(resc(ntt.inverse(r)))
            out.append(r)
        return out[0], out[1]

    return f


@functools.lru_cache(maxsize=None)
def build_mult_scalar(N: int, lvl: tuple, rescale: bool = True, *, device: str):
    """Towers x a per-limb scalar [L] (a big-integer constant's residues) ->
    scaled towers, optionally rescaled (EvalMultConst)."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    resc = _make_rescale(lvl, device) if rescale else None
    ntt_out = NTTL(N, tuple(lvl[:-1]), device=device) if rescale else None

    def f(c0, c1, ks):
        out = []
        for c in (c0, c1):
            r = mv.barrett_mulmod_v(c, _bc_key(ks, c.ndim), lm)
            if rescale:
                r = ntt_out.forward(resc(ntt.inverse(r)))
            out.append(r)
        return out[0], out[1]

    return f


def _bc_stacked(pt: torch.Tensor, ndim: int) -> torch.Tensor:
    """Stacked plaintexts [L, nb, N] against baby stacks [L, nb, ..., N]
    of `ndim` dims: broadcast over the batch axes."""
    if ndim <= 3:
        return pt
    return pt.reshape(pt.shape[:2] + (1,) * (ndim - 3) + pt.shape[-1:])


def _stack_sum(x: torch.Tensor, n: int, lm: mv.LimbModuli) -> torch.Tensor:
    """The exact mod-sum over axis 1 of x [L, n, ...] (in the JAX
    package's order: term 0, then 1 .. n-1)."""
    r = x[:, 0]
    for k in range(1, n):
        r = mv.addmod_v(r, x[:, k], lm)
    return r


@functools.lru_cache(maxsize=None)
def build_bsgs_inner(N: int, lvl: tuple, b: int, *, device: str):
    """A whole BSGS giant row: babies stacked on a new axis ([L, b, ..., N])
    x their coeff-form diagonal plaintexts ([L, b, N], NTT'd here) -> the
    exact mod-sum over the b terms, for the plain babies (p0, p1) with ptP
    and the conjugated ones (c0, c1) with ptC. One call per giant row
    instead of ~2b plain-mult and add calls."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)

    def f(p0, p1, c0, c1, ptP, ptC):
        ptPe = ntt.forward(ptP)
        ptCe = ntt.forward(ptC)
        outs = [mv.barrett_mulmod_v(x, _bc_stacked(pt, x.ndim), lm)
                for x, pt in ((p0, ptPe), (p1, ptPe), (c0, ptCe), (c1, ptCe))]
        acc0 = mv.addmod_v(outs[0], outs[2], lm)
        acc1 = mv.addmod_v(outs[1], outs[3], lm)
        return _stack_sum(acc0, b, lm), _stack_sum(acc1, b, lm)

    return f


@functools.lru_cache(maxsize=None)
def build_diag_inner(N: int, lvl: tuple, nb: int, *, device: str):
    """C-linear variant of build_bsgs_inner for the FFT-factored transforms
    (ckks_boot_fft.py): the grouped butterfly factors act on z alone (no
    conjugated half), so one call mod-sums baby stacks [L, nb, ..., N]
    against their coeff-form diagonal plaintexts [L, nb, N]."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)

    def f(p0, p1, pt):
        pt_b = _bc_stacked(ntt.forward(pt), p0.ndim)
        a0 = mv.barrett_mulmod_v(p0, pt_b, lm)
        a1 = mv.barrett_mulmod_v(p1, pt_b, lm)
        return _stack_sum(a0, nb, lm), _stack_sum(a1, nb, lm)

    return f


@functools.lru_cache(maxsize=None)
def build_diag_factor_lazy(N: int, lvl: tuple, p_moduli: tuple,
                           groups: tuple, nb: int, elements: tuple,
                           key_rows: tuple | None = None, *, device: str):
    """A WHOLE grouped FFT-transform factor with double-hoisted giant steps
    (lazy ModDown, the BSGS-accumulation idea of the double/triple-hoisting
    line of work, cf. DM21/Lattigo): per giant row, the fused diagonal sum
    over the `nb` baby stacks, rescale, coeff-domain automorphism, digit
    decompose/FBC and key inner product, with every row's keyed result
    ACCUMULATED IN THE EXTENDED PQ BASIS. One shared inverse PQ NTT +
    ModDown closes the factor, so a row costs digits + inner products +
    gathers (the eager path pays a full ModDown and output NTT pair per
    giant).

    `elements`: the Galois element per giant row (1 = no rotation).
    `groups`/`key_rows` describe the POST-rescale level chain lvl[:-1].
    Args: baby stacks p0/p1 [L, nb, (B,) N] EVAL over lvl; plaintext
    stacks pt [Gg, L, nb, N] COEFF; per-giant key towers (4 lists).
    Returns (c0, c1) EVAL towers over lvl[:-1]."""
    lvl2 = lvl[:-1]
    lm = mv.LimbModuli(tuple(lvl), device=device)
    lm2 = mv.LimbModuli(tuple(lvl2), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    ntt2 = NTTL(N, tuple(lvl2), device=device)
    resc = _make_rescale(lvl, device)
    ks = _make_keyswitch(N, lvl2, p_moduli, groups, key_rows, device)
    autos = {k: _automorphism(N, k, lm2) for k in set(elements) if k != 1}

    def add(acc, x, lmx):
        return x if acc is None else mv.addmod_v(acc, x, lmx)

    def f(p0, p1, pt, kbs, kbshs, kas, kashs):
        # [Gg, L, nb, N] -> [L, Gg, nb, N]: the stacked NTT wants the limb
        # axis leading (twiddles broadcast over the trailing dims)
        pte = ntt.forward(pt.movedim(0, 1))
        acc_c0 = acc_c1 = None                      # lvl2 coeff (unkeyed)
        acc_q0 = acc_q1 = None                      # PQ eval (keyed)
        for gi, k in enumerate(elements):
            ptg_b = _bc_stacked(pte[:, gi], p0.ndim)
            r0 = _stack_sum(mv.barrett_mulmod_v(p0, ptg_b, lm), nb, lm)
            r1 = _stack_sum(mv.barrett_mulmod_v(p1, ptg_b, lm), nb, lm)
            r0c = resc(ntt.inverse(r0))             # coeff over lvl2
            r1c = resc(ntt.inverse(r1))
            if k == 1:
                acc_c0 = add(acc_c0, r0c, lm2)
                acc_c1 = add(acc_c1, r1c, lm2)
                continue
            acc_c0 = add(acc_c0, autos[k](r0c), lm2)
            i0, i1 = ks.ip(ks.precompute(autos[k](r1c)),
                           kbs[gi], kbshs[gi], kas[gi], kashs[gi])
            acc_q0 = add(acc_q0, i0, ks.lm_pq)
            acc_q1 = add(acc_q1, i1, ks.lm_pq)
        if acc_q0 is not None:
            d0, d1 = ks.finish(acc_q0, acc_q1)
            acc_c0 = mv.addmod_v(acc_c0, d0, lm2)
            acc_c1 = add(acc_c1, d1, lm2)
        return ntt2.forward(acc_c0), ntt2.forward(acc_c1)

    return f


@functools.lru_cache(maxsize=None)
def build_rescale_only(N: int, lvl: tuple, *, device: str):
    """Towers [L, ..., N] -> [L-1, ..., N], RNS rescale by 1/q_last
    (standalone ModReduce)."""
    ntt = NTTL(N, tuple(lvl), device=device)
    ntt_out = NTTL(N, tuple(lvl[:-1]), device=device)
    resc = _make_rescale(lvl, device)

    def f(c0, c1):
        return (ntt_out.forward(resc(ntt.inverse(c0))),
                ntt_out.forward(resc(ntt.inverse(c1))))

    return f


@functools.lru_cache(maxsize=None)
def build_add_plain(N: int, lvl: tuple, sub: bool = False, *, device: str):
    """c0 + plaintext COEFF rows [L, N] (NTT'd on the device) — EvalAddPlain
    for vector plaintexts; c1 passes through untouched."""
    lm = mv.LimbModuli(tuple(lvl), device=device)
    ntt = NTTL(N, tuple(lvl), device=device)
    op = mv.submod_v if sub else mv.addmod_v

    def f(c0, pt_coeff):
        pt = ntt.forward(pt_coeff)
        return op(c0, _bc_key(pt, c0.ndim), lm)

    return f


@functools.lru_cache(maxsize=None)
def build_add_scalar(lvl: tuple, *, device: str):
    """c0 + per-limb scalar [L] (a constant polynomial is constant in the
    evaluation domain) — EvalAddConst; c1 unchanged by the caller."""
    lm = mv.LimbModuli(tuple(lvl), device=device)

    def f(c0, ks):
        return mv.addmod_v(c0, _bc_key(ks, c0.ndim), lm)

    return f


@functools.lru_cache(maxsize=None)
def build_add(lvl: tuple, sub: bool = False, *, device: str):
    op = mv.submod_v if sub else mv.addmod_v
    lm = mv.LimbModuli(tuple(lvl), device=device)

    def add(a0, a1, b0, b1):
        return op(a0, b0, lm), op(a1, b1, lm)

    return add


# -- context -----------------------------------------------------------------

@dataclass
class DeviceCKKSCiphertext:
    """Ciphertext resident on the device: two int64 eval-form towers
    [L, N] (or [L, B, N] for a batch)."""
    c0: torch.Tensor
    c1: torch.Tensor
    scale: float
    moduli: tuple
    noise_deg: int = 1          # NoiseScaleDeg for the auto-scaling layer

    @property
    def level_len(self) -> int:
        return len(self.moduli)


class _PackedKey:
    """Device form of an RnsHybridKey: [G, L_pq, N] int64 towers with
    per-limb Shoup companions. A FULL-chain key serves every level via
    `level_view` (row selection; the level-aware single-key scheme of
    rns_hybrid_key_switch)."""

    __slots__ = ("kb", "kb_sh", "ka", "ka_sh", "p_moduli", "groups", "q_len")

    def level_view(self, n_l: int):
        """(clipped groups, key row indices) for a length-n_l level chain."""
        if n_l == self.q_len:
            return self.groups, None
        assert n_l < self.q_len
        groups = tuple((g0, min(g1, n_l))
                       for (g0, g1) in self.groups if g0 < n_l)
        rows = tuple(range(n_l)) + tuple(
            range(self.q_len, self.q_len + len(self.p_moduli)))
        return groups, rows

    def __init__(self, key: RnsHybridKey, device: str):
        pq = key.pq_params.moduli
        if not all(m < (1 << 31) for m in pq):
            raise ValueError("device keyswitch needs all PQ limbs < 2^31 "
                             "(build the context with ks_limb_bits <= 30)")
        q = np.asarray(pq, dtype=np.int64)[None, :, None]

        def pack(polys):
            vals = np.stack([np.asarray(p.rns, dtype=np.uint64) for p in polys]
                            ).astype(np.int64)              # [G, L_pq, N]
            return (torch.as_tensor(vals, device=device),
                    torch.as_tensor((vals << 32) // q, device=device))

        self.kb, self.kb_sh = pack(key.bs)
        self.ka, self.ka_sh = pack(key.as_)
        self.p_moduli = tuple(key.p_moduli)
        self.groups = tuple(tuple(g) for g in key.groups)
        self.q_len = len(key.q_moduli)


class CKKSDeviceContext:
    """Front door for the device path: wraps a CKKSRnsContext (which must
    carry a sub-2^31-limb chain and ks_limb_bits <= 30), keeps relin/galois
    keys device-resident, and runs mult/rotate/add chains without the towers
    ever visiting the host. Runs on the card unless `device` names another
    torch device (the tests pass "cpu")."""

    def __init__(self, rns_ctx: CKKSRnsContext, device: str = "cuda"):
        if not all(m < (1 << 31) for m in rns_ctx.params.dcrt.moduli):
            raise ValueError("device chain needs limb moduli < 2^31 "
                             "(use limb_bits <= 30)")
        self.rns = rns_ctx
        self.params = rns_ctx.params
        self.device = str(torch.device(device))
        self._rlk: dict[int, _PackedKey] = {}
        self._gk: dict[tuple[int, int], _PackedKey] = {}

    # -- key management ----------------------------------------------------

    def _load(self, store: dict, keyfn, keys) -> None:
        if isinstance(keys, dict):
            for lvl_len, key in keys.items():
                store[keyfn(lvl_len)] = _PackedKey(key, self.device)
        else:
            pk = _PackedKey(keys, self.device)   # ONE full-chain key, every level
            for lvl_len in range(2, pk.q_len + 1):
                store[keyfn(lvl_len)] = pk

    def load_relin_keys(self, keys) -> None:
        """Accepts the per-level dict OR a single full-chain RnsHybridKey
        (served to every level by row selection — L x less key material and
        keygen)."""
        self._load(self._rlk, lambda lv: lv, keys)

    def load_galois_keys(self, steps: int, keys) -> None:
        self._load(self._gk, lambda lv: (steps, lv), keys)

    # -- transfers ----------------------------------------------------------

    def upload(self, ct) -> DeviceCKKSCiphertext:
        lp = ct.polys[0].params
        return DeviceCKKSCiphertext(
            to_device(ct.polys[0].to_eval().rns, self.device),
            to_device(ct.polys[1].to_eval().rns, self.device),
            ct.scale, lp.moduli)

    def download(self, dct: DeviceCKKSCiphertext):
        from .ckks import CKKSCiphertext
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        return CKKSCiphertext([DCRTPoly(lp, to_host(dct.c0), True),
                               DCRTPoly(lp, to_host(dct.c1), True)],
                              dct.scale, self.params)

    def upload_batch(self, cts) -> DeviceCKKSCiphertext:
        """Batch-first residency: towers stacked to [L, B, N]. Every op of
        this module works on the last axis with any leading batch shape, so
        one call serves the whole batch."""
        lp = cts[0].polys[0].params
        assert all(c.polys[0].params.moduli == lp.moduli for c in cts)
        assert all(abs(c.scale - cts[0].scale) < 1e-6 * cts[0].scale
                   for c in cts)

        def stack(k):
            return to_device(np.stack([c.polys[k].to_eval().rns for c in cts],
                                      axis=1), self.device)

        return DeviceCKKSCiphertext(stack(0), stack(1), cts[0].scale,
                                    lp.moduli)

    def download_batch(self, dct: DeviceCKKSCiphertext) -> list:
        from .ckks import CKKSCiphertext
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        c0, c1 = to_host(dct.c0), to_host(dct.c1)
        return [CKKSCiphertext([DCRTPoly(lp, c0[:, b], True),
                                DCRTPoly(lp, c1[:, b], True)],
                               dct.scale, self.params)
                for b in range(c0.shape[1])]

    # -- homomorphic ops ----------------------------------------------------

    def eval_mult(self, a: DeviceCKKSCiphertext,
                  b: DeviceCKKSCiphertext) -> DeviceCKKSCiphertext:
        assert a.moduli == b.moduli
        key = self._rlk[a.level_len]
        groups, rows = key.level_view(a.level_len)
        fn = build_mult_relin_rescale(self.params.N, a.moduli, key.p_moduli,
                                      groups, rows, device=self.device)
        c0, c1 = fn(a.c0, a.c1, b.c0, b.c1,
                    key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceCKKSCiphertext(c0, c1,
                                    a.scale * b.scale / a.moduli[-1],
                                    a.moduli[:-1])

    def eval_rotate(self, dct: DeviceCKKSCiphertext,
                    steps: int) -> DeviceCKKSCiphertext:
        key = self._gk[(steps, dct.level_len)]
        groups, rows = key.level_view(dct.level_len)
        k = rotation_automorphism_index(self.params.N, steps)
        fn = build_rotate(self.params.N, dct.moduli, key.p_moduli,
                          groups, k, rows, device=self.device)
        c0, c1 = fn(dct.c0, dct.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceCKKSCiphertext(c0, c1, dct.scale, dct.moduli)

    def rotation_precompute(self, dct: DeviceCKKSCiphertext):
        """EvalFastRotationPrecompute: hoisting digits of dct's c1, device-
        resident [G, L_pq, ..., N]; serves every eval_rotate_hoisted of this
        ciphertext (keys must share the context's group layout — they do)."""
        some_key = next(iter(self._gk.values())) if self._gk else \
            self._rlk[dct.level_len]
        groups, _ = some_key.level_view(dct.level_len)
        fn = build_ks_precompute(self.params.N, dct.moduli,
                                 some_key.p_moduli, groups, device=self.device)
        return fn(dct.c1)

    def eval_rotate_hoisted(self, dct: DeviceCKKSCiphertext, steps: int,
                            precomp) -> DeviceCKKSCiphertext:
        """EvalFastRotation: rotation from a rotation_precompute — gathers +
        key inner product + ModDown (bit-identical to eval_rotate)."""
        key = self._gk[(steps, dct.level_len)]
        groups, rows = key.level_view(dct.level_len)
        k = rotation_automorphism_index(self.params.N, steps)
        fn = build_rotate_hoisted(self.params.N, dct.moduli, key.p_moduli,
                                  groups, k, rows, device=self.device)
        c0, c1 = fn(dct.c0, precomp, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceCKKSCiphertext(c0, c1, dct.scale, dct.moduli)

    def eval_add(self, a: DeviceCKKSCiphertext,
                 b: DeviceCKKSCiphertext) -> DeviceCKKSCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, device=self.device)(a.c0, a.c1, b.c0, b.c1)
        return DeviceCKKSCiphertext(c0, c1, a.scale, a.moduli)

    def eval_sub(self, a: DeviceCKKSCiphertext,
                 b: DeviceCKKSCiphertext) -> DeviceCKKSCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, sub=True, device=self.device)(
            a.c0, a.c1, b.c0, b.c1)
        return DeviceCKKSCiphertext(c0, c1, a.scale, a.moduli)
