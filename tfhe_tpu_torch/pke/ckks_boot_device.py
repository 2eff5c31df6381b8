"""CKKS bootstrapping on the device.

Port of `tfhe_tpu/pke/ckks_boot_device.py`: the device counterpart of
pke/ckks_boot.py's production-scale path. BSGS CoeffsToSlots /
SlotsToCoeffs (O(sqrt(slots)) Galois keys and rotations) and
Paterson-Stockmeyer EvalMod, with every homomorphic operation running
through the device tower functions (pke/ckks_device.py, torch ops on int64
towers [L, B, N]): the ciphertext never visits the host between ModRaise
and the final SlotsToCoeffs. The reference's CKKS bootstrapping
(ckksrns-fhe.cpp) is CPU-only.

Key material is the pure-RNS hybrid family (ckks_rns.RnsHybridKey): one
relin key and one Galois key per element, full-chain, kept on the device in
packed [G, L_pq, N] Shoup form and served to every level by row selection.
Host work per op is limited to plaintext encoding (the diagonal vectors of
the BSGS transform and scalar constants); ModRaise, a per-bootstrap
re-embedding of the exhausted ciphertext into the full chain, stays on the
host as in the JAX package and the reference.

Every float scale is computed in the JAX package's order and every
plaintext residue is the same integer, so device towers are bit-identical
to the JAX package's on the same keys and inputs. Runs on the card unless
`device` names another torch device (the tests pass "cpu").

Precision: same construction as the host path (cosine Chebyshev +
double-angle EvalMod), with the chain limited to sub-2^31 limbs, i.e.
scale ~2^28-2^30 per level.
"""

from __future__ import annotations

import numpy as np
import torch

from .ckks import encode
from .ckks_boot import (BootstrapPrecom, _bsgs_split, _cheb_divmod_T,
                        bsgs_key_indices, conj_element, galois_element,
                        mod_raise)
from .ckks_device import (CKKSDeviceContext, DeviceCKKSCiphertext,
                          _PackedKey, build_add, build_add_scalar,
                          build_bsgs_inner, build_ks_precompute,
                          build_mult_plain, build_mult_scalar,
                          build_rescale_only, build_rotate,
                          build_rotate_hoisted)
from .ckks_rns import CKKSRnsContext, RnsHybridKey


def residue_rows(m: np.ndarray, moduli) -> np.ndarray:
    """A signed int64 plaintext -> its residues [L, N] (the JAX package's
    u32 `(m % mod)` rows, as int64)."""
    return np.stack([m % np.int64(mod) for mod in moduli])


class CKKSDeviceEvaluator:
    """Generic device CKKS evaluator: FLEXIBLEAUTO-style canonical-scale
    leveled arithmetic (add/sub/mult/mult_plain/mult_const), automorphisms
    and slot rotations through level-aware packed hybrid keys, BSGS linear
    transforms, and Paterson-Stockmeyer Chebyshev evaluation, every op
    through the device tower functions. `CKKSBootstrapDevice`,
    `CKKSBootstrapFFTDevice` and the device advanced-SHE layer
    (`advancedshe_device.py`) all build on this."""

    def __init__(self, rns_ctx: CKKSRnsContext, device: str = "cuda"):
        self.rns = rns_ctx
        self.ctx = rns_ctx.ctx
        self.params = rns_ctx.params
        self.dctx = CKKSDeviceContext(rns_ctx, device=device)
        self.device = self.dctx.device
        self._gk: dict[tuple[int, int], _PackedKey] = {}
        self._pt_cache: dict = {}     # encoded transform diagonals
        # the host keys loaded, for `load_keys` of another evaluator
        self.relin_key: RnsHybridKey | None = None
        self.galois_keys: dict[int, RnsHybridKey] = {}
        # FLEXIBLEAUTO-style canonical scale per level (chain length):
        # sf[L] = Delta, sf[l-1] = sf[l]^2 / q_l. Every op below lands
        # ciphertexts exactly on sf[level] (plaintext constants are encoded
        # at the level's sf), so adds across differently-shaped paths see
        # BIT-EQUAL float scales, with no drift (the reference's
        # FLEXIBLEAUTO rescaling technique, ckksrns-leveledshe.cpp
        # AdjustScale).
        mods = self.params.dcrt.moduli
        L = len(mods)
        sf = {L: float(self.params.scale)}
        for lv in range(L, 1, -1):
            sf[lv - 1] = sf[lv] * sf[lv] / mods[lv - 1]
        self.sf = sf

    # -- keys ----------------------------------------------------------------

    def load_keys(self, rlk: RnsHybridKey | None, galois: dict) -> None:
        """Pack full-chain host keys onto this evaluator's device: a relin
        key and {Galois element: key}, each served to every level by row
        selection. Another evaluator's `relin_key`/`galois_keys` give the
        same keys on another device."""
        if rlk is not None:
            self.dctx.load_relin_keys(rlk)
            self.relin_key = rlk
        L = self.params.dcrt.L
        for k, key in galois.items():
            pk = _PackedKey(key, self.device)
            for lvl_len in range(2, L + 1):
                self._gk[(k, lvl_len)] = pk
            self.galois_keys[k] = key

    def load_galois_elements(self, sk, elements) -> None:
        """ONE full-chain hybrid key per Galois element, served to every
        level by the level-aware restriction (the PartQlHat row-selection
        design)."""
        for k in elements:
            if k not in self.galois_keys:
                self.load_keys(None, {k: self.rns.galois_key_gen_single(sk, k=k)})

    def keygen_rotations(self, sk, rots, conj: bool = True) -> None:
        """Relin key + Galois keys for the given slot rotations (and the
        conjugation element), the EvalAtIndexKeyGen analogue for the
        device tier."""
        self.load_keys(self.rns.relin_key_gen_single(sk), {})
        els = [galois_element(r, self.params.N) for r in rots]
        if conj:
            els.append(conj_element(self.params.N))
        self.load_galois_elements(sk, els)

    def rotate(self, ct, rot: int) -> DeviceCKKSCiphertext:
        """Slot rotation: out[j] = in[j + rot] (EvalRotate)."""
        if rot % self.params.slots == 0:
            return ct
        return self.auto(ct, galois_element(rot, self.params.N))

    # -- device op helpers -------------------------------------------------

    def _reduce_to(self, ct: DeviceCKKSCiphertext,
                   n: int) -> DeviceCKKSCiphertext:
        """Canonical level reduction: multiply by 1.0 encoded at the level's
        sf and rescale, once per dropped limb, landing exactly on sf[n]
        (LevelReduce with scale adjustment; a plain row slice would carry
        the old sf down and reintroduce drift)."""
        while len(ct.moduli) > n:
            ct = self.mult_const(ct, 1.0, rescale=True)
        return ct

    def _align(self, a, b):
        n = min(len(a.moduli), len(b.moduli))
        a2, b2 = self._reduce_to(a, n), self._reduce_to(b, n)
        rel = abs(a2.scale - b2.scale) / max(a2.scale, b2.scale)
        # canonical sf tracking makes scales bit-equal floats on every path
        assert rel < 1e-9, f"scale drift too large to add: {rel}"
        return a2, b2

    def add(self, a, b) -> DeviceCKKSCiphertext:
        a2, b2 = self._align(a, b)
        c0, c1 = build_add(a2.moduli, device=self.device)(a2.c0, a2.c1, b2.c0, b2.c1)
        return DeviceCKKSCiphertext(c0, c1, max(a2.scale, b2.scale), a2.moduli)

    def sub(self, a, b) -> DeviceCKKSCiphertext:
        a2, b2 = self._align(a, b)
        c0, c1 = build_add(a2.moduli, sub=True, device=self.device)(
            a2.c0, a2.c1, b2.c0, b2.c1)
        return DeviceCKKSCiphertext(c0, c1, max(a2.scale, b2.scale), a2.moduli)

    def mult(self, a, b) -> DeviceCKKSCiphertext:
        a2, b2 = self._align(a, b)
        return self.dctx.eval_mult(a2, b2)

    def _const_rows(self, k: int, moduli: tuple) -> torch.Tensor:
        """A (possibly negative) integer constant's residues [L]."""
        return torch.as_tensor(np.array([k % m for m in moduli], dtype=np.int64),
                               device=self.device)

    def _scaled(self, c0, c1, ct, s_c: float, rescale: bool):
        if rescale:
            return DeviceCKKSCiphertext(c0, c1, ct.scale * s_c / ct.moduli[-1],
                                        ct.moduli[:-1])
        return DeviceCKKSCiphertext(c0, c1, ct.scale * s_c, ct.moduli)

    def mult_plain(self, ct, vec, rescale: bool = True, pt_key=None):
        """Slotwise multiply by a complex vector, host-encoded at the
        LEVEL'S canonical scale sf[l] (so a subsequent rescale lands
        exactly on sf[l-1]); only the per-limb residues are built on the
        host, the plaintext NTT runs on the device. `pt_key` caches the
        encoded residues (the transforms re-use fixed diagonals every
        bootstrap)."""
        n_l = len(ct.moduli)
        ck = None if pt_key is None else (pt_key, n_l, bool(rescale))
        pt = None if ck is None else self._pt_cache.get(ck)
        s_c = self.sf[n_l]
        if pt is None:
            pt = torch.as_tensor(residue_rows(encode(self.params, vec, s_c), ct.moduli),
                                 device=self.device)
            if ck is not None:
                self._pt_cache[ck] = pt
        fn = build_mult_plain(self.params.N, ct.moduli, rescale, device=self.device)
        return self._scaled(*fn(ct.c0, ct.c1, pt), ct, s_c, rescale)

    def mult_const(self, ct, c: float, rescale: bool = True):
        s_c = self.sf[len(ct.moduli)]
        k = int(round(c * s_c))
        fn = build_mult_scalar(self.params.N, ct.moduli, rescale, device=self.device)
        return self._scaled(*fn(ct.c0, ct.c1, self._const_rows(k, ct.moduli)),
                            ct, s_c, rescale)

    def scale_int(self, ct, k: int) -> DeviceCKKSCiphertext:
        fn = build_mult_scalar(self.params.N, ct.moduli, rescale=False, device=self.device)
        c0, c1 = fn(ct.c0, ct.c1, self._const_rows(k, ct.moduli))
        return DeviceCKKSCiphertext(c0, c1, ct.scale, ct.moduli)

    def add_const(self, ct, c: float) -> DeviceCKKSCiphertext:
        k = int(round(c * ct.scale))
        c0 = build_add_scalar(ct.moduli, device=self.device)(
            ct.c0, self._const_rows(k, ct.moduli))
        return DeviceCKKSCiphertext(c0, ct.c1, ct.scale, ct.moduli)

    def rescale(self, ct) -> DeviceCKKSCiphertext:
        fn = build_rescale_only(self.params.N, ct.moduli, device=self.device)
        c0, c1 = fn(ct.c0, ct.c1)
        return DeviceCKKSCiphertext(c0, c1, ct.scale / ct.moduli[-1], ct.moduli[:-1])

    def auto(self, ct, k: int) -> DeviceCKKSCiphertext:
        """X -> X^k + key switch back to s, via the full-chain Galois key
        restricted to the ciphertext's level."""
        key = self._gk[(k, len(ct.moduli))]
        groups, rows = key.level_view(len(ct.moduli))
        fn = build_rotate(self.params.N, ct.moduli, key.p_moduli, groups, k, rows,
                          device=self.device)
        c0, c1 = fn(ct.c0, ct.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceCKKSCiphertext(c0, c1, ct.scale, ct.moduli)

    def _hoist_pre(self, ct):
        """Hoisting digits of ct's c1 (EvalFastRotationPrecompute)."""
        key = next(iter(self._gk.values()))
        groups, _ = key.level_view(len(ct.moduli))
        return build_ks_precompute(self.params.N, ct.moduli, key.p_moduli, groups,
                                   device=self.device)(ct.c1)

    def auto_hoisted(self, ct, k: int, pre) -> DeviceCKKSCiphertext:
        """X -> X^k from a _hoist_pre: gathers + key inner product +
        ModDown only, no per-rotation decompose/FBC/digit NTTs."""
        key = self._gk[(k, len(ct.moduli))]
        groups, rows = key.level_view(len(ct.moduli))
        fn = build_rotate_hoisted(self.params.N, ct.moduli, key.p_moduli, groups, k,
                                  rows, device=self.device)
        c0, c1 = fn(ct.c0, pre, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceCKKSCiphertext(c0, c1, ct.scale, ct.moduli)

    def conjugate(self, ct) -> DeviceCKKSCiphertext:
        return self.auto(ct, conj_element(self.params.N))

    # -- BSGS linear transform --------------------------------------------

    def _bsgs_row_pts(self, tag, A: np.ndarray, B: np.ndarray, i: int,
                      b: int, n_l: int):
        """Stacked coeff-form diagonal plaintexts for giant row i:
        ([L, b, N] for the plain babies, [L, b, N] for the conjugated ones),
        encoded at the level's canonical scale; cached per (tag, i, level),
        since the matrices are fixed per bootstrap configuration."""
        ck = None if tag is None else (tag, i, n_l)
        if ck is not None and ck in self._pt_cache:
            return self._pt_cache[ck]
        s = self.params.slots
        j = np.arange(s)
        s_c = self.sf[n_l]
        moduli = self.params.dcrt.moduli[:n_l]
        out = []
        for M in (A, B):
            pt = np.zeros((n_l, b, self.params.N), dtype=np.int64)
            for k in range(b):
                r = i * b + k
                if r >= s:
                    break
                d = np.roll(M[j, (j + r) % s], i * b)
                if not np.any(np.abs(d) > 1e-14):
                    continue
                pt[:, k] = residue_rows(encode(self.params, d, s_c), moduli)
            out.append(torch.as_tensor(pt, device=self.device))
        out = tuple(out)
        if ck is not None:
            self._pt_cache[ck] = out
        return out

    def linear_transform_bsgs(self, ct, A: np.ndarray, B: np.ndarray,
                              tag=None) -> DeviceCKKSCiphertext:
        """w = A z + B conj(z) by baby-step/giant-step diagonals, the
        device run of ckks_boot.eval_linear_transform_bsgs, with each
        giant row's b-term baby sum fused into one call (build_bsgs_inner).
        `tag` enables the stacked-plaintext cache."""
        N, s = self.params.N, self.params.slots
        b, g = _bsgs_split(s)
        ct_c = self.conjugate(ct)
        bab, bab_c = [ct], [ct_c]
        if b > 1:
            # baby rotations are b-1 rotations of the SAME two ciphertexts:
            # hoist the digit decomposition once each (EvalFastRotation)
            pre, pre_c = self._hoist_pre(ct), self._hoist_pre(ct_c)
        for k in range(1, b):
            a = galois_element(k, N)
            bab.append(self.auto_hoisted(ct, a, pre))
            bab_c.append(self.auto_hoisted(ct_c, a, pre_c))
        p0 = torch.stack([x.c0 for x in bab], dim=1)     # [L, b, (B,) N]
        p1 = torch.stack([x.c1 for x in bab], dim=1)
        c0s = torch.stack([x.c0 for x in bab_c], dim=1)
        c1s = torch.stack([x.c1 for x in bab_c], dim=1)
        n_l = len(ct.moduli)
        fused = build_bsgs_inner(N, ct.moduli, b, device=self.device)
        s_c = self.sf[n_l]
        acc = None
        for i in range(g):
            ptP, ptC = self._bsgs_row_pts(tag, A, B, i, b, n_l)
            r0, r1 = fused(p0, p1, c0s, c1s, ptP, ptC)
            inner = self.rescale(DeviceCKKSCiphertext(r0, r1, ct.scale * s_c, ct.moduli))
            if i > 0:
                inner = self.auto(inner, galois_element(i * b, N))
            acc = inner if acc is None else self.add(acc, inner)
        return acc

    # -- Paterson-Stockmeyer Chebyshev -------------------------------------

    def chebyshev_ps(self, t, coeffs: np.ndarray,
                     k: int | None = None) -> DeviceCKKSCiphertext:
        """sum_j c_j T_j(t) by Paterson-Stockmeyer (EvalChebyshevSeriesPS):
        baby T_1..T_k, giant T_{k 2^i} by double angle, then the recursive
        split f = q T_e + r of ckks_boot._PSEvaluator."""
        deg = len(coeffs) - 1
        if k is None:
            k = max(2, 1 << int(np.ceil(np.log2(max(2.0, np.sqrt(deg / 2))))))
        T: dict[int, DeviceCKKSCiphertext] = {1: t}

        def baby(jj):
            if jj not in T:
                hi, lo = (jj + 1) // 2, jj // 2
                prod2 = self.scale_int(self.mult(baby(hi), baby(lo)), 2)
                T[jj] = (self.add_const(prod2, -1.0) if jj % 2 == 0
                         else self.sub(prod2, baby(1)))
            return T[jj]

        def giant(e):
            if e not in T:
                if e <= k:
                    return baby(e)
                half = giant(e // 2)
                T[e] = self.add_const(self.scale_int(self.mult(half, half), 2), -1.0)
            return T[e]

        def ev(c):
            n = len(c) - 1
            while n > 0 and abs(c[n]) < 1e-14:
                n -= 1
            c = c[:n + 1]
            if n < k:
                acc = None
                for jj in range(1, n + 1):
                    if abs(c[jj]) < 1e-14:
                        continue
                    term = self.mult_const(baby(jj), float(c[jj]))
                    acc = term if acc is None else self.add(acc, term)
                return acc, float(c[0])
            e = k
            while 2 * e <= n:
                e *= 2
            q, r = _cheb_divmod_T(c, e)
            q_ct, q_const = ev(q)
            r_ct, r_const = ev(r)
            Te = giant(e)
            parts = []
            if q_ct is not None:
                parts.append(self.mult(q_ct, Te))
            if abs(q_const) > 1e-14:
                parts.append(self.mult_const(Te, q_const))
            if r_ct is not None:
                parts.append(r_ct)
            acc = parts[0]
            for pt in parts[1:]:
                acc = self.add(acc, pt)
            return acc, r_const

        ct_out, const = ev(np.asarray(coeffs, dtype=np.float64))
        return self.add_const(ct_out, const) if abs(const) > 1e-14 else ct_out

    # -- shared bootstrap steps ----------------------------------------------

    def _raise_batch(self, cts) -> tuple[DeviceCKKSCiphertext, float]:
        """Host ModRaise of a batch of depth-exhausted ciphertexts, uploaded
        as [L, B, N] towers claiming the canonical top scale; returns them
        and corr = the inputs' true scale / sf[L], which the caller folds
        into its final transform (mixing s*-typed and sf-typed paths would
        desync the canonical tracking)."""
        from .ckks import CKKSCiphertext
        L = self.params.dcrt.L
        assert all(c.polys[0].params.L == 1 and len(c.polys) == 2 for c in cts)
        assert all(abs(c.scale - cts[0].scale) < 1e-6 * cts[0].scale for c in cts)
        raised = [CKKSCiphertext(mod_raise(self.ctx, ct).polys, self.sf[L], self.params)
                  for ct in cts]
        return self.dctx.upload_batch(raised), cts[0].scale / self.sf[L]

    def _eval_mod_halves(self, ct_w, eval_mod) -> DeviceCKKSCiphertext:
        """Split slots w into re = (w + conj w)/2 and im = (w - conj w)/2i,
        run ONE EvalMod over both (re/im ride the batch axis, [L, 2B, N]),
        and recombine re + i im."""
        w_c = self.conjugate(ct_w)
        ct_re = self.mult_const(self.add(ct_w, w_c), 0.5)
        ct_im = self.mult_plain(self.sub(ct_w, w_c), np.full(self.params.slots, -0.5j),
                                pt_key="im_half")
        assert ct_re.scale == ct_im.scale and ct_re.moduli == ct_im.moduli
        B = ct_re.c0.shape[1]
        m2 = eval_mod(DeviceCKKSCiphertext(torch.cat([ct_re.c0, ct_im.c0], dim=1),
                                           torch.cat([ct_re.c1, ct_im.c1], dim=1),
                                           ct_re.scale, ct_re.moduli))
        m_re = DeviceCKKSCiphertext(m2.c0[:, :B], m2.c1[:, :B], m2.scale, m2.moduli)
        m_im = DeviceCKKSCiphertext(m2.c0[:, B:], m2.c1[:, B:], m2.scale, m2.moduli)
        return self.add(m_re, self.mult_plain(m_im, np.full(self.params.slots, 1j),
                                              pt_key="im_one"))

    def _eval_mod_with(self, t, pre: BootstrapPrecom) -> DeviceCKKSCiphertext:
        """x mod r on slots given t = x/(K r): the Chebyshev base cosine,
        `double_angles` squarings, then the r/(2 pi) scaling."""
        w = self.chebyshev_ps(t, pre.cheb_coeffs)
        for _ in range(pre.double_angles):
            w = self.add_const(self.scale_int(self.mult(w, w), 2), -1.0)
        return self.mult_const(w, pre.r / (2 * np.pi))


class CKKSBootstrapDevice(CKKSDeviceEvaluator):
    """Device bootstrap driver: the generic evaluator plus the bootstrap
    precomputation (transform matrices, EvalMod Chebyshev series) and the
    BSGS rotation-plan keygen."""

    def __init__(self, rns_ctx: CKKSRnsContext, pre: BootstrapPrecom,
                 device: str = "cuda"):
        super().__init__(rns_ctx, device=device)
        self.pre = pre

    def keygen(self, sk) -> None:
        """Relin + Galois keys for the BSGS index set (EvalBootstrapKeyGen
        with the rotation plan; 2*sqrt(slots)+2 keys in all)."""
        self.load_keys(self.rns.relin_key_gen_single(sk), {})
        self.load_galois_elements(sk, bsgs_key_indices(self.params.N, self.params.slots))

    def eval_mod(self, t) -> DeviceCKKSCiphertext:
        return self._eval_mod_with(t, self.pre)

    # -- the bootstrap ------------------------------------------------------

    def bootstrap(self, ct):
        """Refresh a depth-exhausted host ciphertext: host ModRaise, then
        CoeffsToSlots -> EvalMod -> SlotsToCoeffs on the device
        (EvalBootstrap, ckksrns-fhe.cpp)."""
        return self.bootstrap_batch([ct])[0]

    def bootstrap_batch(self, cts) -> list:
        """Refresh a BATCH of depth-exhausted ciphertexts in one device
        pipeline: towers ride as [L, B, N], so every op serves the whole
        batch."""
        pre = self.pre
        dct, corr = self._raise_batch(cts)
        norm = 1.0 / (pre.K * pre.r)
        ct_slots = self.linear_transform_bsgs(dct, pre.cts_A * norm, pre.cts_B * norm,
                                              tag="cts")
        recomb = self._eval_mod_halves(ct_slots, self.eval_mod)
        out = self.linear_transform_bsgs(recomb, pre.stc_A / corr, pre.stc_B / corr,
                                         tag=("stc", round(float(corr) * (1 << 48))))
        return self.dctx.download_batch(out)
