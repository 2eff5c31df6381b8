"""FFT-factored (levelBudget) CKKS bootstrapping on the device.

Port of `tfhe_tpu/pke/ckks_boot_fft_device.py`, the device run of
pke/ckks_boot_fft.py: the grouped radix-2 butterfly factors of
CoeffsToSlots/SlotsToCoeffs evaluated through the device tower functions
(torch ops on int64 towers [L, B, N]), with the baby rotations of each
factor hoisted (one digit decomposition per input, EvalFastRotation) and
each factor's giant rows double-hoisted into one call
(build_diag_factor_lazy; build_diag_inner on the eager path). Handles the
sparsely packed case (slots < N/2: PartialSum fold, size-s' factors with
tiled diagonals) exactly as the host path does. Towers are bit-identical
to the JAX package's on the same keys and inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ckks import encode
from .ckks_boot import galois_element
from .ckks_boot_device import CKKSDeviceEvaluator, residue_rows
from .ckks_boot_fft import BootstrapFFTPrecom, DiagMatrix, fft_key_indices
from .ckks_device import (DeviceCKKSCiphertext, build_diag_factor_lazy,
                          build_diag_inner)
from .ckks_rns import CKKSRnsContext


class CKKSBootstrapFFTDevice(CKKSDeviceEvaluator):
    """Device bootstrap driver over the FFT-factored transforms."""

    def __init__(self, rns_ctx: CKKSRnsContext, pre: BootstrapFFTPrecom,
                 device: str = "cuda"):
        super().__init__(rns_ctx, device=device)
        self.pre = pre

    def keygen(self, sk) -> None:
        """Relin + Galois keys for the factored rotation plan
        (FindBootstrapRotationIndices, conjugation and PartialSum)."""
        self.load_keys(self.rns.relin_key_gen_single(sk), {})
        self.load_galois_elements(sk, fft_key_indices(self.ctx, self.pre))

    # -- one grouped factor --------------------------------------------------

    def _diag_row_pt(self, tag, g: DiagMatrix, gg: int, n_l: int,
                     scale_mul: float, plain_scale: float | None = None):
        """Stacked coeff-form plaintexts [L, nb, N] for giant row gg:
        row k holds roll(tile(diag), gg) for the plan entries whose baby is
        g.babies[k]; zeros elsewhere. Cached per (tag, giant, level).
        `plain_scale` overrides the canonical sf encoding (the exact-scale
        landing lever, see diag_transform)."""
        ck = None if tag is None else (tag, gg, n_l)
        if ck is not None and ck in self._pt_cache:
            return self._pt_cache[ck]
        reps = self.params.slots // g.s
        bpos = {r: k for k, r in enumerate(g.babies)}
        s_c = self.sf[n_l] if plain_scale is None else plain_scale
        moduli = self.params.dcrt.moduli[:n_l]
        pt = np.zeros((n_l, len(g.babies), self.params.N), dtype=np.int64)
        for off, gi, r in g.plan:
            if gi != gg:
                continue
            d = np.roll(np.tile(g.diags[off], reps) * scale_mul, gg)
            pt[:, bpos[r]] = residue_rows(encode(self.params, d, s_c), moduli)
        pt = torch.as_tensor(pt, device=self.device)
        if ck is not None:
            self._pt_cache[ck] = pt
        return pt

    def diag_transform(self, ct, g: DiagMatrix, tag=None,
                       scale_mul: float = 1.0,
                       target_scale: float | None = None,
                       lazy: bool = True) -> DeviceCKKSCiphertext:
        """out = M ct for one grouped factor (one rescale level): hoisted
        baby rotations; the giant rows run DOUBLE-HOISTED by default, every
        row's keyed result accumulating in the extended PQ basis and one
        shared ModDown closing the factor (build_diag_factor_lazy;
        `lazy=False` keeps the eager one-ModDown-per-giant path). With
        `target_scale`, the plaintexts encode at q_last*target/ct.scale so
        the output lands on EXACTLY that scale (instead of the canonical
        sf), as the iterative bootstrap's residual subtraction needs."""
        N, slots = self.params.N, self.params.slots
        if any(r % slots for r in g.babies):
            pre_h = self._hoist_pre(ct)
        bab = {r: ct if r % slots == 0 else
               self.auto_hoisted(ct, galois_element(r, N), pre_h) for r in g.babies}
        p0 = torch.stack([bab[r].c0 for r in g.babies], dim=1)
        p1 = torch.stack([bab[r].c1 for r in g.babies], dim=1)
        n_l = len(ct.moduli)
        ps = None if target_scale is None else \
            float(ct.moduli[-1]) * target_scale / ct.scale
        s_c = self.sf[n_l] if ps is None else ps
        giants = sorted({p[1] for p in g.plan})

        if lazy:
            elements = tuple(galois_element(gg, N) if gg % slots else 1 for gg in giants)
            pt = torch.stack([self._diag_row_pt(tag, g, gg, n_l, scale_mul, plain_scale=ps)
                              for gg in giants])
            key0 = next(iter(self._gk.values()))
            groups, rows = key0.level_view(n_l - 1)
            keys = [key0 if k == 1 else self._gk[(k, n_l)] for k in elements]
            fn = build_diag_factor_lazy(N, ct.moduli, key0.p_moduli, groups,
                                        len(g.babies), elements, rows, device=self.device)
            c0, c1 = fn(p0, p1, pt, [k.kb for k in keys], [k.kb_sh for k in keys],
                        [k.ka for k in keys], [k.ka_sh for k in keys])
            return DeviceCKKSCiphertext(c0, c1, ct.scale * s_c / ct.moduli[-1],
                                        ct.moduli[:-1])

        fused = build_diag_inner(N, ct.moduli, len(g.babies), device=self.device)
        acc = None
        for gg in giants:
            pt = self._diag_row_pt(tag, g, gg, n_l, scale_mul, plain_scale=ps)
            r0, r1 = fused(p0, p1, pt)
            inner = self.rescale(DeviceCKKSCiphertext(r0, r1, ct.scale * s_c, ct.moduli))
            if gg % slots:
                inner = self.auto(inner, galois_element(gg, N))
            acc = inner if acc is None else self.add(acc, inner)
        return acc

    # -- EvalMod (same cosine/double-angle core as the BSGS driver) ----------

    def eval_mod(self, t) -> DeviceCKKSCiphertext:
        return self._eval_mod_with(t, self.pre.base)

    # -- the bootstrap --------------------------------------------------------

    def bootstrap(self, ct):
        return self.bootstrap_batch([ct])[0]

    def bootstrap_iterative_batch(self, cts, precision: int = 4) -> list:
        """Iterative (2-iteration) bootstrapping with both bootstraps on the
        device (EvalBootstrap(ct, numIterations=2, precision)). Both runs
        land on EXACTLY the input scale (target_scale), so the residual
        subtraction is drift-free."""
        from .ckks_boot import _drop_to, mult_const, scale_int, sub_ct
        if not 1 <= precision <= 8:
            raise ValueError(f"precision {precision} out of the supported "
                             "range [1, 8]")
        target = float(cts[0].scale)
        b1s = self.bootstrap_batch(cts, target_scale=target)
        P = 1 << precision
        errs = [sub_ct(_drop_to(scale_int(b1, P), ct.level_params), scale_int(ct, P))
                for b1, ct in zip(b1s, cts)]
        b2s = self.bootstrap_batch(errs, target_scale=target)
        out = []
        for b1, b2 in zip(b1s, b2s):
            q_last = b2.level_params.moduli[-1]
            ps = float(q_last) * b1.scale / b2.scale
            out.append(sub_ct(b1, mult_const(self.ctx, b2, 1.0 / P, plain_scale=ps)))
        return out

    def stages(self, cts, target_scale: float | None = None):
        """The bootstrap stage by stage: yields (name, device ciphertext)
        after ModRaise ("raise"), PartialSum ("partial_sum", sparse only),
        each CoeffsToSlots factor ("cts0", ...), EvalMod with the re/im
        recombination ("eval_mod") and each SlotsToCoeffs factor ("stc0",
        ...); the last one is the result."""
        p = self.params
        pre = self.pre
        dct, corr = self._raise_batch(cts)
        yield "raise", dct
        sp = pre.sparse_slots
        F = p.slots // sp
        if F > 1:
            j = 1
            while j < F:
                dct = self.add(dct, self.rotate(dct, j * sp))
                j <<= 1
            yield "partial_sum", dct
        ct_w = dct
        for i, g in enumerate(pre.cts_groups):
            ct_w = self.diag_transform(ct_w, g, tag=("cts", i))
            yield f"cts{i}", ct_w
        out = self._eval_mod_halves(ct_w, self.eval_mod)
        yield "eval_mod", out
        last = len(pre.stc_groups) - 1
        for i, g in enumerate(pre.stc_groups):
            sm = 1.0 / float(corr) if i == last else 1.0
            ts = target_scale if i == last else None
            tg = ("stc", i) if i != last else \
                ("stc", i, round(float(corr) * (1 << 48)), None if ts is None else round(ts))
            out = self.diag_transform(out, g, tag=tg, scale_mul=sm, target_scale=ts)
            yield f"stc{i}", out

    def bootstrap_batch(self, cts, target_scale: float | None = None) -> list:
        """Host ModRaise, then PartialSum (sparse) -> factored CoeffsToSlots
        -> EvalMod -> factored SlotsToCoeffs on the device, batched
        [L, B, N]."""
        for _, out in self.stages(cts, target_scale):
            pass
        return self.dctx.download_batch(out)
