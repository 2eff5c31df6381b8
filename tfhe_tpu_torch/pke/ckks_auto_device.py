"""Automatic CKKS scaling on the device: FIXEDAUTO / FLEXIBLEAUTO over
device-resident towers.

Port of `tfhe_tpu/pke/ckks_auto_device.py`. The host layer (`ckks_auto.py`) gives the reference's ScalingTechnique
semantics (ckksrns-leveledshe.cpp EvalMultAuto + AdjustLevelsAndDepthInPlace)
on the pure-RNS numpy evaluator. This module is the same state machine over
`CKKSDeviceContext`'s builders, so an auto-scaled program — multiplications with
lazy rescale, mixed-level adds, plaintext ops — runs with the towers never
leaving the device:

- lazy rescale  = `build_mult_relin_rescale(..., rescale=False)` keeps the
  product at noise degree 2; the division by q happens in whichever call
  consumes it next,
- level/depth alignment = ONE `build_mult_scalar(rescale=True)` call
  (constant multiply + rescale fused), plus row slicing for LevelReduce,
- plaintext ops encode on the host at the canonical level scale (cheap
  [L, N] residue rows) and NTT on the device (`build_mult_plain` /
  `build_add_plain`).

The adjustment constants are the same integers the host layer computes, so
device towers stay BIT-IDENTICAL to `CKKSAutoContext` on every input
(tests/test_torch_ckks_auto.py). Batched [L, B, N] towers ride the same
calls (the plaintext/scalar operands broadcast).
"""

from __future__ import annotations

import numpy as np
import torch

from .ckks import encode
from .ckks_auto import CKKSAutoContext
from .ckks_device import (CKKSDeviceContext, DeviceCKKSCiphertext,
                          build_add_plain, build_mult_plain,
                          build_mult_relin_rescale, build_mult_scalar,
                          build_rescale_only)

__all__ = ["CKKSAutoDeviceContext"]


class CKKSAutoDeviceContext:
    """Auto-scaling evaluator over device-resident CKKS towers."""

    def __init__(self, dctx: CKKSDeviceContext,
                 technique: str = "flexibleauto"):
        self.dev = dctx
        self.params = dctx.params
        # reuse the host layer's canonical grids + encode/encrypt plumbing
        self.host = CKKSAutoContext(dctx.rns, technique=technique)
        self.sf, self.sf2 = self.host.sf, self.host.sf2
        self.technique = technique
        self.device = dctx.device

    # -- plumbing -------------------------------------------------------------

    def upload(self, ct) -> DeviceCKKSCiphertext:
        d = self.dev.upload(ct)
        d.noise_deg = getattr(ct, "noise_deg", 1)
        return d

    def upload_batch(self, cts) -> DeviceCKKSCiphertext:
        d = self.dev.upload_batch(cts)
        d.noise_deg = getattr(cts[0], "noise_deg", 1)
        return d

    def download(self, d: DeviceCKKSCiphertext):
        ct = self.dev.download(d)
        ct.noise_deg = d.noise_deg
        return ct

    def download_batch(self, d: DeviceCKKSCiphertext) -> list:
        cts = self.dev.download_batch(d)
        for ct in cts:
            ct.noise_deg = d.noise_deg
        return cts

    # -- canonical-state primitives -------------------------------------------

    def _stamp(self, d: DeviceCKKSCiphertext, deg: int) -> DeviceCKKSCiphertext:
        l = d.level_len
        d.noise_deg = deg
        d.scale = self.sf[l] if deg == 1 else self.sf2[l]
        return d

    def _rescale(self, d: DeviceCKKSCiphertext) -> DeviceCKKSCiphertext:
        assert d.noise_deg == 2
        c0, c1 = build_rescale_only(self.params.N, d.moduli,
                                    device=self.device)(d.c0, d.c1)
        return self._stamp(
            DeviceCKKSCiphertext(c0, c1, d.scale, d.moduli[:-1]), 1)

    def _level_reduce(self, d: DeviceCKKSCiphertext,
                      k: int) -> DeviceCKKSCiphertext:
        n = d.level_len - k
        out = DeviceCKKSCiphertext(d.c0[:n], d.c1[:n], d.scale, d.moduli[:n])
        out.noise_deg = d.noise_deg
        return out

    def _const_residues(self, c: int, moduli: tuple) -> torch.Tensor:
        return torch.as_tensor(np.array([c % m for m in moduli], dtype=np.int64),
                               device=self.device)

    def _mult_const_core(self, d: DeviceCKKSCiphertext, dval: float,
                         rescale: bool = False) -> DeviceCKKSCiphertext:
        """EvalMultCore by round(dval * sf[l]); with `rescale` the constant
        multiply and the ModReduce fuse into one call (the adjustment step)."""
        l = d.level_len
        c = int(round(dval * self.sf[l]))
        ks = self._const_residues(c, d.moduli)
        fn = build_mult_scalar(self.params.N, d.moduli, rescale=rescale,
                               device=self.device)
        c0, c1 = fn(d.c0, d.c1, ks)
        moduli = d.moduli[:-1] if rescale else d.moduli
        out = DeviceCKKSCiphertext(c0, c1, d.scale, moduli)
        return self._stamp(out, d.noise_deg + (0 if rescale else 1))

    def _bring_to(self, d: DeviceCKKSCiphertext,
                  target_len: int) -> DeviceCKKSCiphertext:
        """AdjustLevelsAndDepth single-operand core (mirrors
        ckks_auto._bring_to, fused on device)."""
        l = d.level_len
        if l == target_len:
            return d
        assert l > target_len
        if d.noise_deg == 2:
            d = self._rescale(d)
            l -= 1
            if l == target_len:
                return d
        q_drop = d.moduli[l - 1]
        dval = self.sf[target_len] * q_drop / (self.sf[l] * self.sf[l])
        d = self._mult_const_core(d, dval, rescale=True)   # one fused call
        if d.level_len > target_len:
            d = self._level_reduce(d, d.level_len - target_len)
        return self._stamp(d, 1)

    def _adjust_for_add(self, a, b):
        target = min(a.level_len, b.level_len)
        a, b = self._bring_to(a, target), self._bring_to(b, target)
        if a.noise_deg < b.noise_deg:
            a = self._mult_const_core(a, 1.0)
        elif b.noise_deg < a.noise_deg:
            b = self._mult_const_core(b, 1.0)
        return a, b

    def _adjust_for_mult(self, a, b):
        if a.noise_deg == 2:
            a = self._rescale(a)
        if b.noise_deg == 2:
            b = self._rescale(b)
        target = min(a.level_len, b.level_len)
        return self._bring_to(a, target), self._bring_to(b, target)

    # -- public evaluator -------------------------------------------------------

    def eval_mult(self, a: DeviceCKKSCiphertext,
                  b: DeviceCKKSCiphertext) -> DeviceCKKSCiphertext:
        """EvalMultAuto: align operands, multiply + relinearize in one call,
        leave the product at noise degree 2 (lazy rescale)."""
        a, b = self._adjust_for_mult(a, b)
        key = self.dev._rlk[a.level_len]
        groups, rows = key.level_view(a.level_len)
        fn = build_mult_relin_rescale(self.params.N, a.moduli, key.p_moduli,
                                      groups, rows, rescale=False,
                                      device=self.device)
        c0, c1 = fn(a.c0, a.c1, b.c0, b.c1,
                    key.kb, key.kb_sh, key.ka, key.ka_sh)
        return self._stamp(
            DeviceCKKSCiphertext(c0, c1, a.scale, a.moduli), 2)

    def eval_add(self, a, b) -> DeviceCKKSCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = self.dev.eval_add(a, b)
        return self._stamp(out, a.noise_deg)

    def eval_sub(self, a, b) -> DeviceCKKSCiphertext:
        a, b = self._adjust_for_add(a, b)
        out = self.dev.eval_sub(a, b)
        return self._stamp(out, a.noise_deg)

    def eval_rotate(self, d: DeviceCKKSCiphertext,
                    steps: int) -> DeviceCKKSCiphertext:
        deg = d.noise_deg
        out = self.dev.eval_rotate(d, steps)
        return self._stamp(out, deg)

    def _encode_rows(self, z, l: int, moduli: tuple) -> torch.Tensor:
        m = encode(self.params, z, scale=self.sf[l])      # int64 coeffs [N]
        # numpy % of int64 by a positive int is already non-negative
        return torch.as_tensor(np.stack([m % np.int64(mod) for mod in moduli]),
                               device=self.device)

    def eval_mult_plain(self, d: DeviceCKKSCiphertext,
                        z) -> DeviceCKKSCiphertext:
        if d.noise_deg == 2:
            d = self._rescale(d)
        zarr = np.asarray(z)
        if zarr.ndim == 0 and np.isrealobj(zarr):
            return self._mult_const_core(d, float(zarr))
        z = self.host._as_slots(z)
        pt = self._encode_rows(z, d.level_len, d.moduli)
        fn = build_mult_plain(self.params.N, d.moduli, rescale=False,
                              device=self.device)
        c0, c1 = fn(d.c0, d.c1, pt)
        return self._stamp(
            DeviceCKKSCiphertext(c0, c1, d.scale, d.moduli), 2)

    def eval_add_plain(self, d: DeviceCKKSCiphertext, z,
                       sub: bool = False) -> DeviceCKKSCiphertext:
        if d.noise_deg == 2:
            d = self._rescale(d)
        z = self.host._as_slots(z)
        pt = self._encode_rows(z, d.level_len, d.moduli)
        c0 = build_add_plain(self.params.N, d.moduli, sub=sub,
                             device=self.device)(d.c0, pt)
        out = DeviceCKKSCiphertext(c0, d.c1, d.scale, d.moduli)
        return self._stamp(out, 1)

    def eval_sub_plain(self, d: DeviceCKKSCiphertext,
                       z) -> DeviceCKKSCiphertext:
        return self.eval_add_plain(d, z, sub=True)
