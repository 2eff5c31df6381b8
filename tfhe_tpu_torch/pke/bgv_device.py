"""Device-resident RNS-BGV: the leveled homomorphic hot loop on torch tensors.

Port of `tfhe_tpu/pke/bgv_device.py`, the BGV counterpart of
pke/ckks_device.py: the same tower builders (tensor product, hybrid key
switch, ModReduce, automorphisms) with the BGV t-corrections threaded
through their `t` argument: the t-exact ModDown inside the key switch and
the t-preserving ModReduce after each mult. Bit-identical to the host
BGVRnsContext and to the JAX package's device towers on every input
(tests/test_torch_bgv.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .bfv import BFVCiphertext
from .bgv_rns import BGVRnsContext
from .ckks_device import (_PackedKey, build_add, build_mult_relin_rescale,
                          build_rotate)
from .dcrt import DCRTParams, DCRTPoly
from .dcrt_device import to_device, to_host
from .encoding import rotation_automorphism_index


@dataclass
class DeviceBGVCiphertext:
    """Ciphertext resident on the device: two int64 eval-form towers [L, N]
    (or [L, B, N] for a batch)."""
    c0: torch.Tensor
    c1: torch.Tensor
    moduli: tuple

    @property
    def level_len(self) -> int:
        return len(self.moduli)


class BGVDeviceContext:
    """Front door for the BGV device path: wraps a BGVRnsContext (which must
    carry a sub-2^31-limb chain and ks_limb_bits <= 30), keeps relin/galois
    keys device-resident, and runs mult/rotate/add chains without the towers
    ever visiting the host. Runs on the card unless `device` names another
    torch device (the tests pass "cpu")."""

    def __init__(self, rns_ctx: BGVRnsContext, device: str = "cuda"):
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
        """Per-level dict OR a single full-chain key (level-aware)."""
        self._load(self._rlk, lambda lv: lv, keys)

    def load_galois_keys(self, steps: int, keys) -> None:
        self._load(self._gk, lambda lv: (steps, lv), keys)

    # -- transfers ----------------------------------------------------------

    def upload(self, ct: BFVCiphertext) -> DeviceBGVCiphertext:
        lp = ct.polys[0].params
        return DeviceBGVCiphertext(
            to_device(ct.polys[0].to_eval().rns, self.device),
            to_device(ct.polys[1].to_eval().rns, self.device),
            lp.moduli)

    def download(self, dct: DeviceBGVCiphertext) -> BFVCiphertext:
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        return BFVCiphertext([DCRTPoly(lp, to_host(dct.c0), True),
                              DCRTPoly(lp, to_host(dct.c1), True)],
                             self.params)

    def upload_batch(self, cts) -> DeviceBGVCiphertext:
        """Batch-first residency: towers stacked to [L, B, N]; every builder
        works on the last axis with any leading batch shape."""
        lp = cts[0].polys[0].params
        assert all(c.polys[0].params.moduli == lp.moduli for c in cts)

        def stack(k):
            return to_device(np.stack([c.polys[k].to_eval().rns for c in cts],
                                      axis=1), self.device)

        return DeviceBGVCiphertext(stack(0), stack(1), lp.moduli)

    def download_batch(self, dct: DeviceBGVCiphertext) -> list:
        lp = DCRTParams(N=self.params.N, moduli=dct.moduli)
        c0, c1 = to_host(dct.c0), to_host(dct.c1)
        return [BFVCiphertext([DCRTPoly(lp, c0[:, b], True),
                               DCRTPoly(lp, c1[:, b], True)], self.params)
                for b in range(c0.shape[1])]

    # -- homomorphic ops ----------------------------------------------------

    def eval_mult(self, a: DeviceBGVCiphertext,
                  b: DeviceBGVCiphertext) -> DeviceBGVCiphertext:
        """Tensor product -> t-noise hybrid relinearization -> BGV ModReduce,
        one call per level chain (level consumed, like BGVRnsContext)."""
        assert a.moduli == b.moduli
        key = self._rlk[a.level_len]
        groups, rows = key.level_view(a.level_len)
        fn = build_mult_relin_rescale(self.params.N, a.moduli, key.p_moduli,
                                      groups, rows, t=self.params.t,
                                      device=self.device)
        c0, c1 = fn(a.c0, a.c1, b.c0, b.c1,
                    key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceBGVCiphertext(c0, c1, a.moduli[:-1])

    def eval_rotate(self, dct: DeviceBGVCiphertext,
                    steps: int) -> DeviceBGVCiphertext:
        key = self._gk[(steps, dct.level_len)]
        groups, rows = key.level_view(dct.level_len)
        k = rotation_automorphism_index(self.params.N, steps)
        fn = build_rotate(self.params.N, dct.moduli, key.p_moduli, groups, k,
                          rows, t=self.params.t, device=self.device)
        c0, c1 = fn(dct.c0, dct.c1, key.kb, key.kb_sh, key.ka, key.ka_sh)
        return DeviceBGVCiphertext(c0, c1, dct.moduli)

    def eval_add(self, a: DeviceBGVCiphertext,
                 b: DeviceBGVCiphertext) -> DeviceBGVCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, device=self.device)(a.c0, a.c1, b.c0, b.c1)
        return DeviceBGVCiphertext(c0, c1, a.moduli)

    def eval_sub(self, a: DeviceBGVCiphertext,
                 b: DeviceBGVCiphertext) -> DeviceBGVCiphertext:
        assert a.moduli == b.moduli
        c0, c1 = build_add(a.moduli, sub=True, device=self.device)(
            a.c0, a.c1, b.c0, b.c1)
        return DeviceBGVCiphertext(c0, c1, a.moduli)
