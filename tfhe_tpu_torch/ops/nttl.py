"""Limb-stacked exact negacyclic NTT: every RNS limb in one torch op a step.

Port of `tfhe_tpu/ops/nttl.py`. The per-limb twiddle tables of
`ref/ntt.py:_tables` are stacked to [L, ...] and the identical radix-2 DIT
schedule (bit reversal, then stages of half-length 1 .. N/2) runs on an
int64 [L, ..., N] tower with vector-modulus arithmetic (`ops/modmathv.py`),
so a transform is O(log N) ops whatever the chain length.

The evaluation order is `ref/ntt.py`'s (index k holds the value at
psi^(2k+1) in the twisted cyclic order), not the bit-reversed order of
`ops/ntt.py`: towers stay bit-identical to the host `DCRTPoly` and to the
JAX package's towers, key towers included.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ref import ntt as ref_ntt
from . import modmathv as mv


@functools.lru_cache(maxsize=None)
class NTTL:
    """Stacked tables for (N, moduli tuple) on one device."""

    def __init__(self, N: int, moduli: tuple, *, device: str):
        self.N = N
        self.moduli = tuple(int(m) for m in moduli)
        self.lm = lm = mv.LimbModuli(self.moduli, device=device)
        tabs = [ref_ntt._tables(N, m) for m in self.moduli]

        def stacked(rows):
            host = np.stack([np.asarray(r, dtype=np.int64) for r in rows])
            return lm.tensor(host), lm.tensor(lm.shoup(host))

        self.bitrev = torch.as_tensor(tabs[0]["bitrev"], device=lm.device)
        self.twist, self.twist_sh = stacked(t["twist"] for t in tabs)
        self.untwist, self.untwist_sh = stacked(t["untwist"] for t in tabs)
        n_stages = len(tabs[0]["fwd_stages"])
        self.fwd_stages = [stacked(t["fwd_stages"][si] for t in tabs)
                           for si in range(n_stages)]
        self.inv_stages = [stacked(t["inv_stages"][si] for t in tabs)
                           for si in range(n_stages)]

    @staticmethod
    def _bc(tab: torch.Tensor, ndim: int) -> torch.Tensor:
        # a per-limb row [L, n] against an operand [L, ..., n]
        return tab.reshape((tab.shape[0],) + (1,) * (ndim - 2) + (tab.shape[1],))

    def _cyclic(self, x, stages):
        N = self.N
        x = x.index_select(-1, self.bitrev)
        length = 2
        for tw, tw_sh in stages:
            half = length // 2
            x = x.reshape(x.shape[:-1] + (N // length, length))
            even = x[..., :half]
            odd = mv.mulmod_shoup_v(x[..., half:], self._bc(tw, x.ndim),
                                    self._bc(tw_sh, x.ndim), self.lm)
            x = torch.cat([mv.addmod_v(even, odd, self.lm),
                           mv.submod_v(even, odd, self.lm)], dim=-1)
            x = x.reshape(x.shape[:-2] + (N,))
            length *= 2
        return x

    def forward(self, x):
        """Coefficient -> evaluation (negacyclic), int64 [L, ..., N]."""
        tx = mv.mulmod_shoup_v(x, self._bc(self.twist, x.ndim),
                               self._bc(self.twist_sh, x.ndim), self.lm)
        return self._cyclic(tx, self.fwd_stages)

    def inverse(self, x):
        """Evaluation -> coefficient (negacyclic), int64 [L, ..., N]."""
        y = self._cyclic(x, self.inv_stages)
        return mv.mulmod_shoup_v(y, self._bc(self.untwist, x.ndim),
                                 self._bc(self.untwist_sh, x.ndim), self.lm)
