"""Vector-modulus modular arithmetic: one torch op across stacked RNS limbs.

Port of `tfhe_tpu/ops/modmath32v.py`. The modulus (and its preconditioned
companions) is a per-limb tensor broadcast over a stacked [L, ..., N] tower,
so one elementwise op serves every limb. `LimbModuli` holds the per-limb
constants as int64 tensors on the tower's device.

The JAX module computes in uint32 and relies on its wraparound: the low
words of a*b and t*q in `mulmod_shoup_v`, the (lo, hi) halves of a*b in
`barrett_mulmod_v`. torch's uint32 has no add, sub, shift or compare on the
CPU, so these compute in int64, exactly, like `ops/modmath.py`: with every
modulus below 2^31 and every Shoup companion below 2^32, both a*b and a*b'
stay below 2^63. The values the JAX code keeps are the exact ones reduced
mod 2^32 and lie in [0, 2q), so after the same conditional subtraction the
canonical residues are identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
class LimbModuli:
    """Per-limb constants for a tuple of moduli < 2^31, on one device."""

    def __init__(self, moduli: tuple, *, device: str):
        self.moduli = tuple(int(m) for m in moduli)
        if not all(0 < m < (1 << 31) for m in self.moduli):
            raise ValueError(f"limb moduli must lie in (0, 2^31): {self.moduli}")
        self.device = torch.device(device)
        self.q = self.tensor(self.moduli)

    def tensor(self, values) -> torch.Tensor:
        """A host array of per-limb constants as an int64 tensor here."""
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)

    @staticmethod
    def bc(arr: torch.Tensor, ndim: int) -> torch.Tensor:
        """Reshape a per-limb [L] (or [L, N]) constant to broadcast against
        a stacked [L, ..., N] operand of `ndim` dims."""
        if arr.ndim == 1:
            return arr.reshape((arr.shape[0],) + (1,) * (ndim - 1))
        return arr.reshape((arr.shape[0],) + (1,) * (ndim - arr.ndim)
                           + tuple(arr.shape[1:]))

    def shoup(self, b) -> np.ndarray:
        """Per-limb Shoup companions floor(b * 2^32 / q) of a stacked
        [L, ...] host array of residues (int64)."""
        b64 = np.asarray(b, dtype=np.int64)
        q = np.asarray(self.moduli, dtype=np.int64).reshape(
            (len(self.moduli),) + (1,) * (b64.ndim - 1))
        return (b64 << 32) // q


def addmod_v(a, b, lm: LimbModuli):
    q = lm.bc(lm.q, a.ndim)
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod_v(a, b, lm: LimbModuli):
    q = lm.bc(lm.q, a.ndim)
    s = a + q - b
    return torch.where(s >= q, s - q, s)


def mulmod_shoup_v(a, b, b_shoup, lm: LimbModuli):
    """(a * b) mod q per limb for 0 <= a < 2^31; b, b_shoup are stacked
    per-limb constants already broadcastable against a (use lm.bc)."""
    q = lm.bc(lm.q, a.ndim)
    r = a * b - ((a * b_shoup) >> 32) * q
    return torch.where(r >= q, r - q, r)


def mod_u32_v(x, lm: LimbModuli):
    """x mod q per limb for 0 <= x < 2^32. The JAX module reduces with a
    Barrett magic and masks power-of-two limbs; the exact remainder is the
    same residue for every modulus."""
    return torch.remainder(x, lm.bc(lm.q, x.ndim))


def barrett_mulmod_v(a, b, lm: LimbModuli):
    """Generic (a * b) mod q per limb for variable a, b < q: the product is
    exact in int64, so one remainder stands for the JAX module's split into
    u32 halves."""
    return torch.remainder(a * b, lm.bc(lm.q, a.ndim))
