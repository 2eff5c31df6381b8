"""The ring products of the CGGI bootstrapping key's generation, on a device.

`ref/rgsw.keygen_acc_cggi` draws the key's uniform rows a and errors e on the
host, then computes b = a * s + e in Z_Q[X]/(X^N + 1) for the ring secret s.
`ring_mul` gives the a * s part in torch on the context's device, a chunk of
rows at a time, in place of the host's forward NTT, Montgomery product and
inverse NTT (about four fifths of an accelerated key's host keygen at
N = 8192). The draws stay on the host in the same order, and the product in
the ring is unique, so every key word equals the host engine's:

- Q = q1 * q2, two primes < 2^28 (the accelerated sets): the product mod
  each prime, whose NTT is exact in int64 with `%`, then the Garner CRT back
  to Q (`modmath.crt_combine`);
- Q < 2^31: mod Q with `%`; a prime Q < 2^54 (the two-limb sets and the
  single 54-bit prime): mod Q with the 64-bit Shoup products of
  `ntt.forward`/`ntt.inverse` and `modmath.mulmod_shoup64`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import modmath as mm
from .ntt import forward, inverse

CHUNK_WORDS = 1 << 24   # residues of a in one chunk on the device


def ring_mul(s_coeff: np.ndarray, Q: int, rns_primes: tuple[int, int] | None,
             device: str | torch.device) -> Callable[[np.ndarray], np.ndarray]:
    """The function a [R, N] uint64 residues mod Q (host) -> a * s mod
    (Q, X^N + 1) [R, N] uint64 (host), computed on `device`; s_coeff [N] is
    the ring secret's coefficients mod Q."""
    moduli = tuple(rns_primes) if rns_primes else (Q,)
    if rns_primes is None and Q >= (1 << 54):
        raise ValueError(f"ring_mul takes Q < 2^54 or a pair of primes, not {Q}")
    s = torch.from_numpy(np.asarray(s_coeff, dtype=np.uint64).view(np.int64)).to(device)
    s_hat = []
    for m in moduli:
        sh = forward(s % m, m)
        s_hat.append((sh, None if m < (1 << 31) else mm.shoup64_tensor(sh, m)))

    def times_s(x: torch.Tensor, m: int, sh: torch.Tensor, sh_sh) -> torch.Tensor:
        x_hat = forward(x % m if len(moduli) > 1 else x, m)
        prod = x_hat * sh % m if sh_sh is None else mm.mulmod_shoup64(x_hat, sh, sh_sh, m)
        return inverse(prod, m)

    def apply(a: np.ndarray) -> np.ndarray:
        R, N = a.shape
        out = np.empty((R, N), dtype=np.uint64)
        rows = max(1, CHUNK_WORDS // N)
        for r in range(0, R, rows):
            x = torch.from_numpy(np.ascontiguousarray(a[r:r + rows]).view(np.int64)).to(device)
            parts = [times_s(x, m, *sh) for m, sh in zip(moduli, s_hat)]
            y = mm.crt_combine(*parts, *moduli) if len(moduli) > 1 else parts[0]
            out[r:r + rows] = y.cpu().numpy().view(np.uint64)
        return out

    return apply
