"""Plain batched CGGI blind rotation in torch.

Port of `tfhe_tpu/ops/blindrotate32.py`: per round, split the accumulator
into signed base-G digits, forward-NTT them, take the inner product with the
round's RGSW key pair, inverse-NTT, multiply by (X^a - 1) and (X^-a - 1),
and accumulate. It reads the key in the hand kernel's packed layout
(`rotate_kernel.pack_bsk`), so it is that kernel's plain version: the CPU
path of `rotate_kernel.rotate`, and the oracle the kernel is held to on the
card. All values are exact int64 residues mod Q.
"""

from __future__ import annotations

import torch

from . import modmath as mm
from . import ntt


def signed_digits(d: torch.Tensor, base_g: int, digits: int,
                  throw: int) -> torch.Tensor:
    """Balanced base-G digits (rgsw-acc.cpp:57-111) of signed int64 values
    d [B, 2, N], the lowest `throw` dropped -> [B, 2*digits, N] signed
    digits, digit l of poly j at row j + 2l."""
    g_bits = base_g.bit_length() - 1
    half = base_g >> 1

    def extract(d):
        r = d & (base_g - 1)
        r = torch.where(r >= half, r - base_g, r)
        return r, (d - r) >> g_bits

    for _ in range(throw):
        _, d = extract(d)
    rows = []
    for _ in range(digits):
        r, d = extract(d)
        rows.append(r)
    B, _, N = d.shape
    return torch.stack(rows, dim=1).reshape(B, 2 * digits, N)


def decompose(acc: torch.Tensor, Q: int, base_g: int, digits: int,
              throw: int) -> torch.Tensor:
    """Signed digit decomposition of acc [B, 2, N] residues mod Q ->
    [B, 2*digits, N] digit residues, digit l of poly j at row j + 2l.
    Centred with acc < Q/2 as the JAX kernels do."""
    d = torch.where(acc < (Q >> 1), acc, acc - Q)
    return signed_digits(d, base_g, digits, throw) % Q


def rotate_sub(c: torch.Tensor, m: torch.Tensor, Q: int) -> torch.Tensor:
    """(X^m - 1) * c in Z_Q[X]/(X^N + 1) for per-batch exponents m [B] in
    [0, 2N); c [B, ..., N]. Coefficient i of X^m * c is c[i - m] when
    (i - m) mod 2N < N, else -c[i - m + N]."""
    N = c.shape[-1]
    bshape = (c.shape[0],) + (1,) * (c.ndim - 2) + (N,)
    r = (torch.arange(N, device=c.device) - m[:, None]) % (2 * N)
    src = (r % N).reshape(bshape).expand_as(c)
    neg = (r >= N).reshape(bshape)
    g = torch.gather(c, -1, src)
    return (torch.where(neg, -g, g) - c) % Q


def external_round(acc: torch.Tensor, digits: torch.Tensor,
                   bsk_r: torch.Tensor, idx_pos: torch.Tensor,
                   Q: int, bsk_sh_r: torch.Tensor | None = None) -> torch.Tensor:
    """One CGGI round on residues mod Q: the digits [B, d2, N] of the
    accumulator acc [B, 2, N] to the NTT domain, their product with the
    round's key bsk_r [2(key), 2(out), d2, N] (evaluation domain, bit-reversed
    order), back, times (X^idx_pos - 1) for key 0 and (X^-idx_pos - 1) for
    key 1, added to acc. Above 2^31 the products are the 64-bit Shoup
    products with the key's companions bsk_sh_r; their sum over d2 <= 8
    terms stays below 2^57."""
    N = acc.shape[-1]
    dct = ntt.forward(digits, Q)[:, None, None]
    if bsk_sh_r is None:
        prod = dct * bsk_r[None]
    else:
        prod = mm.mulmod_shoup64(dct, bsk_r[None], bsk_sh_r[None], Q)
    u = prod.sum(dim=-2) % Q                                 # [B,key,out,N]
    c = ntt.inverse(u, Q)
    upd = (rotate_sub(c[:, 0], idx_pos, Q)
           + rotate_sub(c[:, 1], (2 * N - idx_pos) % (2 * N), Q))
    return (acc + upd) % Q


def blind_rotate(acc: torch.Tensor, a_idx: torch.Tensor,
                 bsk_pack: torch.Tensor, Q: int, base_g: int,
                 throw: int = 0) -> torch.Tensor:
    """acc [B, 2, N] int32 residues, a_idx [B, n] int32 exponents
    (q - a) * 2N/q mod 2N (rgsw-acc-cggi.cpp:151-154), bsk_pack
    [n, 8*d2, N] int32 -> acc [B, 2, N] int32 after n rounds."""
    n, rows, N = bsk_pack.shape
    d2 = rows // 8
    # value rows only: [n, vs, key, out, d2, N] -> [n, key, out, d2, N]
    bsk = bsk_pack.reshape(n, 2, 2, 2, d2, N)[:, 0].to(torch.int64)
    acc = acc.to(torch.int64)
    a_idx = a_idx.to(torch.int64)
    for r in range(n):
        acc = external_round(acc, decompose(acc, Q, base_g, d2 // 2, throw),
                             bsk[r], a_idx[:, r], Q)
    return acc.to(torch.int32)


def transpose_extract(acc: torch.Tensor, Q: int):
    """Transpose automorphism of the a-polynomial (poly.cpp:762-770) and the
    constant term of b: acc [B, 2, N] -> (a_t [B, N], b [B])."""
    a = acc[:, 0, :]
    a_t = torch.cat([a[:, :1], (-a[:, 1:].flip(-1)) % Q], dim=-1)
    return a_t, acc[:, 1, 0]
