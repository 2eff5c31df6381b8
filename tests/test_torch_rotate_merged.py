"""The gate kernel's register NTT and rounds, emulated in torch on the CPU.

`csrc/blind_rotate.cu` runs only on the card. This file repeats what its
threads do, with the helpers of tests/test_torch_ntt_merged.py (the shared
`csrc/register_ntt.cuh`: thread ownership, swizzled exchanges, u32 lazy
arithmetic), and reads the tables the wrapper uploads
(`rotate_kernel._twiddles`) and only the companion rows of the key
(`rotate_kernel.pack_bsk`'s layout). The merged forward and inverse must
equal `ops.ntt.forward` and `ops.ntt.inverse` exactly at the moduli the gate
sets use, and a whole emulated rotation must equal the plain version
(`blindrotate.blind_rotate`, itself held to the Pallas kernel in
tests/test_torch_rotate.py). The cases are the chip run's own
(`chip_smoke.gate_cases`: every ring size, modulus, digit count and throw
the gate kernel serves)."""

import numpy as np
import pytest
import torch
from chip_smoke import gate_cases
from test_torch_ntt_merged import (M32, csub, extract, forward_regs, groups,
                                   inverse_regs, mulmod_lazy, owned, scatter,
                                   umulhi)

from tfhe_tpu_torch.ops import blindrotate, ntt, rotate_kernel
from torch_threads import one_torch_thread  # noqa: F401

CASES = gate_cases()                                  # (N, Q, d2, base, throw)
GATE_MODULI = sorted({(Q, N) for N, Q, *_ in CASES})


def tables(N, q):
    """The uploaded table as u32 in int64: fwd, fwd', inv, inv'."""
    return [row.to(torch.int64) & M32 for row in rotate_kernel._twiddles(N, q, "cpu")]


@pytest.mark.parametrize("q,N", GATE_MODULI)
def test_merged_forward_and_inverse_equal_ntt_at_gate_moduli(q, N):
    fw, fws, iw, iws = tables(N, q)
    rng = np.random.default_rng(N + q)
    x = torch.from_numpy(rng.integers(0, q, (3, N)))
    x[0, :4] = torch.tensor([0, q - 1, 1, q // 2])
    got = scatter(forward_regs(x.clone(), q, fw, fws), 2) % q
    assert torch.equal(got, ntt.forward(x, q))
    y = torch.from_numpy(rng.integers(0, q, (3, N)))
    y_lazy = y + q * torch.from_numpy(rng.integers(0, 2, (3, N)))   # < 2q
    regs = y_lazy[..., owned(2, N // 8)]
    got = csub(scatter(inverse_regs(regs, q, iw, iws), groups(N.bit_length() - 1)[0][0]), q)
    assert torch.equal(got, ntt.inverse(y, q))


def emulate_rotation(acc, a_idx, bsk_pack, Q, base_g, throw):
    """What every block of the kernel computes, for all blocks at once:
    acc [B, 2, N], a_idx [B, n], bsk_pack [n, 8 d2, N] int32 from pack_bsk,
    of which only the companion rows are read."""
    B, _, N = acc.shape
    n, rows, _ = bsk_pack.shape
    d2, TG = rows // 8, N // 8
    digits = d2 // 2
    g_bits = min(base_g.bit_length() - 1, 28)    # the kernel's clamp
    grp = groups(N.bit_length() - 1)
    fw, fws, iw, iws = tables(N, Q)
    red_sh = int(fws[0])
    comp = (bsk_pack.to(torch.int64) & M32)[:, 4 * d2:].reshape(n, 4, d2, TG, 8)
    pos0 = owned(grp[0][0], TG)                  # coefficient t + k N/8
    a = acc.to(torch.int64)[..., pos0]           # [B, 2, TG, 8]
    for r in range(n):
        d = torch.where(a < Q >> 1, a, a - Q)
        for _ in range(throw):
            _, d = extract(d, g_bits)
        u = None
        for l in range(digits):
            rr, d = extract(d, g_bits)
            x = forward_regs(scatter(torch.where(rr < 0, rr + Q, rr), grp[0][0]),
                             Q, fw, fws)                              # [B, 2, TG, 8]
            s0, s1 = comp[r, :, 2 * l], comp[r, :, 2 * l + 1]         # [4, TG, 8]
            v0, v1 = umulhi(s0 + 1, Q), umulhi(s1 + 1, Q)
            p = (mulmod_lazy(x[:, None, 0], v0, s0, Q)
                 + mulmod_lazy(x[:, None, 1], v1, s1, Q))              # [B, 4, TG, 8]
            u = p if u is None else u + p
            assert (u < 1 << 32).all()
        u = u - umulhi(u, red_sh) * Q
        u = csub(inverse_regs(u, Q, iw, iws), Q)                       # [B, 4, TG, 8]
        out = scatter(u, grp[0][0])                                    # [B, 4, N]
        m_pos = a_idx[:, r].to(torch.int64)[:, None, None]
        m_neg = (2 * N - m_pos) & (2 * N - 1)
        r0 = (pos0 - m_pos) & (2 * N - 1)
        r1 = (pos0 - m_neg) & (2 * N - 1)
        for o in range(2):
            c0 = torch.gather(out[:, o], 1, (r0 & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
            c1 = torch.gather(out[:, 2 + o], 1, (r1 & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
            v0 = torch.where(r0 < N, c0, Q - c0)
            v1 = torch.where(r1 < N, c1, Q - c1)
            s = a[:, o] + v0 + (Q - u[:, o]) + v1 + (Q - u[:, 2 + o])
            assert (s < 5 * Q).all()
            a[:, o] = csub(csub(csub(s, 4 * Q), 2 * Q), Q)
    return scatter(a, grp[0][0]).to(torch.int32)


@pytest.mark.parametrize("N,Q,d2,base_g,throw", CASES)
def test_emulated_gate_kernel_equals_plain(N, Q, d2, base_g, throw):
    B, n = 3, 2
    rng = np.random.default_rng(N + d2 + throw)
    acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32))
    acc[0, 0, :3] = torch.tensor([0, Q - 1, Q >> 1])
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[0] = [0, 2 * N - 1]
    a_idx[1] = [N, 1]
    a_idx = torch.from_numpy(a_idx)
    bsk = rotate_kernel.pack_bsk(rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64), Q)
    want = blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g, throw)
    assert torch.equal(emulate_rotation(acc, a_idx, bsk, Q, base_g, throw), want)
