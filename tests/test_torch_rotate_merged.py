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
the gate kernel serves). At N = 8192 the kernel runs each ciphertext on a
cluster of two blocks whose exchange between register groups 0 and 1
crosses the cluster; the emulation keeps the two blocks' shared memory
apart, laid out as the kernel lays it out, and lets one block run ahead
of the other to each cluster barrier, so that a buffer reused too early,
or a block that leaves too soon, shows as a wrong result."""

import numpy as np
import pytest
import torch
from chip_smoke import gate_cases
from test_torch_ntt_merged import (M32, csub, drop_rank, extract, forward_regs, fwd_group, groups,
                                   inv_group, inverse_regs, mulmod_lazy, owned, scatter,
                                   swz, umulhi)

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


def emulate_cluster_rotation(acc, a_idx, bsk_pack, Q, base_g, throw, parity=None,
                             output_buffer=True, last_barrier=True):
    """The kernel's N = 8192 layout: one ciphertext on a cluster of two
    blocks of 512 threads, logical thread t = rank * 512 + threadIdx.x.
    Each block's shared memory [B, 14 S] words (S = N / 2) is its own
    tensor, laid out as the kernel lays it out: the crossing's buffer
    [2 parities][2][S] at 0, the forward's [2][S] at 4S, the inverse's
    [4][S] (with the waiting sums) at 6S and the output [4][S] at 10S. A
    word of the peer is read from the peer's tensor.

    Each block runs as a generator that stops at every cluster barrier: the
    forward's crossing of each digit, the inverse's crossing, the output's
    and the final one. At each, block 0 runs on to the next one before
    block 1 resumes, so block 1 reads block 0's buffers after block 0 has
    written whatever it writes before the next barrier: the latest such a
    read can come. Barriers inside a block are not modelled. `parity(r, l)`
    picks the crossing buffer of round r's digit l (the kernel's: the
    digit's count across rounds mod 2); without `output_buffer` the output
    is written over the inverse's buffer; a block that leaves zeroes its
    shared memory, after the final barrier with `last_barrier`."""
    B, _, N = acc.shape
    n, rows, _ = bsk_pack.shape
    d2, S, TB = rows // 8, N // 2, N // 16
    digits = d2 // 2
    g_bits = min(base_g.bit_length() - 1, 28)
    grp = groups(N.bit_length() - 1)
    assert len(grp) == 5 and N == 8192
    fw, fws, iw, iws = tables(N, Q)
    red_sh = int(fws[0])
    comp = (bsk_pack.to(torch.int64) & M32)[:, 4 * d2:].reshape(n, 4, d2, N)
    if parity is None:
        parity = lambda r, l: (r * digits + l) & 1       # noqa: E731
    X, F, I = 0, 4 * S, 6 * S
    O = 10 * S if output_buffer else I
    smem = [torch.full((B, 14 * S), -1, dtype=torch.int64) for _ in range(2)]
    result = [None, None]
    tid = torch.arange(TB)
    sums_w = (8 * (tid & ~31) + (tid & 31))[:, None] + 32 * torch.arange(8)   # [TB, 8]

    def write(h, base, words, regs):
        """regs [B, P, TB, 8] to block h's words base + p S + words."""
        for p in range(regs.shape[1]):
            smem[h][:, base + p * S + words.reshape(-1)] = regs[:, p].reshape(B, -1)

    def read(owner, base, words, P):
        """[B, P, TB, 8] from the words base + p S + words, each element
        from block owner [TB, 8] (0 or 1)."""
        out = []
        for p in range(P):
            w = (base + p * S + words).reshape(-1)
            got = torch.where(owner.reshape(-1) == 0, smem[0][:, w], smem[1][:, w])
            out.append(got.reshape(B, TB, 8))
        return torch.stack(out, 1)

    def local(h, C_from, C_to, regs, base):
        """A block-local exchange in the block's half (bit 12 dropped)."""
        t = h * TB + tid
        write(h, base, swz(owned(C_from, 2 * TB)[t]) & (S - 1), regs)
        mine = torch.full((TB, 8), h)
        return read(mine, base, swz(owned(C_to, 2 * TB)[t]) & (S - 1), regs.shape[1])

    def block(h):
        t = h * TB + tid
        js = [owned(C, 2 * TB)[t] for C, _, _ in grp]              # [TB, 8] per group
        a = acc.to(torch.int64)[..., js[0]]                        # [B, 2, TB, 8]
        for r in range(n):
            d = torch.where(a < Q >> 1, a, a - Q)
            for _ in range(throw):
                _, d = extract(d, g_bits)
            u = None
            for l in range(digits):
                rr, d = extract(d, g_bits)
                x = fwd_group(torch.where(rr < 0, rr + Q, rr), js[0], *grp[0][1:], Q, fw, fws)
                par = X + 2 * S * parity(r, l)
                write(h, par, drop_rank(swz(js[0]), 2), x)
                yield                                              # the crossing
                x = read(js[1] >> 9 & 1, par, drop_rank(swz(js[1]), 2), 2)
                x = fwd_group(x, js[1], *grp[1][1:], Q, fw, fws)
                for g in range(2, 5):
                    x = local(h, grp[g - 1][0], grp[g][0], x, F)
                    x = fwd_group(x, js[g], *grp[g][1:], Q, fw, fws)
                s0, s1 = comp[r, :, 2 * l][:, js[4]], comp[r, :, 2 * l + 1][:, js[4]]
                v0, v1 = umulhi(s0 + 1, Q), umulhi(s1 + 1, Q)
                p = (mulmod_lazy(x[:, None, 0], v0, s0, Q)
                     + mulmod_lazy(x[:, None, 1], v1, s1, Q))     # [B, 4, TB, 8]
                mine = torch.full((TB, 8), h)
                if l:
                    p = p + read(mine, I, sums_w, 4)
                assert (p < 1 << 32).all()
                if l + 1 < digits:
                    write(h, I, sums_w, p)
                else:
                    u = p
            u = u - umulhi(u, red_sh) * Q
            u = inv_group(u, js[4], *grp[4][1:], Q, iw, iws)
            for g in range(3, 0, -1):
                u = local(h, grp[g + 1][0], grp[g][0], u, I)
                u = inv_group(u, js[g], *grp[g][1:], Q, iw, iws)
            write(h, I, swz(js[1]) & (S - 1), u)
            yield                                                  # the inverse's crossing
            u = read(js[0] >> 12 & 1, I, swz(js[0]) & (S - 1), 4)
            u = csub(inv_group(u, js[0], *grp[0][1:], Q, iw, iws), Q)
            write(h, O, drop_rank(js[0], 2), u)
            yield                                                  # the output
            m_pos = a_idx[:, r].to(torch.int64)[:, None, None]
            m_neg = (2 * N - m_pos) & (2 * N - 1)
            for o in range(2):
                v = []
                for ko, m in ((o, m_pos), (2 + o, m_neg)):
                    rot = (js[0] - m) & (2 * N - 1)                 # [B, TB, 8]
                    c = rot & (N - 1)
                    w = (O + ko * S + drop_rank(c, 2)).reshape(B, -1)
                    got = torch.where((c >> 9 & 1).reshape(B, -1) == 0,
                                      torch.gather(smem[0], 1, w), torch.gather(smem[1], 1, w))
                    got = got.reshape(B, TB, 8)
                    v.append(torch.where(rot < N, got, Q - got))
                s_ = a[:, o] + v[0] + (Q - u[:, o]) + v[1] + (Q - u[:, 2 + o])
                assert (s_ < 5 * Q).all()
                a[:, o] = csub(csub(csub(s_, 4 * Q), 2 * Q), Q)
        if last_barrier:
            yield                                                  # the final barrier
        result[h] = a
        smem[h].zero_()                                            # the block leaves

    running = [block(0), block(1)]
    while running:
        for g in list(running):
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    out = torch.empty((B, 2, N), dtype=torch.int64)
    for h in range(2):
        t = h * TB + tid
        out[..., owned(grp[0][0], 2 * TB)[t].reshape(-1)] = result[h].reshape(B, 2, -1)
    return out.to(torch.int32)


def rotation_inputs(N, Q, d2, B=3, n=2, seed=0):
    """acc, a_idx and a pack_bsk key from a seed; rows 0 and 1 of the
    exponents hold 0, 2N - 1, N and 1."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32))
    acc[0, 0, :3] = torch.tensor([0, Q - 1, Q >> 1])
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[0, :2] = [0, 2 * N - 1]
    a_idx[1 % B, :2] = [N, 1]
    bsk = rotate_kernel.pack_bsk(rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64), Q)
    return acc, torch.from_numpy(a_idx), bsk


@pytest.mark.parametrize("N,Q,d2,base_g,throw", CASES)
def test_emulated_gate_kernel_equals_plain(N, Q, d2, base_g, throw):
    """One block up to N = 4096, the two-block cluster at N = 8192."""
    acc, a_idx, bsk = rotation_inputs(N, Q, d2, seed=N + d2 + throw)
    want = blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g, throw)
    emulate = emulate_cluster_rotation if N > 4096 else emulate_rotation
    assert torch.equal(emulate(acc, a_idx, bsk, Q, base_g, throw), want)


@pytest.mark.parametrize("hazard", ["one forward buffer", "output over the inverse's buffer",
                                    "no final barrier", "parity of l alone"])
def test_cluster_hazards_show_in_the_emulation(hazard):
    """The emulated cluster equals the plain version only with the kernel's
    guards: one crossing buffer lets block 0 write the next digit's values
    over those block 1 still reads (two kept digits a round here), the
    output written over the inverse's buffer overwrites words the peer
    still reads in the inverse's crossing, and a block that leaves without
    the final cluster barrier takes its output away from the peer's last
    rotated reads. The parity of l alone is safe in this layout (three kept
    digits a round here, so it repeats across rounds): the inverse's and the
    output's cluster barriers come between a round's last digit and the
    next round's first, and the next round's sums and inverse reach the
    inverse's buffer only after the output's barrier."""
    N, Q = 8192, 133857281
    d2, base_g, throw = (6, 1 << 10, 0) if hazard == "parity of l alone" else (4, 1 << 10, 1)
    acc, a_idx, bsk = rotation_inputs(N, Q, d2, B=2, seed=13)
    want = blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g, throw)
    kw = {"one forward buffer": {"parity": lambda r, l: 0},
          "output over the inverse's buffer": {"output_buffer": False},
          "no final barrier": {"last_barrier": False},
          "parity of l alone": {"parity": lambda r, l: l & 1}}[hazard]
    got = emulate_cluster_rotation(acc, a_idx, bsk, Q, base_g, throw, **kw)
    assert torch.equal(got, want) == (hazard == "parity of l alone")
