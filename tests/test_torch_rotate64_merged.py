"""The 64-bit kernel's register NTT and rounds, emulated in torch on the CPU.

`csrc/blind_rotate64.cu` (with `csrc/register_ntt64.cuh`) runs only on the
card. This file repeats what its threads do in torch int64 with wrapping
u64 arithmetic (`modmath.mulhi64` for the high words of the Shoup products
and of the key values rebuilt from companions), with the index helpers of
tests/test_torch_ntt_merged.py (thread ownership, swizzle, twiddle indices)
and its exchanges split into the two u32 planes the kernel's shared memory
holds. It reads the tables the wrapper uploads (`rotate64_kernel._twiddles`)
and only the companions of `pack_bsk64`'s key. The merged forward and
inverse must equal `ops.ntt.forward` and `ops.ntt.inverse` exactly at every
modulus the kernel serves, and a whole emulated rotation must equal the
plain version (`blindrotate64.blind_rotate64`, itself held to the Pallas
kernel in tests/test_torch_rotate64.py) with tolerance 0. The cases are the
chip run's own (`chip_smoke.rotate64_cases`). At N = 4096 the kernel runs
each ciphertext on a cluster of two blocks, at N = 8192 on a cluster of four
(two a polynomial), and the emulation keeps the blocks' shared memory apart
and lets one block run ahead of the others to the next cluster barrier, so
that a buffer reused too early, or a block that leaves too soon, shows as a
wrong result."""

import numpy as np
import pytest
import torch
from chip_smoke import rotate64_cases
from test_torch_ntt_merged import (M32, drop_rank, extract, groups, owned, scatter, swz,
                                   twiddle_index)
from test_torch_ntt_merged import exchange as exchange32

from tfhe_tpu_torch.ops import blindrotate64, ntt, rotate64_kernel
from tfhe_tpu_torch.ops.modmath import mulhi64, shoup64, shoup64_values
from torch_threads import one_torch_thread  # noqa: F401

CASES = rotate64_cases()                        # name -> (N, Q, base, d2, throw)
SIGN = -(1 << 63)
MODULI = sorted({(Q, N) for N, Q, *_ in CASES.values()})


def mulmod_lazy(a, w, w_sh, q):
    """a * w - hi64(a * w_sh) * q in wrapping u64 (int64 bits), as the kernel."""
    return a * w - mulhi64(a, w_sh) * q


class OutOfRange(Exception):
    """A value left the lazy range that the kernel's arithmetic keeps it in:
    in the hazard cases, a word read before it was written."""


def in_range(x, hi):
    if not ((x >= 0) & (x < hi)).all():
        raise OutOfRange(f"a value outside [0, {hi})")


def csub(x, c):
    """min(x, x - c) in u64, as the kernel computes it: the unsigned order
    of int64 bit patterns is the signed order with the sign bit flipped."""
    y = x - c
    return torch.where((y ^ SIGN) < (x ^ SIGN), y, x)


def tables(N, q):
    """The uploaded table [2, N, 2] as rows fwd, fwd', inv, inv'."""
    tw = rotate64_kernel._twiddles(N, q, "cpu")
    return tw[0, :, 0], tw[0, :, 1], tw[1, :, 0], tw[1, :, 1]


def exchange(regs, N, c_from, c_to):
    """Registers [..., TG, 8] of u64 through the two swizzled u32 planes."""
    lo = exchange32(regs & M32, N, c_from, c_to)
    hi = exchange32(regs >> 32 & M32, N, c_from, c_to)
    return lo | hi << 32


def fwd_group(regs, j, top, lo, q, fw, fws):
    """The forward stages of bits top..lo on registers [..., T, 8] whose
    indices are j [T, 8] (any T threads of a group), values < 4q."""
    N = fw.shape[0]
    for b in range(top, lo - 1, -1):
        r = b - lo
        for k in range(8):
            if k >> r & 1:
                continue
            k2 = k | 1 << r
            idx = twiddle_index(N, j[:, 0], k >> (r + 1), b)
            assert torch.equal(idx, (N | j[:, k]) >> (b + 1))
            u = csub(regs[..., k], 2 * q)
            v = mulmod_lazy(regs[..., k2], fw[idx], fws[idx], q)
            regs[..., k], regs[..., k2] = u + v, u + 2 * q - v
    in_range(regs, 4 * q)
    return regs


def inv_group(regs, j, top, lo, q, iw, iws):
    """The inverse stages of bits lo..top, values < 2q; the stage of bit
    log2(N) - 1 folds in N^-1."""
    N = iw.shape[0]
    for b in range(lo, top + 1):
        r = b - lo
        for k in range(8):
            if k >> r & 1:
                continue
            k2 = k | 1 << r
            idx = twiddle_index(N, j[:, 0], k >> (r + 1), b)
            u, v = regs[..., k].clone(), regs[..., k2].clone()
            if b == N.bit_length() - 2:
                regs[..., k] = mulmod_lazy(u + v, iw[0], iws[0], q)
            else:
                regs[..., k] = csub(u + v, 2 * q)
            regs[..., k2] = mulmod_lazy(u + 2 * q - v, iw[idx], iws[idx], q)
    in_range(regs, 2 * q)
    return regs


def forward_regs(x, q, fw, fws):
    """Natural-order coefficients [..., N] (< 4q) -> the last group's
    registers [..., TG, 8]: point 8t + k, values < 4q."""
    N = x.shape[-1]
    grp = groups(N.bit_length() - 1)
    regs = x[..., owned(grp[0][0], N // 8)]
    for g, (C, top, lo) in enumerate(grp):
        if g:
            regs = exchange(regs, N, grp[g - 1][0], C)
        regs = fwd_group(regs, owned(C, N // 8), top, lo, q, fw, fws)
    return regs


def inverse_regs(regs, q, iw, iws):
    """The last group's registers [..., TG, 8] (< 2q) -> group 0's:
    coefficient t + k N/8, values < 2q."""
    N = regs.shape[-2] * 8
    grp = groups(N.bit_length() - 1)
    for g in range(len(grp) - 1, -1, -1):
        C, top, lo = grp[g]
        if g < len(grp) - 1:
            regs = exchange(regs, N, grp[g + 1][0], C)
        regs = inv_group(regs, owned(C, N // 8), top, lo, q, iw, iws)
    return regs


@pytest.mark.parametrize("q,N", MODULI)
def test_merged_forward_and_inverse_equal_ntt_at_64bit_moduli(q, N):
    fw, fws, iw, iws = tables(N, q)
    rng = np.random.default_rng(N + q % 1000)
    x = torch.from_numpy(rng.integers(0, q, (3, N)))
    x[0, :4] = torch.tensor([0, q - 1, 1, q // 2])
    got = scatter(forward_regs(x.clone(), q, fw, fws), 2) % q
    assert torch.equal(got, ntt.forward(x, q))
    # the forward also takes lazy inputs below 4q
    lazy = x + q * torch.from_numpy(rng.integers(0, 4, (3, N)))
    assert torch.equal(scatter(forward_regs(lazy, q, fw, fws), 2) % q, got)

    y = torch.from_numpy(rng.integers(0, q, (3, N)))
    y_lazy = y + q * torch.from_numpy(rng.integers(0, 2, (3, N)))   # < 2q
    regs = y_lazy[..., owned(2, N // 8)]
    got = csub(scatter(inverse_regs(regs, q, iw, iws), groups(N.bit_length() - 1)[0][0]), q)
    assert torch.equal(got, ntt.inverse(y, q))


@pytest.mark.parametrize("q,N", MODULI)
def test_key_values_and_reduction_from_companions(q, N):
    """The kernel rebuilds a key value as hi64((b' + 1) q), the plain
    version as hi64(b' q) + (lo64(b' q) != 0): equal for every companion
    b' = floor(b 2^64 / q) of a value b < q. And forward entry 0 is 1, so
    its companion floor(2^64 / q) takes any lazy sum below 2^62 to
    [0, 2q) in one Shoup product."""
    b = np.random.default_rng(q % 1000).integers(0, q, 1 << 14)
    b = np.concatenate([b, [0, 1, q - 2, q - 1]])
    sh = torch.from_numpy(shoup64(b, q))
    assert torch.equal(mulhi64(sh + 1, q), torch.from_numpy(b))
    assert torch.equal(shoup64_values(sh, q), torch.from_numpy(b))
    fw, fws, _, _ = tables(N, q)
    assert int(fw[0]) == 1 and int(fws[0]) == (1 << 64) // q
    s = torch.from_numpy(np.random.default_rng(q % 997).integers(0, 1 << 62, 1 << 14))
    s[:2] = torch.tensor([0, (1 << 62) - 1])
    red = s - mulhi64(s, fws[0]) * q
    assert ((red >= 0) & (red < 2 * q)).all() and torch.equal(red % q, s % q)


def emulate_rotation(acc, a_idx, key, Q, base_g, throw, cluster=None, parity=None,
                     last_barrier=True):
    """What the kernel computes, for all ciphertexts at once: acc [B, 2, N],
    a_idx [B, n], key [n, 4 d2, N] int64 from pack_bsk64. Half h holds
    polynomial h of the accumulator and computes outputs ko = h + 2i of the
    external product; the halves are the two halves of one block up to
    N = 2048 and the two blocks of a cluster at N = 4096 (`cluster`, by
    default N > 2048). N = 8192 is `emulate_four_blocks`.

    Each half runs as a generator that stops at every barrier both halves
    take part in: the digit's crossing, and in one block the round's end.
    At each such barrier half 0 runs on to the next one before half 1
    resumes, so half 1 reads half 0's forward buffer after half 0 has written
    whatever it writes before the next common barrier: the latest such a
    read can come. Each half's forward buffer [2 parities][2 planes][N] u32
    is its own tensor, laid out as the kernel lays it out; the crossing
    writes the forward's values there at the words of the last group's
    registers and reads the other half's at the same words. `parity(r, l)`
    picks the buffer of round r's digit l: the kernel's rule, l mod 2 in one
    block and (r digits + l) mod 2 in a cluster, by default. A block of a
    cluster that leaves zeroes its shared memory; with `last_barrier` it
    leaves after the kernel's final cluster barrier."""
    B, _, N = acc.shape
    if N == 8192:
        return emulate_four_blocks(acc, a_idx, key, Q, base_g, throw)
    n, rows, _ = key.shape
    d2, TG = rows // 4, N // 8
    digits, g_bits = d2 // 2, base_g.bit_length() - 1
    cluster = N > 2048 if cluster is None else cluster
    if parity is None:
        parity = (lambda r, l: (r * digits + l) & 1) if cluster else (lambda r, l: l & 1)
    grp = groups(N.bit_length() - 1)
    fw, fws, iw, iws = tables(N, Q)
    comp = key.reshape(n, 2, 2, d2, TG, 8)       # [n, key, out, d2, ...]: point 8t + k
    pos0 = owned(grp[0][0], TG)                  # coefficient t + k N/8
    words = swz(owned(2, TG)).reshape(-1)        # the last group's words
    fbuf = [torch.full((B, 4 * N), -1, dtype=torch.int64) for _ in range(2)]
    result = [None, None]

    def half(h):
        a = acc[:, h][..., pos0]                 # [B, TG, 8]
        for r in range(n):
            d = torch.where(a < Q >> 1, a, a - Q)
            for _ in range(throw):
                _, d = extract(d, g_bits)
            u = None
            for l in range(digits):
                rr, d = extract(d, g_bits)
                x = forward_regs(scatter(torch.where(rr < 0, rr + Q, rr), grp[0][0]),
                                 Q, fw, fws)                          # [B, TG, 8]
                par = 2 * N * parity(r, l)
                fbuf[h][:, par + words] = (x & M32).reshape(B, -1)
                fbuf[h][:, par + N + words] = (x >> 32 & M32).reshape(B, -1)
                yield                                                 # the crossing
                other = fbuf[1 - h]
                y = (other[:, par + words] | other[:, par + N + words] << 32).reshape(B, TG, 8)
                # rows 2l + h (for x) and 2l + 1 - h (for y) of K[i][out = h]
                k_x, k_y = comp[r, :, h, 2 * l + h], comp[r, :, h, 2 * l + 1 - h]
                p = (mulmod_lazy(x[:, None], mulhi64(k_x + 1, Q), k_x, Q)
                     + mulmod_lazy(y[:, None], mulhi64(k_y + 1, Q), k_y, Q))  # [B, key, TG, 8]
                u = p if u is None else u + p
                assert ((u >= 0) & (u < 2 * Q * d2)).all()
            u = u - mulhi64(u, fws[0]) * Q
            u = csub(inverse_regs(u, Q, iw, iws), Q)                   # [B, key, TG, 8]
            out = scatter(u, grp[0][0])                                # [B, key, N]
            m_pos = a_idx[:, r].to(torch.int64)[:, None, None]
            m_neg = (2 * N - m_pos) & (2 * N - 1)
            r0 = (pos0 - m_pos) & (2 * N - 1)
            r1 = (pos0 - m_neg) & (2 * N - 1)
            c0 = torch.gather(out[:, 0], 1, (r0 & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
            c1 = torch.gather(out[:, 1], 1, (r1 & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
            v0 = torch.where(r0 < N, c0, Q - c0)
            v1 = torch.where(r1 < N, c1, Q - c1)
            s = a + v0 + (Q - u[:, 0]) + v1 + (Q - u[:, 1])
            assert (s < 5 * Q).all()
            a = csub(csub(csub(s, 4 * Q), 2 * Q), Q)
            if not cluster:
                yield                                                 # the round's end
        if cluster and last_barrier:
            yield                                                     # the final barrier
        result[h] = scatter(a, grp[0][0])
        if cluster:
            fbuf[h].zero_()                                           # the block leaves

    running = [half(0), half(1)]
    while running:
        for g in list(running):
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    return torch.stack(result, 1)


# The N = 8192 kernel's buffers in a block's shared memory, in units of
# S = N / 2 words: the output ([2][S] u64) lies over the forward's buffer
# and the 2S words after it, the remainders the digits are taken from
# ([8][512] int64, each thread's own) after it; 12 S in all.
LAYOUT_8192 = {"inverse": 0, "crossing": 4, "forward": 6, "output": 6, "remainders": 10}
WORDS_8192 = 12 * 4096
BARRIERS_8192 = ("A", "B", "C", "E", "final")   # the cluster barriers a hazard may drop


def planes(x):
    """u64 registers [B, P, TB, 8] -> their u32 planes [B, 2P, TB, 8], low
    then high for each polynomial."""
    return torch.stack((x & M32, x >> 32 & M32), 2).flatten(1, 2)


def unplanes(y):
    """The inverse of `planes`."""
    y = y.unflatten(1, (-1, 2))
    return y[:, :, 0] | y[:, :, 1] << 32


def emulate_four_blocks(acc, a_idx, key, Q, base_g, throw, layout=None, block_barriers=()):
    """The kernel's N = 8192 layout: one ciphertext on a cluster of four
    blocks of 512 threads, rank = 2 poly + half, logical thread t = half *
    512 + threadIdx.x of the polynomial's N/8. Each block's shared memory
    [B, 12 S] u32 words (S = N / 2) is its own tensor, its buffers at
    `layout` (LAYOUT_8192 unless given); a word of another block is read
    from that block's tensor. A block holds the words of its polynomial
    whose owner bit (bit 9 of j in register group 0, bit 12 after) is its
    half, at the word with bit 9 dropped in group 0 (drop_rank(j, 2)) and
    with bit 12 dropped after;
    a u64 is two u32 planes S words apart, as cluster.cuh's crossings move
    it, and the output u64 words in natural order.

    Each block runs as a generator that stops at every cluster barrier: per
    kept digit in the forward's crossing (B_l) and after the forward's
    values are stored (A_l); in the inverse's crossing (C); after the output
    is written (E); at the kernel's end. At each, block 0 runs on to its next
    barrier, then blocks 1, 2 and 3, so a block reads another's buffers
    after that block has written whatever it writes before the next
    barrier: the latest such a read can come. Barriers inside a block are
    not modelled. A barrier named in `block_barriers` (of BARRIERS_8192) is
    a block barrier, which no other block waits for; a block that leaves
    zeroes its shared memory."""
    B, _, N = acc.shape
    n, rows, _ = key.shape
    d2, S, TB = rows // 4, N // 2, N // 16
    digits, g_bits = d2 // 2, base_g.bit_length() - 1
    grp = groups(N.bit_length() - 1)
    assert len(grp) == 5 and N == 8192
    assert WORDS_8192 * 4 + 16 <= 227 * 1024          # and `zero`: a block's 227 KB
    at = {name: S * v for name, v in (layout or LAYOUT_8192).items()}
    fw, fws, iw, iws = tables(N, Q)
    comp = key.reshape(n, 2, 2, d2, N)                 # [n, key, out, d2, N]
    smem = [torch.full((B, WORDS_8192), -1, dtype=torch.int64) for _ in range(4)]
    result = [None] * 4
    tid = torch.arange(TB)
    sums_w = (8 * (tid & ~31) + (tid & 31))[:, None] + 32 * torch.arange(8)   # [TB, 8]
    rem_w = at["remainders"] + 2 * (tid[:, None] + TB * torch.arange(8))      # [TB, 8]

    def write(rank, base, words, regs):
        """regs [B, P, TB, 8] to block rank's words base + p S + words."""
        for p in range(regs.shape[1]):
            smem[rank][:, base + p * S + words.reshape(-1)] = regs[:, p].reshape(B, -1)

    def read(ranks, owner, base, words, P):
        """[B, P, TB, 8] from the words base + p S + words, each element from
        block ranks[owner] (owner [TB, 8] of 0 and 1)."""
        out = []
        for p in range(P):
            w = (base + p * S + words).reshape(-1)
            got = torch.where(owner.reshape(-1) == 0, smem[ranks[0]][:, w], smem[ranks[1]][:, w])
            out.append(got.reshape(B, TB, 8))
        return torch.stack(out, 1)

    def barrier(name):
        return name not in block_barriers

    def block(rank):
        h, half = rank >> 1, rank & 1
        halves = (rank & 2, (rank & 2) | 1)                   # this polynomial's two blocks
        t = half * TB + tid
        js = [owned(C, 2 * TB)[t] for C, _, _ in grp]         # [TB, 8] per group
        mine = torch.zeros((TB, 8), dtype=torch.int64)
        last = swz(js[4]) & (S - 1)                           # the last group's words

        def local(C_from, C_to, regs, base):
            """A block-local exchange of u64 registers [B, P, TB, 8] in the
            block's half (bit 12 dropped), as two planes a polynomial."""
            y = planes(regs)
            write(rank, base, swz(owned(C_from, 2 * TB)[t]) & (S - 1), y)
            return unplanes(read((rank, rank), mine, base,
                                 swz(owned(C_to, 2 * TB)[t]) & (S - 1), y.shape[1]))

        def remainders(d=None):
            """The thread's int64 remainders [B, TB, 8] to or from their
            words, two u32 words each."""
            if d is not None:
                smem[rank][:, rem_w.reshape(-1)] = (d & M32).reshape(B, -1)
                smem[rank][:, (rem_w + 1).reshape(-1)] = (d >> 32).reshape(B, -1)
                return d
            lo, hi = smem[rank][:, rem_w.reshape(-1)], smem[rank][:, (rem_w + 1).reshape(-1)]
            return (lo | hi << 32).reshape(B, TB, 8)

        a = acc[:, h][..., js[0]]                              # [B, TB, 8]
        for r in range(n):
            d = torch.where(a < Q >> 1, a, a - Q)
            for _ in range(throw):
                _, d = extract(d, g_bits)
            remainders(d)
            for l in range(digits):
                rr, d = extract(remainders(), g_bits)
                remainders(d)
                x = torch.where(rr < 0, rr + Q, rr)[:, None]   # [B, 1, TB, 8]
                x = fwd_group(x, js[0], *grp[0][1:], Q, fw, fws)
                write(rank, at["crossing"], drop_rank(swz(js[0]), 2), planes(x))
                if barrier("B"):
                    yield                                      # B_l
                x = unplanes(read(halves, js[1] >> 9 & 1, at["crossing"],
                                  drop_rank(swz(js[1]), 2), 2))
                x = fwd_group(x, js[1], *grp[1][1:], Q, fw, fws)
                for g in range(2, 5):
                    x = local(grp[g - 1][0], grp[g][0], x, at["forward"])
                    x = fwd_group(x, js[g], *grp[g][1:], Q, fw, fws)
                write(rank, at["forward"], last, planes(x))
                if barrier("A"):
                    yield                                      # A_l
                y = unplanes(read((rank ^ 2, rank ^ 2), mine, at["forward"], last, 2))
                # rows 2l + h (for x) and 2l + 1 - h (for y) of K[i][out = h]
                # at this block's points 8t + k
                k_x = comp[r, :, h, 2 * l + h][:, js[4]]        # [2, TB, 8]
                k_y = comp[r, :, h, 2 * l + 1 - h][:, js[4]]
                p = (mulmod_lazy(x, mulhi64(k_x + 1, Q), k_x, Q)
                     + mulmod_lazy(y, mulhi64(k_y + 1, Q), k_y, Q))   # [B, 2, TB, 8]
                if l:
                    p = p + unplanes(read((rank, rank), mine, at["inverse"], sums_w, 4))
                in_range(p, 2 * Q * d2)
                write(rank, at["inverse"], sums_w, planes(p))
            u = unplanes(read((rank, rank), mine, at["inverse"], sums_w, 4))
            u = u - mulhi64(u, fws[0]) * Q
            u = inv_group(u, js[4], *grp[4][1:], Q, iw, iws)
            for g in range(3, 0, -1):
                u = local(grp[g + 1][0], grp[g][0], u, at["inverse"])
                u = inv_group(u, js[g], *grp[g][1:], Q, iw, iws)
            write(rank, at["inverse"], swz(js[1]) & (S - 1), planes(u))
            if barrier("C"):
                yield                                          # C
            u = unplanes(read(halves, js[0] >> 12 & 1, at["inverse"], swz(js[0]) & (S - 1), 4))
            u = csub(inv_group(u, js[0], *grp[0][1:], Q, iw, iws), Q)   # [B, 2, TB, 8]
            w0 = at["output"] + 2 * drop_rank(js[0], 2)
            for i in range(2):
                smem[rank][:, (w0 + 2 * i * S).reshape(-1)] = (u[:, i] & M32).reshape(B, -1)
                smem[rank][:, (w0 + 2 * i * S + 1).reshape(-1)] = (u[:, i] >> 32).reshape(B, -1)
            if barrier("E"):
                yield                                          # E
            m_pos = a_idx[:, r].to(torch.int64)[:, None, None]
            m_neg = (2 * N - m_pos) & (2 * N - 1)
            v = []
            for i, m in ((0, m_pos), (1, m_neg)):
                rot = (js[0] - m) & (2 * N - 1)                 # [B, TB, 8]
                c = rot & (N - 1)
                w = (at["output"] + 2 * (i * S + drop_rank(c, 2))).reshape(B, -1)
                own = (c >> 9 & 1).reshape(B, -1) == 0
                lo = torch.where(own, torch.gather(smem[halves[0]], 1, w),
                                 torch.gather(smem[halves[1]], 1, w))
                hi = torch.where(own, torch.gather(smem[halves[0]], 1, w + 1),
                                 torch.gather(smem[halves[1]], 1, w + 1))
                got = (lo | hi << 32).reshape(B, TB, 8)
                v.append(torch.where(rot < N, got, Q - got))
            s_ = a + v[0] + (Q - u[:, 0]) + v[1] + (Q - u[:, 1])
            in_range(s_, 5 * Q)
            a = csub(csub(csub(s_, 4 * Q), 2 * Q), Q)
        if barrier("final"):
            yield                                              # the final barrier
        result[rank] = a
        smem[rank].zero_()                                     # the block leaves

    running = [block(rank) for rank in range(4)]
    while running:
        for g in list(running):
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    out = torch.empty((B, 2, N), dtype=torch.int64)
    for rank in range(4):
        t = (rank & 1) * TB + tid
        j = owned(grp[0][0], 2 * TB)[t].reshape(-1)
        out[:, rank >> 1, j] = result[rank].reshape(B, -1)
    return out


def rotation_inputs(N, Q, d2, B=3, n=2, seed=0):
    """acc, a_idx and a pack_bsk64 key from a seed; rows 0 and 1 of the
    exponents hold 0, 2N - 1, N and 1."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)))
    acc[0, 0, :3] = torch.tensor([0, Q - 1, Q >> 1])
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[0, :2] = [0, 2 * N - 1]
    a_idx[1, :2] = [N, 1]
    key = rotate64_kernel.pack_bsk64(rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64), Q)
    return acc, torch.from_numpy(a_idx), key


@pytest.mark.parametrize("N,Q,base_g,d2,throw", CASES.values(), ids=CASES.keys())
def test_emulated_rotate64_kernel_equals_plain(N, Q, base_g, d2, throw):
    acc, a_idx, key = rotation_inputs(N, Q, d2, seed=N + d2 + throw)
    want = blindrotate64.blind_rotate64(acc, a_idx, key, Q, base_g, throw)
    assert torch.equal(emulate_rotation(acc, a_idx, key, Q, base_g, throw), want)


@pytest.mark.parametrize("hazard", ["parity of l alone", "no final barrier"])
def test_cluster_hazards_show_in_the_emulation(hazard):
    """The emulated cluster equals the plain version only with the kernel's
    two guards: at base 2^27 (one kept digit, d2 = 2) the parity of l alone
    reuses the forward's buffer while the peer still reads it, and a block
    that leaves without the final cluster barrier takes its buffer away from
    the peer's last read. Both also give the plain result in one block,
    whose round-end barriers cover both halves."""
    name = "N=4096, Q54, base 2^27"
    N, Q, base_g, d2, throw = CASES[name]
    acc, a_idx, key = rotation_inputs(N, Q, d2, B=2, seed=27)
    want = blindrotate64.blind_rotate64(acc, a_idx, key, Q, base_g, throw)
    kw = ({"parity": lambda r, l: l & 1} if hazard == "parity of l alone"
          else {"last_barrier": False})
    assert not torch.equal(emulate_rotation(acc, a_idx, key, Q, base_g, throw, **kw), want)
    assert torch.equal(emulate_rotation(acc, a_idx, key, Q, base_g, throw, cluster=False,
                                        **kw), want)


@pytest.fixture(scope="module")
def four_block_case():
    """The hazard cases' inputs at N = 8192, base 2^18, and the plain
    result, which the emulation without a hazard gives on them. Row 2 and
    round 2 rotate by random exponents, whose reads cross blocks in the
    rounds before another."""
    name = "N=8192, Q54, base 2^18"
    N, Q, base_g, d2, throw = CASES[name]
    acc, a_idx, key = rotation_inputs(N, Q, d2, B=3, n=3, seed=8192)
    want = blindrotate64.blind_rotate64(acc, a_idx, key, Q, base_g, throw)
    assert torch.equal(emulate_four_blocks(acc, a_idx, key, Q, base_g, throw), want)
    return (acc, a_idx, key, Q, base_g, throw), want


@pytest.mark.parametrize("hazard", ["crossing over the forward's buffer",
                                    "output over the inverse's buffer",
                                    "output over the crossing's buffer",
                                    "A in the block", "B in the block", "C in the block",
                                    "E in the block", "no final barrier"])
def test_four_block_hazards_show_in_the_emulation(four_block_case, hazard):
    """N = 8192: the emulated cluster equals the plain version only with the
    kernel's layout and barriers. The crossing in the forward's buffer
    overwrites the forward's values that the other polynomial's block still
    reads; the output over the inverse's buffer overwrites what the
    polynomial's other block still reads in the inverse's crossing, and
    over the crossing's buffer is overwritten by the next round's crossing
    while that block still reads it rotated; a block barrier in place of
    A_l, B_l, C or E lets a block read another's words before they are
    written, and a block that leaves without the final barrier takes its
    output away from the last rotated reads."""
    args, want = four_block_case
    layout = dict(LAYOUT_8192)
    kw = {}
    if hazard == "crossing over the forward's buffer":
        layout["crossing"] = layout["forward"]
    elif hazard == "output over the inverse's buffer":
        layout["output"] = layout["inverse"]
    elif hazard == "output over the crossing's buffer":
        layout["output"] = layout["crossing"]
    elif hazard == "no final barrier":
        kw["block_barriers"] = ("final",)
    else:
        kw["block_barriers"] = (hazard[0],)
    try:
        got = emulate_four_blocks(*args, layout=layout, **kw)
    except OutOfRange:
        return                  # a word read too early left the lazy ranges
    assert not torch.equal(got, want)


@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192])
def test_register_exchanges64_are_conflict_free_bijections(N):
    """The 64-bit exchanges: every group's words, in both u32 planes of a
    polynomial, are filled once, and each warp's access to a plane for one
    register hits 32 banks, the high plane's the same banks as the low one's
    (it starts a multiple of 32 words on). At N = 8192 the threads of each
    block (rank = thread bit 9) fill the block's half of the buffer, S = N/2
    words a plane, once with the owner bit dropped (bit 9 of j in group 0,
    bit 12 after), banks unchanged; the kernel's other buffers (the sums,
    the output) lie at the words `emulate_four_blocks` reads."""
    TG = N // 8
    blocks, S = (2, N // 2) if N == 8192 else (1, N)
    grp = groups(N.bit_length() - 1)
    for g, (C, _, _) in enumerate(grp):
        j = owned(C, TG)
        for r in range(blocks):
            jr = j[r * TG // blocks:(r + 1) * TG // blocks]
            s = swz(jr)
            if blocks == 2:
                s = drop_rank(s, 2) if g == 0 else s & (S - 1)
            word = torch.cat([s, s + S]).reshape(-1)              # the two planes
            assert torch.equal(word.sort().values, torch.arange(2 * S))
            for w in range(0, jr.shape[0], 32):
                for k in range(8):
                    lo, hi = s[w:w + 32, k], s[w:w + 32, k] + S
                    assert len(set((lo % 32).tolist())) == 32
                    assert torch.equal(lo % 32, hi % 32)
