"""The RNS kernel's register NTT and round, emulated in torch on the CPU.

`csrc/blind_rotate_rns.cu` (with `csrc/register_ntt.cuh`) runs only on the
card. This file repeats what its threads do, with its u32 lazy arithmetic,
its thread ownership and its swizzled shared-memory exchanges, and reads
the tables the wrapper uploads (`rotate_rns_kernel._twiddles`). The merged-
twiddle forward and inverse must equal `ops.ntt.forward` and `ops.ntt.inverse`
exactly, and a whole emulated rotation must equal the plain version
(`blindrotate_rns.blind_rotate_rns`, itself held to the Pallas kernel in
tests/test_torch_rns.py)."""

import os

import numpy as np
import pytest
import torch

from tfhe_tpu_torch.ops import _build, blindrotate_rns, ntt, rotate_rns_kernel
from torch_threads import one_torch_thread  # noqa: F401

Q1, Q2 = 134176769, 134111233          # the accelerated sets' primes (N = 2048, 4096)
Q1_8K, Q2_8K = 133857281, 133644289    # and at N = 8192
Q1_16K, Q2_16K = 133857281, 132710401  # and at N = 16384
M32 = (1 << 32) - 1


def primes_of(N):
    """The accelerated sets' (q1, q2) at ring N."""
    return {8192: (Q1_8K, Q2_8K), 16384: (Q1_16K, Q2_16K)}.get(N, (Q1, Q2))


class OutOfRange(Exception):
    """A value left the lazy range that the kernel's arithmetic keeps it in:
    in the hazard cases, a word read before it was written."""


def in_range(x, hi):
    if not ((x >= 0) & (x < hi)).all():
        raise OutOfRange(f"a value outside [0, {hi})")


def umulhi(a, b):
    """High word of the 64-bit product of two u32 tensors held in int64."""
    ah, al = a >> 16, a & 0xFFFF
    return (ah * b + ((al * b) >> 16)) >> 16


def mulmod_lazy(a, w, w_sh, q):
    return (a * w - umulhi(a, w_sh) * q) & M32


def csub(x, c):
    """min(x, x - c) in u32, as the kernel computes it."""
    return torch.minimum(x, (x - c) & M32)


def groups(logn):
    """(C, top, lo) of each register group (register_ntt.cuh: Group)."""
    out = []
    for g in range((logn + 2) // 3):
        top = logn - 1 - 3 * g
        C = max(top, 2)
        out.append((C, top, C - 2))
    return out


def owned(C, TG):
    """[TG, 8] index j of register k of thread t in the group with top
    register bit C."""
    t = torch.arange(TG)[:, None]
    k = torch.arange(8)[None, :]
    return ((t >> (C - 2)) << (C + 1)) | (k << (C - 2)) | (t & ((1 << (C - 2)) - 1))


def pmask(b):
    return ((b << 2) & 28) ^ ((b >> 1) & 3)


def swz(j):
    return j ^ pmask((j >> 5) & 7) ^ pmask((j >> 8) & 7)


def tables(N, lane, q1=Q1, q2=Q2):
    """The lane's rows of the uploaded table as u32 in int64: fwd, fwd',
    inv, inv'."""
    tw = rotate_rns_kernel._twiddles(N, q1, q2, "cpu")
    return [row.to(torch.int64) & M32 for row in tw[lane]]


def twiddle_index(N, base, hi, b):
    """Table entry of the stage of bit b for the pairs whose registers
    above the stage's bit are `hi`; base = the thread's register 0 index."""
    return (N | base | (hi << (b + 1))) >> (b + 1)


def exchange(regs, N, c_from, c_to):
    """Registers [..., TG, 8] of group c_from through a swizzled buffer
    into those of group c_to."""
    TG = N // 8
    buf = torch.full(regs.shape[:-2] + (N,), -1, dtype=torch.int64)
    buf[..., swz(owned(c_from, TG)).reshape(-1)] = regs.reshape(*regs.shape[:-2], -1)
    assert (buf >= 0).all()
    return buf[..., swz(owned(c_to, TG))]


def fwd_group(regs, j, top, lo, q, fw, fws):
    """The forward stages of bits top..lo on registers [..., T, 8] whose
    indices are j [T, 8] (any T threads of a group)."""
    N = fw.shape[0]
    for b in range(top, lo - 1, -1):
        r = b - lo
        for k in range(8):
            if k >> r & 1:
                continue
            k2 = k | 1 << r
            assert torch.equal(j[:, k2], j[:, k] + (1 << b))
            idx = twiddle_index(N, j[:, 0], k >> (r + 1), b)
            assert torch.equal(idx, (N | j[:, k]) >> (b + 1))
            u = csub(regs[..., k], 2 * q)
            v = mulmod_lazy(regs[..., k2], fw[idx], fws[idx], q)
            regs[..., k], regs[..., k2] = u + v, u + 2 * q - v
    in_range(regs, 4 * q)
    return regs


def inv_group(regs, j, top, lo, q, iw, iws):
    """The inverse stages of bits lo..top; the stage of bit log2(N) - 1
    folds in N^-1."""
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


def scatter(regs, C):
    """Registers [..., TG, 8] of group C -> [..., N] in index order."""
    TG = regs.shape[-2]
    out = torch.empty(regs.shape[:-2] + (8 * TG,), dtype=torch.int64)
    out[..., owned(C, TG).reshape(-1)] = regs.reshape(*regs.shape[:-2], -1)
    return out


@pytest.mark.parametrize("lane", [0, 1])
@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_merged_forward_and_inverse_equal_ntt(N, lane):
    primes = primes_of(N)
    q = primes[lane]
    fw, fws, iw, iws = tables(N, lane, *primes)
    rng = np.random.default_rng(N + lane)
    x = torch.from_numpy(rng.integers(0, q, (3, N)))
    x[0, :4] = torch.tensor([0, q - 1, 1, q // 2])
    got = scatter(forward_regs(x.clone(), q, fw, fws), 2) % q
    assert torch.equal(got, ntt.forward(x, q))
    # the forward also takes lazy inputs below 4q
    lazy = x + q * torch.from_numpy(rng.integers(0, 4, (3, N)))
    lazy = torch.where(lazy < 4 * q, lazy, x)
    assert torch.equal(scatter(forward_regs(lazy, q, fw, fws), 2) % q, got)

    y = torch.from_numpy(rng.integers(0, q, (3, N)))
    y_lazy = y + q * torch.from_numpy(rng.integers(0, 2, (3, N)))   # < 2q
    regs = y_lazy[..., owned(2, N // 8)]
    got = csub(scatter(inverse_regs(regs, q, iw, iws), groups(N.bit_length() - 1)[0][0]), q)
    assert torch.equal(got, ntt.inverse(y, q))


@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_register_exchanges_are_conflict_free_bijections(N):
    """Every group's layout covers each index once, every warp's access to a
    swizzled buffer hits 32 banks, and a block-wide barrier is needed only
    where a group with C > 7 takes part. At N = 8192 and 16384 the N/8
    threads are the P = N / 4096 blocks of a lane (rank = thread bits
    9 .. 8 + log2 P): each block's words (those bits of j in group 0, the
    top log2 P bits in the others) fill its part of the buffer once with
    them dropped (cluster.cuh's drop_rank in group 0), banks unchanged, so
    that only the exchange between groups 0 and 1 crosses blocks, and there
    register k of group 1, or of group 0 in the inverse, lies in block
    k >> (3 - log2 P)."""
    TG = N // 8
    phys = swz(torch.arange(N))
    assert torch.equal(phys.sort().values, torch.arange(N))
    grp = groups(N.bit_length() - 1)
    for C, _, _ in grp:
        j = owned(C, TG)
        assert torch.equal(j.reshape(-1).sort().values, torch.arange(N))
        for w in range(0, TG, 32):
            for k in range(8):
                assert len(set((swz(j[w:w + 32, k]) % 32).tolist())) == 32
    for (c_a, _, _), (c_b, _, _) in zip(grp, grp[1:]):
        ja, jb = owned(c_a, TG), owned(c_b, TG)
        warp_of = torch.empty(N, dtype=torch.int64)
        warp_of[ja.reshape(-1)] = (torch.arange(TG)[:, None] // 32).expand(TG, 8).reshape(-1)
        same_warp = torch.equal(warp_of[jb], (torch.arange(TG)[:, None] // 32).expand(TG, 8))
        assert same_warp == (max(c_a, c_b) <= 7)
    if N < 8192:
        return
    P = N // 4096
    lp = P.bit_length() - 1
    rank = torch.arange(TG)[:, None] >> 9                            # [TG, 1]
    k = torch.arange(8)[None, :]
    for g, (C, _, _) in enumerate(grp):
        j = owned(C, TG)
        bit = 9 if g == 0 else 12
        assert torch.equal(j >> bit & (P - 1), rank.expand(TG, 8))   # the block's words
        if g == 1:                                                   # the forward's crossing
            assert torch.equal(j >> 9 & (P - 1), (k >> (3 - lp)).expand(TG, 8))
        if g == 0:                                                   # the inverse's
            assert torch.equal(j >> 12 & (P - 1), (k >> (3 - lp)).expand(TG, 8))
        for r in range(P):
            s = swz(j[r * TG // P:(r + 1) * TG // P])
            word = ((s >> (bit + lp)) << bit) | (s & ((1 << bit) - 1))
            if g == 0:
                assert torch.equal(word, drop_rank(s, P))
            assert torch.equal(word.reshape(-1).sort().values, torch.arange(N // P))
            assert torch.equal(word % 32, s % 32)


def extract(d, g_bits):
    base = 1 << g_bits
    r = d & (base - 1)
    r = torch.where(r >= base >> 1, r - base, r)
    return r, (d - r) >> g_bits


def centred_digits(r1, r2, q1, q2, g_bits, throw, digits):
    """The kernel's Garner CRT of the lane residues r1, r2, centred, the
    thrown digits dropped -> the `digits` balanced digits kept."""
    c12 = pow(q2, -1, q1)
    c12_sh = (c12 << 32) // q1
    Q = q1 * q2
    diff = torch.where(r1 >= r2, r1 - r2, r1 + q1 - r2)
    c = csub(mulmod_lazy(diff, c12, c12_sh, q1), q1)
    xv = r2 + q2 * c
    d = torch.where(xv >= Q >> 1, xv - Q, xv)
    for _ in range(throw):
        _, d = extract(d, g_bits)
    digs = []
    for _ in range(digits):
        rr, d = extract(d, g_bits)
        digs.append(rr)
    return digs


def lane_round(a, digs, key, lane, q, m_pos):
    """One lane's round after the digits: a [B, 2, TG, 8] its accumulator at
    coefficient t + k N/8, digs the signed digits [B, 2, TG, 8] of both
    polynomials per kept digit, key [4 d2, N] the lane's rows of the round,
    m_pos [B] the exponents -> the new accumulator [B, 2, TG, 8]."""
    B, _, TG, _ = a.shape
    N = 8 * TG
    d2 = key.shape[0] // 4
    fw, fws, iw, iws = tables(N, lane)
    grp = groups(N.bit_length() - 1)
    red_sh = int(fws[0])
    u = None
    for l, dig in enumerate(digs):
        dig = torch.where(dig < 0, dig + q, dig)
        x = forward_regs(scatter(dig, grp[0][0]), q, fw, fws)   # [B, 2, TG, 8]
        pts = torch.arange(TG)[:, None] * 8 + torch.arange(8)[None, :]
        ks = key[:, pts].reshape(4, d2, TG, 8)
        s0, s1 = ks[:, 2 * l], ks[:, 2 * l + 1]
        v0, v1 = umulhi(s0 + 1, q), umulhi(s1 + 1, q)
        p = (mulmod_lazy(x[:, None, 0], v0, s0, q)
             + mulmod_lazy(x[:, None, 1], v1, s1, q))        # [B, 4, TG, 8]
        u = p if u is None else u + p
        in_range(u, 1 << 32)
    u = u - umulhi(u, red_sh) * q
    u = csub(inverse_regs(u, q, iw, iws), q)                   # [B, 4, TG, 8]
    out = scatter(u, grp[0][0])                                # [B, 4, N]
    j = owned(grp[0][0], TG)
    m_pos = m_pos.to(torch.int64)[:, None, None]
    m_neg = (2 * N - m_pos) & (2 * N - 1)
    a = a.clone()
    for o in range(2):
        r0 = (j - m_pos) & (2 * N - 1)
        r1_ = (j - m_neg) & (2 * N - 1)
        c0 = torch.gather(out[:, o], 1, (r0 & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
        c1 = torch.gather(out[:, 2 + o], 1, (r1_ & (N - 1)).reshape(B, -1)).reshape(B, TG, 8)
        v0 = torch.where(r0 < N, c0, q - c0)
        v1 = torch.where(r1_ < N, c1, q - c1)
        s = a[:, o] + v0 + (q - u[:, o]) + v1 + (q - u[:, 2 + o])
        in_range(s, 5 * q)
        a[:, o] = csub(csub(csub(s, 4 * q), 2 * q), q)
    return a


def emulate_rotation(acc1, acc2, a_idx, key, q1, q2, base_g, throw):
    """What every block of the kernel computes, for all blocks at once:
    acc [B, 2, N], a_idx [B, n], key [n, 8 d2, N] int32 as from pack_bsk_rns;
    q1, q2 are Q1, Q2 (the tables')."""
    B, _, N = acc1.shape
    n, rows, _ = key.shape
    d2, TG, g_bits = rows // 8, N // 8, base_g.bit_length() - 1
    C0 = groups(N.bit_length() - 1)[0][0]
    acc = [acc1.to(torch.int64), acc2.to(torch.int64)]
    key = key.to(torch.int64) & M32
    pos0 = owned(C0, TG)                         # coefficient t + k N/8
    for r in range(n):
        digs = centred_digits(acc[0][..., pos0], acc[1][..., pos0], q1, q2, g_bits,
                              throw, d2 // 2)    # [B, 2, TG, 8] each
        acc = [scatter(lane_round(acc[lane][..., pos0], digs,
                                  key[r, lane * 4 * d2:(lane + 1) * 4 * d2], lane,
                                  (q1, q2)[lane], a_idx[:, r]), C0)
               for lane in range(2)]
    return acc[0].to(torch.int32), acc[1].to(torch.int32)


def drop_rank(j, P):
    """The word of j in its owner's part when the owner is bits
    9 .. 8 + log2 P of j (cluster.cuh's drop_rank)."""
    lp = P.bit_length() - 1
    return ((j >> (9 + lp)) << 9) | (j & 511)


# The N >= 8192 kernel's buffers in a block's shared memory, in units of
# S = 4096 words (N / P): the output lies over the crossing's and the
# forward's buffers; 11 S in all.
LAYOUT_8192 = {"acc": 0, "digits": 2, "inverse": 3, "crossing": 7, "forward": 9,
               "output": 7}


def emulate_lane_blocks(acc1, acc2, a_idx, key, q1, q2, base_g, throw, P, layout=None,
                        block_barriers=()):
    """The kernel's layout at N = 4096 P (P = 2 or 4 blocks a residue
    lane): one ciphertext on a cluster of 2 P blocks of 512 threads, rank =
    P lane + part, logical thread t = part * 512 + threadIdx.x of the lane's
    N/8. Each block's shared memory [B, 11 S] words (S = N / P = 4096) is
    its own tensor, its buffers at `layout` (LAYOUT_8192 unless given); a
    word of another block is read from that block's tensor. A block holds
    the words of the lane's polynomials whose owner bits (bits
    9 .. 8 + log2 P of j in register group 0, the top log2 P bits after) are
    its part, at drop_rank of the word in group 0.

    Each block runs as a generator that stops at every cluster barrier:
    after the load; per kept digit, after the digits are written (A_l,
    "digits") and in the forward's crossing (B_l, "forward"); in the
    inverse's crossing (C, "inverse"); after the output is written (E,
    "output"); at the round's end (F, "round"). At each, block 0 runs on to
    its next barrier, then block 1, and so on, so a block reads another's
    buffers after that block has written whatever it writes before the next
    barrier: the latest such a read can come. Barriers inside a block are
    not modelled. A barrier named in `block_barriers` is a block barrier,
    which no other block waits for; a block that leaves zeroes its shared
    memory."""
    B, _, N = acc1.shape
    n, rows, _ = key.shape
    d2, S, TB, TG = rows // 8, N // P, 512, N // 8
    digits, g_bits = d2 // 2, base_g.bit_length() - 1
    grp = groups(N.bit_length() - 1)
    assert len(grp) == 5 and S == 4096 and P in (2, 4)
    at = {name: S * v for name, v in (layout or LAYOUT_8192).items()}
    key = (key.to(torch.int64) & M32).reshape(n, 2, 4, d2, N)
    smem = [torch.full((B, 11 * S), -1, dtype=torch.int64) for _ in range(2 * P)]
    result = [None] * (2 * P)
    tid = torch.arange(TB)
    sums_w = (8 * (tid & ~31) + (tid & 31))[:, None] + 32 * torch.arange(8)   # [TB, 8]

    def barrier(name):
        return name not in block_barriers

    def write(rank, base, words, regs):
        """regs [B, NP, TB, 8] to block rank's words base + p S + words."""
        for p in range(regs.shape[1]):
            smem[rank][:, base + p * S + words.reshape(-1)] = regs[:, p].reshape(B, -1)

    def read(ranks, owner, base, words, NP):
        """[B, NP, TB, 8] from the words base + p S + words, each element
        from block ranks[owner] (owner [TB, 8] in [0, len(ranks)))."""
        out = []
        for p in range(NP):
            w = (base + p * S + words).reshape(-1)
            vals = torch.stack([smem[r][:, w] for r in ranks])              # [R, B, W]
            got = vals.gather(0, owner.reshape(1, 1, -1).expand(1, B, -1))[0]
            out.append(got.reshape(B, TB, 8))
        return torch.stack(out, 1)

    def block(rank):
        lane, part = rank // P, rank % P
        q = (q1, q2)[lane]
        fw, fws, iw, iws = tables(N, lane, q1, q2)
        red_sh = int(fws[0])
        parts = tuple(lane * P + i for i in range(P))         # this lane's blocks
        t = part * TB + tid
        js = [owned(C, TG)[t] for C, _, _ in grp]             # [TB, 8] per group
        w0 = drop_rank(js[0], P)                               # register k's word
        mine = torch.zeros((TB, 8), dtype=torch.int64)

        def local(C_from, C_to, regs, base):
            """A block-local exchange in the block's part (top bits dropped)."""
            write(rank, base, swz(owned(C_from, TG)[t]) & (S - 1), regs)
            return read((rank,), mine, base, swz(owned(C_to, TG)[t]) & (S - 1), regs.shape[1])

        lane_acc = (acc1, acc2)[lane].to(torch.int64)
        for o in range(2):
            smem[rank][:, at["acc"] + o * S + w0.reshape(-1)] = lane_acc[:, o, js[0].reshape(-1)]
        yield                                                  # after the load
        for r in range(n):
            own = smem[rank][:, at["acc"] + lane * S + w0]
            other = smem[rank ^ P][:, at["acc"] + lane * S + w0]
            r1, r2 = (own, other) if lane == 0 else (other, own)
            digs = centred_digits(r1, r2, q1, q2, g_bits, throw, digits)
            u = None
            for l in range(digits):
                smem[rank][:, at["digits"] + w0] = digs[l]
                if barrier("digits"):
                    yield                                      # A_l
                own = smem[rank][:, at["digits"] + w0]
                other = smem[rank ^ P][:, at["digits"] + w0]
                x = torch.stack((own, other) if lane == 0 else (other, own), 1)
                x = fwd_group(torch.where(x < 0, x + q, x), js[0], *grp[0][1:], q, fw, fws)
                write(rank, at["crossing"], drop_rank(swz(js[0]), P), x)
                if barrier("forward"):
                    yield                                      # B_l
                x = read(parts, js[1] >> 9 & (P - 1), at["crossing"],
                         drop_rank(swz(js[1]), P), 2)
                x = fwd_group(x, js[1], *grp[1][1:], q, fw, fws)
                for g in range(2, 5):
                    x = local(grp[g - 1][0], grp[g][0], x, at["forward"])
                    x = fwd_group(x, js[g], *grp[g][1:], q, fw, fws)
                s0 = key[r, lane, :, 2 * l][:, js[4]]          # [4, TB, 8]
                s1 = key[r, lane, :, 2 * l + 1][:, js[4]]
                v0, v1 = umulhi(s0 + 1, q), umulhi(s1 + 1, q)
                p = (mulmod_lazy(x[:, None, 0], v0, s0, q)
                     + mulmod_lazy(x[:, None, 1], v1, s1, q))  # [B, 4, TB, 8]
                if l:
                    p = p + read((rank,), mine, at["inverse"], sums_w, 4)
                in_range(p, 1 << 32)
                if l + 1 < digits:
                    write(rank, at["inverse"], sums_w, p)
                else:
                    u = p
            u = u - umulhi(u, red_sh) * q
            u = inv_group(u, js[4], *grp[4][1:], q, iw, iws)
            for g in range(3, 0, -1):
                u = local(grp[g + 1][0], grp[g][0], u, at["inverse"])
                u = inv_group(u, js[g], *grp[g][1:], q, iw, iws)
            write(rank, at["inverse"], swz(js[1]) & (S - 1), u)
            if barrier("inverse"):
                yield                                          # C
            u = read(parts, js[0] >> 12 & (P - 1), at["inverse"], swz(js[0]) & (S - 1), 4)
            u = csub(inv_group(u, js[0], *grp[0][1:], q, iw, iws), q)
            write(rank, at["output"], w0, u)
            if barrier("output"):
                yield                                          # E
            m_pos = a_idx[:, r].to(torch.int64)[:, None, None]
            m_neg = (2 * N - m_pos) & (2 * N - 1)
            for o in range(2):
                v = []
                for ko, m in ((o, m_pos), (2 + o, m_neg)):
                    rot = (js[0] - m) & (2 * N - 1)             # [B, TB, 8]
                    c = (rot & (N - 1)).reshape(B, -1)
                    w = at["output"] + ko * S + drop_rank(c, P)
                    vals = torch.stack([torch.gather(smem[h], 1, w) for h in parts])
                    got = vals.gather(0, (c >> 9 & (P - 1))[None])[0].reshape(B, TB, 8)
                    v.append(torch.where(rot < N, got, q - got))
                a = smem[rank][:, at["acc"] + o * S + w0]
                s_ = a + v[0] + (q - u[:, o]) + v[1] + (q - u[:, 2 + o])
                in_range(s_, 5 * q)
                smem[rank][:, at["acc"] + o * S + w0] = csub(csub(csub(s_, 4 * q), 2 * q), q)
            if barrier("round"):
                yield                                          # F
        result[rank] = torch.stack([smem[rank][:, at["acc"] + o * S + w0] for o in range(2)], 1)
        smem[rank].zero_()                                     # the block leaves

    running = [block(rank) for rank in range(2 * P)]
    while running:
        for g in list(running):
            try:
                next(g)
            except StopIteration:
                running.remove(g)
    out = [torch.empty((B, 2, N), dtype=torch.int64) for _ in range(2)]
    for rank in range(2 * P):
        t = (rank % P) * TB + tid
        j = owned(grp[0][0], TG)[t].reshape(-1)
        out[rank // P][..., j] = result[rank].reshape(B, 2, -1)
    return out[0].to(torch.int32), out[1].to(torch.int32)


def emulate_cluster_rotation(acc1, acc2, a_idx, key, q1, q2, base_g, throw, **hazard):
    """The kernel's cluster layouts. N = 8192 and 16384: `emulate_lane_blocks`
    with P = 2 and 4 blocks a lane. N = 4096: a cluster of two blocks, rank =
    residue lane, each with its own shared memory, laid out as the kernel
    lays it out (words: accumulator [2][N] at 0, the forward's buffer at
    2N, the digits [2 parities][N] at 4N, the inverse's output at 6N and
    its buffer at 10N; 14N in all). A read of the peer is a read of the
    other block's array at the same word. Rank r takes polynomial r in the
    CRT, reading its own lane's residue and the peer's; each rank writes
    its polynomial's digit l at parity l mod 2 and, after the cluster
    barrier, reads its own and the peer's. Both ranks finish a step before
    either starts the next, as the cluster barriers order them."""
    B, _, N = acc1.shape
    if N >= 8192:
        return emulate_lane_blocks(acc1, acc2, a_idx, key, q1, q2, base_g, throw, N // 4096,
                                   **hazard)
    n, rows, _ = key.shape
    d2, TG, g_bits = rows // 8, N // 8, base_g.bit_length() - 1
    C0 = groups(N.bit_length() - 1)[0][0]
    key = key.to(torch.int64) & M32
    pos0 = owned(C0, TG)
    flat = lambda off: off + pos0                # noqa: E731  words t + k N/8 at off
    smem = [torch.full((B, 14 * N), -1, dtype=torch.int64) for _ in range(2)]
    for rank, a in enumerate((acc1, acc2)):
        smem[rank][:, :2 * N] = a.to(torch.int64).reshape(B, 2 * N)
    for r in range(n):
        mine = []
        for rank in range(2):
            own = smem[rank][:, flat(rank * N)]
            other = smem[rank ^ 1][:, flat(rank * N)]
            r1, r2 = (other, own) if rank else (own, other)
            mine.append(centred_digits(r1, r2, q1, q2, g_bits, throw, d2 // 2))
        digs = [[], []]
        for l in range(d2 // 2):
            at = 4 * N + (l & 1) * N
            for rank in range(2):
                smem[rank][:, flat(at)] = mine[rank][l]
            for rank in range(2):
                own, other = smem[rank][:, flat(at)], smem[rank ^ 1][:, flat(at)]
                digs[rank].append(torch.stack((other, own) if rank else (own, other), 1))
        for rank in range(2):
            a = torch.stack([smem[rank][:, flat(o * N)] for o in range(2)], 1)
            a = lane_round(a, digs[rank], key[r, rank * 4 * d2:(rank + 1) * 4 * d2], rank,
                           (q1, q2)[rank], a_idx[:, r])
            for o in range(2):
                smem[rank][:, flat(o * N)] = a[:, o]
    return tuple(smem[rank][:, :2 * N].reshape(B, 2, N).to(torch.int32) for rank in range(2))


@pytest.mark.parametrize("N,d2,throw,base_log", [(256, 4, 1, 18), (512, 2, 1, 27),
                                                  (256, 6, 0, 9), (1024, 8, 0, 7),
                                                  (4096, 2, 1, 27)])
def test_emulated_kernel_round_equals_plain(N, d2, throw, base_log):
    q1, q2 = Q1, Q2
    B, n = 3, 2
    rng = np.random.default_rng(N + d2)
    acc = [torch.from_numpy(rng.integers(0, qi, (B, 2, N)).astype(np.int32)) for qi in (q1, q2)]
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[0] = [0, 2 * N - 1]
    a_idx[1] = [N, 1]
    a_idx = torch.from_numpy(a_idx)
    bsk = rng.integers(0, q1 * q2, (n, 2, d2, 2, N)).astype(np.uint64)
    key = rotate_rns_kernel.pack_bsk_rns(bsk, q1, q2)
    want = blindrotate_rns.blind_rotate_rns(*acc, a_idx, key, q1, q2, 1 << base_log, throw)
    got = emulate_rotation(*acc, a_idx, key, q1, q2, 1 << base_log, throw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def cluster_inputs(N, d2, seed, B=2, n=2):
    """acc1, acc2, a_idx and a pack_bsk_rns key at the ring's primes; row 0
    of the exponents holds 0 and 2N - 1."""
    q1, q2 = primes_of(N)
    rng = np.random.default_rng(seed)
    acc = [torch.from_numpy(rng.integers(0, qi, (B, 2, N)).astype(np.int32)) for qi in (q1, q2)]
    a_idx = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32))
    a_idx[0, :2] = torch.tensor([0, 2 * N - 1])
    bsk = rng.integers(0, q1 * q2, (n, 2, d2, 2, N)).astype(np.uint64)
    return acc, a_idx, rotate_rns_kernel.pack_bsk_rns(bsk, q1, q2), q1, q2


@pytest.mark.parametrize("N,d2,throw,base_log", [
    (4096, 4, 1, 18), (4096, 2, 1, 27), (8192, 4, 1, 18), (8192, 2, 1, 27),
    (8192, 8, 0, 7), (16384, 4, 1, 18), (16384, 2, 1, 27), (16384, 8, 0, 7)],
    ids=["base18", "base27", "N8192-base18", "N8192-base27", "N8192-base7-throw0",
         "N16384-base18", "N16384-base27", "N16384-base7-throw0"])
def test_emulated_cluster_round_equals_plain(N, d2, throw, base_log):
    """N = 4096: the two blocks of a cluster, each reading the peer's
    residues and digits; N = 8192 and 16384: the four and eight blocks, two
    and four a lane, also crossing inside each transform and in the rotated
    reads. All give the plain rotation, and a block's buffers fit the 227 KB
    it may use."""
    words = 14 * N if N == 4096 else 11 * 4096
    assert words * 4 + 4 <= 232448
    acc, a_idx, key, q1, q2 = cluster_inputs(N, d2, base_log if N == 4096 else N + d2)
    want = blindrotate_rns.blind_rotate_rns(*acc, a_idx, key, q1, q2, 1 << base_log, throw)
    got = emulate_cluster_rotation(*acc, a_idx, key, q1, q2, 1 << base_log, throw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("hazard", ["output over the inverse's buffer",
                                    "digits over the crossing's buffer",
                                    "crossing over the forward's buffer",
                                    "digits' barrier in the block",
                                    "round's barrier in the block"])
def test_four_block_hazards_show_in_the_emulation(hazard):
    """N = 8192: the emulated cluster equals the plain version only with the
    kernel's layout and barriers. The output written over the inverse's
    buffer overwrites words the lane's other block still reads in the
    inverse's crossing; the digits in the crossing's buffer are overwritten
    by the crossing while the other lane's block still reads them; one
    buffer for the crossing and the forward lets a block's forward overwrite
    crossing words the lane's other block still reads; a block barrier in
    place of A_l lets a block read the other lane's digits before they are
    written, and one in place of F its accumulator before the round has
    updated it (and lets a block leave while another reads it)."""
    N, d2, throw, base_g = 8192, 4, 1, 1 << 18
    acc, a_idx, key, q1, q2 = cluster_inputs(N, d2, seed=17)
    want = blindrotate_rns.blind_rotate_rns(*acc, a_idx, key, q1, q2, base_g, throw)
    layout = dict(LAYOUT_8192)
    kw = {}
    if hazard == "output over the inverse's buffer":
        layout["output"] = layout["inverse"]
    elif hazard == "digits over the crossing's buffer":
        layout["digits"] = layout["crossing"]
    elif hazard == "crossing over the forward's buffer":
        layout["crossing"] = layout["forward"]
    else:
        kw["block_barriers"] = ("digits",) if hazard.startswith("digits") else ("round",)
    got = emulate_cluster_rotation(*acc, a_idx, key, q1, q2, base_g, throw, layout=layout, **kw)
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


@pytest.fixture(scope="module")
def eight_block_case():
    """The eight-block hazard cases' inputs at N = 16384, base 2^18, d2 = 4,
    one digit thrown, and the plain result, which the emulation without a
    hazard gives on them."""
    N, d2, throw, base_g = 16384, 4, 1, 1 << 18
    acc, a_idx, key, q1, q2 = cluster_inputs(N, d2, seed=16384)
    args = (*acc, a_idx, key, q1, q2, base_g, throw)
    want = blindrotate_rns.blind_rotate_rns(*args)
    got = emulate_cluster_rotation(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return args, want


@pytest.mark.parametrize("hazard", ["output over the inverse's buffer",
                                    "digits over the crossing's buffer",
                                    "crossing over the forward's buffer",
                                    "digits", "forward", "inverse", "output", "round"],
                         ids=["output-over-inverse", "digits-over-crossing",
                              "crossing-over-forward", "A-in-the-block", "B-in-the-block",
                              "C-in-the-block", "E-in-the-block", "F-in-the-block"])
def test_eight_block_hazards_show_in_the_emulation(eight_block_case, hazard):
    """N = 16384, four blocks a lane: the emulated cluster equals the plain
    version only with the kernel's layout and all five cluster barriers a
    round. The three layouts of the four-block case go wrong here too, and
    a block barrier in place of any of A_l, B_l, C, E or F lets a block
    read another's words before they are written (F: also the accumulator
    before the round has updated it). A case counts a wrong result or a
    value out of its lazy range (`OutOfRange`), nothing else."""
    args, want = eight_block_case
    layout, kw = dict(LAYOUT_8192), {}
    if hazard == "output over the inverse's buffer":
        layout["output"] = layout["inverse"]
    elif hazard == "digits over the crossing's buffer":
        layout["digits"] = layout["crossing"]
    elif hazard == "crossing over the forward's buffer":
        layout["crossing"] = layout["forward"]
    else:
        kw["block_barriers"] = (hazard,)
    try:
        got = emulate_cluster_rotation(*args, layout=layout, **kw)
    except OutOfRange:
        return                  # a word read too early left the lazy ranges
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))


@pytest.mark.parametrize("q", [Q1, Q2, 134215681, 268369921])
def test_key_values_from_companions(q):
    """The kernels rebuild a key value as hi32((b' + 1) q), the plain
    version as hi32(b' q) + (lo32(b' q) != 0): equal for every companion
    b' = floor(b 2^32 / q) of a value b < q, at the RNS primes and the gate
    sets' moduli (Q1 is also STD256Q's)."""
    b = torch.from_numpy(np.random.default_rng(q).integers(0, q, 1 << 16))
    b = torch.cat([b, torch.tensor([0, 1, q - 2, q - 1])])
    sh = (b << 32) // q
    key = torch.where(sh < 1 << 31, sh, sh - (1 << 32)).to(torch.int32)
    key = key.expand(1, 8, -1).contiguous()          # one round, d2 = 1
    plain = blindrotate_rns.key_values(key, q, q)[0].reshape(4, -1)[0]
    assert torch.equal(plain, b)
    assert torch.equal(umulhi(sh + 1, q), b)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """A library's name changes with any header in csrc/, so an edit to a
    shared header never loads a stale build."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    first = _build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path("k") != first
    assert os.path.basename(first).startswith("k-")
