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
each ciphertext on a cluster of two blocks, and the emulation keeps the two
blocks' shared memory apart and lets one block run ahead of the other to
the next cluster barrier, so that a buffer reused too early, or a block
that leaves too soon, shows as a wrong result."""

import numpy as np
import pytest
import torch
from chip_smoke import rotate64_cases
from test_torch_ntt_merged import M32, extract, groups, owned, scatter, swz, twiddle_index
from test_torch_ntt_merged import exchange as exchange32

from tfhe_tpu_torch.ops import blindrotate64, ntt, rotate64_kernel
from tfhe_tpu_torch.ops.modmath import mulhi64, shoup64, shoup64_values
from torch_threads import one_torch_thread  # noqa: F401

CASES = rotate64_cases()                        # name -> (N, Q, base, d2, throw)
MODULI = sorted({(Q, N) for N, Q, *_ in CASES.values()})


def mulmod_lazy(a, w, w_sh, q):
    """a * w - hi64(a * w_sh) * q in wrapping u64 (int64 bits), as the kernel."""
    return a * w - mulhi64(a, w_sh) * q


def csub(x, c):
    """min(x, x - c) in u64, as the kernel computes it; every operand here
    lies below 2^63, where the unsigned minimum is this one."""
    assert (x >= 0).all()
    y = x - c
    return torch.where(y < 0, x, y)


def tables(N, q):
    """The uploaded table [2, N, 2] as rows fwd, fwd', inv, inv'."""
    tw = rotate64_kernel._twiddles(N, q, "cpu")
    return tw[0, :, 0], tw[0, :, 1], tw[1, :, 0], tw[1, :, 1]


def exchange(regs, N, c_from, c_to):
    """Registers [..., TG, 8] of u64 through the two swizzled u32 planes."""
    lo = exchange32(regs & M32, N, c_from, c_to)
    hi = exchange32(regs >> 32 & M32, N, c_from, c_to)
    return lo | hi << 32


def forward_regs(x, q, fw, fws):
    """Natural-order coefficients [..., N] (< 4q) -> the last group's
    registers [..., TG, 8]: point 8t + k, values < 4q."""
    N = x.shape[-1]
    grp = groups(N.bit_length() - 1)
    regs = x[..., owned(grp[0][0], N // 8)]
    for g, (C, top, lo) in enumerate(grp):
        if g:
            regs = exchange(regs, N, grp[g - 1][0], C)
        j = owned(C, N // 8)
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
        assert ((regs >= 0) & (regs < 4 * q)).all()
    return regs


def inverse_regs(regs, q, iw, iws):
    """The last group's registers [..., TG, 8] (< 2q) -> group 0's:
    coefficient t + k N/8, values < 2q."""
    N = regs.shape[-2] * 8
    logn = N.bit_length() - 1
    grp = groups(logn)
    for g in range(len(grp) - 1, -1, -1):
        C, top, lo = grp[g]
        if g < len(grp) - 1:
            regs = exchange(regs, N, grp[g + 1][0], C)
        j = owned(C, N // 8)
        for b in range(lo, top + 1):
            r = b - lo
            for k in range(8):
                if k >> r & 1:
                    continue
                k2 = k | 1 << r
                idx = twiddle_index(N, j[:, 0], k >> (r + 1), b)
                u, v = regs[..., k].clone(), regs[..., k2].clone()
                if b == logn - 1:
                    regs[..., k] = mulmod_lazy(u + v, iw[0], iws[0], q)
                else:
                    regs[..., k] = csub(u + v, 2 * q)
                regs[..., k2] = mulmod_lazy(u + 2 * q - v, iw[idx], iws[idx], q)
        assert ((regs >= 0) & (regs < 2 * q)).all()
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
    default N > 2048).

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
