"""The port's 64-bit slice against the JAX package's two-limb code, exactly:
the arithmetic (tfhe_tpu.ops.modmath64, the Pallas kernel's lazy Shoup
product), the NTT (tfhe_tpu.ref.ntt), the plain rotation with the kernel's
key layout (tfhe_tpu.ops.pallas_rotate64 in interpret mode, as
tests/test_pallas.py runs it, and tfhe_tpu.ops.blindrotate64) and the key
switch from a big Q (tfhe_tpu.ops.keyswitch32.build_mkm_switch_from64).

Inputs are made with numpy from a seed and compared with tolerance 0. The
CUDA kernel itself runs only on the card (chip_smoke.py); here
`rotate64_kernel.rotate64` is given CPU tensors and takes the plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.ops import pallas_rotate64 as pr64
from tfhe_tpu.ops.blindrotate64 import build_blind_rotate64
from tfhe_tpu.ops.keyswitch32 import build_mkm_switch_from64, pack_ksk
from tfhe_tpu.params import ParamSet, from_param_set
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.utils.numtheory import ntt_prime
from tfhe_tpu_torch.ops import keyswitch, ntt, rotate64_kernel
from tfhe_tpu_torch.ops import modmath as mm
from tfhe_tpu_torch.ops.ntt_sched import schedule
from torch_threads import one_torch_thread  # noqa: F401

Q54 = ntt_prime(54, 4096)                       # the reference's 54-bit prime
PRIMES = [Q54, from_param_set(ParamSet.STD128Q).lwe.Q,
          from_param_set(ParamSet.STD192).lwe.Q]
IDS = ["q54", "std128q", "std192"]


def residues(Q, size=2048, seed=0):
    """Random residues mod Q plus the edges 0, 1 and Q - 1."""
    x = np.random.default_rng(seed).integers(0, Q, size, dtype=np.int64)
    x[:3] = [0, 1, Q - 1]
    return x


def u64_words(size, seed):
    """Random 64-bit words (int64 bit patterns), with 0, 2^63 - 1 and
    2^64 - 1 among them."""
    x = np.random.default_rng(seed).integers(-(1 << 63), (1 << 63) - 1, size,
                                             dtype=np.int64, endpoint=True)
    x[:3] = [0, (1 << 63) - 1, -1]
    return x


def pair(x):
    """int64 bit patterns -> the JAX package's (lo, hi) uint32 pair."""
    return tuple(jnp.asarray(h) for h in mm64.pack_host(x.view(np.uint64)))


def unpair(p):
    return mm64.unpack_host(np.asarray(p[0]), np.asarray(p[1])).view(np.int64)


@pytest.mark.parametrize("Q", PRIMES, ids=IDS)
def test_shoup64_matches_jax(Q):
    b = residues(Q, seed=1)
    got = mm.shoup64(b, Q)
    assert np.array_equal(got.view(np.uint64), mm64.unpack_host(*mm64.shoup64(b, Q)))
    # the companion of Q - 1 is the largest, 2^64 - ceil(2^64 / Q): its top
    # bit is set, so its int64 view is negative
    assert int(got[2].view(np.uint64)) == ((Q - 1) << 64) // Q and got[2] < 0


@pytest.mark.parametrize("Q", PRIMES, ids=IDS)
def test_mulhi64_is_the_high_word(Q):
    a, b = u64_words(512, 2), u64_words(512, 3)
    got = mm.mulhi64(torch.from_numpy(a), torch.from_numpy(b)).numpy().view(np.uint64)
    want = [(int(x) * int(y)) >> 64 for x, y in zip(a.view(np.uint64), b.view(np.uint64))]
    assert [int(g) for g in got] == want
    want_q = [(int(x) * Q) >> 64 for x in a.view(np.uint64)]
    assert [int(g) for g in mm.mulhi64(torch.from_numpy(a), Q).numpy().view(np.uint64)] == want_q


@pytest.mark.parametrize("Q", PRIMES, ids=IDS)
def test_mulmod_shoup64_matches_jax(Q):
    a, w = residues(Q, seed=4), residues(Q, seed=5)[::-1].copy()
    w_sh = mm.shoup64(w, Q)
    got = mm.mulmod_shoup64(torch.from_numpy(a), torch.from_numpy(w),
                            torch.from_numpy(w_sh), Q)
    want = mm64.mulmod_shoup64(pair(a), pair(w), pair(w_sh), Q)
    assert np.array_equal(got.numpy(), unpair(want))


@pytest.mark.parametrize("Q", PRIMES, ids=IDS)
def test_lazy_shoup64_matches_pallas_for_any_word(Q):
    """[0, 2Q) for any 64-bit a, as the kernel's lazy product."""
    a, w = u64_words(2048, 6), residues(Q, seed=7)
    w_sh = mm.shoup64(w, Q)
    got = mm.mulmod_shoup64_lazy(torch.from_numpy(a), torch.from_numpy(w),
                                 torch.from_numpy(w_sh), Q).numpy()
    want = unpair(pr64._mulmod_shoup64_lazy(pair(a), pair(w), pair(w_sh), Q))
    assert np.array_equal(got, want)
    assert got.min() >= 0 and got.max() < 2 * Q


@pytest.mark.parametrize("Q", PRIMES, ids=IDS)
def test_values_rebuilt_from_companions(Q):
    w = residues(Q, seed=8)
    sh = torch.from_numpy(mm.shoup64(w, Q))
    assert np.array_equal(mm.shoup64_values(sh, Q).numpy(), w)


@pytest.mark.parametrize("N", [16, 256])
@pytest.mark.parametrize("Q", [Q54, PRIMES[1]], ids=IDS[:2])
def test_ntt64_matches_reference_and_roundtrips(N, Q):
    if (Q - 1) % (2 * N):
        Q = ntt_prime(Q.bit_length(), 2 * N)
    rng = np.random.default_rng(9)
    x = rng.integers(0, Q, (5, N)).astype(np.uint64)
    x[0, :2] = [0, Q - 1]
    got = ntt.forward(torch.from_numpy(x.astype(np.int64)), Q)
    bitrev = schedule(N, Q)["bitrev"]
    assert np.array_equal(got.numpy()[..., bitrev], ref_ntt.forward(x, Q).astype(np.int64))
    assert np.array_equal(ntt.inverse(got, Q).numpy(), x.astype(np.int64))


# tests/test_pallas.py:53-80's shapes, so a whole run shares its compiles
N, n, B = 128, 5, 8
QR = ntt_prime(54, 2 * N)
BASE_G, DIGITS = 1 << 20, 3


def rotation_case(throw):
    """acc, a_idx, the key in the coefficient domain (as the port packs it)
    and its host NTT mod QR (as the JAX package's packers take it)."""
    rng = np.random.default_rng(5)
    acc = rng.integers(0, QR, (B, 2, N)).astype(np.uint64)
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    d2 = 2 * (DIGITS - throw)
    bsk_coeff = rng.integers(0, QR, (n, 2, d2, 2, N)).astype(np.uint64)
    return acc, a_idx, bsk_coeff, ref_ntt.forward(bsk_coeff, QR)


def port_rotate64(acc, a_idx, bsk_coeff, throw):
    out = rotate64_kernel.rotate64(
        torch.from_numpy(acc.astype(np.int64)), torch.from_numpy(a_idx),
        rotate64_kernel.pack_bsk64(bsk_coeff, QR), QR, BASE_G, throw)
    return out.numpy().astype(np.uint64)


@pytest.mark.parametrize("throw", [0, 1])
def test_rotate64_matches_pallas_and_xla(throw):
    """throw 0 against the XLA rotation, throw 1 against the Pallas kernel
    in interpret mode: tests/test_pallas.py holds the two equal to each
    other on these same inputs at both throws, so each case covers both."""
    acc, a_idx, bsk_coeff, bsk_hat = rotation_case(throw)
    alo, ahi = mm64.pack_host(acc)
    got = port_rotate64(acc, a_idx, bsk_coeff, throw)
    if throw:
        pfn = pr64.build_pallas_rotate64(N, QR, BASE_G, DIGITS - throw, throw, n, BT=8, bt=4)
        want = pfn(alo, ahi, a_idx, pr64.pack_bsk64(bsk_hat, QR))
    else:
        fn = build_blind_rotate64(N, QR, BASE_G, DIGITS - throw, throw, n)
        want = fn(alo, ahi, a_idx, *mm64.pack_host(bsk_hat), *mm64.shoup64(bsk_hat, QR))
    assert np.array_equal(got, mm64.unpack_host(np.asarray(want[0]), np.asarray(want[1])))


@pytest.mark.parametrize("throw", [0, 1])
def test_pack_bsk64_is_the_pallas_layout(throw):
    """One int64 row per companion where Pallas keeps a lo row, then a hi
    row 4*d2 rows later: the port's packer, which runs the NTT mod Q and
    the companions in torch, on the coefficient-domain key equals the JAX
    package's on its host NTT."""
    _, _, bsk_coeff, bsk_hat = rotation_case(throw)
    got = rotate64_kernel.pack_bsk64(bsk_coeff, QR)
    assert got.dtype == torch.int64 and got.is_contiguous()
    want = pr64.pack_bsk64(bsk_hat, QR)
    lo, hi = np.split(want, 2, axis=1)
    assert np.array_equal(got.numpy().view(np.uint64), mm64.unpack_host(lo, hi))


def test_pack_bsk64_on_the_cpu_at_n8192_is_the_pallas_layout():
    """A key packed on the CPU device at N = 8192 and TOY's single prime
    there (ntt_prime(54, 16384), d2 = 4: base 2^18, one of three digits
    thrown), two rounds, equals the JAX package's packer; so do the
    companions alone (`modmath.shoup64_tensor`, 9-bit long division) at the edges."""
    Q8, N8 = ntt_prime(54, 16384), 8192
    bsk_coeff = np.random.default_rng(8192).integers(0, Q8, (2, 2, 4, 2, N8)).astype(np.uint64)
    got = rotate64_kernel.pack_bsk64(bsk_coeff, Q8, device="cpu")
    assert got.device.type == "cpu" and got.shape == (2, 16, N8)
    lo, hi = np.split(pr64.pack_bsk64(ref_ntt.forward(bsk_coeff, Q8), Q8), 2, axis=1)
    assert np.array_equal(got.numpy().view(np.uint64), mm64.unpack_host(lo, hi))
    b = residues(Q8)
    want = mm64.unpack_host(*mm64.shoup64(b.view(np.uint64), Q8))
    assert np.array_equal(mm.shoup64_tensor(torch.from_numpy(b), Q8).numpy(),
                          want.view(np.int64))


def test_rotate64_refuses_other_devices_and_parameters():
    acc, a_idx, bsk_coeff, _ = rotation_case(1)
    key = rotate64_kernel.pack_bsk64(bsk_coeff, QR)
    meta = torch.empty((B, 2, N), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rotate64_kernel.rotate64(meta, torch.from_numpy(a_idx), key, QR, BASE_G)
    with pytest.raises(ValueError):
        rotate64_kernel.check_params(N, 4, QR, BASE_G)              # N < 256
    with pytest.raises(ValueError):
        rotate64_kernel.check_params(256, 4, 1 << 55, BASE_G)       # Q >= 2^54
    with pytest.raises(ValueError):
        rotate64_kernel.check_params(256, 4, QR, 3 << 20)           # not 2^k
    rotate64_kernel.check_params(2048, 8, Q54, 1 << 27)


def test_cpu_rotate64_does_not_count_launches():
    acc, a_idx, bsk_coeff, _ = rotation_case(1)
    before = rotate64_kernel.LAUNCHES
    port_rotate64(acc, a_idx, bsk_coeff, 1)
    assert rotate64_kernel.LAUNCHES == before


@pytest.mark.parametrize("param_set", [ParamSet.STD192, ParamSet.STD128Q],
                         ids=lambda s: s.name)
def test_mkm_switch_from_big_q_matches_jax(param_set):
    """STD192: baseKS = 28 (not a power of two), dc = 4, qKS = 2^19;
    STD128Q: baseKS = 32, dc = 5, qKS = 2^25; Q of 37 and 50 bits. Full
    widths but the LWE dimension, which is cut to 8."""
    p = from_param_set(param_set).lwe
    nn, Bk, dc = 8, 4, p.digit_count_ks
    rng = np.random.default_rng(10)
    ksk_a = rng.integers(0, p.q_ks, (p.N, p.base_ks, dc, nn)).astype(np.uint64)
    ksk_b = rng.integers(0, p.q_ks, (p.N, p.base_ks, dc)).astype(np.uint64)
    a_ext = rng.integers(0, p.Q, (Bk, p.N)).astype(np.uint64)
    b_ext = rng.integers(0, p.Q, Bk).astype(np.uint64)
    a_ext[0, :3] = [0, p.Q - 1, p.Q >> 1]
    b_ext[:2] = [p.Q - 1, 0]
    table = keyswitch.ksk_table(ksk_a, ksk_b)
    got = keyswitch.mkm_switch(torch.from_numpy(a_ext.astype(np.int64)),
                               torch.from_numpy(b_ext.astype(np.int64)), table,
                               p.Q, p.q_ks, p.base_ks, dc, p.q)
    fn = build_mkm_switch_from64(p.N, p.Q, p.q_ks, p.base_ks, dc, nn, p.q)
    want = fn(*mm64.pack_host(a_ext), *mm64.pack_host(b_ext),
              pack_ksk(ksk_a.reshape(-1, nn), ksk_b.reshape(-1), p.q_ks))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
