"""The port's RNS blind rotation (plain version, kernel wrapper, key layout)
against tfhe_tpu.ops.pallas_rotate_rns and the two-limb XLA rotation
tfhe_tpu.ops.blindrotate64, exactly.

The Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it. The CUDA kernel itself runs only on the card (chip_smoke.py); here
`rotate_rns_kernel.rotate_rns` is given CPU tensors and takes the plain
version."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.ops import pallas_rotate_rns as prr
from tfhe_tpu.ops.blindrotate64 import build_blind_rotate64
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.utils.numtheory import ntt_prime, previous_prime
from tfhe_tpu_torch.ops import modmath, rotate_rns_kernel
from torch_threads import one_torch_thread  # noqa: F401

N, n, B = 128, 5, 8
Q1 = ntt_prime(27, 2 * N)
Q2 = previous_prime(Q1, 2 * N)
BASE_G, DIGITS = 1 << 20, 3


def case(throw, seed=7):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, Q1 * Q2, (B, 2, N)).astype(np.uint64)
    acc[0, 0, :4] = [0, Q1 * Q2 - 1, (Q1 * Q2) >> 1, ((Q1 * Q2) >> 1) - 1]
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    d2 = 2 * (DIGITS - throw)
    bsk_coeff = rng.integers(0, Q1 * Q2, (n, 2, d2, 2, N)).astype(np.uint64)
    return acc, a_idx, bsk_coeff


def port_rotate(acc, a_idx, bsk_coeff, throw):
    """The port's rotation, CRT-combined to uint64 residues mod Q1*Q2."""
    lanes = [torch.from_numpy((acc % np.uint64(q)).astype(np.int32)) for q in (Q1, Q2)]
    o1, o2 = rotate_rns_kernel.rotate_rns(
        *lanes, torch.from_numpy(a_idx),
        rotate_rns_kernel.pack_bsk_rns(bsk_coeff, Q1, Q2), Q1, Q2, BASE_G, throw)
    return (o1.numpy(), o2.numpy(),
            modmath.crt_combine(o1.long(), o2.long(), Q1, Q2).numpy().astype(np.uint64))


@pytest.mark.parametrize("throw", [0, 1])
def test_rotate_rns_matches_pallas_kernel(throw):
    acc, a_idx, bsk_coeff = case(throw)
    rfn = prr.build_pallas_rotate_rns(N, Q1, Q2, BASE_G, DIGITS - throw, throw,
                                      n, BT=8, bt=4)
    w1, w2 = rfn((acc % np.uint64(Q1)).astype(np.uint32),
                 (acc % np.uint64(Q2)).astype(np.uint32),
                 a_idx, prr.pack_bsk_rns(bsk_coeff, Q1, Q2))
    o1, o2, _ = port_rotate(acc, a_idx, bsk_coeff, throw)
    assert np.array_equal(o1, np.asarray(w1).astype(np.int32))
    assert np.array_equal(o2, np.asarray(w2).astype(np.int32))


@pytest.mark.parametrize("throw", [0, 1])
def test_rotate_rns_matches_two_limb_rotation(throw):
    """At the same composite Q, after CRT: the XLA twin with 64-bit pairs."""
    acc, a_idx, bsk_coeff = case(throw, seed=8)
    Q = Q1 * Q2
    bsk_hat = ref_ntt.forward(bsk_coeff, Q)
    blo, bhi = mm64.pack_host(bsk_hat)
    slo, shi = mm64.shoup64(bsk_hat, Q)
    fn = build_blind_rotate64(N, Q, BASE_G, DIGITS - throw, throw, n)
    want = fn(*mm64.pack_host(acc), a_idx, blo, bhi, slo, shi)
    want = mm64.unpack_host(np.asarray(want[0]), np.asarray(want[1]))
    assert np.array_equal(port_rotate(acc, a_idx, bsk_coeff, throw)[2], want)


@pytest.mark.parametrize("throw", [0, 1])
def test_pack_bsk_rns_is_the_pallas_layout(throw):
    _, _, bsk_coeff = case(throw, seed=9)
    got = rotate_rns_kernel.pack_bsk_rns(bsk_coeff, Q1, Q2)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint32),
                          prr.pack_bsk_rns(bsk_coeff, Q1, Q2))


def test_rotate_rns_refuses_other_devices_and_parameters():
    acc, a_idx, bsk_coeff = case(1)
    key = rotate_rns_kernel.pack_bsk_rns(bsk_coeff, Q1, Q2)
    meta = torch.empty((B, 2, N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        rotate_rns_kernel.rotate_rns(meta, meta, torch.from_numpy(a_idx), key,
                                     Q1, Q2, BASE_G)
    with pytest.raises(ValueError):
        rotate_rns_kernel.check_params(N, 4, Q1, Q2, BASE_G)     # N < 256
    with pytest.raises(ValueError):
        rotate_rns_kernel.check_params(256, 4, Q2, Q1, BASE_G)   # q1 < q2
    with pytest.raises(ValueError):
        rotate_rns_kernel.check_params(256, 4, Q1, Q2, 3 << 20)  # not 2^k
    rotate_rns_kernel.check_params(2048, 4, Q1, Q2, 1 << 18)


def test_cpu_rotate_rns_does_not_count_launches():
    acc, a_idx, bsk_coeff = case(1)
    before = rotate_rns_kernel.LAUNCHES
    port_rotate(acc, a_idx, bsk_coeff, 1)
    assert rotate_rns_kernel.LAUNCHES == before
