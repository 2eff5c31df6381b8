"""The port's blind rotation (plain version, kernel wrapper, key layout)
against tfhe_tpu.ops.blindrotate32 and the Pallas kernel, exactly.

The Pallas kernel runs in interpret mode on the CPU, as tests/test_pallas.py
runs it. The CUDA kernel itself runs only on the card (chip_smoke.py); here
`rotate_kernel.rotate` is given CPU tensors and takes the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import blindrotate32 as br32
from tfhe_tpu.ops import modmath32 as mm32
from tfhe_tpu.ops import pallas_rotate as pr
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.utils.numtheory import ntt_prime
from tfhe_tpu_torch.ops import blindrotate, rotate_kernel
from torch_threads import one_torch_thread  # noqa: F401

N, n, B = 128, 6, 16
Q = ntt_prime(27, 2 * N)
BASE_G, DIGITS = 1 << 9, 3


def case(throw, seed=3):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, Q, (B, 2, N)).astype(np.uint32)
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    d2 = 2 * (DIGITS - throw)
    bsk_hat = ref_ntt.forward(
        rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64), Q)
    return acc, a_idx, bsk_hat


def port_rotate(acc, a_idx, bsk_hat, throw):
    return rotate_kernel.rotate(
        torch.from_numpy(acc.astype(np.int32)), torch.from_numpy(a_idx),
        rotate_kernel.pack_bsk(bsk_hat, Q), Q, BASE_G, throw).numpy()


@pytest.mark.parametrize("throw", [0, 1])
def test_rotate_matches_jnp_blind_rotate(throw):
    acc, a_idx, bsk_hat = case(throw)
    fn = br32.build_blind_rotate(N, Q, BASE_G, DIGITS - throw, throw, n)
    want = np.asarray(fn(acc, a_idx, bsk_hat.astype(np.uint32),
                         mm32.shoup(bsk_hat, Q)))
    assert np.array_equal(port_rotate(acc, a_idx, bsk_hat, throw),
                          want.astype(np.int32))


@pytest.mark.parametrize("throw", [0, 1])
def test_rotate_matches_pallas_kernel(throw):
    acc, a_idx, bsk_hat = case(throw, seed=4)
    pfn = pr.build_pallas_rotate(N, Q, BASE_G, DIGITS - throw, throw, n,
                                 BT=8, bt=4)
    want = np.asarray(pfn(acc, a_idx, pr.pack_bsk(bsk_hat, Q)))
    assert np.array_equal(port_rotate(acc, a_idx, bsk_hat, throw),
                          want.astype(np.int32))


@pytest.mark.parametrize("throw", [0, 1])
def test_pack_bsk_is_the_pallas_layout(throw):
    _, _, bsk_hat = case(throw)
    got = rotate_kernel.pack_bsk(bsk_hat, Q)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint32), pr.pack_bsk(bsk_hat, Q))


@pytest.mark.parametrize("throw", [0, 1])
def test_decompose_matches_jnp(throw):
    acc, _, _ = case(throw, seed=5)
    want = br32._decompose(jnp.asarray(acc), Q, BASE_G, DIGITS - throw, throw)
    got = blindrotate.decompose(torch.from_numpy(acc.astype(np.int64)), Q,
                                BASE_G, DIGITS - throw, throw)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_rotate_sub_matches_jnp():
    rng = np.random.default_rng(6)
    c = rng.integers(0, Q, (B, 2, N)).astype(np.uint32)
    m = rng.integers(0, 2 * N, B).astype(np.int32)
    m[:4] = [0, 1, N, 2 * N - 1]
    want = br32._rotate_sub(jnp.asarray(c), jnp.asarray(m), Q)
    got = blindrotate.rotate_sub(torch.from_numpy(c.astype(np.int64)),
                                 torch.from_numpy(m.astype(np.int64)), Q)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_transpose_extract_matches_jnp():
    acc = np.random.default_rng(7).integers(0, Q, (B, 2, N)).astype(np.uint32)
    acc[0, 0] = 0
    want_a, want_b = br32.transpose_extract(jnp.asarray(acc), Q)
    got_a, got_b = blindrotate.transpose_extract(
        torch.from_numpy(acc.astype(np.int64)), Q)
    assert np.array_equal(got_a.numpy(), np.asarray(want_a).astype(np.int64))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b).astype(np.int64))


def test_rotate_refuses_other_devices():
    acc, a_idx, bsk_hat = case(0)
    with pytest.raises(ValueError):
        rotate_kernel.rotate(torch.empty((B, 2, N), dtype=torch.int32, device="meta"),
                             torch.from_numpy(a_idx),
                             rotate_kernel.pack_bsk(bsk_hat, Q), Q, BASE_G)


def test_cpu_rotate_does_not_count_launches():
    acc, a_idx, bsk_hat = case(0)
    before = rotate_kernel.LAUNCHES
    port_rotate(acc, a_idx, bsk_hat, 0)
    assert rotate_kernel.LAUNCHES == before
