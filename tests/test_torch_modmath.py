"""tfhe_tpu_torch.ops.modmath against tfhe_tpu.ops.modmath32 (and, for the
RNS path, modmath64, the JAX backend's CRT and the host oracle's
Python-int RoundqQ), exactly.

Inputs are made with numpy from a seed, run through the jnp (uint32)
function and its int64 torch port, and compared with tolerance 0: the
arithmetic is modular and exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import modmath32 as mm32
from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.ops.backend import _crt_combine_pair
from tfhe_tpu.ref import modmath as ref_mm
from tfhe_tpu.params import ParamSet, from_gpu_style, from_param_set
from tfhe_tpu_torch.ops import modmath as mm
from torch_threads import one_torch_thread  # noqa: F401

Q_STD128 = from_param_set(ParamSet.STD128).lwe.Q
Q_TOY = from_param_set(ParamSet.TOY).lwe.Q
MODULI = [Q_STD128, Q_TOY, 1 << 14, 1021]


def residues(Q, size=4096, seed=0):
    """Random residues mod Q plus the edges 0, 1 and Q - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size, dtype=np.int64)
    x[:3] = [0, 1, Q - 1]
    return x


def jax_np(x):
    return np.asarray(x).astype(np.int64)


def torch_np(x):
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("Q", MODULI)
@pytest.mark.parametrize("op", ["addmod", "submod"])
def test_binary_ops(Q, op):
    a, b = residues(Q, seed=1), residues(Q, seed=2)[::-1].copy()
    want = getattr(mm32, op)(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32), Q)
    got = getattr(mm, op)(torch.from_numpy(a), torch.from_numpy(b), Q)
    assert np.array_equal(torch_np(got), jax_np(want))


@pytest.mark.parametrize("Q", MODULI)
def test_negmod(Q):
    a = residues(Q, seed=3)
    want = mm32.negmod(jnp.asarray(a, jnp.uint32), Q)
    assert np.array_equal(torch_np(mm.negmod(torch.from_numpy(a), Q)), jax_np(want))


@pytest.mark.parametrize("Q", MODULI)
def test_mod_of_any_u32(Q):
    """Reduction of lazy values: the whole u32 range, including 2^32 - 1
    and the largest lazy external-product sum (2Q - 1) * 8."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    x[:4] = [0, Q - 1, (1 << 32) - 1, min((2 * Q - 1) * 8, (1 << 32) - 1)]
    want = mm32.mod_u32(jnp.asarray(x.astype(np.uint32)), Q)
    assert np.array_equal(torch_np(mm.mod(torch.from_numpy(x), Q)), jax_np(want))


@pytest.mark.parametrize("Q", MODULI)
def test_shoup(Q):
    b = residues(Q, seed=5)
    assert np.array_equal(torch_np(mm.shoup(torch.from_numpy(b), Q)),
                          mm32.shoup(b.astype(np.uint64), Q).astype(np.int64))


@pytest.mark.parametrize("q,Q", [
    (1 << 14, Q_STD128),   # ModSwitch Q -> qKS, STD128
    (1024, 1 << 14),       # ModSwitch qKS -> fmod, STD128
    (512, Q_TOY),          # ModSwitch qKS = Q -> fmod, TOY
    (Q_TOY, Q_TOY),        # identity
])
def test_round_q_Q(q, Q):
    v = residues(Q, seed=6)
    want = mm32.round_q_Q(jnp.asarray(v, jnp.uint32), q, Q)
    got = mm.round_q_Q(torch.from_numpy(v), q, Q)
    assert np.array_equal(torch_np(got), jax_np(want))


# -- the RNS path's 64-bit helpers ---------------------------------------

Q1_RNS, Q2_RNS = from_gpu_style(ParamSet.STD128, True, 12).rgsw.rns_primes
Q_RNS = Q1_RNS * Q2_RNS


def big_residues(Q, size=4096, seed=0):
    """Random residues mod Q < 2^56, the edges 0, 1, Q - 1, and values on
    both sides of the rounding ties v*q/Q = k + 1/2 for q = 2^35."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size, dtype=np.int64)
    ties = [(2 * int(k) + 1) * Q // (2 << 35) for k in rng.integers(0, 1 << 35, 16)]
    edges = [0, 1, Q - 1, Q // 2, Q // 2 + 1] + [t + d for t in ties for d in (-1, 0, 1)]
    x[:len(edges)] = edges
    return x


@pytest.mark.parametrize("q,Q", [
    (1 << 35, Q_RNS),          # ModSwitch Q -> qKS, accelerated sets
    (1 << 35, (1 << 55) - 55), # the largest Q the float estimate is held to
    (4096, 1 << 35),           # qKS -> fmod: the exact int64 path
    ((1 << 40) - 87, Q_RNS),
])
def test_round_q_Q_big(q, Q):
    v = big_residues(Q, seed=7)
    got = mm.round_q_Q(torch.from_numpy(v), q, Q).numpy()
    want = ref_mm.round_q_Q(v.astype(object), q, Q)
    assert np.array_equal(got, np.asarray(want, dtype=np.int64))
    if q < (1 << 62) and Q < (1 << 62) and q != Q:
        lo, hi = mm64.round_q_Q64(mm64.pack_host(v.astype(np.uint64)), q, Q)
        assert np.array_equal(got, mm64.unpack_host(np.asarray(lo), np.asarray(hi))
                              .astype(np.int64))


def test_crt_combine_matches_jax():
    x = big_residues(Q_RNS, seed=8)
    r1, r2 = x % Q1_RNS, x % Q2_RNS
    got = mm.crt_combine(torch.from_numpy(r1), torch.from_numpy(r2), Q1_RNS, Q2_RNS)
    assert np.array_equal(got.numpy(), x)
    lo, hi = _crt_combine_pair(jnp.asarray(r1, jnp.uint32), jnp.asarray(r2, jnp.uint32),
                               Q1_RNS, Q2_RNS)
    assert np.array_equal(mm64.unpack_host(np.asarray(lo), np.asarray(hi)).astype(np.int64), x)


@pytest.mark.parametrize("Q", [1 << 35, 1 << 14, Q_TOY])
def test_mod_masks_powers_of_two(Q):
    x = np.random.default_rng(9).integers(-(1 << 62), 1 << 62, 4096, dtype=np.int64)
    assert np.array_equal(mm.mod(torch.from_numpy(x), Q).numpy(), x % Q)
