"""tfhe_tpu_torch.ops.modmath against tfhe_tpu.ops.modmath32, exactly.

Inputs are made with numpy from a seed, run through the jnp (uint32)
function and its int64 torch port, and compared with tolerance 0: the
arithmetic is modular and exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.ops import modmath32 as mm32
from tfhe_tpu.params import ParamSet, from_param_set
from tfhe_tpu_torch.ops import modmath as mm

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
