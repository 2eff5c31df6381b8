"""tfhe_tpu_torch.ops.ntt against the JAX package's permutation-free
schedule (ntt_sched.apply_*_np) and the host NTT (ref.ntt), exactly."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import ntt_sched as ns
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.utils.numtheory import ntt_prime
from tfhe_tpu_torch.ops import ntt
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("N", [16, 256])
def test_forward_matches_schedule_and_reference(N):
    Q = ntt_prime(27, 2 * N)
    x = np.random.default_rng(1).integers(0, Q, (5, N)).astype(np.uint64)
    got = ntt.forward(torch.from_numpy(x.astype(np.int64)), Q).numpy()
    assert np.array_equal(got, ns.apply_forward_np(x, N, Q).astype(np.int64))
    bitrev = ns.schedule(N, Q)["bitrev"]
    assert np.array_equal(got[..., bitrev], ref_ntt.forward(x, Q).astype(np.int64))


@pytest.mark.parametrize("N", [16, 256])
def test_inverse_matches_schedule_and_roundtrips(N):
    Q = ntt_prime(27, 2 * N)
    rng = np.random.default_rng(2)
    y = rng.integers(0, Q, (5, N)).astype(np.uint64)
    got = ntt.inverse(torch.from_numpy(y.astype(np.int64)), Q).numpy()
    assert np.array_equal(got, ns.apply_inverse_np(y, N, Q).astype(np.int64))
    x = torch.from_numpy(rng.integers(0, Q, (3, 2, N)))
    assert torch.equal(ntt.inverse(ntt.forward(x, Q), Q), x)


@pytest.mark.parametrize("N", [16, 256])
def test_tables_are_the_schedule_compacted(N):
    """Twiddle row entry h + t is the schedule's stage vector at lane h + t."""
    Q = ntt_prime(27, 2 * N)
    sch, tab = ns.schedule(N, Q), ntt.tables(N, Q)
    assert np.array_equal(tab[0], sch["twist"])
    assert np.array_equal(tab[3], sch["untwist"])
    for k in range(N.bit_length() - 1):
        h = N >> (k + 1)
        assert np.array_equal(tab[1, h:2 * h], sch["fwd_w"][k][h:2 * h])
        h = 1 << k
        assert np.array_equal(tab[2, h:2 * h], sch["inv_w"][k][h:2 * h])
