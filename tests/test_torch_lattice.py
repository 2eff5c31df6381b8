"""The port's lattice utilities (`utils/field2n.py`, `dgg_generic.py`,
`dgsampling.py`, `trapdoor.py`) against their twins in the JAX package on
the same seeds: samples with `np.array_equal`, `Field2n` values with
`np.array_equal` too (the same numpy expressions on the same inputs). The
cases are those of tests/test_dgg_generic.py, test_dgsampling.py and
test_trapdoor.py, at their sizes or smaller; each also checks the property
the JAX package's test checks, on the port's output."""

import numpy as np
import pytest

from tfhe_tpu.utils import dgg_generic as jax_dgg
from tfhe_tpu.utils import dgsampling as jax_dgs
from tfhe_tpu.utils import field2n as jax_f2n
from tfhe_tpu.utils import trapdoor as jax_td
from tfhe_tpu.utils.rng import BinFHERng as JaxRng
from tfhe_tpu_torch.utils import dgg_generic as dgg
from tfhe_tpu_torch.utils import dgsampling as dgs
from tfhe_tpu_torch.utils import field2n as f2n
from tfhe_tpu_torch.utils import trapdoor as td
from tfhe_tpu_torch.utils.numtheory import ntt_prime
from tfhe_tpu_torch.utils.rng import BinFHERng


def twins(fn):
    """fn(module set, rng) on the port and on the JAX package, each with a
    numpy generator of the same seed."""
    port = fn(dgg, dgs, f2n, np.random.default_rng(11))
    ref = fn(jax_dgg, jax_dgs, jax_f2n, np.random.default_rng(11))
    return port, ref


def near(x, center, sigma, nse=6.0):
    n = len(x)
    return (abs(x.mean() - center) < nse * sigma / np.sqrt(n)
            and abs(x.std() - sigma) < nse * sigma / np.sqrt(2 * n))


def negacyclic(a, b):
    n = len(a)
    full = np.convolve(a, b)
    out = full[:n].copy()
    out[:n - 1] -= full[n:]
    return out


# -- field2n ---------------------------------------------------------------

def field_ops(F, a, b):
    """Every Field2n operation of the JAX package's tests on a and b."""
    fa, fb = F.Field2n(a), F.Field2n(b)
    ea, eb = fa.to_eval(), fb.to_eval()
    return {
        "eval": ea.v, "roundtrip": ea.to_coeff().v,
        "prod": (ea * eb).to_coeff().v, "scalar": (fa * 2.5).v,
        "sum": (fa + fb).v, "diff": (ea - eb).v, "neg": (-fa).v,
        "add_const": (fa + 3.0).v, "inverse": ea.inverse().v,
        "shift": fa.shift_right().v, "t_coeff": fa.transpose().v,
        "t_eval": ea.transpose().v,
        **{f"auto{i}": ea.automorphism(i).v for i in (3, 5, 2 * len(a) - 1)},
        "even": fa.extract_even().v, "odd": fa.extract_odd().v,
        "perm": fa.permute().v, "unperm": fa.permute().inverse_permute().v,
        "ints": F.inverse_permute_ints(np.arange(len(a))),
    }


@pytest.mark.parametrize("n", [8, 16])
def test_field2n_matches_jax(n):
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=n), rng.normal(size=n)
    got, want = field_ops(f2n, a, b), field_ops(jax_f2n, a, b)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    np.testing.assert_allclose(got["roundtrip"].real, a, atol=1e-10)
    np.testing.assert_allclose(got["prod"].real, negacyclic(a, b), atol=1e-8)
    np.testing.assert_allclose(got["unperm"], a)
    with pytest.raises(ValueError):
        f2n.Field2n(a).inverse()
    with pytest.raises(ValueError):
        f2n.Field2n(a).to_eval().automorphism(2)


# -- dgg_generic -----------------------------------------------------------

@pytest.mark.parametrize("center,sigma", [(0.0, 34.0), (5.37, 34.0), (-2.25, 50.0),
                                          (0.4, 2.0)])
def test_base_sampler_matches_jax(center, sigma):
    got, want = twins(lambda G, S, F, r: G.BaseSampler(center, sigma).sample(r, 40000))
    assert np.array_equal(got, want)
    assert near(got, center, sigma)


@pytest.mark.parametrize("center,sigma", [(0.0, 40.0), (1.75, 64.0), (-123.4, 200.0)])
def test_generic_sampler_matches_jax(center, sigma):
    got, want = twins(lambda G, S, F, r: G.GenericSampler().sample(r, center, sigma, 30000))
    assert np.array_equal(got, want)
    assert near(got, center, sigma)


def test_generic_sampler_vector_centers_and_contracts():
    centers = np.linspace(-3.0, 3.0, 20000)
    got, want = twins(lambda G, S, F, r: G.GenericSampler().sample(r, centers, 48.0))
    assert np.array_equal(got, want) and got.shape == centers.shape
    assert near(got - centers, 0.0, 48.0)
    for G in (dgg, jax_dgg):
        with pytest.raises(ValueError):
            G.GenericSampler(sigma_b=10.0, eta=6.0)
        g = G.GenericSampler()
        with pytest.raises(ValueError):
            g.sample(np.random.default_rng(0), 0.0, g.min_sigma * 0.5, 16)


@pytest.mark.parametrize("center,sigma", [(0.0, 7.5), (1.3, 3.19), (-41.7, 119.0),
                                          (0.4, 2.0)])
def test_karney_matches_jax(center, sigma):
    got, want = twins(lambda G, S, F, r: G.karney(r, center, sigma, 60000))
    assert np.array_equal(got, want)
    assert near(got, center, sigma)


def test_karney_reads_binfhe_rng_stream_alike():
    """Karney's sampler on `BinFHERng`'s uniform stream, vector centers."""
    centers = np.linspace(-5.0, 5.0, 4096)
    got = dgg.karney(BinFHERng(19), centers, 3.19)
    want = jax_dgg.karney(JaxRng(19), centers, 3.19)
    assert np.array_equal(got, want)


# -- dgsampling ------------------------------------------------------------

@pytest.mark.parametrize("q,base,n,continuous", [
    (1019 * 1021, 4, 64, False), (12289, 2, 256, False), (786433, 2, 32, True)])
def test_gauss_samp_gq_matches_jax(q, base, n, continuous):
    k = int(np.ceil(np.log(q) / np.log(base)))
    v = np.random.default_rng(q).integers(0, q, n)

    def run(G, S, F, r):
        return S.gauss_samp_gq(v, (base + 1) * S.SIGMA, k, q, base, r,
                               continuous=continuous)

    got, want = twins(run)
    assert np.array_equal(got, want)
    recon = sum((base ** t) * got[t].astype(object) for t in range(k))
    assert all((int(x) - int(y)) % q == 0 for x, y in zip(recon, v))
    assert np.abs(got).max() < 40 * base * dgs.SIGMA


def test_zsample_and_spectral_bound_match_jax():
    n = 8
    f = np.zeros(n)
    f[0] = 900.0

    def run(G, S, F, r):
        return np.stack([S.zsample_f(F.Field2n(f), F.Field2n(np.zeros(n)), r)
                         for _ in range(200)])

    got, want = twins(run)
    assert np.array_equal(got, want)
    assert dgs.spectral_bound(512, 10, 2) == jax_dgs.spectral_bound(512, 10, 2)
    assert dgs.spectral_bound(512, 10, 2) > 3 * dgs.SIGMA
    a, b, d = np.zeros((3, n))
    a[0], b[0], d[0] = 900.0, 30.0, 800.0       # a positive definite block
    c = np.random.default_rng(3).normal(size=(2, n))

    def run2(G, S, F, r):
        ev = [F.Field2n(x).to_eval() for x in (a, b, d)]
        return S.zsample_sigma_2x2(*ev, (F.Field2n(c[0]), F.Field2n(c[1])), r)

    got, want = twins(run2)
    assert np.array_equal(got, want)


# -- trapdoor --------------------------------------------------------------

@pytest.fixture(scope="module")
def trapdoors():
    """The JAX test's trapdoor (N = 64, a 20-bit prime, base 4) from the
    same seed in both packages, with their generators after it."""
    N, Q = 64, ntt_prime(20, 128)
    rng, jrng = BinFHERng(77), JaxRng(77)
    return rng, td.trapdoor_gen(rng, N, Q, base=4), jrng, jax_td.trapdoor_gen(jrng, N, Q, base=4)


def test_trapdoor_gen_matches_jax(trapdoors):
    _, trap, _, jtrap = trapdoors
    for name in ("A", "r", "e"):
        assert np.array_equal(getattr(trap, name), getattr(jtrap, name)), name
    assert (trap.N, trap.Q, trap.base, trap.k) == (jtrap.N, jtrap.Q, jtrap.base, jtrap.k)


@pytest.mark.parametrize("spherical", [False, True])
def test_gauss_samp_matches_jax(trapdoors, spherical):
    rng, trap, jrng, jtrap = trapdoors
    u, ju = rng.discrete_uniform(trap.N, trap.Q), jrng.discrete_uniform(trap.N, trap.Q)
    assert np.array_equal(u, ju)
    x = td.gauss_samp(rng, trap, u, spherical=spherical)
    assert np.array_equal(x, jax_td.gauss_samp(jrng, jtrap, ju, spherical=spherical))
    assert np.array_equal(td.apply_A(trap, x), np.asarray(u, dtype=np.uint64))
    assert np.array_equal(td.apply_A(trap, x), jax_td.apply_A(jtrap, x))
    bound = (trap.Q // 64 if spherical
             else 8 * dgs.spectral_bound(trap.N, trap.k, trap.base))
    assert np.abs(x).max() < bound
