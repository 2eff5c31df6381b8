"""The ring-sharded NTT and CKKS multiplication (`parallel/limb_ntt.py`) on
a ("limb",) mesh of D in {2, 4, 8} shards, all on "cpu" (a mesh may name one
device more than once), against the JAX package: the forward transform
equal to `ops/ntt_sched.apply_forward_np`, the inverse to
`apply_inverse_np`, and `CKKSRnsContext.eval_mult_limb` equal tower for
tower to the JAX package's host `eval_mult` on keys and ciphertexts carried
across (`ks_limb_bits` 28: the whole multiplication sharded; 30: the key
switch on the gathered towers). tests/test_limb_ntt.py holds the JAX
package's own `eval_mult_limb` to that same `eval_mult`. At D = 2 the
exchanges of +-shift land on one shard, so only D >= 4 tells their
directions apart."""

import numpy as np
import pytest

from tfhe_tpu.ops.ntt_sched import apply_forward_np, apply_inverse_np
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxRnsContext
from tfhe_tpu.pke.dcrt import DCRTParams as JaxDCRTParams
from tfhe_tpu.utils.numtheory import ntt_prime
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.parallel import limb_ntt
from tfhe_tpu_torch.parallel.mesh import Mesh
from tfhe_tpu_torch.pke.ckks import CKKSContext
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from torch_threads import one_torch_thread  # noqa: F401


def mesh(D: int) -> Mesh:
    return Mesh(["cpu"] * D, "limb")


def run(build, N, Q, m, x):
    return limb_ntt.join(build(N, Q, m)(limb_ntt.scatter(m, x))).numpy().astype(np.uint64)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("N", [1 << 10, 1 << 13])
def test_limb_ntt_matches_schedule(N, D):
    Q = ntt_prime(27, 2 * N)
    x = np.random.default_rng(4).integers(0, Q, N).astype(np.uint64)
    got = run(limb_ntt.build_limb_ntt, N, Q, mesh(D), x)
    np.testing.assert_array_equal(got, apply_forward_np(x, N, Q))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_limb_intt_round_trip(D):
    N = 1 << 10
    Q = ntt_prime(29, 2 * N)
    x = np.random.default_rng(5).integers(0, Q, N).astype(np.uint64)
    fwd = run(limb_ntt.build_limb_ntt, N, Q, mesh(D), x)
    back = run(limb_ntt.build_limb_intt, N, Q, mesh(D), fwd)
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(back, apply_inverse_np(fwd, N, Q))


def test_refusals_match_jax():
    """Moduli of 2^30 and above are refused, as the JAX module asserts; so
    is a ring that does not split into shards of an even size."""
    with pytest.raises(AssertionError):
        limb_ntt.build_limb_ntt(1 << 10, ntt_prime(31, 1 << 11), mesh(2))
    with pytest.raises(ValueError):
        limb_ntt.build_limb_ntt(16, ntt_prime(20, 32), mesh(16))


@pytest.fixture(scope="module", params=[28, 30], ids=["ks28-sharded", "ks30-gathered"])
def ckks(request):
    """The JAX package's contexts at N = 64, L = 3 (28-bit limbs, the
    sizes of tests/test_limb_ntt.py), the port's on the same keys, and two
    ciphertexts carried across."""
    N = 64
    p = JaxCKKSParams(N=N, dcrt=JaxDCRTParams.create(N, 3, 28), scale=float(1 << 28))
    jc = JaxCKKSContext(p, seed=33)
    jsk, jpk = jc.key_gen()
    jr = JaxRnsContext(jc, dnum=2, ks_limb_bits=request.param)
    jkeys = jr.relin_key_gen(jsk)
    rng = np.random.default_rng(6)
    zs = [rng.normal(size=jc.params.slots) * 0.5 for _ in range(2)]
    jcts = [jc.encrypt(jpk, z) for z in zs]
    c = CKKSContext(convert.ckks_params_from(p), seed=33)
    r = CKKSRnsContext(c, dnum=2, ks_limb_bits=request.param)
    keys = {L: convert.hybrid_key_from(k) for L, k in jkeys.items()}
    cts = [convert.ckks_ciphertext_from(x, c.params) for x in jcts]
    return dict(jr=jr, jkeys=jkeys, jcts=jcts, c=c, r=r, keys=keys, cts=cts, zs=zs,
                sk=convert.ckks_secret_from(jsk))


def same_towers(a, b) -> bool:
    return len(a.polys) == len(b.polys) and all(
        np.array_equal(np.asarray(x.to_eval().rns, dtype=np.uint64),
                       np.asarray(y.to_eval().rns, dtype=np.uint64))
        for x, y in zip(a.polys, b.polys))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_eval_mult_limb_matches_jax_eval_mult(ckks, D):
    k = ckks
    want = k["jr"].eval_mult(*k["jcts"], k["jkeys"])
    got = k["r"].eval_mult_limb(*k["cts"], k["keys"], mesh(D))
    assert same_towers(got, want) and got.scale == want.scale
    assert same_towers(got, k["r"].eval_mult(*k["cts"], k["keys"]))
    assert np.abs(k["c"].decrypt(k["sk"], got) - k["zs"][0] * k["zs"][1]).max() < 1e-3
    raw = k["r"].eval_mult_limb(*k["cts"], k["keys"], mesh(D), rescale=False)
    assert same_towers(raw, k["jr"].eval_mult(*k["jcts"], k["jkeys"], rescale=False))
