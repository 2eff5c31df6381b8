"""The port's advanced SHE layer (`tfhe_tpu_torch.pke.advancedshe` on the
exact host CKKS, `advancedshe_device` on the device evaluator) against the
JAX package's, on torch CPU tensors.

- Host: eval_linear_wsum, eval_poly, eval_logistic, eval_sum and
  eval_merge on identically seeded contexts (N = 32, 8 limbs of 40 bits),
  ciphertext for ciphertext (tolerance 0).
- Device, N = 32, 7 limbs of 28 bits, dnum 3, identical keys (identically
  seeded contexts, the keys held equal) and ciphertexts (carried across by
  `tfhe_tpu_torch.convert`): eval_linear_wsum, eval_poly (the
  Paterson-Stockmeyer route), eval_logistic and eval_sum torch.equal to
  `tfhe_tpu.pke.advancedshe_device` (tolerance 0), and each within the JAX
  package's device bounds of numpy by decryption.
- The port's device layer alone at the JAX package's test configuration
  (N = 32, 30 limbs): the rest of the family by decryption against numpy,
  to that package's bounds.
"""

import numpy as np
import pytest
import torch

import tfhe_tpu.pke.advancedshe as jash
import tfhe_tpu.pke.advancedshe_device as jashd
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_boot_device import CKKSDeviceEvaluator as JaxEvaluator
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxRnsContext
from tfhe_tpu.pke.dcrt import DCRTParams as JaxDCRTParams
from tfhe_tpu.pke.keyswitch import relin_key_gen_hybrid as jax_relin_hybrid
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.pke import advancedshe as ash
from tfhe_tpu_torch.pke import advancedshe_device as ashd
from tfhe_tpu_torch.pke.ckks import CKKSContext, CKKSParams
from tfhe_tpu_torch.pke.ckks_boot_device import CKKSDeviceEvaluator
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from tfhe_tpu_torch.pke.dcrt import DCRTParams
from tfhe_tpu_torch.pke.keyswitch import relin_key_gen_hybrid
from torch_threads import one_torch_thread  # noqa: F401

N = 32
SLOTS = N // 2


def contexts(L: int, bits: int, seed: int):
    """The JAX package's context and the port's, identically seeded, after
    one key_gen each (the secrets held equal)."""
    jp = JaxCKKSParams(N=N, dcrt=JaxDCRTParams.create(N, L, bits), scale=float(1 << bits))
    jc, c = JaxCKKSContext(jp, seed=seed), CKKSContext(convert.ckks_params_from(jp), seed=seed)
    (jsk, jpk), (sk, pk) = jc.key_gen(), c.key_gen()
    assert np.array_equal(sk[1], jsk[1])
    return jc, jsk, jpk, c, sk, pk


def same_ct(x, y) -> bool:
    return x.scale == y.scale and len(x.polys) == len(y.polys) and all(
        a.params.moduli == b.params.moduli and np.array_equal(a.to_eval().rns, b.to_eval().rns)
        for a, b in zip(x.polys, y.polys))


def eq(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j, dtype=np.uint32).astype(np.int64))


def same_dct(d, jd) -> bool:
    return (d.scale == jd.scale and tuple(d.moduli) == tuple(jd.moduli)
            and eq(d.c0, jd.c0) and eq(d.c1, jd.c1))


def logistic(x):
    return 1.0 / (1.0 + np.exp(-x))


# -- host --------------------------------------------------------------------------

def test_host_layer_matches_jax():
    jc, jsk, jpk, c, sk, pk = contexts(8, 40, 11)
    jrlk = jax_relin_hybrid(jc.rng, jc.params.dcrt, jsk[1], dnum=3)
    rlk = relin_key_gen_hybrid(c.rng, c.params.dcrt, sk[1], dnum=3)
    jkeys, keys = jash.sum_key_gen(jc, jsk), ash.sum_key_gen(c, sk)
    assert sorted(keys) == sorted(jkeys)
    rng = np.random.default_rng(1)
    vs = [rng.uniform(-0.9, 0.9, SLOTS) for _ in range(3)]
    jcts = [jc.encrypt(jpk, v) for v in vs]
    cts = [c.encrypt(pk, v) for v in vs]
    assert all(same_ct(x, y) for x, y in zip(cts, jcts))
    pairs = [
        (ash.eval_linear_wsum(c, cts, [0.5, -1.25, 2.0]),
         jash.eval_linear_wsum(jc, jcts, [0.5, -1.25, 2.0])),
        (ash.eval_poly(c, cts[0], [0.1, -0.3, 0.25, 0.2, -0.15, 0.05], rlk),
         jash.eval_poly(jc, jcts[0], [0.1, -0.3, 0.25, 0.2, -0.15, 0.05], jrlk)),
        (ash.eval_logistic(c, cts[1], -4.0, 4.0, 7, rlk),
         jash.eval_logistic(jc, jcts[1], -4.0, 4.0, 7, jrlk)),
        (ash.eval_sum(c, cts[2], keys), jash.eval_sum(jc, jcts[2], jkeys)),
        (ash.eval_merge(c, cts, keys), jash.eval_merge(jc, jcts, jkeys)),
    ]
    assert all(same_ct(x, y) for x, y in pairs)
    got = c.decrypt(sk, pairs[3][0]).real
    assert np.abs(got - vs[2].sum()).max() < 1e-3


# -- device, against the JAX package ------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jc, jsk, jpk, c, sk, pk = contexts(7, 28, 23)
    jev = JaxEvaluator(JaxRnsContext(jc, dnum=3, ks_limb_bits=28))
    ev = CKKSDeviceEvaluator(CKKSRnsContext(c, dnum=3, ks_limb_bits=28), device="cpu")
    jashd.sum_key_gen(jev, jsk)
    ashd.sum_key_gen(ev, sk)
    return dict(jc=jc, jsk=jsk, jpk=jpk, c=c, sk=sk, jev=jev, ev=ev)


def upload(k, z):
    """z encrypted by the JAX context, on both evaluators."""
    jct = k["jc"].encrypt(k["jpk"], np.asarray(z, dtype=np.float64))
    return (k["ev"].dctx.upload(convert.ckks_ciphertext_from(jct, k["c"].params)),
            k["jev"].dctx.upload(jct))


def dec(k, d):
    return k["c"].decrypt(k["sk"], k["ev"].dctx.download(d)).real


def test_device_keys_match(pair):
    ev, jev = pair["ev"], pair["jev"]
    assert sorted(ev._gk) == sorted(jev._gk)
    for key in sorted(ev._gk)[::5]:
        assert all(eq(getattr(ev._gk[key], f), getattr(jev._gk[key], f))
                   for f in ("kb", "ka"))
    L = 7
    assert eq(ev.dctx._rlk[L].ka, jev.dctx._rlk[L].ka)


def test_eval_linear_wsum(pair):
    rng = np.random.default_rng(3)
    vs = [rng.normal(size=SLOTS) for _ in range(3)]
    w = [0.5, -1.25, 2.0]
    ups = [upload(pair, v) for v in vs]
    got = ashd.eval_linear_wsum(pair["ev"], [u[0] for u in ups], w)
    assert same_dct(got, jashd.eval_linear_wsum(pair["jev"], [u[1] for u in ups], w))
    assert np.abs(dec(pair, got) - sum(wi * vi for wi, vi in zip(w, vs))).max() < 1e-3


def test_eval_poly(pair):
    coeffs = np.random.default_rng(10).normal(size=7) * 0.3
    z = np.linspace(-0.9, 0.9, SLOTS)
    x, jx = upload(pair, z)
    got = ashd.eval_poly(pair["ev"], x, coeffs)
    assert same_dct(got, jashd.eval_poly(pair["jev"], jx, coeffs))
    want = np.polynomial.polynomial.polyval(z, coeffs)
    assert np.abs(dec(pair, got) - want).max() < 3e-3


def test_eval_logistic(pair):
    z = np.linspace(-3.5, 3.5, SLOTS)
    x, jx = upload(pair, z)
    got = ashd.eval_logistic(pair["ev"], x, -4.0, 4.0, 8)
    assert same_dct(got, jashd.eval_logistic(pair["jev"], jx, -4.0, 4.0, 8))
    assert np.abs(dec(pair, got) - logistic(z)).max() < 1e-2


def test_eval_sum(pair):
    v = np.random.default_rng(8).normal(size=SLOTS)
    x, jx = upload(pair, v)
    got = ashd.eval_sum(pair["ev"], x)
    assert same_dct(got, jashd.eval_sum(pair["jev"], jx))
    assert np.abs(dec(pair, got) - v.sum()).max() < 1e-3


# -- the port alone at the JAX package's test configuration -----------------------

@pytest.fixture(scope="module")
def dev():
    p = CKKSParams(N=N, dcrt=DCRTParams.create(N, 30, 28), scale=float(1 << 28))
    ctx = CKKSContext(p, seed=23)
    sk, pk = ctx.key_gen()
    ev = CKKSDeviceEvaluator(CKKSRnsContext(ctx, dnum=3, ks_limb_bits=28), device="cpu")
    ashd.sum_key_gen(ev, sk)
    return ctx, sk, pk, ev


def _enc(dev, z):
    ctx, sk, pk, ev = dev
    return ev.dctx.upload(ctx.encrypt(pk, np.asarray(z, dtype=np.float64)))


def _dec(dev, dct):
    ctx, sk, pk, ev = dev
    return ctx.decrypt(sk, ev.dctx.download(dct)).real


def test_add_and_mult_many(dev):
    ev = dev[3]
    rng = np.random.default_rng(1)
    vs = [rng.normal(size=SLOTS) for _ in range(5)]
    got = _dec(dev, ashd.eval_add_many(ev, [_enc(dev, v) for v in vs]))
    assert np.abs(got - np.sum(vs, axis=0)).max() < 1e-4
    vs = [rng.uniform(0.3, 1.0, size=SLOTS) for _ in range(4)]
    got = _dec(dev, ashd.eval_mult_many(ev, [_enc(dev, v) for v in vs]))
    assert np.abs(got - np.prod(vs, axis=0)).max() < 1e-3


@pytest.mark.parametrize("deg", [3, 10])
def test_eval_poly_routes(dev, deg):
    coeffs = np.random.default_rng(deg).normal(size=deg + 1) * 0.3
    z = np.linspace(-0.9, 0.9, SLOTS)
    got = _dec(dev, ashd.eval_poly(dev[3], _enc(dev, z), coeffs))
    assert np.abs(got - np.polynomial.polynomial.polyval(z, coeffs)).max() < 3e-3
    with pytest.raises(ValueError):
        ashd.eval_poly(dev[3], _enc(dev, z), [1.0, 0.0])


@pytest.mark.parametrize("fn, lo, hi, deg, want, bound", [
    ("eval_sin", -3.0, 3.0, 25, np.sin, 1e-2),
    ("eval_cos", -3.0, 3.0, 25, np.cos, 1e-2),
    ("eval_logistic", -4.0, 4.0, 27, logistic, 1e-2),
    ("eval_divide", 1.0, 3.0, 33, lambda x: 1.0 / x, 1e-2),
])
def test_chebyshev_functions(dev, fn, lo, hi, deg, want, bound):
    z = np.linspace(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), SLOTS)
    got = _dec(dev, getattr(ashd, fn)(dev[3], _enc(dev, z), lo, hi, deg))
    assert np.abs(got - want(z)).max() < bound


def test_chebyshev_series_interval(dev):
    coeffs = np.random.default_rng(7).normal(size=9) * 0.4
    z = np.linspace(0.2, 3.8, SLOTS)
    got = _dec(dev, ashd.eval_chebyshev_series(dev[3], _enc(dev, z), coeffs, 0.0, 4.0))
    want = np.polynomial.chebyshev.chebval((2 * z - 4.0) / 4.0, coeffs)
    assert np.abs(got - want).max() < 3e-3


def test_sum_trees_and_merge(dev):
    ev = dev[3]
    R = 4
    rng = np.random.default_rng(10)
    v = rng.normal(size=SLOTS)
    got = _dec(dev, ashd.eval_sum(ev, _enc(dev, v), batch_size=4))
    assert abs(got[0] - v[:4].sum()) < 1e-3              # slot 0 sums slots 0..3
    m = rng.normal(size=(SLOTS // R, R))
    got = _dec(dev, ashd.eval_sum_rows(ev, _enc(dev, m.ravel()), R))
    assert np.abs(got.reshape(SLOTS // R, R) - m.sum(axis=0)).max() < 1e-3
    got = _dec(dev, ashd.eval_sum_cols(ev, _enc(dev, m.ravel()), R))
    assert np.abs(got.reshape(SLOTS // R, R) - m.sum(axis=1)[:, None]).max() < 3e-3
    vals = rng.normal(size=5)
    cts = []
    for x in vals:
        z = rng.normal(size=SLOTS)
        z[0] = x
        cts.append(_enc(dev, z))
    got = _dec(dev, ashd.eval_merge(ev, cts))
    assert np.abs(got[:5] - vals).max() < 3e-3 and np.abs(got[5:]).max() < 3e-3
