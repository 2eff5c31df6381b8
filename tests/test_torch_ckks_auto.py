"""The port's automatic-scaling CKKS layer and noise flooding against the
JAX package, exactly.

- `ckks_auto`: the scale grids under FLEXIBLEAUTO and FIXEDAUTO equal to
  the last bit, and the towers, scales and noise degrees of a lazily
  rescaled multiplication chain, a mixed-level add, plaintext and scalar
  operations, a subtraction and a rotation equal to the JAX package's host
  `CKKSAutoContext`, at tests/test_ckks_auto_device.py's size (N = 64, a
  30-bit limb and four 28-bit limbs, dnum 2);
- `ckks_auto_device` (`CKKSDeviceContext` on the CPU) on the same
  programs, singly and batched, equal to the same towers; under
  FLEXIBLEAUTO the JAX package's `CKKSAutoDeviceContext` too;
- `noise_flooding`: the phase-1 estimate, the flooding sigma and the
  phase-2 flooded decryption with one seeded numpy Generator passed to
  both packages, at tests/test_noise_flooding.py's size.

Keys and ciphertexts come from identically seeded contexts and are also
carried across with `tfhe_tpu_torch.convert`. Tolerance 0 wherever towers
or floats of the two packages are compared; decryptions within 1e-3."""

import numpy as np
import pytest

from tfhe_tpu.pke import noise_flooding as jax_nf
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_auto import CKKSAutoContext as JaxAuto
from tfhe_tpu.pke.ckks_auto_device import CKKSAutoDeviceContext as JaxAutoDevice
from tfhe_tpu.pke.ckks_device import CKKSDeviceContext as JaxDeviceContext
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxRnsContext
from tfhe_tpu.pke.dcrt import DCRTParams as JaxDCRTParams
from tfhe_tpu.pke.dcrt import _moduli_chain_pattern
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.pke import noise_flooding as nf
from tfhe_tpu_torch.pke.ckks import CKKSContext
from tfhe_tpu_torch.pke.ckks_auto import CKKSAutoContext
from tfhe_tpu_torch.pke.ckks_auto_device import CKKSAutoDeviceContext
from tfhe_tpu_torch.pke.ckks_device import CKKSDeviceContext
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from torch_threads import one_torch_thread  # noqa: F401

N, L = 64, 5


def towers(ct) -> list:
    return [np.asarray(p.to_eval().rns, dtype=np.uint64) for p in ct.polys]


def assert_same(want, *got):
    for g in got:
        assert g.noise_deg == want.noise_deg and g.scale == want.scale
        assert g.polys[0].params.moduli == want.polys[0].params.moduli
        assert all(np.array_equal(a, b) for a, b in zip(towers(want), towers(g)))


@pytest.fixture(scope="module", params=["flexibleauto", "fixedauto"])
def ctxs(request):
    """The JAX package's host auto context, the port's host and device auto
    contexts, all from one seed (the port's keys and first ciphertexts held
    equal to the JAX package's), and the JAX device auto context under
    FLEXIBLEAUTO."""
    tech = request.param
    jp = JaxCKKSParams(N=N, dcrt=JaxDCRTParams(N=N, moduli=_moduli_chain_pattern(
        N, (30,) + (28,) * (L - 1))), scale=float(1 << 28))
    jbase = JaxCKKSContext(jp, seed=20260818)
    jrns = JaxRnsContext(jbase, dnum=2, ks_limb_bits=28)
    jhost = JaxAuto(jrns, technique=tech)
    jsk, jpk = jhost.key_gen()
    jrlk = jhost.relin_key_gen(jsk)
    jgk = jhost.galois_key_gen(jsk, 1)
    base = CKKSContext(convert.ckks_params_from(jp), seed=20260818)
    rns = CKKSRnsContext(base, dnum=2, ks_limb_bits=28)
    host = CKKSAutoContext(rns, technique=tech)
    sk, pk = host.key_gen()
    rlk, gk = host.relin_key_gen(sk), host.galois_key_gen(sk, 1)
    assert np.array_equal(sk[1], jsk[1])
    assert all(np.array_equal(a.rns, b.rns) for a, b in zip(rlk.bs, jrlk.bs))
    assert all(np.array_equal(a.rns, b.rns) for a, b in zip(gk.as_, jgk.as_))
    dev = CKKSAutoDeviceContext(CKKSDeviceContext(rns, device="cpu"), technique=tech)
    dev.dev.load_relin_keys(convert.hybrid_key_from(jrlk))
    dev.dev.load_galois_keys(1, convert.hybrid_key_from(jgk))
    jdev = None
    if tech == "flexibleauto":
        jdev = JaxAutoDevice(JaxDeviceContext(jrns), technique=tech)
        jdev.dev.load_relin_keys(jrlk)
    rng = np.random.default_rng(1)
    zs = [rng.uniform(0.2, 0.9, N // 2) for _ in range(3)]
    jcts = [jhost.encrypt(jpk, z) for z in zs]
    cts = [host.encrypt(pk, z) for z in zs]
    for jc, c in zip(jcts, cts):
        assert_same(jc, c, convert.ckks_ciphertext_from(jc, base.params))
    return dict(jhost=jhost, host=host, dev=dev, jdev=jdev, jsk=jsk, sk=sk,
                jrlk=jrlk, rlk=rlk, jgk=jgk, gk=gk, zs=zs, jcts=jcts, cts=cts)


def decrypts(k, ct, want) -> bool:
    return np.abs(k["host"].decrypt(k["sk"], ct).real - want).max() < 1e-3


def test_scale_grid_matches(ctxs):
    k = ctxs
    assert k["host"].sf == k["jhost"].sf and k["host"].sf2 == k["jhost"].sf2
    assert k["dev"].sf == k["jhost"].sf and k["dev"].sf2 == k["jhost"].sf2


def run(ctx, cts, *args):
    """The programs of tests/test_ckks_auto_device.py: (name, result)."""
    x, y = cts[0], cts[1]
    key = args

    def mult(a, b):
        return ctx.eval_mult(a, b, *key)

    x2 = mult(x, x)
    return {
        "chain": mult(mult(x, y), x),
        "mixed_add": ctx.eval_add(mult(x2, x2), y),
        "plain": ctx.eval_add_plain(ctx.eval_mult_plain(
            x2, np.linspace(-1.0, 1.0, N // 2)), 0.25),
        "scalar_sub": ctx.eval_sub(ctx.eval_mult_plain(x, 3.0), y),
    }


def test_programs_match(ctxs):
    """Host port and device port, each program, against the JAX host layer
    (and the JAX device layer under FLEXIBLEAUTO); then decryption."""
    k = ctxs
    want = run(k["jhost"], k["jcts"], k["jrlk"])
    host = run(k["host"], k["cts"], k["rlk"])
    dev = k["dev"]
    got = run(dev, [dev.upload(c) for c in k["cts"]])
    jgot = None if k["jdev"] is None else run(
        k["jdev"], [k["jdev"].upload(c) for c in k["jcts"]])
    for name in want:
        assert_same(want[name], host[name], dev.download(got[name]))
        if jgot is not None:
            assert_same(want[name], convert.ckks_ciphertext_from(
                k["jdev"].download(jgot[name]), k["host"].params))
    x, y, _ = k["zs"]
    assert decrypts(k, host["chain"], x * x * y)
    assert decrypts(k, host["mixed_add"], x ** 4 + y)
    assert decrypts(k, host["plain"], x * x * np.linspace(-1.0, 1.0, N // 2) + 0.25)
    assert decrypts(k, host["scalar_sub"], 3.0 * x - y)


def test_rotation_and_batch_match(ctxs):
    k = ctxs
    jh, h, dev = k["jhost"], k["host"], k["dev"]
    jx, jy = k["jcts"][:2]
    x, y = k["cts"][:2]
    want = jh.eval_add(jh.eval_rotate(jh.eval_mult(jx, jy, k["jrlk"]), 1, k["jgk"]), jx)
    got = h.eval_add(h.eval_rotate(h.eval_mult(x, y, k["rlk"]), 1, k["gk"]), x)
    dx, dy = dev.upload(x), dev.upload(y)
    dgot = dev.eval_add(dev.eval_rotate(dev.eval_mult(dx, dy), 1), dx)
    assert_same(want, got, dev.download(dgot))
    zx, zy, _ = k["zs"]
    assert decrypts(k, got, np.roll(zx * zy, -1) + zx)
    d = dev.upload_batch(k["cts"])
    downs = dev.download_batch(dev.eval_add_plain(dev.eval_mult(d, d), 0.5))
    for jc, ct in zip(k["jcts"], downs):
        assert_same(jh.eval_add_plain(jh.eval_mult(jc, jc, k["jrlk"]), 0.5), ct)


def flood_ctx(auto_cls, rns_cls, ctx_cls, params, seed):
    """tests/test_noise_flooding.py's context (N = 64, limbs 52/40/40,
    scale 2^40, FIXEDAUTO), in either package."""
    actx = auto_cls(rns_cls(ctx_cls(params, seed=seed), dnum=2), technique="fixedauto")
    sk, pk = actx.key_gen()
    return actx, sk, pk, actx.relin_key_gen(sk)


def circuit(actx, pk, rlk, v1, v2):
    c1, c2 = actx.encrypt(pk, v1), actx.encrypt(pk, v2)
    return actx.eval_add(actx.eval_mult(c1, c2, rlk), c1)


def test_noise_flooding_matches():
    jp = JaxCKKSParams(N=N, dcrt=JaxDCRTParams(N=N, moduli=_moduli_chain_pattern(
        N, (52, 40, 40))), scale=float(1 << 40))
    p = convert.ckks_params_from(jp)
    rng = np.random.default_rng(0)
    v1, v2 = rng.uniform(0.1, 0.9, N // 2), rng.uniform(0.1, 0.9, N // 2)
    out = {}
    for seed in (101, 202):
        ja, jsk, jpk, jrlk = flood_ctx(JaxAuto, JaxRnsContext, JaxCKKSContext, jp, seed)
        a, sk, pk, rlk = flood_ctx(CKKSAutoContext, CKKSRnsContext, CKKSContext, p, seed)
        jct, ct = circuit(ja, jpk, jrlk, v1, v2), circuit(a, pk, rlk, v1, v2)
        assert_same(jct, ct)
        out[seed] = (ja, jsk, jct, a, sk, ct)
    ja, jsk, jct, a, sk, ct = out[101]
    est = nf.estimate_noise(a.ctx, sk, ct)
    assert est == jax_nf.estimate_noise(ja.ctx, jsk, jct) and 0.0 < est < 30.0
    assert nf.flooding_sigma(est, 40.0, 3) == jax_nf.flooding_sigma(est, 40.0, 3)
    ja, jsk, jct, a, sk, ct = out[202]
    got = nf.decrypt_flooded(a.ctx, sk, ct, est, rng=np.random.default_rng(1))
    want = jax_nf.decrypt_flooded(ja.ctx, jsk, jct, est, rng=np.random.default_rng(1))
    assert np.array_equal(got, want)
    carried = nf.decrypt_flooded(a.ctx, convert.ckks_secret_from(jsk),
                                 convert.ckks_ciphertext_from(jct, a.params), est,
                                 rng=np.random.default_rng(1))
    assert np.array_equal(carried, want)
    assert np.abs(got.real - (v1 * v2 + v1)).max() < 1e-3
    with pytest.raises(ValueError):
        nf.decrypt_flooded(a.ctx, sk, ct, 30.0)
