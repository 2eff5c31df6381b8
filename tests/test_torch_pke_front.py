"""The port's pke front end against the JAX package's: `parametergen`
(`derive_bfv`, `derive_bgv`, `derive_ckks`) over a grid of depths,
plaintext moduli, scale widths and security levels, the `SecurityError`
cases included, and `context.gen_crypto_context` for each scheme and
option: the derived parameters and moduli chains (BFV exact, HPS and BEHZ,
among them `chip_smoke.py`'s simple-integers configuration: t = 65537,
depth 2, 28-bit limbs; BGV; CKKS fixedmanual, fixedauto, flexibleauto,
hybrid, bootstrapping), and, at explicit toy ring dimensions, the same
keys, ciphertexts and product towers after one encrypt and one mult.
Tolerance 0."""

import dataclasses

import numpy as np
import pytest

from tfhe_tpu.pke import context as jax_context
from tfhe_tpu.pke import parametergen as jax_pg
from tfhe_tpu_torch.pke import (BFVBehzContext, BFVRnsContext, SecurityError,
                                gen_crypto_context)
from tfhe_tpu_torch.pke import parametergen as pg
from torch_threads import one_torch_thread  # noqa: F401

LEVELS = ("128_classic", "192_classic", "256_classic", "128_quantum",
          "256_quantum", "NotSet")


def same_outcome(fn, jfn, *args, **kwargs):
    """fn and jfn return equal DerivedParams, or raise the same error
    class (SecurityError under its own name in each package)."""
    try:
        want = jfn(*args, **kwargs)
    except Exception as e:                          # noqa: BLE001
        with pytest.raises(Exception) as got:
            fn(*args, **kwargs)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return type(e).__name__
    got = fn(*args, **kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.log_qp == want.log_qp
    return "ok"


@pytest.mark.parametrize("scheme", ["BFV", "BGV", "CKKS"])
def test_derive_matches(scheme):
    seen = set()
    for level in LEVELS:
        for depth in (-1, 0, 1, 2, 4, 8, 16):
            for ring_dim in (None, 1024, 4096, 32768):
                if scheme == "BFV":
                    for t, lb in ((257, 54), (65537, 28), (786433, 30)):
                        seen.add(same_outcome(pg.derive_bfv, jax_pg.derive_bfv, depth, t,
                                              level, ring_dim=ring_dim, limb_bits=lb))
                elif scheme == "BGV":
                    for t, lb in ((257, None), (65537, None), (65537, 40)):
                        seen.add(same_outcome(pg.derive_bgv, jax_pg.derive_bgv, depth, t,
                                              level, ring_dim=ring_dim, limb_bits=lb))
                else:
                    for sb, fb, ks in ((40, 60, "bv"), (50, 60, "hybrid"), (59, 60, "bv"),
                                       (60, 60, "bv")):
                        seen.add(same_outcome(pg.derive_ckks, jax_pg.derive_ckks, depth,
                                              sb, fb, level, ring_dim=ring_dim,
                                              key_switch=ks))
    assert {"ok", "SecurityError", "ValueError"} <= seen


DERIVED = [
    ("BFV", dict(mult_depth=1, plaintext_modulus=65537)),
    ("BFV", dict(mult_depth=2, plaintext_modulus=65537, limb_bits=28,
                 multiplication_technique="hps")),
    ("BFV", dict(mult_depth=2, plaintext_modulus=65537, limb_bits=28,
                 multiplication_technique="behz")),
    ("BFV", dict(mult_depth=3, plaintext_modulus=786433, limb_bits=30,
                 multiplication_technique="hps", security_level="192_classic")),
    ("BGV", dict(mult_depth=3, plaintext_modulus=65537)),
    ("CKKS", dict(mult_depth=2)),
    ("CKKS", dict(mult_depth=3, scale_bits=50, key_switch="hybrid",
                  scaling_technique="fixedauto")),
    ("CKKS", dict(mult_depth=2, scaling_technique="flexibleauto")),
    ("CKKS", dict(mult_depth=1, bootstrapping=True, level_budget=(2, 2))),
]


def describe(cc) -> dict:
    """The parameters and moduli a context was built with, as plain values."""
    p = cc.params
    out = {"class": type(cc).__name__, "N": p.N, "moduli": tuple(p.dcrt.moduli),
           "t": getattr(p, "t", None), "scale": getattr(p, "scale", None),
           "std": p.std, "derived": dataclasses.asdict(cc.derived)
           if hasattr(cc, "derived") else None,
           "boot": getattr(cc, "bootstrap_config", None)}
    for name in ("r_moduli", "bsk_moduli", "dnum", "ks_limb_bits", "technique"):
        if hasattr(cc, name):
            v = getattr(cc, name)
            out[name] = tuple(v) if isinstance(v, (list, tuple)) else v
    return out


@pytest.mark.parametrize("case", range(len(DERIVED)))
def test_gen_crypto_context_derived_matches(case):
    scheme, kw = DERIVED[case]
    got = gen_crypto_context(scheme, seed=3, **kw)
    want = jax_context.gen_crypto_context(scheme, seed=3, **kw)
    assert describe(got) == describe(want)
    if kw.get("multiplication_technique") == "hps" and kw["mult_depth"] == 2:
        # chip_smoke.py's simple-integers configuration
        assert isinstance(got, BFVRnsContext) and not isinstance(got, BFVBehzContext)
        assert got.params.N == 4096 and len(got.params.dcrt.moduli) == 4
    if kw.get("multiplication_technique") == "behz":
        assert isinstance(got, BFVBehzContext)


TOY = [
    ("BFV", dict(N=64, plaintext_modulus=257, mult_depth=1)),
    ("BFV", dict(N=64, plaintext_modulus=257, mult_depth=2, limb_bits=28,
                 multiplication_technique="hps")),
    ("BFV", dict(N=64, plaintext_modulus=257, mult_depth=2, limb_bits=28,
                 multiplication_technique="behz")),
    ("BGV", dict(N=64, plaintext_modulus=257, mult_depth=2, limb_bits=28)),
    ("CKKS", dict(N=64, mult_depth=2, scale_bits=30, limb_bits=40)),
    ("CKKS", dict(N=64, mult_depth=2, scale_bits=30, limb_bits=40,
                  scaling_technique="fixedauto")),
    ("CKKS", dict(N=64, mult_depth=2, scale_bits=30, limb_bits=40,
                  scaling_technique="flexibleauto")),
]


def towers(ct) -> list:
    return [np.asarray(p.to_eval().rns, dtype=np.uint64) for p in ct.polys]


@pytest.mark.parametrize("case", range(len(TOY)))
def test_gen_crypto_context_towers_match(case):
    """At an explicit toy N: the same parameters, and one encrypt and one
    mult give the JAX package's towers."""
    scheme, kw = TOY[case]
    cc = gen_crypto_context(scheme, seed=17, **kw)
    jcc = jax_context.gen_crypto_context(scheme, seed=17, **kw)
    assert describe(cc) == describe(jcc)
    rng = np.random.default_rng(case)
    if scheme == "CKKS":
        m1, m2 = rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8)
    else:
        m1, m2 = rng.integers(0, 257, 64), rng.integers(0, 257, 64)
    outs = []
    for c in (cc, jcc):
        sk, pk = c.key_gen()
        rlk = c.relin_key_gen(sk)
        a, b = c.encrypt(pk, m1), c.encrypt(pk, m2)
        prod = c.eval_mult(a, b, rlk)
        outs.append((a, prod, c.decrypt(sk, prod)))
    for got, want in zip(outs[0][:2], outs[1][:2]):
        assert got.polys[0].params.moduli == want.polys[0].params.moduli
        assert all(np.array_equal(x, y) for x, y in zip(towers(got), towers(want)))
        assert getattr(got, "scale", None) == getattr(want, "scale", None)
    assert np.array_equal(np.asarray(outs[0][2]), np.asarray(outs[1][2]))


def test_gen_crypto_context_refusals_match():
    """Explicit N against a requested level, a missing N under NotSet, and
    the technique checks raise the same error class in both packages."""
    cases = [("CKKS", dict(N=1024, mult_depth=4, security_level="128_classic")),
             ("BFV", dict(N=1024, mult_depth=8, plaintext_modulus=65537,
                          security_level="128_classic")),
             ("BFV", dict(security_level="NotSet")),
             ("BFV", dict(N=64, plaintext_modulus=257, multiplication_technique="behz")),
             ("CKKS", dict(N=64, multiplication_technique="behz")),
             ("BFV", dict(N=64, limb_bits=28, multiplication_technique="gpu")),
             ("CKKS", dict(N=64, scaling_technique="fixed")),
             ("BGV", dict(N=64, bootstrapping=True)),
             ("TFHE", dict(N=64))]
    for scheme, kw in cases:
        with pytest.raises(Exception) as want:
            jax_context.gen_crypto_context(scheme, **kw)
        with pytest.raises(Exception) as got:
            gen_crypto_context(scheme, **kw)
        assert type(got.value).__name__ == type(want.value).__name__
    with pytest.raises(SecurityError):
        gen_crypto_context("CKKS", N=1024, mult_depth=4, security_level="128_classic")
