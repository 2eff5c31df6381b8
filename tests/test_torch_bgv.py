"""The port's BGV stack against the JAX package's, exactly: the host BFV
base (`bfv`: keygen, encryption, the exact product with relinearization),
`bgv` (keygen, packed encryption, the exact product, modulus switching,
rotation), `bgv_rns` (leveled mult, ModReduce, rotation, plaintext product,
compression), `bgv_auto` (deferred ModReduce, mixed-level add and sub,
plaintext product, rotation), `bgv_device` on the CPU (mult chain, packed
rotation, add, sub, a batch) against the JAX package's host
`BGVRnsContext`, and the `t` > 1 device builders of `pke/ckks_device.py`
(the t-exact ModDown and the BGV ModReduce inside `build_mult_relin_rescale`,
`build_rotate` and `build_rotate_hoisted`) against the JAX package's
builders.

The BGV ring is tests/test_bgv_device.py's: N = 64, t = 257 (packed
slots), three 28-bit limbs = 1 mod t, dnum 2. Keys and ciphertexts come
from identically seeded contexts and are also carried across with
`tfhe_tpu_torch.convert`. Tolerance 0 wherever towers are compared."""

import numpy as np
import pytest
import torch

from tfhe_tpu.pke import ckks_device as jax_dev
from tfhe_tpu.pke.bfv import BFVContext as JaxBFVContext
from tfhe_tpu.pke.bfv import BFVParams as JaxBFVParams
from tfhe_tpu.pke.bgv import BGVContext as JaxBGVContext
from tfhe_tpu.pke.bgv import BGVParams as JaxBGVParams
from tfhe_tpu.pke.bgv_auto import BGVAutoContext as JaxBGVAuto
from tfhe_tpu.pke.bgv_rns import BGVRnsContext as JaxBGVRns
from tfhe_tpu.pke.bgv_rns import mod_reduce_rns as jax_mod_reduce_rns
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.ops.nttl import NTTL
from tfhe_tpu_torch.pke import ckks_device as dev
from tfhe_tpu_torch.pke.bfv import BFVContext, BFVParams
from tfhe_tpu_torch.pke.bgv import BGVContext, BGVParams
from tfhe_tpu_torch.pke.bgv_auto import BGVAutoContext
from tfhe_tpu_torch.pke.bgv_device import BGVDeviceContext
from tfhe_tpu_torch.pke.bgv_rns import BGVRnsContext, mod_reduce_rns
from tfhe_tpu_torch.pke.encoding import rotation_automorphism_index
from test_torch_ckks_device import eq, jx
from torch_threads import one_torch_thread  # noqa: F401

N, T = 64, 257


def towers(ct) -> list:
    return [np.asarray(p.to_eval().rns, dtype=np.uint64) for p in ct.polys]


def assert_same(want, *got):
    for g in got:
        assert g.polys[0].params.moduli == want.polys[0].params.moduli
        assert g.noise_deg == want.noise_deg
        assert len(g.polys) == len(want.polys)
        assert all(np.array_equal(a, b) for a, b in zip(towers(want), towers(g)))


def same_poly(a, b) -> bool:
    return a.params.moduli == b.params.moduli and np.array_equal(
        a.to_eval().rns, b.to_eval().rns)


def test_bfv_host_matches():
    jp = JaxBFVParams.create(N=N, t=T, mult_depth=1)
    p = BFVParams.create(N=N, t=T, mult_depth=1)
    assert p.dcrt.moduli == jp.dcrt.moduli and p.delta == jp.delta
    jc, c = JaxBFVContext(jp, seed=42), BFVContext(p, seed=42)
    (jsk, jpk), (sk, pk) = jc.key_gen(), c.key_gen()
    assert same_poly(sk.s, jsk.s) and same_poly(pk.b, jpk.b)
    jrlk, rlk = jc.relin_key_gen(jsk), c.relin_key_gen(sk)
    assert all(same_poly(a, b) for a, b in zip(rlk.b, jrlk.b))
    rng = np.random.default_rng(0)
    m1, m2 = rng.integers(0, T, N), rng.integers(0, T, N)
    jx, jy = jc.encrypt(jpk, m1), jc.encrypt(jpk, m2)
    x, y = c.encrypt(pk, m1), c.encrypt(pk, m2)
    assert_same(jx, x, convert.bgv_ciphertext_from(jx, p))
    want = jc.eval_mult(jx, jy, jrlk)
    got = c.eval_mult(x, y, rlk)
    assert_same(want, got)
    assert_same(jc.eval_sub(jx, jy), c.eval_sub(x, y))
    prod = np.zeros(2 * N, dtype=np.int64)
    for i in range(N):
        prod[i:i + N] += m1[i] * m2
    assert np.array_equal(c.decrypt(sk, got), (prod[:N] - prod[N:]) % T)


@pytest.fixture(scope="module")
def bgv():
    """The JAX package's BGV contexts and the port's, from one seed, with
    per-level relinearization and Galois keys (steps 3) and three packed
    ciphertexts."""
    jp = JaxBGVParams.create(N=N, t=T, mult_depth=2, limb_bits=28)
    p = BGVParams.create(N=N, t=T, mult_depth=2, limb_bits=28)
    assert p == convert.bgv_params_from(jp)
    jc, c = JaxBGVContext(jp, seed=37), BGVContext(p, seed=37)
    (jsk, jpk), (sk, pk) = jc.key_gen(), c.key_gen()
    assert same_poly(sk.s, jsk.s) and same_poly(pk.b, jpk.b) and same_poly(pk.a, jpk.a)
    assert same_poly(convert.bgv_secret_from(jsk).s, sk.s)
    assert same_poly(convert.bgv_public_from(jpk).b, pk.b)
    jr, r = JaxBGVRns(jc, dnum=2, ks_limb_bits=28), BGVRnsContext(c, dnum=2, ks_limb_bits=28)
    jrlk, rlk = jr.relin_key_gen(jsk), r.relin_key_gen(sk)
    jgk, gk = jr.galois_key_gen(jsk, 3), r.galois_key_gen(sk, 3)
    for lv in rlk:
        assert all(same_poly(a, b) for a, b in zip(rlk[lv].bs, jrlk[lv].bs))
        assert all(same_poly(a, b) for a, b in zip(gk[lv].as_, jgk[lv].as_))
    rng = np.random.default_rng(0)
    vs = [rng.integers(0, T, N) for _ in range(3)]
    jcts = [jc.encrypt_packed(jpk, v) for v in vs]
    cts = [c.encrypt_packed(pk, v) for v in vs]
    for jx, x in zip(jcts, cts):
        assert_same(jx, x, convert.bgv_ciphertext_from(jx, p))
    return dict(jc=jc, c=c, jsk=jsk, sk=sk, jr=jr, r=r, jrlk=jrlk, rlk=rlk,
                jgk=jgk, gk=gk, vs=vs, jcts=jcts, cts=cts)


def rotated(v, steps):
    h = N // 2
    return np.concatenate([np.roll(v[:h], -steps), np.roll(v[h:], -steps)])


def test_bgv_host_matches(bgv):
    k = bgv
    jc, c = k["jc"], k["c"]
    jrlk, rlk = jc.relin_key_gen(k["jsk"]), c.relin_key_gen(k["sk"])
    assert all(same_poly(a, b) for a, b in zip(rlk.a, convert.bgv_relin_from(jrlk).a))
    (jx, jy, _), (x, y, _) = k["jcts"], k["cts"]
    want = jc.mod_switch(jc.eval_mult(jx, jy, jrlk))
    got = c.mod_switch(c.eval_mult(x, y, rlk))
    assert_same(want, got)
    v1, v2, _ = k["vs"]
    assert np.array_equal(c.decrypt_packed(k["sk"], got), v1 * v2 % T)
    (jkk, jg), (kk, g) = jc.galois_key_gen(k["jsk"], 1), c.galois_key_gen(k["sk"], 1)
    assert kk == jkk and all(same_poly(a, b) for a, b in zip(g.b, jg.b))
    rot = c.eval_rotate(x, (kk, g))
    assert_same(jc.eval_rotate(jx, (jkk, jg)), rot)
    assert np.array_equal(c.decrypt_packed(k["sk"], rot), rotated(v1, 1))


def test_bgv_rns_matches(bgv):
    k = bgv
    jr, r = k["jr"], k["r"]
    (jx, jy, jz), (x, y, z) = k["jcts"], k["cts"]
    want = jr.eval_mult(jr.eval_mult(jx, jy, k["jrlk"]), jr.mod_reduce(jz), k["jrlk"])
    got = r.eval_mult(r.eval_mult(x, y, k["rlk"]), r.mod_reduce(z), k["rlk"])
    assert_same(want, got)
    v1, v2, v3 = k["vs"]
    assert np.array_equal(k["c"].decrypt_packed(k["sk"], got), v1 * v2 % T * v3 % T)
    assert_same(jr.eval_rotate(jx, 3, k["jgk"]), r.eval_rotate(x, 3, k["gk"]))
    assert_same(jr.eval_mult_plain(jx, v2), r.eval_mult_plain(x, v2))
    assert_same(jr.compress(jx), r.compress(x))
    assert same_poly(mod_reduce_rns(x.polys[0], T), jax_mod_reduce_rns(jx.polys[0], T))
    assert_same(jr.eval_add(jx, jy), r.eval_add(x, y))


def test_bgv_auto_matches(bgv):
    k = bgv
    ja, a = JaxBGVAuto(k["jr"]), BGVAutoContext(k["r"])
    jrlk, rlk = ja.relin_key_gen(k["jsk"]), a.relin_key_gen(k["sk"])
    jgk, gk = ja.galois_key_gen(k["jsk"], 1), a.galois_key_gen(k["sk"], 1)
    v1, v2, v3 = k["vs"]
    (jx, jy, jz), (x, y, z) = k["jcts"], k["cts"]

    def program(ctx, x, y, z, rlk, gk):
        xy = ctx.eval_mult(x, y, rlk)                      # deg 2, deferred
        xyz = ctx.eval_mult(xy, z, rlk)                    # ModReduce, align
        s = ctx.eval_add(xyz, z)                           # mixed-level add
        d = ctx.eval_sub(ctx.eval_mult_plain(s, v2), x)
        return xy, xyz, s, ctx.eval_rotate(d, 1, gk)

    want = program(ja, jx, jy, jz, jrlk, jgk)
    got = program(a, x, y, z, rlk, gk)
    for w, g in zip(want, got):
        assert_same(w, g)
    s = (v1 * v2 % T * v3 + v3) % T
    assert np.array_equal(a.decrypt(k["sk"], got[2]), s)
    assert np.array_equal(a.decrypt(k["sk"], got[3]), rotated((s * v2 - v1) % T, 1))


def test_bgv_device_matches_host_rns(bgv):
    """The port's BGVDeviceContext on the CPU against the JAX package's
    host BGVRnsContext: a depth-2 mult chain, a rotation, add and sub, and
    a batch of two in one call."""
    k = bgv
    jr = k["jr"]
    d = BGVDeviceContext(k["r"], device="cpu")
    d.load_relin_keys(k["rlk"])
    d.load_galois_keys(3, {lv: convert.hybrid_key_from(key) for lv, key in k["jgk"].items()})
    (jx, jy, jz), (x, y, z) = k["jcts"], k["cts"]
    want = jr.eval_mult(jr.eval_mult(jx, jy, k["jrlk"]), jr.mod_reduce(jz), k["jrlk"])
    got = d.eval_mult(d.eval_mult(d.upload(x), d.upload(y)),
                      d.upload(k["r"].mod_reduce(z)))
    assert_same(want, d.download(got))
    v1, v2, v3 = k["vs"]
    assert np.array_equal(k["c"].decrypt_packed(k["sk"], d.download(got)),
                          v1 * v2 % T * v3 % T)
    assert_same(jr.eval_rotate(jx, 3, k["jgk"]), d.download(d.eval_rotate(d.upload(x), 3)))
    dx, dy = d.upload(x), d.upload(y)
    assert_same(jr.eval_add(jx, jy), d.download(d.eval_add(dx, dy)))
    sub = k["c"].decrypt_packed(k["sk"], d.download(d.eval_sub(dx, dy)))
    assert np.array_equal(sub, (v1 - v2) % T)
    batch = d.download_batch(d.eval_mult(d.upload_batch([x, z]), d.upload_batch([y, x])))
    assert_same(jr.eval_mult(jx, jy, k["jrlk"]), batch[0])
    assert_same(jr.eval_mult(jz, jx, k["jrlk"]), batch[1])
    with pytest.raises(ValueError):
        BGVDeviceContext(BGVRnsContext(BGVContext(
            BGVParams.create(N=N, t=T, mult_depth=1, limb_bits=40), seed=1)), device="cpu")


def test_t_builders_match_jax(bgv):
    """`t` = 257 in the device builders against the JAX package's builders on
    the same towers and keys: mult + relin + BGV ModReduce at the full chain
    (and without the ModReduce, through the checked ModReduce); rotation and hoisted rotation at the full
    chain and (single full-chain key, level view) one level down."""
    k = bgv
    r, jr = k["r"], k["jr"]
    lvl = r.params.dcrt.moduli
    rng = np.random.default_rng(5)
    towers_ = [torch.as_tensor(np.stack([rng.integers(0, q, N) for q in lvl]))
               for _ in range(2)]
    a0, a1 = towers_
    ja0, ja1 = jx(a0), jx(a1)
    rkey = k["rlk"][len(lvl)]
    pk, jpk = dev._PackedKey(rkey, "cpu"), jax_dev._PackedKey(k["jrlk"][len(lvl)])
    kt = (pk.kb, pk.kb_sh, pk.ka, pk.ka_sh)
    jkt = (jpk.kb, jpk.kb_sh, jpk.ka, jpk.ka_sh)
    got = dev.build_mult_relin_rescale(N, lvl, pk.p_moduli, pk.groups, None, True,
                                       t=T, device="cpu")(a0, a1, a1, a0, *kt)
    want = jax_dev.build_mult_relin_rescale(N, lvl, jpk.p_moduli, jpk.groups, T, None,
                                            True)(ja0, ja1, ja1, ja0, *jkt)
    assert all(eq(g, w) for g, w in zip(got, want))
    # without the ModReduce: the same product, held through the checked one
    raw = dev.build_mult_relin_rescale(N, lvl, pk.p_moduli, pk.groups, None, False,
                                       t=T, device="cpu")(a0, a1, a1, a0, *kt)
    ntt, ntt_out = NTTL(N, lvl, device="cpu"), NTTL(N, lvl[:-1], device="cpu")
    modreduce = dev._make_rescale(lvl, "cpu", T)
    assert all(torch.equal(ntt_out.forward(modreduce(ntt.inverse(r))), g)
               for r, g in zip(raw, got))
    jgkey = jr.galois_key_gen_single(k["jsk"], 1)
    gpk = dev._PackedKey(convert.hybrid_key_from(jgkey), "cpu")
    jgpk = jax_dev._PackedKey(jgkey)
    kidx = rotation_automorphism_index(N, 1)
    for n_l in (len(lvl), len(lvl) - 1):
        groups, rows = gpk.level_view(n_l)
        sub = lvl[:n_l]
        b0, b1 = a0[:n_l].contiguous(), a1[:n_l].contiguous()
        gk = (gpk.kb, gpk.kb_sh, gpk.ka, gpk.ka_sh)
        jgk = (jgpk.kb, jgpk.kb_sh, jgpk.ka, jgpk.ka_sh)
        got = dev.build_rotate(N, sub, gpk.p_moduli, groups, kidx, rows, t=T,
                               device="cpu")(b0, b1, *gk)
        want = jax_dev.build_rotate(N, sub, jgpk.p_moduli, groups, kidx, T, rows)(
            jx(b0), jx(b1), *jgk)
        assert all(eq(g, w) for g, w in zip(got, want))
        # the hoisted form equals the plain rotation, so the JAX rotation too
        pre = dev.build_ks_precompute(N, sub, gpk.p_moduli, groups, device="cpu")(b1)
        hoisted = dev.build_rotate_hoisted(N, sub, gpk.p_moduli, groups, kidx, rows, t=T,
                                           device="cpu")(b0, pre, *gk)
        assert all(torch.equal(h, g) for h, g in zip(hoisted, got))
    resc = dev._make_rescale(lvl, "cpu", T)(a0)
    assert eq(resc, jax_dev._make_rescale(lvl, T)(ja0))
    assert torch.equal(dev._make_rescale(lvl, "cpu")(a0), dev._make_rescale(lvl, "cpu", 1)(a0))
