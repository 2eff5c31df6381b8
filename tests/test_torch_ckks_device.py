"""The port's device CKKS path on torch CPU tensors against the JAX package:
`ops/modmathv.py` and `ops/nttl.py` against `ops/modmath32v.py` and
`ops/nttl.py` (inputs with 0, q-1 and a power-of-two limb), `pke/dcrt_device`
against its JAX twin, the fast base conversion with an input in the
fixed-point alpha's tie band, and `CKKSDeviceContext` (mult chains down 3
levels, rotations at two levels, hoisted rotations, add/sub, batches, the
plaintext and scalar `build_*` functions) against the JAX package's host
`CKKSRnsContext` at N = 32, L = 5, on identical keys and ciphertexts carried
across by `tfhe_tpu_torch.convert`, at dnum 2 and 3, and at dnum 2 (the
configuration of tests/test_ckks_device.py) against the JAX package's
`CKKSDeviceContext` as well; its own tests hold that equal to its host
context. Tolerance 0 wherever towers are compared; decryptions within
1e-3. JAX graphs are jitted once each, to keep its compile time down."""

from types import SimpleNamespace

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tfhe_tpu.ops import modmath32v as jax_mv
from tfhe_tpu.ops import nttl as jax_nttl
from tfhe_tpu.pke import ckks_device as jax_dev
from tfhe_tpu.pke import dcrt_device as jax_dd
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxRnsContext
from tfhe_tpu.pke.ckks_rns import fast_base_convert as jax_fbc
from tfhe_tpu.pke.dcrt import DCRTParams as JaxDCRTParams
from tfhe_tpu.pke.dcrt import DCRTPoly as JaxDCRTPoly
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.ops import modmathv as mv
from tfhe_tpu_torch.ops.nttl import NTTL
from tfhe_tpu_torch.pke import ckks_device as dev
from tfhe_tpu_torch.pke import dcrt_device as dd
from tfhe_tpu_torch.pke.ckks import CKKSContext
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from tfhe_tpu_torch.pke.dcrt import DCRTParams, DCRTPoly, _moduli_chain
from tfhe_tpu_torch.ref import ntt as ref_ntt
from test_torch_ckks_host import alpha_tie_band_rows
from torch_threads import one_torch_thread  # noqa: F401

Q28 = _moduli_chain(64, 2, 28)
Q30 = _moduli_chain(64, 1, 30)[0]
MODULI = Q28 + (Q30, 1 << 20, (1 << 31) - 1)          # a power of two, a Mersenne prime


def residues(rng, moduli, shape):
    """[L, *shape] residues mod each limb, with 0 and q-1 in the first two
    slots."""
    x = np.stack([rng.integers(0, q, shape, dtype=np.int64) for q in moduli])
    x.reshape(len(moduli), -1)[:, 0] = 0
    x.reshape(len(moduli), -1)[:, 1] = [q - 1 for q in moduli]
    return x


def jx(x):
    return jnp.asarray(np.asarray(x, dtype=np.int64).astype(np.uint32))


def eq(t, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j, dtype=np.uint32).astype(np.int64))


def test_modmathv_matches_modmath32v():
    rng = np.random.default_rng(10)
    lm, jlm = mv.LimbModuli(MODULI, device="cpu"), jax_mv.LimbModuli(MODULI)
    a, b = residues(rng, MODULI, (3, 40)), residues(rng, MODULI, (3, 40))[:, ::-1]
    x = rng.integers(0, 1 << 32, (len(MODULI), 3, 40), dtype=np.int64)
    x[:, 0, :4] = [0, 1, (1 << 32) - 1, (1 << 31)]
    x[:, 1, :2] = np.array([[q, q - 1] for q in MODULI])
    b_sh, jb_sh = lm.shoup(b), jlm.shoup(b.astype(np.uint32))
    assert np.array_equal(b_sh, jb_sh.astype(np.int64))
    ta, tb, tx = (torch.from_numpy(np.ascontiguousarray(v)) for v in (a, b, x))
    assert eq(mv.addmod_v(ta, tb, lm), jax_mv.addmod_v(jx(a), jx(b), jlm))
    assert eq(mv.submod_v(ta, tb, lm), jax_mv.submod_v(jx(a), jx(b), jlm))
    assert eq(mv.mulmod_shoup_v(ta, tb, torch.from_numpy(b_sh), lm),
              jax_mv.mulmod_shoup_v(jx(a), jx(b), jx(b_sh), jlm))
    assert eq(mv.mod_u32_v(tx, lm), jax_mv.mod_u32_v(jx(x), jlm))
    assert eq(mv.barrett_mulmod_v(ta, tb, lm), jax_mv.barrett_mulmod_v(jx(a), jx(b), jlm))
    one = lm.tensor(np.arange(1, len(MODULI) + 1))               # per-limb scalars
    one_sh = lm.tensor(lm.shoup(np.arange(1, len(MODULI) + 1)))
    assert eq(mv.mulmod_shoup_v(ta, lm.bc(one, 3), lm.bc(one_sh, 3), lm),
              jax_mv.mulmod_shoup_v(jx(a), jlm.bc(jx(np.arange(1, 6)), 3),
                                    jlm.bc(jx(lm.shoup(np.arange(1, 6))), 3), jlm))
    with pytest.raises(ValueError):
        mv.LimbModuli((1 << 31,), device="cpu")


@pytest.mark.parametrize("N", [32, 64])
def test_nttl_matches_jax_and_ref(N):
    moduli = _moduli_chain(N, 2, 28) + (_moduli_chain(N, 1, 30)[0],)
    rng = np.random.default_rng(N)
    x = residues(rng, moduli, (3, N))
    ntt, jntt = NTTL(N, moduli, device="cpu"), jax_nttl.NTTL(N, moduli)
    fwd = ntt.forward(torch.from_numpy(x))
    assert eq(fwd, jax.jit(jntt.forward)(jx(x)))
    assert all(np.array_equal(fwd[i].numpy(), ref_ntt.forward(x[i].astype(np.uint64), q)
                              .astype(np.int64)) for i, q in enumerate(moduli))
    inv = ntt.inverse(torch.from_numpy(x))
    assert eq(inv, jax.jit(jntt.inverse)(jx(x)))
    assert torch.equal(ntt.inverse(fwd), torch.from_numpy(x))


def test_dcrt_device_matches_jax():
    rng = np.random.default_rng(11)
    for moduli in (Q28 + (Q30,), _moduli_chain(64, 3, 28)):     # Q30: q_last > m
        lp, jlp = DCRTParams(64, moduli), JaxDCRTParams(64, moduli)
        cs = [rng.integers(-1 << 40, 1 << 40, 64) for _ in range(4)]
        ps = [DCRTPoly.from_signed(lp, c, True) for c in cs]
        jps = [JaxDCRTPoly.from_signed(jlp, c, True) for c in cs]
        assert np.array_equal(dd.rescale_device(ps[0], "cpu").rns,
                              jax_dd.rescale_device(jps[0]).rns)
    c = DCRTPoly.from_signed(lp, cs[0])
    assert np.array_equal(dd.to_eval_device(c, "cpu").rns,
                          jax_dd.to_eval_device(JaxDCRTPoly.from_signed(jlp, cs[0])).rns)
    got = dd.tensor_mult_device(ps[:2], ps[2:], "cpu")
    want = jax_dd.tensor_mult_device(jps[:2], jps[2:])
    assert all(np.array_equal(g.rns, w.rns) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        dd.build_to_eval(DCRTParams(64, (Q28[0], (1 << 31) + 1)), "cpu")


def test_fast_base_convert_device():
    """_make_fbc on a batch of rows, with 0, q-1 and a column in the tie band
    of the fixed-point alpha, against the JAX package's device and host
    conversions."""
    rng = np.random.default_rng(12)
    src = _moduli_chain(64, 2, 28)
    dst = _moduli_chain(64, 3, 28, skip=2) + (Q30,)
    rows = residues(rng, src, (2, 16))
    rows[:, 1, 5:6] = alpha_tie_band_rows(src).astype(np.int64)
    got = dev._make_fbc(src, dst, "cpu")(torch.from_numpy(rows))
    assert eq(got, jax.jit(jax_dev._make_fbc(src, dst))(jx(rows)))
    host = np.stack([jax_fbc(rows[:, b].astype(np.uint64), src, dst) for b in range(2)], axis=1)
    assert np.array_equal(got.numpy(), host.astype(np.int64))


@functools.lru_cache(maxsize=None)
def make_contexts(dnum: int) -> dict:
    """The JAX package's contexts at N = 32, L = 5 (28-bit limbs, as
    tests/test_ckks_device.py) and the port's on the same keys, carried
    across; the JAX device context at dnum 2 only."""
    p = JaxCKKSParams(N=32, dcrt=JaxDCRTParams.create(32, 5, 28), scale=float(1 << 28))
    jc = JaxCKKSContext(p, seed=33)
    jsk, jpk = jc.key_gen()
    jr = JaxRnsContext(jc, dnum=dnum, ks_limb_bits=28)
    jrlk = jr.relin_key_gen_single(jsk)
    jgk = {s: jr.galois_key_gen_single(jsk, s) for s in (1, 3)}
    jd = None
    if dnum == 2:
        jd = jax_dev.CKKSDeviceContext(jr)
        jd.load_relin_keys(jrlk)
        for s, key in jgk.items():
            jd.load_galois_keys(s, key)
    c = CKKSContext(convert.ckks_params_from(p), seed=33)
    r = CKKSRnsContext(c, dnum=dnum, ks_limb_bits=28)
    rlk = convert.hybrid_key_from(jrlk)
    d = dev.CKKSDeviceContext(r, device="cpu")
    d.load_relin_keys(rlk)
    for s, key in jgk.items():
        d.load_galois_keys(s, convert.hybrid_key_from(key))
    enc = [jc.encrypt(jpk, z) for z in
           (np.linspace(0.3, 0.95, 16), np.linspace(-0.9, 0.9, 16), np.linspace(0.5, 0.1, 16))]
    return dict(jsk=jsk, jc=jc, jr=jr, jd=jd, jrlk=jrlk, jgk=jgk, c=c, r=r, d=d, rlk=rlk,
                sk=convert.ckks_secret_from(jsk), jcts=enc,
                cts=[convert.ckks_ciphertext_from(x, c.params) for x in enc])


@pytest.fixture(scope="module", params=[2, 3], ids=["dnum2", "dnum3"])
def contexts(request):
    return make_contexts(request.param)


def towers(ct) -> list:
    return [np.asarray(p.to_eval().rns, dtype=np.uint64) for p in ct.polys]


def same(*cts) -> bool:
    first = towers(cts[0])
    return all(len(towers(x)) == len(first) and all(
        np.array_equal(a, b) for a, b in zip(towers(x), first)) for x in cts[1:])


def decrypts(k, ct, want) -> bool:
    return np.abs(k["c"].decrypt(k["sk"], ct) - want).max() < 1e-3


def test_device_mult_chain(contexts):
    """Squaring chain 5 -> 2 limbs: the port's device == the JAX package's
    device == the JAX host RNS chain at every level; a batch of two
    ciphertexts in one call equals them one by one."""
    k = contexts
    d, jd, jr = k["d"], k["jd"], k["jr"]
    x, hx = d.upload(k["cts"][0]), k["jcts"][0]
    jx_ = jd and jd.upload(k["jcts"][0])
    batch = d.upload_batch(k["cts"][:2])
    z = np.linspace(0.3, 0.95, 16)
    for level in range(3):
        x, hx = d.eval_mult(x, x), jr.eval_mult(hx, hx, k["jrlk"])
        batch = d.eval_mult(batch, batch)
        got = d.download(x)
        assert got.scale == hx.scale and x.moduli == hx.level_params.moduli
        assert same(got, hx), level
        if jd:
            jx_ = jd.eval_mult(jx_, jx_)
            assert same(got, jd.download(jx_)), level
        assert same(d.download_batch(batch)[0], got)
        z = z * z
        assert decrypts(k, got, z)
    y = d.upload(k["cts"][1])
    for _ in range(3):
        y = d.eval_mult(y, y)
    assert same(d.download_batch(batch)[1], d.download(y))


def test_device_rotate_at_two_levels(contexts):
    """eval_rotate at the full chain and after a mult (the full-chain key's
    level view), against both JAX paths."""
    k = contexts
    d, jd, jr = k["d"], k["jd"], k["jr"]
    z = np.linspace(-0.9, 0.9, 16)
    x, hx = d.upload(k["cts"][1]), k["jcts"][1]
    jx_ = jd and jd.upload(k["jcts"][1])
    for level, jax_step in enumerate((1, 3)):
        for s in (1, 3):
            got = d.download(d.eval_rotate(x, s))
            assert same(got, jr.eval_rotate(hx, s, k["jgk"][s])), (level, s)
            assert decrypts(k, got, np.roll(z, -s))
            if jd and s == jax_step:
                assert same(got, jd.download(jd.eval_rotate(jx_, s))), (level, s)
        x, hx = d.eval_mult(x, x), jr.eval_mult(hx, hx, k["jrlk"])
        jx_ = jd and jd.eval_mult(jx_, jx_)
        z = z * z


def test_device_hoisted_rotations(contexts):
    k = contexts
    d, jd, jr = k["d"], k["jd"], k["jr"]
    x = d.eval_mult(d.upload(k["cts"][2]), d.upload(k["cts"][2]))
    hx = jr.eval_mult(k["jcts"][2], k["jcts"][2], k["jrlk"])
    pre = d.rotation_precompute(x)
    hpre = jr.rotation_precompute(hx, k["jgk"][1])
    assert np.array_equal(pre.numpy(), np.stack([p.rns for p in hpre]).astype(np.int64))
    if jd:
        jx_ = jd.eval_mult(jd.upload(k["jcts"][2]), jd.upload(k["jcts"][2]))
        jpre = jd.rotation_precompute(jx_)
        assert eq(pre, jpre)
        assert same(d.download(d.eval_rotate_hoisted(x, 3, pre)),
                    jd.download(jd.eval_rotate_hoisted(jx_, 3, jpre)))
    z = np.linspace(0.5, 0.1, 16) ** 2
    for s in (1, 3):
        got = d.download(d.eval_rotate_hoisted(x, s, pre))
        assert same(got, jr.eval_rotate_hoisted(hx, s, k["jgk"][s], hpre),
                    d.download(d.eval_rotate(x, s)))
        assert decrypts(k, got, np.roll(z, -s))
    batch = d.upload_batch(k["cts"][:2])
    rot = d.download_batch(d.eval_rotate_hoisted(batch, 3, d.rotation_precompute(batch)))
    assert all(same(rot[b], d.download(d.eval_rotate(d.upload(k["cts"][b]), 3)))
               for b in range(2))


def test_device_add_sub(contexts):
    k = contexts
    d, jd, jr = k["d"], k["jd"], k["jr"]
    a, b = d.upload(k["cts"][0]), d.upload(k["cts"][1])
    add = d.download(d.eval_add(a, b))
    sub = d.download(d.eval_sub(a, b))
    assert same(add, jr.eval_add(k["jcts"][0], k["jcts"][1]))
    assert same(d.download(d.eval_add(d.upload(sub), b)), d.download(a))
    if jd:
        ja, jb = jd.upload(k["jcts"][0]), jd.upload(k["jcts"][1])
        assert same(add, jd.download(jd.eval_add(ja, jb)))
        assert same(sub, jd.download(jd.eval_sub(ja, jb)))
    z0, z1 = np.linspace(0.3, 0.95, 16), np.linspace(-0.9, 0.9, 16)
    assert decrypts(k, add, z0 + z1) and decrypts(k, sub, z0 - z1)


def test_device_plain_and_scalar_ops():
    """The plaintext, scalar, rescale-only and unrescaled-mult `build_*`
    functions on a batch, against the JAX package's (the other flag of
    each against its composition with the checked ones)."""
    k = make_contexts(2)
    d, jd = k["d"], k["jd"]
    N, lvl = 32, d.upload(k["cts"][0]).moduli
    rng = np.random.default_rng(13)
    batch = d.upload_batch(k["cts"][:2])
    jb0, jb1 = jx(batch.c0.numpy()), jx(batch.c1.numpy())
    pt = residues(rng, lvl, (N,))
    ks = np.array([q - 1 - i for i, q in enumerate(lvl)])
    tpt, tks = torch.from_numpy(pt), torch.from_numpy(ks)
    rescale = dev.build_rescale_only(N, lvl, device="cpu")
    got = rescale(batch.c0, batch.c1)
    assert all(eq(g, w) for g, w in zip(got, jax_dev.build_rescale_only(N, lvl)(jb0, jb1)))
    plain = dev.build_mult_plain(N, lvl, True, device="cpu")(batch.c0, batch.c1, tpt)
    want = jax_dev.build_mult_plain(N, lvl, True)(jb0, jb1, jx(pt))
    assert all(eq(g, w) for g, w in zip(plain, want))
    raw = dev.build_mult_plain(N, lvl, False, device="cpu")(batch.c0, batch.c1, tpt)
    assert all(torch.equal(g, w) for g, w in zip(rescale(*raw), plain))
    raw = dev.build_mult_scalar(N, lvl, False, device="cpu")(batch.c0, batch.c1, tks)
    want = jax_dev.build_mult_scalar(N, lvl, False)(jb0, jb1, jx(ks))
    assert all(eq(g, w) for g, w in zip(raw, want))
    got = dev.build_mult_scalar(N, lvl, True, device="cpu")(batch.c0, batch.c1, tks)
    assert all(torch.equal(g, w) for g, w in zip(got, rescale(*raw)))
    added = dev.build_add_plain(N, lvl, False, device="cpu")(batch.c0, tpt)
    assert eq(added, jax_dev.build_add_plain(N, lvl, False)(jb0, jx(pt)))
    assert torch.equal(dev.build_add_plain(N, lvl, True, device="cpu")(added, tpt), batch.c0)
    assert eq(dev.build_add_scalar(lvl, device="cpu")(batch.c0, tks),
              jax_dev.build_add_scalar(lvl)(jb0, jx(ks)))
    key, jkey = d._rlk[len(lvl)], jd._rlk[len(lvl)]
    got = dev.build_mult_relin_rescale(N, lvl, key.p_moduli, key.groups, None, False,
                                       device="cpu")(batch.c0, batch.c1, batch.c0, batch.c1,
                                                     key.kb, key.kb_sh, key.ka, key.ka_sh)
    want = jax_dev.build_mult_relin_rescale(N, lvl, jkey.p_moduli, jkey.groups, 1, None,
                                            False)(jb0, jb1, jb0, jb1, jkey.kb, jkey.kb_sh,
                                                   jkey.ka, jkey.ka_sh)
    assert all(eq(g, w) for g, w in zip(got, want))


def test_per_level_keys_and_refusals(contexts):
    """Per-level key dicts serve the same chain; the default device is the
    card, which this path never leaves for the CPU; limbs of 2^31 and above
    are refused."""
    k = contexts
    jkeys = k["jr"].relin_key_gen(k["jsk"])
    d = dev.CKKSDeviceContext(k["r"], device="cpu")
    d.load_relin_keys({L: convert.hybrid_key_from(key) for L, key in jkeys.items()})
    x, hx = d.upload(k["cts"][0]), k["jcts"][0]
    for level in range(3):
        x, hx = d.eval_mult(x, x), k["jr"].eval_mult(hx, hx, jkeys)
        assert same(d.download(x), hx), level
    on_card = dev.CKKSDeviceContext(k["r"])
    assert on_card.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            on_card.upload(k["cts"][0])
    with pytest.raises(ValueError):
        dev._PackedKey(SimpleNamespace(pq_params=DCRTParams(32, ((1 << 31) + 11,))), "cpu")
