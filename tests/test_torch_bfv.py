"""The port's BFV stack against the JAX package's, exactly: the HPS
fixed point and base conversions of `bfv_rns` (`_fp_round_dot`,
`expand_crt_basis`, `scale_and_round`), the device fixed-point helpers of
`bfv_device` (`_fp_dot_words`, `_fp_round_shift` at F = 80 and 64, ten
30-bit limbs), the BEHZ lift, floor and Shenoy-Kumaresan builders of
`bfv_behz_device` (with the m~ = 2^16 channel's rows pushed to the masking
and centering edges), `BFVRnsContext` and `BFVBehzContext` (mult, the
depth-2 chain, rotation), `BFVDeviceContext` and `BFVBehzDeviceContext` on
the CPU (batched mult, chain, rotation, add, sub) against the JAX
package's device contexts (jit on the CPU) and host contexts, and
`advanced` (EvalSum, inner product, proxy re-encryption with HRA
re-randomization, 3-party threshold decryption).

The ring is tests/test_bfv_device.py's: N = 64, t = 257, mult depth 2,
28-bit limbs, dnum 2, 28-bit special limbs. Keys and ciphertexts come from
identically seeded contexts and are also carried across with
`tfhe_tpu_torch.convert`. Tolerance 0 wherever towers or words are
compared. Each JAX device graph is jitted once (one module-scoped context,
one batch shape)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tfhe_tpu.pke import advanced as jax_adv
from tfhe_tpu.pke import bfv_behz as jax_behz
from tfhe_tpu.pke import bfv_behz_device as jax_behz_dev
from tfhe_tpu.pke import bfv_device as jax_dev
from tfhe_tpu.pke import bfv_rns as jax_rns
from tfhe_tpu.pke.bfv import BFVContext as JaxBFVContext
from tfhe_tpu.pke.bfv import BFVParams as JaxBFVParams
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.ops import modmathv as mv
from tfhe_tpu_torch.pke import advanced as adv
from tfhe_tpu_torch.pke import bfv_behz as behz
from tfhe_tpu_torch.pke import bfv_behz_device as behz_dev
from tfhe_tpu_torch.pke import bfv_device as dev
from tfhe_tpu_torch.pke import bfv_rns as rns
from tfhe_tpu_torch.pke.bfv import BFVContext, BFVParams
from tfhe_tpu_torch.pke.dcrt import _moduli_chain
from torch_threads import one_torch_thread  # noqa: F401

N, T = 64, 257
BATCH = 2
STEPS = 3
MT = behz.MTILDE


def towers(ct) -> list:
    return [np.asarray(p.to_eval().rns, dtype=np.uint64) for p in ct.polys]


def assert_same(want, *got):
    for g in got:
        assert g.polys[0].params.moduli == want.polys[0].params.moduli
        assert len(g.polys) == len(want.polys)
        assert all(np.array_equal(a, b) for a, b in zip(towers(want), towers(g)))


def same_poly(a, b) -> bool:
    return a.params.moduli == b.params.moduli and np.array_equal(
        a.to_eval().rns, b.to_eval().rns)


def rows_mod(rng, mods, n: int) -> np.ndarray:
    """[len(mods), n] uint64 residues, 0 and q-1 in the first two columns."""
    x = np.stack([rng.integers(0, m, n, dtype=np.int64) for m in mods]).astype(np.uint64)
    x[:, 0] = 0
    x[:, 1] = [m - 1 for m in mods]
    return x


def jx(x):
    return jnp.asarray(np.asarray(x, dtype=np.uint64).astype(np.uint32))


def tx(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.uint64).astype(np.int64))


def eq(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j, dtype=np.uint32).astype(np.int64))


def rotated(v, steps):
    h = N // 2
    return np.concatenate([np.roll(v[:h], -steps), np.roll(v[h:], -steps)])


# -- the host fixed point and base conversions ------------------------------

def test_fixed_point_and_base_conversions_match():
    rng = np.random.default_rng(70)
    q = _moduli_chain(N, 4, 28)
    r = _moduli_chain(N, 6, 28, skip=4)
    numers = [int(x) for x in rng.integers(1, 1 << 28, len(q))]
    for F in (80, 64):
        w, jw = rns._fp_split(numers, q, F), jax_rns._fp_split(numers, q, F)
        assert all(np.array_equal(a, b) for a, b in zip(w, jw))
        y = rows_mod(rng, q, 300)
        assert np.array_equal(rns._fp_round_dot(y, w, F), jax_rns._fp_round_dot(y, jw, F))
    x = rows_mod(rng, q, 300)
    assert np.array_equal(rns.expand_crt_basis(x, q, r), jax_rns.expand_crt_basis(x, q, r))
    xr = rows_mod(rng, r, 300)
    assert np.array_equal(rns.expand_crt_basis(xr, r, q), jax_rns.expand_crt_basis(xr, r, q))
    xqr = rows_mod(rng, q + r, 300)
    assert np.array_equal(rns.scale_and_round(xqr, q, r, T),
                          jax_rns.scale_and_round(xqr, q, r, T))


# -- the device fixed point --------------------------------------------------

@pytest.mark.parametrize("F", [80, 64])
def test_device_fixed_point_matches(F):
    """Word sums and the rounding shift at ten 30-bit limbs: the alpha
    table (numerators 1), a theta-like table (numerators below the
    moduli), and words drawn at random over all 32 bits (every column's
    carries, the top word's wrap), on rows with 0 and q-1."""
    rng = np.random.default_rng(71 + F)
    q = _moduli_chain(N, 10, 30)
    lm = mv.LimbModuli(tuple(q), device="cpu")
    y = rows_mod(rng, q, 256)
    tables = [rns._fp_split([1] * len(q), q, F),
              rns._fp_split([int(rng.integers(1, m)) for m in q], q, F),
              tuple(rng.integers(0, 1 << 32, len(q), dtype=np.uint64) for _ in range(3))]
    for i, words in enumerate(tables):
        jws = jax_dev._fp_dot_words([jx(row) for row in y], words)
        ws = dev._fp_dot_words(tx(y), dev._word_tensors(words, lm))
        assert all(eq(a, b) for a, b in zip(ws, jws))
        jlo, jhi = jax_dev._fp_round_shift(list(jws), F)
        lo, hi = dev._fp_round_shift(ws, F)
        assert eq(lo, jlo) and eq(hi, jhi)
        if i < 2:       # the rounded value is the host's
            assert np.array_equal((hi.numpy() << 32) + lo.numpy(),
                                  rns._fp_round_dot(y, words, F))


# -- the BEHZ device builders ------------------------------------------------

def edge_rows(rng, q: tuple, bsk: tuple, n: int) -> np.ndarray:
    """Coefficient rows over Q whose Montgomery-twisted residues y push the
    m~ channel: r_m at 0, 2^15 - 1, 2^15 and 2^16 - 1 (the centering edge),
    y with all 16 low bits set, y = q - 1, and random columns."""
    tabs = behz._behz_tables(tuple(q), tuple(bsk), T)
    mqi, qhat_mt, negq = tabs[0], tabs[2], int(tabs[3])
    y = rows_mod(rng, q, n)
    for c, r_target in enumerate((0, MT // 2 - 1, MT // 2, MT - 1)):
        col = 2 + c
        s_need = r_target * pow(negq, -1, MT) % MT
        rest = sum((int(y[i, col]) & (MT - 1)) * int(qhat_mt[i]) for i in range(1, len(q)))
        low = (s_need - rest) * pow(int(qhat_mt[0]) % MT, -1, MT) % MT
        y[0, col] = low + (int(rng.integers(0, (q[0] - 1 - low) >> 16)) << 16)
    for i, m in enumerate(q):
        y[i, 6] = (((m - 1 - 0xFFFF) >> 16) << 16) | 0xFFFF     # 16 low bits set
        y[i, 7] = m - 1
    y = y.astype(np.uint64)
    r_m = np.zeros(n, dtype=np.uint64)
    for i in range(len(q)):
        r_m = (r_m + (y[i] & np.uint64(MT - 1)) * (qhat_mt[i] & np.uint64(MT - 1))) \
            & np.uint64(MT - 1)
    r_m = (r_m * np.uint64(negq)) & np.uint64(MT - 1)
    assert list(r_m[2:6]) == [0, MT // 2 - 1, MT // 2, MT - 1]
    assert all(int(v) & (MT - 1) == MT - 1 for v in y[:, 6])
    inv = [pow(int(m_), -1, m) for m_, m in zip(mqi, q)]
    return np.stack([(y[i].astype(object) * inv[i] % m).astype(np.uint64)
                     for i, m in enumerate(q)])


def test_behz_device_steps_match():
    rng = np.random.default_rng(72)
    q = _moduli_chain(N, 3, 28)
    bsk = behz.choose_bsk_moduli(N, q, T)
    assert bsk == jax_behz.choose_bsk_moduli(N, q, T)
    x = edge_rows(rng, q, bsk, 64)
    got = behz_dev._make_lift_bsk(q, bsk, T, "cpu")(tx(x))
    assert eq(got, jax_behz_dev._make_lift_bsk(q, bsk, T)(jx(x)))
    assert eq(got, behz.fast_base_conv_q_to_bsk(x, q, bsk, T))
    assert eq(got, jax_behz.fast_base_conv_q_to_bsk(x, q, bsk, T))
    xq, xb = rows_mod(rng, q, 64), rows_mod(rng, bsk, 64)
    got = behz_dev._make_floor(q, bsk, T, "cpu")(tx(xq), tx(xb))
    assert eq(got, jax_behz_dev._make_floor(q, bsk, T)(jx(xq), jx(xb)))
    assert eq(got, jax_behz.fast_rns_floor_q(xq, xb, q, bsk, T))
    got = behz_dev._make_conv_sk(q, bsk, T, "cpu")(tx(xb))
    assert eq(got, jax_behz_dev._make_conv_sk(q, bsk, T)(jx(xb)))
    assert eq(got, jax_behz.fast_base_conv_sk(xb, q, bsk, T))


# -- the contexts --------------------------------------------------------------

@pytest.fixture(scope="module")
def bfv():
    """The JAX package's BFV contexts and the port's from one seed: the HPS
    and BEHZ contexts on one base, each with its relinearization key and
    rotation-by-3 Galois key, and three batches of packed ciphertexts."""
    jp = JaxBFVParams.create(N=N, t=T, mult_depth=2, limb_bits=28)
    p = BFVParams.create(N=N, t=T, mult_depth=2, limb_bits=28)
    assert p == convert.bfv_params_from(jp)
    jc, c = JaxBFVContext(jp, seed=41), BFVContext(p, seed=41)
    (jsk, jpk), (sk, pk) = jc.key_gen(), c.key_gen()
    assert same_poly(convert.bfv_secret_from(jsk).s, sk.s)
    assert same_poly(convert.bfv_public_from(jpk).b, pk.b)
    tech = {}
    for name, jcls, cls in (("hps", jax_rns.BFVRnsContext, rns.BFVRnsContext),
                            ("behz", jax_behz.BFVBehzContext, behz.BFVBehzContext)):
        jr, r = jcls(jc, dnum=2, ks_limb_bits=28), cls(c, dnum=2, ks_limb_bits=28)
        assert r.r_moduli == jr.r_moduli
        assert getattr(r, "bsk_moduli", None) == getattr(jr, "bsk_moduli", None)
        jrlk, rlk = jr.relin_key_gen(jsk), r.relin_key_gen(sk)
        jgk, gk = jr.galois_key_gen(jsk, STEPS), r.galois_key_gen(sk, STEPS)
        for k, jk in ((rlk, jrlk), (gk, jgk), (convert.hybrid_key_from(jgk), jgk)):
            assert k.groups == [tuple(g) for g in jk.groups] and k.p_moduli == tuple(jk.p_moduli)
            assert all(same_poly(a, b) for a, b in zip(k.bs + k.as_, jk.bs + jk.as_))
        tech[name] = dict(jr=jr, r=r, jrlk=jrlk, rlk=rlk, jgk=jgk, gk=gk)
    rng = np.random.default_rng(0)
    vs = [[rng.integers(0, T, N) for _ in range(BATCH)] for _ in range(3)]
    r = tech["hps"]["r"]
    jr = tech["hps"]["jr"]
    jcts = [[jr.encrypt_packed(jpk, v) for v in vv] for vv in vs]
    cts = [[r.encrypt_packed(pk, v) for v in vv] for vv in vs]
    for jrow, row in zip(jcts, cts):
        for jct, ct in zip(jrow, row):
            assert_same(jct, ct, convert.bfv_ciphertext_from(jct, p))
    return dict(jc=jc, c=c, sk=sk, tech=tech, vs=vs, jcts=jcts, cts=cts)


@pytest.mark.parametrize("technique", ["hps", "behz"])
def test_host_contexts_match(bfv, technique):
    """mult, the depth-2 chain x*y*z and the rotation by 3 on the host,
    tower for tower against the JAX package's, decrypted right."""
    k, sk, vs = bfv["tech"][technique], bfv["sk"], bfv["vs"]
    r, jr = k["r"], k["jr"]
    x, y, z = (row[0] for row in bfv["cts"])
    jx_, jy, jz = (row[0] for row in bfv["jcts"])
    xy = r.eval_mult(x, y, k["rlk"])
    assert_same(jr.eval_mult(jx_, jy, k["jrlk"]), xy)
    assert np.array_equal(r.decrypt_packed(sk, xy), vs[0][0] * vs[1][0] % T)
    xyz = r.eval_mult(xy, z, k["rlk"])
    assert_same(jr.eval_mult(jr.eval_mult(jx_, jy, k["jrlk"]), jz, k["jrlk"]), xyz)
    assert np.array_equal(r.decrypt_packed(sk, xyz),
                          vs[0][0] * vs[1][0] % T * vs[2][0] % T)
    rot = r.eval_rotate(x, STEPS, k["gk"])
    assert_same(jr.eval_rotate(jx_, STEPS, k["jgk"]), rot)
    assert np.array_equal(r.decrypt_packed(sk, rot), rotated(vs[0][0], STEPS))


@pytest.mark.parametrize("technique", ["hps", "behz"])
def test_device_contexts_match(bfv, technique):
    """The device contexts on the CPU at batch 2 ([L, 2, N] towers): mult,
    the chain, rotation, add and sub equal the JAX package's device
    contexts (jit on the CPU) tower for tower, and every ciphertext equals
    the host context's."""
    k, c, sk, vs = bfv["tech"][technique], bfv["c"], bfv["sk"], bfv["vs"]
    r = k["r"]
    cls, jcls = ((dev.BFVDeviceContext, jax_dev.BFVDeviceContext) if technique == "hps"
                 else (behz_dev.BFVBehzDeviceContext, jax_behz_dev.BFVBehzDeviceContext))
    d, jd = cls(r, device="cpu"), jcls(k["jr"])
    d.load_relin_key(k["rlk"])
    jd.load_relin_key(k["jrlk"])
    d.load_galois_key(STEPS, k["gk"])
    jd.load_galois_key(STEPS, k["jgk"])
    X, Y, Z = (d.upload_batch(row) for row in bfv["cts"])
    JX, JY, JZ = (jd.upload_batch(row) for row in bfv["jcts"])
    x, y, z = bfv["cts"]

    def holds(got, jgot, host):
        assert got.c0.device.type == "cpu" and got.moduli == jgot.moduli
        assert eq(got.c0, jgot.c0) and eq(got.c1, jgot.c1)
        for b, ct in enumerate(d.download_batch(got)):
            assert_same(host(b), ct)
        return d.download_batch(got)

    xy = d.eval_mult(X, Y)
    holds(xy, jd.eval_mult(JX, JY), lambda b: r.eval_mult(x[b], y[b], k["rlk"]))
    outs = holds(d.eval_mult(xy, Z), jd.eval_mult(jd.eval_mult(JX, JY), JZ),
                 lambda b: r.eval_mult(r.eval_mult(x[b], y[b], k["rlk"]), z[b], k["rlk"]))
    for b, ct in enumerate(outs):
        assert np.array_equal(r.decrypt_packed(sk, ct),
                              vs[0][b] * vs[1][b] % T * vs[2][b] % T)
    outs = holds(d.eval_rotate(X, STEPS), jd.eval_rotate(JX, STEPS),
                 lambda b: r.eval_rotate(x[b], STEPS, k["gk"]))
    assert np.array_equal(r.decrypt_packed(sk, outs[1]), rotated(vs[0][1], STEPS))
    holds(d.eval_add(X, Y), jd.eval_add(JX, JY), lambda b: r.eval_add(x[b], y[b]))
    outs = holds(d.eval_sub(X, Y), jd.eval_sub(JX, JY), lambda b: c.eval_sub(x[b], y[b]))
    assert np.array_equal(r.decrypt_packed(sk, outs[0]), (vs[0][0] - vs[1][0]) % T)


def test_device_context_defaults_to_the_card(bfv):
    """No fallback: the default device is "cuda", so on a torch without
    CUDA the upload raises instead of evaluating on the host."""
    r = bfv["tech"]["hps"]["r"]
    d = dev.BFVDeviceContext(r)
    assert d.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            d.upload(bfv["cts"][0][0])


# -- advanced: EvalSum, inner product, PRE, threshold -------------------------

@pytest.fixture(scope="module")
def adv_ctx():
    jp = JaxBFVParams.create(N=N, t=T, mult_depth=1)
    p = BFVParams.create(N=N, t=T, mult_depth=1)
    jc, c = JaxBFVContext(jp, seed=23), BFVContext(p, seed=23)
    return jc, c, jc.key_gen(), c.key_gen()


def test_eval_sum_and_inner_product_match(adv_ctx):
    jc, c, (jsk, jpk), (sk, pk) = adv_ctx
    jkeys, keys = jax_adv.eval_sum_key_gen(jc, jsk), adv.eval_sum_key_gen(c, sk)
    assert sorted(keys) == sorted(jkeys) == [1, 2, 4, 8, 16]
    rng = np.random.default_rng(80)
    v = rng.integers(0, 50, N)
    out = adv.eval_sum(c, c.encrypt_packed(pk, v), keys)
    assert_same(jax_adv.eval_sum(jc, jc.encrypt_packed(jpk, v), jkeys), out)
    got = c.decrypt_packed(sk, out)
    assert np.all(got[:N // 2] == int(v[:N // 2].sum()) % T)
    assert np.all(got[N // 2:] == int(v[N // 2:].sum()) % T)
    jrlk, rlk = jc.relin_key_gen(jsk), c.relin_key_gen(sk)
    v1, v2 = np.zeros(N, dtype=np.int64), np.zeros(N, dtype=np.int64)
    v1[:N // 2], v2[:N // 2] = rng.integers(0, 10, N // 2), rng.integers(0, 10, N // 2)
    out = adv.eval_inner_product(c, c.encrypt_packed(pk, v1), c.encrypt_packed(pk, v2),
                                 rlk, keys)
    want = jax_adv.eval_inner_product(jc, jc.encrypt_packed(jpk, v1),
                                      jc.encrypt_packed(jpk, v2), jrlk, jkeys)
    assert_same(want, out)
    assert int(c.decrypt_packed(sk, out)[0]) == int((v1 * v2).sum()) % T


def test_pre_and_threshold_match(adv_ctx):
    """Proxy re-encryption, plain and with the HRA re-randomization, and
    3-party threshold decryption (flooded shares, fusion) from the same
    seed: every ciphertext and share the JAX package's."""
    jc, c, (jsk, jpk), (sk, pk) = adv_ctx
    (jsk_b, _), (sk_b, _) = jc.key_gen(), c.key_gen()
    jrk, rk = jax_adv.re_key_gen(jc, jsk, jsk_b), adv.re_key_gen(c, sk, sk_b)
    assert all(same_poly(a, b) for a, b in zip(rk.b + rk.a, jrk.b + jrk.a))
    m = (np.arange(N) * 7) % T
    jct, ct = jc.encrypt(jpk, m), c.encrypt(pk, m)
    plain = adv.re_encrypt(c, ct, rk)
    assert_same(jax_adv.re_encrypt(jc, jct, jrk), plain)
    hra = adv.re_encrypt(c, ct, rk, public_key=pk)
    assert_same(jax_adv.re_encrypt(jc, jct, jrk, public_key=jpk), hra)
    assert np.array_equal(c.decrypt(sk_b, plain), m)
    assert np.array_equal(c.decrypt(sk_b, hra), m)
    jparties, jjpk, _ = jax_adv.multiparty_key_gen(jc, 3)
    parties, jpk3, _ = adv.multiparty_key_gen(c, 3)
    assert same_poly(jpk3.b, jjpk.b)
    m = np.random.default_rng(81).integers(0, T, N)
    jct, ct = jc.encrypt(jjpk, m), c.encrypt(jpk3, m)
    assert_same(jct, ct)
    jshares = [jax_adv.multiparty_decrypt_lead(jc, jparties[0], jct)]
    jshares += [jax_adv.multiparty_decrypt_main(jc, q, jct) for q in jparties[1:]]
    shares = [adv.multiparty_decrypt_lead(c, parties[0], ct)]
    shares += [adv.multiparty_decrypt_main(c, q, ct) for q in parties[1:]]
    assert all(same_poly(a, b) for a, b in zip(shares, jshares))
    got = adv.multiparty_decrypt_fusion(c, shares)
    assert np.array_equal(got, jax_adv.multiparty_decrypt_fusion(jc, jshares))
    assert np.array_equal(got, m)
