"""The port's pke host layers (`tfhe_tpu_torch.pke`: dcrt, encoding,
keyswitch, ckks, ckks_rns) against their originals in `tfhe_tpu.pke`, array
for array, on the same seeds: moduli chains and DCRT tower arithmetic,
packed encoding and automorphisms, the big-integer hybrid key switch,
`CKKSContext` keygen, encryption, decryption and host mult, the pure-RNS
fast base conversion (with an input in the fixed-point alpha's tie band),
and `CKKSRnsContext` mult chains, rotations and hoisted rotations at N = 32
and 64, L = 4 and 5, dnum 2 and 3, 28-bit special limbs. Tolerance 0
wherever towers are compared."""

import numpy as np
import pytest

from tfhe_tpu.pke import ckks as jax_ckks
from tfhe_tpu.pke import ckks_rns as jax_rns
from tfhe_tpu.pke import dcrt as jax_dcrt
from tfhe_tpu.pke import encoding as jax_enc
from tfhe_tpu.pke import keyswitch as jax_ks
from tfhe_tpu.utils.rng import BinFHERng as JaxRng
from tfhe_tpu_torch.pke import ckks, ckks_rns, dcrt, encoding, keyswitch
from tfhe_tpu_torch.utils.rng import BinFHERng
from torch_threads import one_torch_thread  # noqa: F401


def same_towers(xs, ys) -> bool:
    return len(xs) == len(ys) and all(
        x.params.moduli == y.params.moduli and x.eval_form == y.eval_form
        and np.array_equal(x.rns, y.rns) for x, y in zip(xs, ys))


def same_ct(x, y) -> bool:
    return x.scale == y.scale and x.noise_deg == y.noise_deg \
        and same_towers(x.polys, y.polys)


@pytest.mark.parametrize("N, L, bits, extra", [(32, 5, 28, 1), (64, 4, 40, 1),
                                               (64, 3, 28, 257), (1024, 3, 54, 1)])
def test_moduli_chains(N, L, bits, extra):
    assert dcrt._moduli_chain(N, L, bits, 2, extra) == \
        jax_dcrt._moduli_chain(N, L, bits, 2, extra)
    assert dcrt.DCRTParams.create(N, L, bits, extra).moduli == \
        jax_dcrt.DCRTParams.create(N, L, bits, extra).moduli
    pattern = (bits + 2,) + (bits,) * (L - 1) + (bits - 1,)
    assert dcrt._moduli_chain_pattern(N, pattern, extra) == \
        jax_dcrt._moduli_chain_pattern(N, pattern, extra)


def test_dcrt_poly_arithmetic():
    rng = np.random.default_rng(1)
    lp, jlp = dcrt.DCRTParams.create(64, 4, 28), jax_dcrt.DCRTParams.create(64, 4, 28)
    ca, cb = rng.integers(-1 << 40, 1 << 40, 64), rng.integers(-5, 6, 64)
    a, b = dcrt.DCRTPoly.from_signed(lp, ca), dcrt.DCRTPoly.from_signed(lp, cb, True)
    ja, jb = jax_dcrt.DCRTPoly.from_signed(jlp, ca), jax_dcrt.DCRTPoly.from_signed(jlp, cb, True)
    assert same_towers([a, a.to_eval(), a.to_eval().to_coeff(), b, b.to_coeff()],
                       [ja, ja.to_eval(), ja.to_eval().to_coeff(), jb, jb.to_coeff()])
    assert np.array_equal(a.to_eval().to_coeff().rns, a.rns)
    ae, jae = a.to_eval(), ja.to_eval()
    assert same_towers([ae + b, ae - b, ae * b, -ae, ae.mul_scalar(-12345),
                        dcrt.DCRTPoly.zero(lp)],
                       [jae + jb, jae - jb, jae * jb, -jae, jae.mul_scalar(-12345),
                        jax_dcrt.DCRTPoly.zero(jlp)])
    big = [int(x) * (1 << 70) + 3 for x in ca]
    assert same_towers([dcrt.DCRTPoly.from_bigint(lp, big)],
                       [jax_dcrt.DCRTPoly.from_bigint(jlp, big)])
    assert a.to_bigint() == ja.to_bigint()
    assert ae.to_centered_bigint() == jae.to_centered_bigint() == [int(x) for x in ca]


def test_encoding_and_automorphisms():
    N, t = 32, 65537                                  # t = 1 mod 2N
    values = np.arange(-20, 12)
    assert encoding.supports_packing(t, N) and not encoding.supports_packing(257, 256)
    coeffs = encoding.pack(values, t, N)
    assert np.array_equal(coeffs, jax_enc.pack(values, t, N))
    assert np.array_equal(encoding.unpack(coeffs, t, N), jax_enc.unpack(coeffs, t, N))
    assert np.array_equal(encoding.unpack(coeffs, t, N), values % t)
    for steps in (-3, 0, 1, 5, 17):
        k = encoding.rotation_automorphism_index(N, steps)
        assert k == jax_enc.rotation_automorphism_index(N, steps)
        assert np.array_equal(encoding.apply_automorphism_coeff(coeffs, k, t),
                              jax_enc.apply_automorphism_coeff(coeffs, k, t))
    s = encoding.encode_string("ckks on the card", 256, N)
    assert np.array_equal(s, jax_enc.encode_string("ckks on the card", 256, N))
    assert encoding.decode_string(s, 256, N) == jax_enc.decode_string(s, 256, N)


def test_big_integer_hybrid_key_switch():
    """relin/galois keys of pke/keyswitch.py from identically seeded rngs,
    the switch itself at a full and a reduced level, and CKKSContext's
    relinearize with such a key."""
    rng = np.random.default_rng(2)
    s = rng.integers(-1, 2, 32)
    assert np.array_equal(keyswitch.negacyclic_square_signed(s),
                          jax_ks.negacyclic_square_signed(s))
    assert np.array_equal(keyswitch.automorph_signed(s, 5), jax_ks.automorph_signed(s, 5))
    assert keyswitch._digit_groups(7, 3) == jax_ks._digit_groups(7, 3)
    qp, jqp = dcrt.DCRTParams.create(32, 4, 28), jax_dcrt.DCRTParams.create(32, 4, 28)
    pq, P, groups = keyswitch.hybrid_ks_params(qp, 3, 28)
    jpq, jP, jgroups = jax_ks.hybrid_ks_params(jqp, 3, 28)
    assert (pq.moduli, P, groups) == (jpq.moduli, jP, jgroups)
    for gen, jgen, extra in ((keyswitch.relin_key_gen_hybrid, jax_ks.relin_key_gen_hybrid, ()),
                             (keyswitch.galois_key_gen_hybrid, jax_ks.galois_key_gen_hybrid, (5,))):
        key = gen(BinFHERng(9), qp, s, *extra, dnum=2, limb_bits=28)
        jkey = jgen(JaxRng(9), jqp, s, *extra, dnum=2, limb_bits=28)
        assert same_towers(key.bs + key.as_, jkey.bs + jkey.as_)
        assert (key.P, key.groups) == (jkey.P, jkey.groups)
        c2 = rng.integers(-1 << 50, 1 << 50, 32)
        for L in (4, 3):
            lp, jlp = dcrt.DCRTParams(32, qp.moduli[:L]), jax_dcrt.DCRTParams(32, qp.moduli[:L])
            got = keyswitch.hybrid_key_switch(key, dcrt.DCRTPoly.from_signed(lp, c2, True), lp)
            want = jax_ks.hybrid_key_switch(jkey, jax_dcrt.DCRTPoly.from_signed(jlp, c2, True), jlp)
            assert same_towers(list(got), list(want))


@pytest.fixture(scope="module")
def host_ctx():
    N, L = 32, 3
    p = ckks.CKKSParams(N=N, dcrt=dcrt.DCRTParams.create(N, L, 28), scale=float(1 << 20))
    jp = jax_ckks.CKKSParams(N=N, dcrt=jax_dcrt.DCRTParams.create(N, L, 28),
                             scale=float(1 << 20))
    return ckks.CKKSContext(p, seed=21), jax_ckks.CKKSContext(jp, seed=21)


@pytest.mark.parametrize("dist", ["uniform", "sparse", "gaussian"])
def test_ckks_keygen_encrypt_decrypt(host_ctx, dist):
    c, jc = host_ctx
    (s, s_signed), (b, a) = c.key_gen(dist, hamming_weight=8)
    (js, js_signed), (jb, ja) = jc.key_gen(dist, hamming_weight=8)
    assert np.array_equal(s_signed, js_signed) and same_towers([s, b, a], [js, jb, ja])
    z = np.linspace(-0.7, 0.9, c.params.slots) + 0.25j
    assert np.array_equal(ckks.encode(c.params, z), jax_ckks.encode(jc.params, z))
    ct, jct = c.encrypt((b, a), z), jc.encrypt((jb, ja), z)
    assert same_ct(ct, jct)
    got = c.decrypt((s, s_signed), ct)
    assert np.array_equal(got, jc.decrypt((js, js_signed), jct))
    assert np.abs(got - z).max() < 1e-3
    with pytest.raises(ValueError):
        c.key_gen("binary")


def test_ckks_host_mult_relin_rescale(host_ctx):
    """The exact host mult (CRT-NTT tensor product), the windowed and the
    hybrid relinearization, the big-integer rescale, add, and _at_level."""
    c, jc = host_ctx
    sk, pk = c.key_gen()
    jsk, jpk = jc.key_gen()
    rlk, jrlk = c.relin_key_gen(sk), jc.relin_key_gen(jsk)
    assert same_towers(rlk[0] + rlk[1], jrlk[0] + jrlk[1])
    hk = keyswitch.relin_key_gen_hybrid(c.rng, c.params.dcrt, sk[1], 2, limb_bits=28)
    jhk = jax_ks.relin_key_gen_hybrid(jc.rng, jc.params.dcrt, jsk[1], 2, limb_bits=28)
    z = np.linspace(0.2, 0.9, c.params.slots)
    ct, jct = c.encrypt(pk, z), jc.encrypt(jpk, z)
    for key, jkey in ((rlk, jrlk), (hk, jhk)):
        out = c.eval_mult(ct, ct, key)
        jout = jc.eval_mult(jct, jct, jkey)
        assert same_ct(out, jout)
        assert np.abs(c.decrypt(sk, out) - z * z).max() < 1e-2
        raw, jraw = c.eval_mult(ct, ct, rescale=False), jc.eval_mult(jct, jct, rescale=False)
        assert same_ct(raw, jraw)
        assert same_ct(c.relinearize(raw, key), jc.relinearize(jraw, jkey))
    assert same_ct(c.eval_add(ct, ct), jc.eval_add(jct, jct))
    lp = dcrt.DCRTParams(32, c.params.dcrt.moduli[:2])
    jlp = jax_dcrt.DCRTParams(32, jc.params.dcrt.moduli[:2])
    assert same_towers([ckks._at_level(ct.polys[0], lp)], [jax_ckks._at_level(jct.polys[0], jlp)])


def alpha_tie_band_rows(src: tuple) -> np.ndarray:
    """[2, 1] residues whose y = [x * (D/q_i)^-1]_{q_i} satisfy
    y0/q0 + y1/q1 = k + 1/2 + 1/(2 q0 q1) (k = 0 or 1): the exact sum rounds
    up, the fixed-point sum, which is below the exact one by up to
    sum y_i * frac(2^F / q_i) / 2^F, rounds down."""
    q0, q1 = src
    half = (q0 * q1 + 1) // 2
    y1 = half * pow(q0, -1, q1) % q1
    target = half if y1 * q0 <= q0 * q1 // 2 else half + q0 * q1
    y0 = (target - y1 * q0) // q1
    assert 0 <= y0 < q0 and y0 * q1 + y1 * q0 == target
    D = q0 * q1
    return np.array([[y0 * (D // q0) % q0], [y1 * (D // q1) % q1]], dtype=np.uint64)


def test_fast_base_convert_and_rescale_rns():
    rng = np.random.default_rng(3)
    src = dcrt._moduli_chain(64, 2, 28)
    dst = dcrt._moduli_chain(64, 4, 28, skip=2) + (dcrt._moduli_chain(64, 1, 30)[0],)
    rows = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in src])
    rows[:, 0] = 0
    rows[:, 1] = [q - 1 for q in src]
    rows[:, 2:3] = alpha_tie_band_rows(src)
    F, shifts, t = ckks_rns.alpha_fixed_tables(src)
    assert (F, shifts, t) == jax_rns.alpha_fixed_tables(src)
    y = np.stack([rows[i] * np.uint64(pow((src[0] * src[1] // q) % q, -1, q)) % np.uint64(q)
                  for i, q in enumerate(src)])
    alpha = ckks_rns._fbc_alpha(y, src)
    assert np.array_equal(alpha, jax_rns._fbc_alpha(y, src))
    exact = sum(y[i, 2].astype(object) * (src[1 - i]) for i in range(2))   # y0 q1 + y1 q0
    assert (2 * exact) // (src[0] * src[1]) % 2 == 1      # exact sum is k + 1/2 + tiny
    assert alpha[2] == (2 * exact) // (2 * src[0] * src[1])  # fixed point rounds down
    got = ckks_rns.fast_base_convert(rows, src, dst)
    assert np.array_equal(got, jax_rns.fast_base_convert(rows, src, dst))
    lp = dcrt.DCRTParams(64, src + dst[:2])
    jlp = jax_dcrt.DCRTParams(64, src + dst[:2])
    c = rng.integers(-1 << 60, 1 << 60, 64)
    assert same_towers([ckks_rns.rescale_rns(dcrt.DCRTPoly.from_signed(lp, c, True))],
                       [jax_rns.rescale_rns(jax_dcrt.DCRTPoly.from_signed(jlp, c, True))])


@pytest.fixture(scope="module", params=[(32, 5, 2), (64, 4, 3), (32, 5, 3)],
                ids=["N32-L5-dnum2", "N64-L4-dnum3", "N32-L5-dnum3"])
def rns_pair(request):
    N, L, dnum = request.param
    p = ckks.CKKSParams(N=N, dcrt=dcrt.DCRTParams.create(N, L, 28), scale=float(1 << 28))
    jp = jax_ckks.CKKSParams(N=N, dcrt=jax_dcrt.DCRTParams.create(N, L, 28),
                             scale=float(1 << 28))
    c, jc = ckks.CKKSContext(p, seed=33), jax_ckks.CKKSContext(jp, seed=33)
    sk, pk = c.key_gen()
    jsk, jpk = jc.key_gen()
    r = ckks_rns.CKKSRnsContext(c, dnum=dnum, ks_limb_bits=28)
    jr = jax_rns.CKKSRnsContext(jc, dnum=dnum, ks_limb_bits=28)
    return c, jc, r, jr, sk, jsk, pk, jpk


def test_rns_mult_chain(rns_pair):
    """Squaring chains down 3 levels with the single full-chain key and with
    the per-level keys, bit-identical to the JAX package's, decrypting to
    z^8."""
    c, jc, r, jr, sk, jsk, pk, jpk = rns_pair
    k, jk = r.relin_key_gen_single(sk), jr.relin_key_gen_single(jsk)
    assert same_towers(k.bs + k.as_, jk.bs + jk.as_)
    assert (k.q_moduli, k.p_moduli, k.groups) == (jk.q_moduli, jk.p_moduli, jk.groups)
    kd, jkd = r.relin_key_gen(sk), jr.relin_key_gen(jsk)
    z = np.linspace(0.3, 0.95, c.params.slots)
    ct0, jct0 = c.encrypt(pk, z), jc.encrypt(jpk, z)
    for key, jkey in ((k, jk), (kd, jkd)):
        ct, jct = ct0, jct0
        for _ in range(3):
            ct, jct = r.eval_mult(ct, ct, key), jr.eval_mult(jct, jct, jkey)
            assert same_ct(ct, jct)
        assert np.abs(c.decrypt(sk, ct) - z ** 8).max() < 1e-3
    raw, jraw = r.eval_mult(ct0, ct0, k, rescale=False), jr.eval_mult(jct0, jct0, jk, rescale=False)
    assert same_ct(raw, jraw)
    assert same_ct(r.eval_add(raw, raw), jr.eval_add(jraw, jraw))
    raw.noise_deg = jraw.noise_deg = 2
    assert same_ct(r.compress(raw, 2), jr.compress(jraw, 2))
    assert same_ct(r.level_reduce(ct0, 2), jr.level_reduce(jct0, 2))


def test_rns_rotations(rns_pair):
    """eval_rotate, a hoisted rotation and eval_rotations, at the full chain
    and after a mult, with single and per-level Galois keys."""
    c, jc, r, jr, sk, jsk, pk, jpk = rns_pair
    z = np.linspace(-0.9, 0.9, c.params.slots)
    ct, jct = c.encrypt(pk, z), jc.encrypt(jpk, z)
    rlk, jrlk = r.relin_key_gen_single(sk), jr.relin_key_gen_single(jsk)
    gks = {s: r.galois_key_gen_single(sk, s) for s in (1, 3)}
    jgks = {s: jr.galois_key_gen_single(jsk, s) for s in (1, 3)}
    gkd, jgkd = r.galois_key_gen(sk, 2), jr.galois_key_gen(jsk, 2)
    assert all(same_towers(gks[s].bs + gks[s].as_, jgks[s].bs + jgks[s].as_) for s in gks)
    assert gks[3].galois_k == jgks[3].galois_k
    for x, jx in ((ct, jct), (r.eval_mult(ct, ct, rlk), jr.eval_mult(jct, jct, jrlk))):
        rot, jrot = r.eval_rotate(x, 1, gks[1]), jr.eval_rotate(jx, 1, jgks[1])
        assert same_ct(rot, jrot)
        assert same_ct(r.eval_rotate(x, 2, gkd), jr.eval_rotate(jx, 2, jgkd))
        pre = r.rotation_precompute(x, gks[3])
        jpre = jr.rotation_precompute(jx, jgks[3])
        assert same_towers(pre, jpre)
        hoisted = r.eval_rotate_hoisted(x, 3, gks[3], pre)
        assert same_ct(hoisted, jr.eval_rotate_hoisted(jx, 3, jgks[3], jpre))
        assert same_ct(hoisted, r.eval_rotate(x, 3, gks[3]))
        many, jmany = r.eval_rotations(x, [1, 3], gks), jr.eval_rotations(jx, [1, 3], jgks)
        assert all(same_ct(many[s], jmany[s]) for s in (1, 3))
    assert np.abs(c.decrypt(sk, rot) - np.roll(z * z, -1)).max() < 1e-3
    assert np.abs(c.decrypt(sk, r.eval_rotate(ct, 1, gks[1])) - np.roll(z, -1)).max() < 1e-3
