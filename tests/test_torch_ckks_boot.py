"""The port's CKKS bootstrapping (`tfhe_tpu_torch.pke`: ckks_boot,
ckks_boot_fft, the three bootstrap `build_*` functions of ckks_device,
ckks_boot_device, ckks_boot_fft_device) on torch CPU tensors against the
JAX package.

- Host modules: the precomputations (dense, BSGS and FFT-factored: the
  transform matrices and grouped diagonals, BSGS plans, Chebyshev series,
  bootstrap_depth and the Galois index sets) equal to the JAX package's
  with tolerance 0; ModRaise and whole host bootstraps (FFT-factored and
  BSGS) tower for tower.
- Device: on a chain just long enough to run every stage once (N = 32,
  L = 10 limbs of 28 bits, level budget (1, 1), Chebyshev degree 4, one
  double angle), the JAX package's `CKKSBootstrapFFTDevice` and the port's
  on identical keys (identically seeded contexts, the keys held equal) and
  ciphertexts (carried across by `tfhe_tpu_torch.convert`): the three
  builders on random residues, the evaluator's plaintext, constant,
  level-reduction and hoisted-rotation ops, `linear_transform_bsgs`,
  `diag_transform` lazy and eager, `chebyshev_ps` and one whole
  `bootstrap_batch`, all torch.equal (tolerance 0). This chain is too short
  for a precise refresh; its decryptions are not checked. The tests share
  tower shapes and levels with the whole bootstrap, so the JAX package
  compiles each graph once.
- The port alone at the JAX package's own test configuration (N = 32,
  L = 30, budget (2, 2), degree 22), with a sparse ternary secret of
  weight 8 (so ModRaise's overflow stays inside EvalMod's range on every
  input): batched, sparse and iterative FFT
  bootstraps and the BSGS `CKKSBootstrapDevice`, checked by decryption to
  that package's bounds (6e-3; 5e-3 for the BSGS driver; the iterative
  gain err2 < err1 / 3), and the card as the default device.
"""

import numpy as np
import pytest
import torch

import tfhe_tpu.pke.ckks_boot as jcb
import tfhe_tpu.pke.ckks_boot_fft as jcf
from tfhe_tpu.pke import ckks_device as jax_dev
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_boot_fft_device import CKKSBootstrapFFTDevice as JaxFFTDevice
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxRnsContext
from tfhe_tpu.pke.dcrt import DCRTParams as JaxDCRTParams
from tfhe_tpu.pke.keyswitch import relin_key_gen_hybrid as jax_relin_hybrid
from tfhe_tpu_torch import convert
from tfhe_tpu_torch.pke import ckks_boot as cb
from tfhe_tpu_torch.pke import ckks_boot_fft as cf
from tfhe_tpu_torch.pke import ckks_device as dev
from tfhe_tpu_torch.pke.ckks import CKKSContext, CKKSParams
from tfhe_tpu_torch.pke.ckks_boot_device import CKKSBootstrapDevice
from tfhe_tpu_torch.pke.ckks_boot_fft_device import CKKSBootstrapFFTDevice
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from tfhe_tpu_torch.pke.dcrt import DCRTParams
from tfhe_tpu_torch.pke.keyswitch import relin_key_gen_hybrid
from torch_threads import one_torch_thread  # noqa: F401

N = 32
SLOTS = N // 2
# the short device chain: depth 9 = budget 1 + 1 + re/im split 1 + PS 3 +
# double angle 1 + r/(2 pi) 1 + recombination 1, on 10 limbs
SHORT = dict(L=10, K=4.0, cheb_deg=4, double_angles=1, seed=73, hw=4)


def eq(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j, dtype=np.uint32).astype(np.int64))


def same_dct(d, jd) -> bool:
    """A port device ciphertext and a JAX one: towers, scale and chain."""
    return (d.scale == jd.scale and tuple(d.moduli) == tuple(jd.moduli)
            and eq(d.c0, jd.c0) and eq(d.c1, jd.c1))


def same_ct(x, y) -> bool:
    """Two host ciphertexts (either package): scale and towers."""
    return x.scale == y.scale and len(x.polys) == len(y.polys) and all(
        a.params.moduli == b.params.moduli and np.array_equal(a.to_eval().rns, b.to_eval().rns)
        for a, b in zip(x.polys, y.polys))


def exhaust(ctx, cbm, ct):
    """Drop a fresh ciphertext to one limb (the bootstrap's input)."""
    while ct.level_params.L > 1:
        ct = ctx.rescale(cbm.mult_const(ctx, ct, 1.0, rescale=False))
    return ct


# -- host modules ---------------------------------------------------------------

def host_contexts(L: int, bits: int, seed: int, **keys):
    jp = JaxCKKSParams(N=N, dcrt=JaxDCRTParams.create(N, L, bits), scale=float(1 << bits))
    jc, c = JaxCKKSContext(jp, seed=seed), CKKSContext(convert.ckks_params_from(jp), seed=seed)
    jsk, jpk = jc.key_gen(**keys)
    sk, pk = c.key_gen(**keys)              # advances the port's rng alike
    assert np.array_equal(sk[1], jsk[1])
    return jc, jsk, jpk, c, sk, pk


def same_diag_matrix(g, jg) -> bool:
    return (g.s == jg.s and g.babies == jg.babies and g.plan == jg.plan
            and sorted(g.diags) == sorted(jg.diags)
            and all(np.array_equal(g.diags[o], jg.diags[o]) for o in g.diags))


def same_base(b, jb) -> bool:
    return all(np.array_equal(getattr(b, f), getattr(jb, f))
               for f in ("cts_A", "cts_B", "stc_A", "stc_B", "cheb_coeffs")) and \
        (b.K, b.r, b.q0, b.double_angles) == (jb.K, jb.r, jb.q0, jb.double_angles)


@pytest.mark.parametrize("budget, sparse, deg", [((2, 2), None, 22), ((1, 1), None, 4),
                                                 ((3, 2), None, 44), ((2, 2), 4, 22)])
def test_setup_matches_jax(budget, sparse, deg):
    """eval_bootstrap_setup(_fft), its key index sets, bootstrap_depth and
    the BSGS index set, array for array (tolerance 0)."""
    jp = JaxCKKSParams(N=N, dcrt=JaxDCRTParams.create(N, 12, 28), scale=float(1 << 28))
    jc, c = JaxCKKSContext(jp), CKKSContext(convert.ckks_params_from(jp))
    kw = dict(level_budget=budget, sparse_slots=sparse, K=28.0 if deg == 44 else 8.0,
              cheb_deg=deg)
    pre, jpre = cf.eval_bootstrap_setup_fft(c, **kw), jcf.eval_bootstrap_setup_fft(jc, **kw)
    assert (pre.sparse_slots, pre.level_budget) == (jpre.sparse_slots, jpre.level_budget)
    for gs, jgs in ((pre.cts_groups, jpre.cts_groups), (pre.stc_groups, jpre.stc_groups)):
        assert len(gs) == len(jgs) and all(same_diag_matrix(g, jg) for g, jg in zip(gs, jgs))
    assert same_base(pre.base, jpre.base)
    assert cf.fft_key_indices(c, pre) == jcf.fft_key_indices(jc, jpre)
    for g in (1, 3):
        assert cf.bootstrap_depth(budget, deg, g, slots=sparse) == \
            jcf.bootstrap_depth(budget, deg, g, slots=sparse)
    assert same_base(cb.eval_bootstrap_setup(c, cheb_deg=deg),
                     jcb.eval_bootstrap_setup(jc, cheb_deg=deg))
    assert cb.bsgs_key_indices(N, SLOTS) == jcb.bsgs_key_indices(N, SLOTS)
    c_poly = np.random.default_rng(deg).normal(size=deg + 1)
    for e in (4, 8, 16, 32):
        if deg < 2 * e:
            q, r = cb._cheb_divmod_T(c_poly, e)
            jq, jr = jcb._cheb_divmod_T(c_poly, e)
            assert np.array_equal(q, jq) and np.array_equal(r, jr)


@pytest.mark.parametrize("driver", ["fft", "bsgs"])
def test_host_bootstrap_matches_jax(driver):
    """ModRaise and a whole host bootstrap (exact big-integer CKKS), on the
    short chain with 40-bit limbs, tower for tower, on keys from identically
    seeded contexts."""
    jc, jsk, jpk, c, sk, pk = host_contexts(SHORT["L"], 40, 13, secret_dist="sparse",
                                            hamming_weight=SHORT["hw"])
    z = np.linspace(-0.04, 0.04, SLOTS)
    jct, ct = exhaust(jc, jcb, jc.encrypt(jpk, z)), exhaust(c, cb, c.encrypt(pk, z))
    assert same_ct(ct, jct)
    kw = dict(K=SHORT["K"], cheb_deg=SHORT["cheb_deg"], double_angles=SHORT["double_angles"])
    out = []
    for ctx, key, x, cbm, cfm, relin in ((jc, jsk, jct, jcb, jcf, jax_relin_hybrid),
                                         (c, sk, ct, cb, cf, relin_key_gen_hybrid)):
        rlk = relin(ctx.rng, ctx.params.dcrt, key[1], dnum=3)
        if driver == "fft":
            pre = cfm.eval_bootstrap_setup_fft(ctx, level_budget=(1, 1), **kw)
            keys = cfm.eval_bootstrap_keygen_fft(ctx, key, pre, dnum=3)
            fresh = cfm.eval_bootstrap_fft(ctx, x, pre, keys, rlk)
        else:
            pre = cbm.eval_bootstrap_setup(ctx, **kw)
            keys = cbm.eval_bootstrap_keygen_bsgs(ctx, key, dnum=3)
            fresh = cbm.eval_bootstrap_bsgs(ctx, x, pre, keys, rlk)
        out.append((cbm.mod_raise(ctx, x), fresh))
    (jraised, jfresh), (raised, fresh) = out
    assert same_ct(raised, jraised) and same_ct(fresh, jfresh)
    assert raised.level_params.L == SHORT["L"]


# -- the device path on the short chain ---------------------------------------------

@pytest.fixture(scope="module")
def short():
    """The JAX package's FFT device bootstrap and the port's (on the CPU) on
    the short chain, with identical keys, and three fresh ciphertexts."""
    jc, jsk, jpk, c, sk, _ = host_contexts(SHORT["L"], 28, SHORT["seed"],
                                           secret_dist="sparse", hamming_weight=SHORT["hw"])
    kw = dict(level_budget=(1, 1), K=SHORT["K"], cheb_deg=SHORT["cheb_deg"],
              double_angles=SHORT["double_angles"])
    jbd = JaxFFTDevice(JaxRnsContext(jc, dnum=3, ks_limb_bits=28),
                       jcf.eval_bootstrap_setup_fft(jc, **kw))
    bd = CKKSBootstrapFFTDevice(CKKSRnsContext(c, dnum=3, ks_limb_bits=28),
                                cf.eval_bootstrap_setup_fft(c, **kw), device="cpu")
    jbd.keygen(jsk)
    bd.keygen(sk)
    rng = np.random.default_rng(4)
    zs = [rng.normal(size=SLOTS) * 0.3 + 1j * rng.normal(size=SLOTS) * 0.3 for _ in range(3)]
    jcts = [jc.encrypt(jpk, z) for z in zs]
    cts = [convert.ckks_ciphertext_from(x, c.params) for x in jcts]
    return dict(jc=jc, jsk=jsk, jpk=jpk, c=c, sk=sk, jbd=jbd, bd=bd, zs=zs, jcts=jcts, cts=cts)


def both(k, i: int = 0, batch: int = 1):
    """Ciphertexts i .. i+batch-1 uploaded to both evaluators as [L, B, N]."""
    return (k["bd"].dctx.upload_batch(k["cts"][i:i + batch]),
            k["jbd"].dctx.upload_batch(k["jcts"][i:i + batch]))


def decrypt(k, d) -> list:
    return [k["c"].decrypt(k["sk"], x) for x in k["bd"].dctx.download_batch(d)]


def test_keys_match(short):
    bd, jbd = short["bd"], short["jbd"]
    assert sorted(bd._gk) == sorted(jbd._gk)
    for key in list(bd._gk)[:: max(1, len(bd._gk) // 6)] + [max(bd._gk)]:
        pk, jpk = bd._gk[key], jbd._gk[key]
        assert all(eq(getattr(pk, f), getattr(jpk, f)) for f in ("kb", "kb_sh", "ka", "ka_sh"))
    L = SHORT["L"]
    assert eq(bd.dctx._rlk[L].kb, jbd.dctx._rlk[L].kb)
    assert bd.sf == jbd.sf


def test_evaluator_ops(short):
    """mult_plain (rescaled, unrescaled, cached), mult_const, scale_int and
    add_const with negative constants, _reduce_to, auto_hoisted, rotate."""
    bd, jbd = short["bd"], short["jbd"]
    x, jx = both(short)
    L = SHORT["L"]
    y, jy = bd._reduce_to(x, L - 1), jbd._reduce_to(jx, L - 1)
    assert same_dct(y, jy) and len(y.moduli) == L - 1
    vec = np.full(SLOTS, -0.5j)
    for rescale in (True, False):
        assert same_dct(bd.mult_plain(y, vec, rescale), jbd.mult_plain(jy, vec, rescale))
    got = bd.mult_plain(y, vec, pt_key="test_vec")
    cached = bd._pt_cache[("test_vec", L - 1, True)]
    assert cached.device == torch.device("cpu")
    assert same_dct(bd.mult_plain(y, vec, pt_key="test_vec"), got)
    assert same_dct(bd.mult_const(y, 0.5), jbd.mult_const(jy, 0.5))
    assert same_dct(bd.mult_const(y, -0.37, rescale=False), jbd.mult_const(jy, -0.37, rescale=False))
    assert same_dct(bd.scale_int(y, -3), jbd.scale_int(jy, -3))
    assert same_dct(bd.add_const(y, -1.0), jbd.add_const(jy, -1.0))
    k5 = cb.galois_element(1, N)
    h = bd.auto_hoisted(x, k5, bd._hoist_pre(x))
    assert same_dct(h, jbd.auto_hoisted(jx, k5, jbd._hoist_pre(jx)))
    z = short["zs"][0]
    assert np.abs(decrypt(short, h)[0] - np.roll(z, -1)).max() < 1e-3
    assert np.abs(decrypt(short, bd.add_const(bd.scale_int(y, -3), -1.0))[0]
                  - (-3 * z - 1)).max() < 1e-3


def test_builders_on_random_residues(short):
    """build_bsgs_inner, build_diag_inner and build_diag_factor_lazy on
    random residue stacks with 0 and q-1 in them, at the shapes the
    transforms give them, against the JAX package's."""
    bd, jbd = short["bd"], short["jbd"]
    L = SHORT["L"]
    lvl = bd.params.dcrt.moduli[:L]
    rng = np.random.default_rng(6)

    def res(shape):
        x = np.stack([rng.integers(0, q, shape, dtype=np.int64) for q in lvl])
        x.reshape(L, -1)[:, 0] = 0
        x.reshape(L, -1)[:, 1] = [q - 1 for q in lvl]
        return x

    def jx(x):
        return np.asarray(x).astype(np.uint32)

    b = cb._bsgs_split(SLOTS)[0]
    p = [res((b, 1, N)) for _ in range(4)]
    pts = [res((b, N)) for _ in range(2)]
    got = dev.build_bsgs_inner(N, lvl, b, device="cpu")(*map(torch.from_numpy, p + pts))
    want = jax_dev.build_bsgs_inner(N, lvl, b)(*map(jx, p + pts))
    assert all(eq(g, w) for g, w in zip(got, want))
    g = bd.pre.cts_groups[0]
    nb = len(g.babies)
    p0, p1, pt = res((nb, 1, N)), res((nb, 1, N)), res((nb, N))
    got = dev.build_diag_inner(N, lvl, nb, device="cpu")(*map(torch.from_numpy, (p0, p1, pt)))
    want = jax_dev.build_diag_inner(N, lvl, nb)(jx(p0), jx(p1), jx(pt))
    assert all(eq(g_, w) for g_, w in zip(got, want))
    giants = sorted({e[1] for e in g.plan})
    elements = tuple(cb.galois_element(gg, N) if gg % SLOTS else 1 for gg in giants)
    pts = np.stack([res((nb, N)) for _ in giants])
    args, jargs = [], []
    for ev, out in ((bd, args), (jbd, jargs)):
        key0 = next(iter(ev._gk.values()))
        keys = [key0 if k == 1 else ev._gk[(k, L)] for k in elements]
        out += [key0.p_moduli, *key0.level_view(L - 1),
                *([getattr(k, f) for k in keys] for f in ("kb", "kb_sh", "ka", "ka_sh"))]
    (pm, groups, rows, *keys), (jpm, jgroups, jrows, *jkeys) = args, jargs
    got = dev.build_diag_factor_lazy(N, lvl, pm, groups, nb, elements, rows, device="cpu")(
        torch.from_numpy(p0), torch.from_numpy(p1), torch.from_numpy(pts), *keys)
    want = jax_dev.build_diag_factor_lazy(N, lvl, jpm, jgroups, nb, elements, jrows)(
        jx(p0), jx(p1), jx(pts), *jkeys)
    assert all(eq(g_, w) for g_, w in zip(got, want))


def test_diag_transform_lazy_and_eager(short):
    """One CoeffsToSlots factor, double-hoisted and eager, each equal to the
    JAX package's; the two agree by decryption and match the dense map."""
    bd, jbd = short["bd"], short["jbd"]
    x, jx = both(short, 1)
    g, jg = bd.pre.cts_groups[0], jbd.pre.cts_groups[0]
    lazy = bd.diag_transform(x, g, lazy=True)
    eager = bd.diag_transform(x, g, lazy=False)
    assert same_dct(lazy, jbd.diag_transform(jx, jg, lazy=True))
    assert same_dct(eager, jbd.diag_transform(jx, jg, lazy=False))
    assert lazy.scale == eager.scale and lazy.moduli == eager.moduli
    want = cf.diag_to_dense(g.diags, SLOTS) @ short["zs"][1]
    zl, ze = decrypt(short, lazy)[0], decrypt(short, eager)[0]
    assert np.abs(zl - ze).max() < 1e-4 and np.abs(zl - want).max() < 1e-3


def test_linear_transform_bsgs(short):
    bd, jbd = short["bd"], short["jbd"]
    rng = np.random.default_rng(0)
    A = (rng.normal(size=(SLOTS, SLOTS)) + 1j * rng.normal(size=(SLOTS, SLOTS))) / SLOTS
    B = (rng.normal(size=(SLOTS, SLOTS)) + 1j * rng.normal(size=(SLOTS, SLOTS))) / SLOTS
    x, jx = both(short, 2)
    out = bd.linear_transform_bsgs(x, A, B, tag="test")
    assert same_dct(out, jbd.linear_transform_bsgs(jx, A, B))
    assert same_dct(bd.linear_transform_bsgs(x, A, B, tag="test"), out)     # cached rows
    z = short["zs"][2]
    assert np.abs(decrypt(short, out)[0] - (A @ z + B @ np.conj(z))).max() < 1e-3


def test_chebyshev_ps(short):
    """PS Chebyshev at the bootstrap's EvalMod level and batch shape (re and
    im halves: [L, 2, N])."""
    bd, jbd = short["bd"], short["jbd"]
    x, jx = both(short, 0, 2)
    lv = SHORT["L"] - 2
    x, jx = bd._reduce_to(x, lv), jbd._reduce_to(jx, lv)
    coeffs = np.random.default_rng(1).normal(size=SHORT["cheb_deg"] + 1) * 0.3
    out = bd.chebyshev_ps(x, coeffs)
    assert same_dct(out, jbd.chebyshev_ps(jx, coeffs))
    for b, got in enumerate(decrypt(short, out)):
        assert np.abs(got - cb._cheb_apply(coeffs, short["zs"][b])).max() < 3e-3


def test_whole_bootstrap_matches_jax(short):
    """One whole bootstrap_batch (ModRaise, CoeffsToSlots, EvalMod on the
    re/im halves, SlotsToCoeffs), tower for tower."""
    c, jc = short["c"], short["jc"]
    z = np.linspace(-0.04, 0.04, SLOTS)
    jct = exhaust(jc, jcb, jc.encrypt(short["jpk"], z))
    ct = convert.ckks_ciphertext_from(jct, c.params)
    fresh = short["bd"].bootstrap_batch([ct])
    jfresh = short["jbd"].bootstrap_batch([jct])
    assert len(fresh) == 1 and same_ct(fresh[0], jfresh[0])
    names = [name for name, _ in short["bd"].stages([ct])]
    assert names == ["raise", "cts0", "eval_mod", "stc0"]


# -- the port alone at the JAX package's test configuration --------------------------

@pytest.fixture(scope="module")
def full():
    p = CKKSParams(N=N, dcrt=DCRTParams.create(N, 30, 28), scale=float(1 << 28))
    ctx = CKKSContext(p, seed=73)
    # a sparse ternary secret of weight 8 bounds ModRaise's overflow |I| by
    # about (8 + 1) / 2 + 1, inside EvalMod's range K = 8 whatever the
    # encryption noise; with a uniform secret at N = 32 |I| can pass K, and
    # then the refresh fails, in the JAX package alike
    sk, pk = ctx.key_gen("sparse", hamming_weight=8)
    rctx = CKKSRnsContext(ctx, dnum=3, ks_limb_bits=28)
    bd = CKKSBootstrapFFTDevice(rctx, cf.eval_bootstrap_setup_fft(ctx, level_budget=(2, 2)),
                                device="cpu")
    bd.keygen(sk)
    return ctx, sk, pk, rctx, bd


def test_fft_bootstrap_batch_decrypts(full):
    ctx, sk, pk, _, bd = full
    zs = [np.linspace(-0.04, 0.04, SLOTS), np.linspace(0.03, -0.03, SLOTS)]
    fresh = bd.bootstrap_batch([exhaust(ctx, cb, ctx.encrypt(pk, z)) for z in zs])
    for z, f in zip(zs, fresh):
        assert f.level_params.L >= 3
        assert np.abs(ctx.decrypt(sk, f).real - z).max() < 6e-3
    half = ctx.decrypt(sk, cb.mult_const(ctx, fresh[0], 0.5)).real
    assert np.abs(half - zs[0] / 2).max() < 6e-3


def test_sparse_fft_bootstrap_decrypts(full):
    ctx, sk, pk, rctx, _ = full
    bd = CKKSBootstrapFFTDevice(
        rctx, cf.eval_bootstrap_setup_fft(ctx, level_budget=(2, 2), sparse_slots=4), device="cpu")
    bd.keygen(sk)
    z = np.tile(np.random.default_rng(11).uniform(-0.01, 0.01, 4), SLOTS // 4)
    fresh = bd.bootstrap(exhaust(ctx, cb, ctx.encrypt(pk, z)))
    assert [n for n, _ in bd.stages([exhaust(ctx, cb, ctx.encrypt(pk, z))])][:3] == \
        ["raise", "partial_sum", "cts0"]
    assert fresh.level_params.L >= 3
    assert np.abs(ctx.decrypt(sk, fresh).real - z).max() < 6e-3


def test_iterative_bootstrap_decrypts(full):
    ctx, sk, pk, _, bd = full
    z = np.linspace(-0.04, 0.04, SLOTS)
    ct = exhaust(ctx, cb, ctx.encrypt(pk, z))
    one = bd.bootstrap_batch([ct], target_scale=float(ct.scale))[0]
    assert one.scale == ct.scale
    err1 = np.abs(ctx.decrypt(sk, one).real - z).max()
    two = bd.bootstrap_iterative_batch([ct], precision=4)[0]
    err2 = np.abs(ctx.decrypt(sk, two).real - z).max()
    assert err2 < err1 / 3 and err2 < 2e-3, (err1, err2)
    with pytest.raises(ValueError):
        bd.bootstrap_iterative_batch([ct], precision=12)


def test_bsgs_device_bootstrap_decrypts(full):
    ctx, sk, pk, rctx, _ = full
    bd = CKKSBootstrapDevice(rctx, cb.eval_bootstrap_setup(ctx, cheb_deg=22), device="cpu")
    bd.keygen(sk)
    assert len(bd.galois_keys) == len(cb.bsgs_key_indices(N, SLOTS))
    zs = [np.linspace(-0.04, 0.04, SLOTS), np.linspace(0.03, -0.03, SLOTS)]
    fresh = bd.bootstrap_batch([exhaust(ctx, cb, ctx.encrypt(pk, z)) for z in zs])
    for f, z in zip(fresh, zs):
        assert f.level_params.L >= 3
        assert np.abs(ctx.decrypt(sk, f).real - z).max() < 5e-3
    d = bd.dctx.upload_batch(fresh)
    for s, z in zip(bd.dctx.download_batch(bd.dctx.eval_mult(d, d)), zs):
        assert np.abs(ctx.decrypt(sk, s).real - z * z).max() < 1e-2


def test_keys_move_between_devices_and_card_is_default(full):
    """load_keys packs another evaluator's host keys (the same towers);
    the default device is the card, and without one packing a key raises."""
    ctx, sk, pk, rctx, bd = full
    other = CKKSBootstrapFFTDevice(rctx, bd.pre, device="cpu")
    other.load_keys(bd.relin_key, bd.galois_keys)
    assert sorted(other._gk) == sorted(bd._gk)
    assert all(torch.equal(other._gk[k].kb, bd._gk[k].kb) for k in bd._gk)
    on_card = CKKSBootstrapFFTDevice(rctx, bd.pre)
    assert on_card.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            on_card.load_keys(bd.relin_key, {})
