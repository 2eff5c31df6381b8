"""The port's serialization against the JAX package's: `utils/serial.py`
(the BinFHE context with its key map, ciphertexts, private keys, the bytes
form and the JSON form; a seeded switching key as its seed, dimensions and
B) and `pke/serial.py` (BFV keys, BFV and CKKS ciphertexts, RNS hybrid
keys, single and per level). Each function round-trips in the port, and
files cross both ways: saved by the JAX package and loaded by the port, and
the reverse, with equal parameters and arrays, and a NAND on the loaded
keys bit-equal to the other package's. The files cross at TOY; the port's
own round trips and the seeded key use tests/test_serial.py's small set
(N = 256, n = 8, qKS = 2^35), whose files compress in a fraction of the
time of TOY's 40 MB of key material."""

import io

import numpy as np
import pytest

import tfhe_tpu
from tfhe_tpu import lwe as jax_lwe
from tfhe_tpu.params import BinFHEParams as JaxBinFHEParams
from tfhe_tpu.params import LWEParams as JaxLWEParams
from tfhe_tpu.params import Method as JaxMethod
from tfhe_tpu.params import RGSWParams as JaxRGSWParams
from tfhe_tpu.pke import serial as jax_pke_serial
from tfhe_tpu.pke.bfv import BFVContext as JaxBFVContext
from tfhe_tpu.pke.bfv import BFVParams as JaxBFVParams
from tfhe_tpu.pke.bfv_rns import BFVRnsContext as JaxBFVRns
from tfhe_tpu.pke.ckks import CKKSContext as JaxCKKSContext
from tfhe_tpu.pke.ckks import CKKSParams as JaxCKKSParams
from tfhe_tpu.pke.ckks_rns import CKKSRnsContext as JaxCKKSRns
from tfhe_tpu.utils import serial as jax_serial
from tfhe_tpu.utils.numtheory import ntt_prime
import tfhe_tpu_torch
from tfhe_tpu_torch import lwe
from tfhe_tpu_torch.params import BinFHEParams, LWEParams, Method, RGSWParams
from tfhe_tpu_torch.pke import serial as pke_serial
from tfhe_tpu_torch.pke.bfv import BFVContext, BFVParams
from tfhe_tpu_torch.pke.bfv_rns import BFVRnsContext
from tfhe_tpu_torch.pke.ckks import CKKSContext, CKKSParams
from tfhe_tpu_torch.pke.ckks_rns import CKKSRnsContext
from tfhe_tpu_torch.utils import serial
from torch_threads import one_torch_thread  # noqa: F401

DIRECTIONS = ["jax_to_port", "port_to_jax"]


def params_dict(p) -> dict:
    return serial._params_to_dict(p)


def same_keys(a: dict, b: dict) -> None:
    """Two key maps (either package's) hold equal arrays; a seeded switching
    key on one side is seeded on the other, with the same seed and B."""
    assert sorted(a) == sorted(b)
    for base in a:
        ka, kb = a[base], b[base]
        assert ka.base_g == kb.base_g
        assert np.array_equal(ka.bsk_coeff, kb.bsk_coeff)
        assert np.array_equal(ka.ksk.B, kb.ksk.B)
        if hasattr(ka.ksk, "seed") or hasattr(kb.ksk, "seed"):
            assert (ka.ksk.seed, ka.ksk.N, ka.ksk.base_ks, ka.ksk.digit_count,
                    ka.ksk.n, ka.ksk.q_ks) == (kb.ksk.seed, kb.ksk.N, kb.ksk.base_ks,
                                               kb.ksk.digit_count, kb.ksk.n, kb.ksk.q_ks)
            assert getattr(ka.ksk, "_A", None) is None or getattr(kb.ksk, "_A", None) is None
        else:
            assert np.array_equal(ka.ksk.A, kb.ksk.A)


@pytest.fixture(scope="module")
def toy():
    """TOY contexts of both packages from one seed: the JAX package's on its
    host oracle, the port's on the plain torch path; one secret, inputs."""
    jcc = tfhe_tpu.BinFHEContext(seed=123)
    jcc.generate_binfhe_context(tfhe_tpu.ParamSet.TOY)
    jsk = jcc.key_gen()
    jcc.bt_key_gen(jsk)
    cc = tfhe_tpu_torch.BinFHEContext(seed=123, device="cpu")
    cc.generate_binfhe_context(tfhe_tpu_torch.ParamSet.TOY)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    assert np.array_equal(sk.s, jsk.s)
    m1, m2 = np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])
    ct1, ct2 = jcc.encrypt(jsk, m1), jcc.encrypt(jsk, m2)
    return dict(jcc=jcc, cc=cc, sk=sk, jsk=jsk, m=(m1, m2), cts=(ct1, ct2))


def seeded_params(pkg):
    N, q = 256, 512
    Q = ntt_prime(20, 2 * N)
    P = pkg
    return P.BinFHEParams(
        lwe=P.LWEParams(n=8, N=N, q=q, Q=Q, q_ks=1 << 35, std=3.19, base_ks=32),
        rgsw=P.RGSWParams(N=N, Q=Q, q=q, base_g=1 << 5, base_r=23,
                          method=P.Method.GINX, std=3.19))


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PORT = _Pkg(BinFHEParams=BinFHEParams, LWEParams=LWEParams, RGSWParams=RGSWParams,
            Method=Method)
JAX = _Pkg(BinFHEParams=JaxBinFHEParams, LWEParams=JaxLWEParams,
           RGSWParams=JaxRGSWParams, Method=JaxMethod)


def nand(cc, cts):
    return cc.eval_bin_gate(tfhe_tpu_torch.Gate.NAND, *cts)


def test_binfhe_round_trips(tmp_path):
    """Every function of the port's utils/serial.py, and BinFHEContext.save/
    load, on the port alone, at the small set (a plain switching key):
    equal parameters and keys after the round trip, and the loaded
    context's NAND bit-equal to the original's."""
    cc = tfhe_tpu_torch.BinFHEContext(seed=93, device="cpu")
    cc.params = seeded_params(PORT)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    assert isinstance(cc.bt_key.ksk, lwe.LWESwitchingKey)
    m1, m2 = np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])
    cts = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    cc.save(str(tmp_path / "ctx.npz"))
    cc2 = tfhe_tpu_torch.BinFHEContext.load(str(tmp_path / "ctx.npz"), device="cpu")
    assert cc2.device == "cpu" and params_dict(cc2.params) == params_dict(cc.params)
    same_keys(cc2._bt_key_map, {cc.params.rgsw.base_g: cc.bt_key})
    serial.save_private_key(str(tmp_path / "sk.npz"), sk)
    sk2 = serial.load_private_key(str(tmp_path / "sk.npz"))
    assert np.array_equal(sk2.s, sk.s) and sk2.modulus == sk.modulus
    serial.save_ciphertext(str(tmp_path / "ct.npz"), cts[0])
    ct = serial.load_ciphertext(str(tmp_path / "ct.npz"))
    assert np.array_equal(ct.a, cts[0].a) and np.array_equal(ct.b, cts[0].b)
    out, out2 = nand(cc, cts), nand(cc2, (ct, cts[1]))
    assert np.array_equal(out.a, out2.a) and np.array_equal(out.b, out2.b)
    assert np.array_equal(cc2.decrypt(sk2, out2), 1 - (m1 & m2))
    params, keys = serial.loads_context(serial.dumps_context(cc.params, cc.bt_key))
    assert params_dict(params) == params_dict(cc.params)
    same_keys(keys, {cc.bt_key.base_g: cc.bt_key})
    buf = io.StringIO()
    serial.save_context_json(buf, cc.params, cc.bt_key)
    buf.seek(0)
    params, keys = serial.load_context_json(buf)
    assert params_dict(params) == params_dict(cc.params)
    same_keys(keys, {cc.bt_key.base_g: cc.bt_key})


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_binfhe_files_cross(toy, tmp_path, direction):
    """A TOY context saved by one package loads in the other with equal
    parameters, bsk_coeff, A and B, and a NAND on the loaded keys is
    bit-equal to the saving package's NAND; the same for the JSON form."""
    jcc, cc = toy["jcc"], toy["cc"]
    path, jpath = str(tmp_path / "ctx.npz"), str(tmp_path / "ctx.json")
    m1, m2 = toy["m"]
    if direction == "jax_to_port":
        jcc.save(path)
        jax_serial.save_context_json(jpath, jcc.params, jcc.bt_key)
        loaded = tfhe_tpu_torch.BinFHEContext.load(path, device="cpu")
        same_keys(loaded._bt_key_map, {jcc.params.rgsw.base_g: jcc.bt_key})
        params, keys = serial.load_context_json(jpath)
        same_keys(keys, {jcc.params.rgsw.base_g: jcc.bt_key})
        want = jcc.eval_bin_gate(tfhe_tpu.Gate.NAND, *toy["cts"])
        cts = tuple(lwe.LWECiphertext(c.a.copy(), c.b.copy(), c.modulus) for c in toy["cts"])
        got = nand(loaded, cts)
        src = jcc
    else:
        cc.save(path)
        serial.save_context_json(jpath, cc.params, cc.bt_key)
        loaded = tfhe_tpu.BinFHEContext.load(path)
        same_keys(loaded._bt_key_map, {cc.params.rgsw.base_g: cc.bt_key})
        params, keys = jax_serial.load_context_json(jpath)
        same_keys(keys, {cc.params.rgsw.base_g: cc.bt_key})
        cts = tuple(lwe.LWECiphertext(c.a.copy(), c.b.copy(), c.modulus) for c in toy["cts"])
        want = nand(cc, cts)
        got = loaded.eval_bin_gate(tfhe_tpu.Gate.NAND, *toy["cts"])
        src = cc
    assert params_dict(loaded.params) == params_dict(src.params)
    assert params_dict(params) == params_dict(src.params)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
    assert np.array_equal(toy["cc"].decrypt(toy["sk"], got), 1 - (m1 & m2))


@pytest.mark.parametrize("direction", ["port", *DIRECTIONS])
def test_seeded_key_stays_seeded(tmp_path, direction):
    """A seeded switching key is saved as its seed, dimensions and B and
    loads as a seeded key again, within the port and across the packages,
    its A block never materialized on either side; the port regenerates the
    same A from the loaded seed as the saving package's key holds."""
    path = str(tmp_path / "seeded.npz")
    if direction == "port_to_jax" or direction == "port":
        cc = tfhe_tpu_torch.BinFHEContext(seed=91, seeded_ksk=True, device="cpu")
        cc.params = seeded_params(PORT)
    else:
        cc = tfhe_tpu.BinFHEContext(seed=91, seeded_ksk=True)
        cc.params = seeded_params(JAX)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    assert hasattr(cc.bt_key.ksk, "seed")
    cc.save(path)
    if direction == "port_to_jax":
        loaded = tfhe_tpu.BinFHEContext.load(path)
        kind = jax_lwe.SeededSwitchingKey
    else:
        loaded = tfhe_tpu_torch.BinFHEContext.load(path, device="cpu")
        kind = lwe.SeededSwitchingKey
    key = loaded.bt_key.ksk
    assert isinstance(key, kind) and key._A is None and cc.bt_key.ksk._A is None
    same_keys(loaded._bt_key_map, {cc.params.rgsw.base_g: cc.bt_key})
    if direction != "port_to_jax":
        assert np.array_equal(key.A[:2, :3], cc.bt_key.ksk.A[:2, :3])


# -- pke ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pke():
    """BFV (N = 64, t = 257, three 28-bit limbs) and CKKS (N = 32) objects
    of both packages from one seed: keys, a gadget relinearization key, an
    HPS hybrid key with a Galois element, per-level CKKS hybrid keys, and a
    BFV and a rescaled CKKS ciphertext."""
    out = {}
    for name, C, P, R, CC, CP, CR in (
            ("jax", JaxBFVContext, JaxBFVParams, JaxBFVRns, JaxCKKSContext,
             JaxCKKSParams, JaxCKKSRns),
            ("port", BFVContext, BFVParams, BFVRnsContext, CKKSContext, CKKSParams,
             CKKSRnsContext)):
        c = C(P.create(N=64, t=257, mult_depth=2, limb_bits=28), seed=5)
        sk, pk = c.key_gen()
        rlk = c.relin_key_gen(sk)
        r = R(c, dnum=2, ks_limb_bits=28)
        gk = r.galois_key_gen(sk, 3)
        ct = r.encrypt_packed(pk, np.arange(64) % 257)
        cc = CC(CP.create(N=32, mult_depth=2, scale_bits=28, limb_bits=30), seed=6)
        csk, cpk = cc.key_gen()
        crns = CR(cc, dnum=2, ks_limb_bits=30)
        crlk = crns.relin_key_gen(csk)
        z = np.linspace(-0.5, 0.5, 16)
        cct = crns.eval_mult(cc.encrypt(cpk, z), cc.encrypt(cpk, z), crlk)
        out[name] = dict(c=c, sk=sk, pk=pk, rlk=rlk, gk=gk, ct=ct, cct=cct, crlk=crlk)
    return out


def same_poly(a, b) -> bool:
    return a.params.moduli == b.params.moduli and np.array_equal(
        np.asarray(a.rns, dtype=np.uint64), np.asarray(b.rns, dtype=np.uint64))


def same_hybrid(a, b) -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            same_hybrid(a[k], b[k])
        return
    assert tuple(a.q_moduli) == tuple(b.q_moduli) and tuple(a.p_moduli) == tuple(b.p_moduli)
    assert [tuple(g) for g in a.groups] == [tuple(g) for g in b.groups] and a.t == b.t
    assert getattr(a, "galois_k", None) == getattr(b, "galois_k", None)
    assert all(same_poly(x, y) for x, y in zip(a.bs + a.as_, b.bs + b.as_))


def check_pke_objects(got: dict, want: dict) -> None:
    p, q = got["params"], want["params"]
    assert (p.N, p.t, tuple(p.dcrt.moduli), p.std, p.relin_window) == \
        (q.N, q.t, tuple(q.dcrt.moduli), q.std, q.relin_window)
    assert np.array_equal(got["sk"].s_signed, want["sk"].s_signed)
    assert same_poly(got["sk"].s, want["sk"].s)
    assert same_poly(got["pk"].b, want["pk"].b) and same_poly(got["pk"].a, want["pk"].a)
    assert len(got["rlk"].b) == len(want["rlk"].b)
    assert all(same_poly(x, y) for x, y in zip(got["rlk"].b + got["rlk"].a,
                                                want["rlk"].b + want["rlk"].a))
    assert all(same_poly(x, y) for x, y in zip(got["ct"].polys, want["ct"].polys))
    g, w = got["cct"], want["cct"]
    assert g.scale == w.scale and g.noise_deg == w.noise_deg
    assert tuple(g.params.dcrt.moduli) == tuple(w.params.dcrt.moduli)
    assert all(same_poly(x, y) for x, y in zip(g.polys, w.polys))
    same_hybrid(got["gk"], want["gk"])
    same_hybrid(got["crlk"], want["crlk"])


def save_all(mod, d: dict, tmp_path) -> None:
    mod.save_keys(tmp_path / "keys.npz", d["c"].params, d["sk"], d["pk"], d["rlk"])
    mod.save_ciphertext(tmp_path / "ct.npz", d["ct"])
    mod.save_ckks_ciphertext(tmp_path / "cct.npz", d["cct"])
    mod.save_hybrid_keys(tmp_path / "gk.npz", d["gk"])
    mod.save_hybrid_keys(tmp_path / "crlk.npz", d["crlk"])


def load_all(mod, tmp_path) -> dict:
    params, sk, pk, rlk = mod.load_keys(tmp_path / "keys.npz")
    return dict(params=params, sk=sk, pk=pk, rlk=rlk,
                ct=mod.load_ciphertext(tmp_path / "ct.npz"),
                cct=mod.load_ckks_ciphertext(tmp_path / "cct.npz"),
                gk=mod.load_hybrid_keys(tmp_path / "gk.npz"),
                crlk=mod.load_hybrid_keys(tmp_path / "crlk.npz"))


def as_saved(d: dict) -> dict:
    return dict(params=d["c"].params, sk=d["sk"], pk=d["pk"], rlk=d["rlk"], ct=d["ct"],
                cct=d["cct"], gk=d["gk"], crlk=d["crlk"])


@pytest.mark.parametrize("direction", ["port", *DIRECTIONS])
def test_pke_files(pke, tmp_path, direction):
    """Every function of the port's pke/serial.py: BFV keys (and their bytes
    form), BFV and CKKS ciphertexts, a single hybrid key with its Galois
    element and a per-level dict, round-tripped in the port and crossing
    both ways; both packages' objects are equal from one seed, so each
    loaded object equals both."""
    check_pke_objects(as_saved(pke["port"]), as_saved(pke["jax"]))
    src, dst = {"port": ("port", pke_serial), "jax_to_port": ("jax", pke_serial),
                "port_to_jax": ("port", jax_pke_serial)}[direction]
    save_all(jax_pke_serial if src == "jax" else pke_serial, pke[src], tmp_path)
    got = load_all(dst, tmp_path)
    check_pke_objects(got, as_saved(pke["port"]))
    if direction == "port":
        d = pke["port"]
        blob = pke_serial.dumps_keys(d["c"].params, d["sk"], d["pk"], d["rlk"])
        params, sk, pk, rlk = pke_serial.load_keys(io.BytesIO(blob))
        assert np.array_equal(sk.s_signed, d["sk"].s_signed) and same_poly(pk.b, d["pk"].b)
        got_ct = d["c"].decrypt(sk, got["ct"])
        assert np.array_equal(got_ct, d["c"].decrypt(d["sk"], d["ct"]))
