"""The batch-sharded backend (`parallel/mesh.py`, `TorchBackend(mesh=...)`)
on the CPU: a mesh of D in {1, 2, 4} shards, all on "cpu" (a mesh may name
one device more than once), at batches B in {1, 5, 16}.

Each operation runs on N = 256 rings, one per path of the backend: NAND, AND
and XOR on the gate path; EvalFloor on the mixed path (a 20-bit Q with
qKS = 2^35); EvalFunc (a periodic table), EvalSign and EvalDecomp on the
RNS path's device chain; a gate on the two-limb path (a 30-bit Q) and one on
the DM path. Every sharded output equals the one-device
`TorchBackend("cpu")` output of the same rows, and the rows of the JAX
package's `RefBackend` output at B = 16, computed once per operation on the
same keys: a ciphertext's output does not depend on the batch around it."""

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu.params import BinFHEParams, LWEParams, Method, RGSWParams
from tfhe_tpu.utils.numtheory import ntt_prime, previous_prime
import tfhe_tpu_torch
from tfhe_tpu_torch import convert, lwe
from tfhe_tpu_torch.ops.backend import TorchBackend
from tfhe_tpu_torch.parallel import mesh as mesh_mod
from tfhe_tpu_torch.parallel.mesh import Mesh, shard_rows
from tfhe_tpu_torch.params import Gate
from torch_threads import one_torch_thread  # noqa: F401

N, B_MAX = 256, 16
SHARDS = (1, 2, 4)
BATCHES = (1, 5, B_MAX)


def params(n: int, q: int, Q: int, q_ks: int, base_g: int,
           method: Method = Method.GINX) -> BinFHEParams:
    return BinFHEParams(
        lwe=LWEParams(n=n, N=N, q=q, Q=Q, q_ks=q_ks, std=3.19, base_ks=32),
        rgsw=RGSWParams(N=N, Q=Q, q=q, base_g=base_g, base_r=23, method=method,
                        std=3.19, sign_eval=True))


def rns_params() -> BinFHEParams:
    q1 = ntt_prime(17, 2 * N)
    return params(8, 512, q1 * previous_prime(q1, 2 * N), 1 << 35, 1 << 7)


PATHS = {
    "gate": lambda: params(16, 512, ntt_prime(20, 2 * N), ntt_prime(20, 2 * N), 1 << 5),
    "mixed": lambda: params(8, 512, ntt_prime(20, 2 * N), 1 << 35, 1 << 5),
    "rns": rns_params,
    "two_limb": lambda: params(8, 512, ntt_prime(30, 2 * N), 1 << 25, 1 << 10),
    "dm": lambda: params(8, 512, ntt_prime(20, 2 * N), 1 << 14, 1 << 5, Method.AP),
}


@pytest.fixture(scope="module")
def contexts():
    """path -> (JAX context, the port's context on its parameters and key,
    the LWE secret): keys from one seed per path."""
    out = {}
    for i, (path, make) in enumerate(PATHS.items()):
        jc = JaxContext(seed=900 + i)
        jc.params = make()
        sk = jc.key_gen()
        jc.bt_key_gen(sk)
        tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
        tc.params = convert.params_from(jc.params)
        tc.bt_key_load(convert.key_from(jc.bt_key))
        assert TorchBackend._path(tc.params) == path
        out[path] = jc, tc, sk
    return out


def fresh(jc, sk, rng, B, P, Q_enc=None):
    return jc.encrypt(sk, rng.integers(0, P, B), "FRESH", P, Q_enc)


def gate_inputs(jc, sk, rng):
    return jc.encrypt(sk, rng.integers(0, 2, B_MAX)), jc.encrypt(sk, rng.integers(0, 2, B_MAX))


def periodic_lut(q, rng):
    half = rng.integers(1, q, q // 2).astype(np.uint64)
    return np.concatenate([half, half])


def sign_inputs(jc, sk, rng):
    Q_enc = 1 << 11
    P = jc.params.max_plaintext_space * (Q_enc // jc.params.lwe.q)
    return (fresh(jc, sk, rng, B_MAX, P, Q_enc),)


# operation -> (path, inputs(jc, sk, rng), run(context, *inputs))
OPS = {
    "nand": ("gate", gate_inputs, lambda c, x, y: c.eval_bin_gate(Gate.NAND, x, y)),
    "and": ("gate", gate_inputs, lambda c, x, y: c.eval_bin_gate(Gate.AND, x, y)),
    "xor": ("gate", gate_inputs, lambda c, x, y: c.eval_bin_gate(Gate.XOR, x, y)),
    "floor": ("mixed", lambda jc, sk, rng: (fresh(jc, sk, rng, B_MAX,
                                                  jc.params.max_plaintext_space),),
              lambda c, x: c.eval_floor(x, 1)),
    "func": ("rns", lambda jc, sk, rng: (fresh(jc, sk, rng, B_MAX,
                                                 jc.params.max_plaintext_space),
                                           periodic_lut(jc.params.lwe.q, rng)),
             lambda c, x, lut: c.eval_func(x, lut)),
    "sign": ("rns", sign_inputs, lambda c, x: c.eval_sign(x)),
    "decomp": ("rns", sign_inputs, lambda c, x: c.eval_decomp(x)),
    "two_limb_nand": ("two_limb", gate_inputs,
                      lambda c, x, y: c.eval_bin_gate(Gate.NAND, x, y)),
    "dm_or": ("dm", gate_inputs, lambda c, x, y: c.eval_bin_gate(Gate.OR, x, y)),
}


def as_list(out):
    return out if isinstance(out, list) else [out]


def rows(ct, B):
    """The first B rows of a batch: a port ciphertext (inputs that are
    not ciphertexts, such as a table, pass through)."""
    if not hasattr(ct, "modulus"):
        return ct
    return lwe.LWECiphertext(np.asarray(ct.a)[:B], np.asarray(ct.b)[:B], int(ct.modulus))


def assert_rows(want, got, B):
    for w, g in zip(as_list(want), as_list(got), strict=True):
        assert int(w.modulus) == int(g.modulus)
        assert np.array_equal(np.asarray(w.a)[:B], np.asarray(g.a))
        assert np.array_equal(np.asarray(w.b)[:B], np.asarray(g.b))


@pytest.mark.parametrize("op", OPS)
def test_sharded_outputs_equal_one_device_and_oracle(contexts, op):
    path, make_inputs, run = OPS[op]
    jc, tc, sk = contexts[path]
    inputs = make_inputs(jc, sk, np.random.default_rng(len(op)))
    oracle = run(jc, *inputs)                      # the JAX package's RefBackend
    ported = [convert.ciphertext_from(x) if hasattr(x, "modulus") else x for x in inputs]
    tc.use_backend(TorchBackend("cpu"))
    one = run(tc, *ported)
    assert_rows(oracle, one, B_MAX)
    for D in SHARDS:
        be = TorchBackend(mesh=Mesh(["cpu"] * D))
        tc.use_backend(be)
        for B in BATCHES:
            got = run(tc, *[rows(x, B) for x in ported])
            assert_rows(one, got, B)
            assert_rows(oracle, got, B)
        assert len(be._device_keys[id(tc.bt_key.bsk_coeff)]) == D


def test_device_chain_is_held_shard_by_shard(contexts):
    """Under a mesh the chain's ciphertexts stay on the shards: one part a
    shard that holds rows, None for the others (B = 3 over 4 shards)."""
    jc, tc, sk = contexts["rns"]
    be = TorchBackend(mesh=Mesh(["cpu"] * 4))
    ct = convert.ciphertext_from(jc.encrypt(sk, np.array([0, 1, 2])))
    dct = be.lwe_upload(ct)
    assert [None if p is None else p[0].shape[0] for p in dct.parts] == [None, 1, 1, 1]
    back = be.lwe_download(be.dev_retag(be.dev_sub_const(be.dev_add_const(dct, 5), 5), 7))
    assert back.modulus == 7
    assert np.array_equal(back.a, ct.a) and np.array_equal(back.b, ct.b)


def test_shard_rows_split_every_batch():
    for D in (1, 2, 3, 4, 8):
        m = Mesh(["cpu"] * D)
        for B in (1, 2, 5, 16, 17):
            r = shard_rows(m, B)
            assert r[0][0] == 0 and r[-1][1] == B and len(r) == D
            assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
            assert max(h - lo for lo, h in r) - min(h - lo for lo, h in r) <= 1


def test_replicate_shares_one_copy_per_device():
    t = torch.arange(6)
    copies = mesh_mod.replicate(Mesh(["cpu", "cpu", "meta"]), t)
    assert copies[0] is copies[1] and copies[2].device.type == "meta"
    assert mesh_mod.gather(Mesh(["cpu"] * 3), [np.arange(2), None, np.arange(3)]).tolist() == \
        [0, 1, 0, 1, 2]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without a GPU")
def test_no_gpu_raises_and_never_falls_back_to_the_cpu(contexts):
    with pytest.raises(ValueError):
        mesh_mod.make_mesh()
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(2)
    with pytest.raises(ValueError):
        TorchBackend("cpu", num_devices=2)
    with pytest.raises(RuntimeError):
        TorchBackend(mesh=Mesh(["cuda:0", "cuda:0"]))
    _, tc, _ = contexts["gate"]
    with pytest.raises(ValueError):
        tc.device_setup(num_devices=2)
    with pytest.raises(ValueError):
        Mesh([], "batch")
    with pytest.raises(ValueError):
        TorchBackend(mesh=Mesh(["cpu"], "limb"))
