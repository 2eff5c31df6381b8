"""The seeded (threefry) switching key of the port against the JAX
package's, exactly: the port's threefry against `jax.random`, the key's
seed, B and A from identically seeded contexts at one full chunk (N = 256,
baseKS 32: 57,344 rows) and at a ragged second chunk (N = 512, baseKS 16:
73,728 rows), the device table regenerated from the seed against the table
of the materialized A, a gate and an EvalSign on the seeded key against
the JAX package's `JaxBackend` and host oracle, the carry-across of a
seeded key, and the default (card) context's seeded keygen, which raises
where there is no card rather than fall back to the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import lwe as jax_lwe
from tfhe_tpu import scheme as jax_scheme
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.params import BinFHEParams, LWEParams, Method, RGSWParams
from tfhe_tpu.ref.backend import RefBackend as JaxRefBackend
from tfhe_tpu.utils.numtheory import ntt_prime, previous_prime
import tfhe_tpu_torch
from tfhe_tpu_torch import convert, lwe
from tfhe_tpu_torch.ops.keyswitch import ksk_table, seeded_ksk_table
from tfhe_tpu_torch.params import Gate
from tfhe_tpu_torch.ref.backend import RefBackend
from tfhe_tpu_torch.utils import threefry
from torch_threads import one_torch_thread  # noqa: F401


def jax_words(key) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(key))


def test_threefry_partitionable_default():
    """The stream is defined in partitionable mode (the default since jax
    0.5); a change of that default must fail here, not in a key."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [1, 4243, (1 << 31) - 1])
@pytest.mark.parametrize("chunk", [0, 1, 7])
def test_threefry_matches_jax_random(seed, chunk):
    C, n = 40, 9
    key = jax.random.PRNGKey(np.uint32(seed))
    assert jax_words(key) == threefry.prng_key(seed)
    key_c = jax.random.fold_in(key, chunk)
    tkey = threefry.fold_in(threefry.prng_key(seed), chunk)
    assert jax_words(key_c) == tkey
    one = np.asarray(jax.random.bits(key_c, (C, n), jnp.uint32)).astype(np.int64)
    two = np.asarray(jax.random.bits(key_c, (2, C, n), jnp.uint32)).astype(np.int64)
    assert np.array_equal(threefry.bits(tkey, torch.arange(C * n)).numpy(),
                          one.reshape(-1))
    assert np.array_equal(threefry.bits(tkey, torch.arange(2 * C * n)).numpy(),
                          two.reshape(-1))
    rows = torch.arange(17 * n, 29 * n)            # a block of rows alone
    assert np.array_equal(threefry.bits(tkey, rows).numpy(),
                          one[17:29].reshape(-1))
    assert np.array_equal(threefry.bits(tkey, rows + C * n).numpy(),
                          two[1, 17:29].reshape(-1))


def make_pair(N: int, base_ks: int, seed: int):
    """A JAX-package context and the port's (device "cpu"), both with
    seeded_ksk=True, on the same small composite-Q parameters (qKS = 2^35,
    n = 8), with their keys generated from one seed."""
    q1 = ntt_prime(17, 2 * N)
    q2 = previous_prime(q1, 2 * N)
    params = BinFHEParams(
        lwe=LWEParams(n=8, N=N, q=512, Q=q1 * q2, q_ks=1 << 35, std=3.19,
                      base_ks=base_ks),
        rgsw=RGSWParams(N=N, Q=q1 * q2, q=512, base_g=1 << 7, base_r=23,
                        method=Method.GINX, std=3.19, sign_eval=True))
    jc = JaxContext(seed=seed, seeded_ksk=True)
    jc.params = params
    tc = tfhe_tpu_torch.BinFHEContext(seed=seed, seeded_ksk=True, device="cpu")
    tc.params = convert.params_from(params)
    sk = jc.key_gen()
    jc.bt_key_gen(sk)
    tc.bt_key_gen(tc.key_gen())
    assert isinstance(jc.bt_key.ksk, jax_lwe.SeededSwitchingKey)
    assert isinstance(tc.bt_key.ksk, lwe.SeededSwitchingKey)
    return jc, tc, sk


@pytest.fixture(scope="module")
def full_chunk():
    return make_pair(256, 32, 4243)


@pytest.fixture(scope="module")
def ragged():
    return make_pair(512, 16, 5150)


@pytest.mark.parametrize("pair", ["full_chunk", "ragged"])
def test_seeded_key_matches_jax(pair, request):
    jc, tc, _ = request.getfixturevalue(pair)
    jk, tk = jc.bt_key.ksk, tc.bt_key.ksk
    R = tk.rows
    assert R == (57344 if pair == "full_chunk" else 73728)
    assert (tk.seed, tk.N, tk.base_ks, tk.digit_count, tk.n, tk.q_ks) == \
        (jk.seed, jk.N, jk.base_ks, jk.digit_count, jk.n, jk.q_ks)
    assert np.array_equal(tk.B, jk.B)
    assert np.array_equal(tk.A, np.asarray(jk.A))
    assert np.array_equal(tc.bt_key.bsk_coeff, jc.bt_key.bsk_coeff)
    # a block of rows across the chunk boundary, generated alone
    r0 = min(R, lwe.KSK_ROW_CHUNK + 5) - 10
    block = lwe.seeded_rows(tk.seed, tk.n, tk.q_ks, r0, r0 + 10, "cpu")
    assert np.array_equal(block.numpy().astype(np.uint64),
                          np.asarray(jk.A).reshape(R, -1)[r0:r0 + 10])


@pytest.mark.parametrize("pair", ["full_chunk", "ragged"])
def test_seeded_table_equals_table_of_a(pair, request):
    _, tc, _ = request.getfixturevalue(pair)
    ksk = tc.bt_key.ksk
    assert torch.equal(seeded_ksk_table(ksk, "cpu"), ksk_table(ksk.A, ksk.B))


def test_seeded_gate_matches_jax_backend_and_oracle(full_chunk):
    jc, tc, sk = full_chunk
    m1, m2 = np.array([0, 1, 1, 0]), np.array([1, 1, 0, 0])
    ct1, ct2 = jc.encrypt(sk, m1), jc.encrypt(sk, m2)
    want = jax_scheme.eval_bin_gate(JaxRefBackend(), jc.params, Gate.NAND,
                                    jc.bt_key, ct1, ct2)
    dev = jax_scheme.eval_bin_gate(JaxBackend(), jc.params, Gate.NAND,
                                   jc.bt_key, ct1, ct2)
    got = tc.eval_bin_gate(Gate.NAND, convert.ciphertext_from(ct1),
                           convert.ciphertext_from(ct2))
    assert isinstance(tc.backend, tfhe_tpu_torch.TorchBackend)
    for ref in (want, dev):
        assert np.array_equal(np.asarray(ref.a), got.a)
        assert np.array_equal(np.asarray(ref.b), np.asarray(got.b))
    assert np.array_equal(jc.decrypt(sk, got).astype(np.int64), 1 - (m1 & m2))


def test_seeded_sign_matches_jax_backend_and_oracle(full_chunk):
    jc, tc, sk = full_chunk
    Q_enc = 1 << 11
    P = jc.params.max_plaintext_space * (Q_enc // jc.params.lwe.q)
    m = (P // 2 + np.array([-2, -1, 0, 1])) % P
    ct = jc.encrypt(sk, m, "FRESH", P, Q_enc)
    keys = {jc.params.rgsw.base_g: jc.bt_key}
    want = jax_scheme.eval_sign(JaxRefBackend(), jc.params, keys, ct, jc.params.beta)
    dev = jax_scheme.eval_sign(JaxBackend(), jc.params, keys, ct, jc.params.beta)
    got = tc.eval_sign(convert.ciphertext_from(ct))
    tc.use_backend(RefBackend())
    host = tc.eval_sign(convert.ciphertext_from(ct))
    tc.device_setup()
    for ref in (want, dev, host):
        assert np.array_equal(np.asarray(ref.a), got.a)
        assert np.array_equal(np.asarray(ref.b), np.asarray(got.b))


def test_key_from_seeded_never_reads_a(full_chunk):
    jc, tc, _ = full_chunk

    class NoA:
        """The JAX key's fields, with an `.A` that must not be read."""
        def __init__(self, k):
            for f in ("seed", "N", "base_ks", "digit_count", "n", "q_ks", "B"):
                setattr(self, f, getattr(k, f))

        @property
        def A(self):
            raise AssertionError("key_from read the seeded key's A")

    jkey = jc.bt_key
    carried = convert.key_from(type("K", (), {
        "ksk": NoA(jkey.ksk), "sk_n": jkey.sk_n, "bsk_coeff": jkey.bsk_coeff,
        "base_g": jkey.base_g})())
    ksk = carried.ksk
    assert isinstance(ksk, lwe.SeededSwitchingKey) and ksk._A is None
    assert ksk.seed == tc.bt_key.ksk.seed
    assert np.array_equal(ksk.B, tc.bt_key.ksk.B)
    assert torch.equal(convert.switching_table(ksk, torch.device("cpu")),
                       convert.switching_table(tc.bt_key.ksk, torch.device("cpu")))


def test_seeded_keygen_runs_on_the_contexts_device():
    """The default context is the card's: its seeded keygen sums <A, s>
    there, and without a card it raises rather than fall back to the CPU."""
    N = 256
    q1 = ntt_prime(17, 2 * N)
    params = convert.params_from(BinFHEParams(
        lwe=LWEParams(n=8, N=N, q=512, Q=q1 * previous_prime(q1, 2 * N), q_ks=1 << 35,
                      std=3.19, base_ks=32),
        rgsw=RGSWParams(N=N, Q=q1 * previous_prime(q1, 2 * N), q=512, base_g=1 << 7,
                        base_r=23, method=Method.GINX, std=3.19)))
    cc = tfhe_tpu_torch.BinFHEContext(seed=3, seeded_ksk=True)
    assert cc.device == "cuda"
    cc.params = params
    sk = cc.key_gen()
    if torch.cuda.is_available():
        cc.bt_key_gen(sk)
        assert isinstance(cc.bt_key.ksk, lwe.SeededSwitchingKey)
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cc.bt_key_gen(sk)
        assert cc.bt_key is None


def test_selected_rows_equal_the_materialized_block():
    """TOY's accelerated seeded switching key (n = 32, N = 1024, qKS = 2^35,
    baseKS 32: 229,376 rows over four chunks): the rows that `SeededRows`
    draws for each read, and a host key switch of a batch through it, equal
    the materialized block's, word for word."""
    from tfhe_tpu_torch.params import ParamSet

    tc = tfhe_tpu_torch.BinFHEContext(seed=2027, seeded_ksk=True, device="cpu")
    tc.generate_binfhe_context(ParamSet.TOY, arb_func=False, log_q=17, num_digits_to_throw=1)
    tc.bt_key_gen(tc.key_gen())
    full = tc.bt_key.ksk
    drawn = lwe.SeededSwitchingKey(full.seed, full.N, full.base_ks, full.digit_count, full.n,
                                   full.q_ks, full.B)
    drawn.select_rows_on("cpu")
    p = tc.params.lwe
    assert isinstance(drawn.A, lwe.SeededRows) and drawn._A is None
    assert full.rows > 3 * lwe.KSK_ROW_CHUNK
    rng = np.random.default_rng(2027)
    i = rng.integers(0, p.N, (3, p.N))
    i[0, :4] = [0, p.N - 1, lwe.KSK_ROW_CHUNK // (p.base_ks * p.digit_count_ks), 0]
    a0 = rng.integers(0, p.base_ks, (3, p.N))
    for j in range(p.digit_count_ks):
        assert np.array_equal(drawn.A[i, a0, j], full.A[i, a0, j])
    ct = lwe.LWECiphertext(rng.integers(0, p.Q, (5, p.N)).astype(np.uint64),
                           rng.integers(0, p.Q, 5).astype(np.uint64), p.Q)
    want, got = lwe.key_switch(p, full, ct), lwe.key_switch(p, drawn, ct)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
    assert drawn._A is None                      # the block was never built
