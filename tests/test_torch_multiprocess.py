"""Two processes joined by `torch.distributed` (gloo, on the CPU) run the
batch-sharded backend as one mesh: each process lists two shards on "cpu",
so a batch is split over four shards, and every process gets the whole
output back (`parallel/mesh.gather`). The counterpart of
tests/test_multiprocess.py with its worker tests/_mp_worker.py: both ranks
build the same N = 256 context from one seed, run a NAND gate and an RNS
functional bootstrap sharded across both, and check them bit for bit
against the port's host oracle `RefBackend`, at batches that split
unevenly and one that leaves a whole process without rows.

The worker is this file run as a script: `python
tests/test_torch_multiprocess.py RANK WORLD PORT`."""

import os
import socket
import subprocess
import sys

import pytest

TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gate_and_rns_pipeline():
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), "2",
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        pytest.fail("workers timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"rank {rank}: ok" in out, f"rank {rank} output:\n{out}"


def worker(rank: int, world: int, port: int) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from tfhe_tpu_torch import BinFHEContext, Gate, lwe, scheme
    from tfhe_tpu_torch.ops.backend import TorchBackend
    from tfhe_tpu_torch.params import BinFHEParams, LWEParams, Method, RGSWParams
    from tfhe_tpu_torch.parallel.mesh import Mesh, distributed_initialize
    from tfhe_tpu_torch.ref.backend import RefBackend
    from tfhe_tpu_torch.utils.numtheory import ntt_prime, previous_prime
    from tfhe_tpu_torch.utils.rng import BinFHERng

    distributed_initialize(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                           world_size=world, rank=rank)
    mesh = Mesh(["cpu", "cpu"])
    assert (mesh.world_size, mesh.rank, mesh.size) == (world, rank, 2 * world)

    # the same context on every rank: one seed, identical keys
    cc = BinFHEContext(seed=7, device="cpu")
    cc.generate_binfhe_context_custom(n=16, N=256, q=512, Q=ntt_prime(20, 512), std=3.19,
                                      base_ks=32, base_g=1 << 5, base_r=23)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    be = TorchBackend(mesh=mesh)
    for B in (7, 1):
        m1, m2 = np.arange(B) % 2, (np.arange(B) // 2) % 2
        ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
        want = scheme.eval_bin_gate(RefBackend(), cc.params, Gate.NAND, cc.bt_key, ct1, ct2)
        got = scheme.eval_bin_gate(be, cc.params, Gate.NAND, cc.bt_key, ct1, ct2)
        assert np.array_equal(want.a, got.a) and np.array_equal(want.b, got.b), f"NAND B={B}"
        assert np.array_equal(cc.decrypt(sk, got), 1 - (m1 & m2))

    # the RNS functional bootstrap (composite Q of two 17-bit primes)
    N = 256
    q1 = ntt_prime(17, 2 * N)
    q2 = previous_prime(q1, 2 * N)
    params = BinFHEParams(
        lwe=LWEParams(n=8, N=N, q=512, Q=q1 * q2, q_ks=1 << 35, std=3.19, base_ks=32),
        rgsw=RGSWParams(N=N, Q=q1 * q2, q=512, base_g=1 << 7, base_r=23,
                        method=Method.GINX, std=3.19))
    rng = BinFHERng(31)
    key = scheme.key_gen(rng, params, lwe.key_gen(rng, params.lwe.n, params.lwe.q_ks))
    npr = np.random.default_rng(37)
    B = 6
    ct = lwe.LWECiphertext(npr.integers(0, 512, (B, params.lwe.n)).astype(np.uint64),
                           npr.integers(0, 512, B).astype(np.uint64), 512)

    def f(x, q, fmod):
        return (np.asarray(x, dtype=np.uint64) * 3) % np.uint64(fmod)

    want = scheme.bootstrap_func(RefBackend(), params, key, ct, f, 512)
    got = scheme.bootstrap_func(TorchBackend(mesh=mesh), params, key, ct, f, 512)
    assert np.array_equal(want.a, got.a) and np.array_equal(want.b, got.b), "RNS func"
    print(f"rank {rank}: ok", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(*map(int, sys.argv[1:4]))
