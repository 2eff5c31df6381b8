#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written blind-rotation kernel from `tfhe_tpu_torch/csrc`
(into `tfhe_tpu_torch/_build/`), holds it bit for bit against its plain
torch version at STD128 shapes and times both, runs all eight gates at TOY
on the GPU against the host oracle, then drives the headline path: a
batch-4096 STD128 NAND through `tfhe_tpu_torch.BinFHEContext`, checked by
decryption and, for its first 8 outputs, bit for bit against the oracle.
Exits non-zero on any failure. The line before the last is a JSON record of
the kernels; the last line is the JSON result. Imports no jax, and takes the
JAX package's host layers only through `tfhe_tpu_torch`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20261016
GATE_BATCH = 4096


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events. The
    caller has run fn once already."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_plain(rng, Q: int) -> dict:
    """The kernel against its plain version on the card, at STD128 shapes
    (N = 1024, d2 = 8, baseG = 2^7), with tolerance 0 (torch.equal: the
    arithmetic is exact and modular), each case timed: B = 64 over 16
    rounds, then B = 1024 and the main path's B = GATE_BATCH over all 512
    rounds. B = 1024 is the shape PERF.md's wave analysis compares with
    B = 4096 (1.55 against 6.2 waves of blocks). Returns the largest error
    and the times at the main path's shape."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate, rotate_kernel

    N, d2, base_g = 1024, 8, 1 << 7
    max_err = 0

    def compare(B, n):
        nonlocal max_err
        t0 = time.time()
        acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32)).cuda()
        a_idx = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32)).cuda()
        bsk_hat = rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64)
        bsk = rotate_kernel.pack_bsk(bsk_hat, Q).cuda()
        kernel = lambda: rotate_kernel.rotate(acc, a_idx, bsk, Q, base_g)  # noqa: E731
        plain = lambda: blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"kernel != plain at B={B}, n={n} (max abs err {err})")
        ms = cuda_ms(kernel, reps=3)
        plain_ms = cuda_ms(plain, reps=1)
        log(f"kernel == plain at N={N} d2={d2} B={B} n={n} (torch.equal, tolerance "
            f"0): max_abs_err {err}; kernel {ms:.3f} ms, plain torch {plain_ms:.3f} "
            f"ms ({time.time() - t0:.1f} s)")
        return ms, plain_ms

    compare(64, 16)
    compare(1024, 512)
    ms, plain_ms = compare(GATE_BATCH, 512)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def toy_gates(rng) -> None:
    """All eight gates at TOY on the GPU, bit for bit against the oracle."""
    import numpy as np

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet

    t0 = time.time()
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.TOY)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    m1 = rng.integers(0, 2, 16)
    m2 = rng.integers(0, 2, 16)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    truth = {Gate.OR: m1 | m2, Gate.AND: m1 & m2, Gate.NOR: 1 - (m1 | m2),
             Gate.NAND: 1 - (m1 & m2), Gate.XOR_FAST: m1 ^ m2,
             Gate.XNOR_FAST: 1 - (m1 ^ m2), Gate.XOR: m1 ^ m2,
             Gate.XNOR: 1 - (m1 ^ m2)}
    ref = {g: cc.eval_bin_gate(g, ct1, ct2) for g in truth}
    cc.device_setup("cuda")
    for g, want in truth.items():
        out = cc.eval_bin_gate(g, ct1, ct2)
        check(np.array_equal(cc.decrypt(sk, out), want), f"TOY {g.name} truth table")
        check(np.array_equal(out.a, ref[g].a) and np.array_equal(out.b, ref[g].b),
              f"TOY {g.name} differs from the host oracle")
    log(f"TOY: all 8 gates decrypt right and equal the host oracle bit for bit "
        f"({time.time() - t0:.1f} s)")


def std128_nand(rng, card: str) -> int:
    """The headline path: STD128 NAND at batch 4096 through the port's
    context. Returns the kernel launches of the checked run."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet
    from tfhe_tpu_torch.ops import rotate_kernel

    t0 = time.time()
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.STD128)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    log(f"STD128 host keygen {time.time() - t0:.1f} s")

    m1 = rng.integers(0, 2, GATE_BATCH)
    m2 = rng.integers(0, 2, GATE_BATCH)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    t0 = time.time()
    head = [type(c)(c.a[:8], c.b[:8], c.modulus) for c in (ct1, ct2)]
    ref = cc.eval_bin_gate(Gate.NAND, *head)
    log(f"host oracle NAND on 8 ciphertexts {time.time() - t0:.1f} s")

    t0 = time.time()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup (key to eval domain, pack, upload) {time.time() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    rotate_kernel.LAUNCHES = 0
    t0 = time.time()
    out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
    first_s = time.time() - t0
    launches = rotate_kernel.LAUNCHES
    check(launches > 0, "the NAND batch did not launch the blind-rotation kernel")
    check(out.a.shape == (GATE_BATCH, cc.params.lwe.n) and out.b.shape == (GATE_BATCH,),
          f"output shapes {out.a.shape}, {out.b.shape}")
    check(np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)), "STD128 NAND decryption")
    check(np.array_equal(out.a[:8], ref.a) and np.array_equal(out.b[:8], ref.b),
          "STD128 NAND: first 8 outputs differ from the host oracle")
    log(f"STD128 NAND B={GATE_BATCH}: all decrypt to 1-(m1&m2), first 8 equal the "
        f"host oracle bit for bit, kernel launches {launches}, first call "
        f"{first_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for _ in range(2):
        t0 = time.time()
        cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        s = time.time() - t0
        log(f"STD128 NAND B={GATE_BATCH} warm: {s:.4f} s, "
            f"{GATE_BATCH / s:.1f} bootstraps/s on {card}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"nvidia-smi {time.time() - t0:.1f} s")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from tfhe_tpu_torch import ParamSet, from_param_set
    from tfhe_tpu_torch.ops import _build

    t0 = time.time()
    _build.load("blind_rotate")
    for line in _build.LOGS.get("blind_rotate", "").splitlines():
        if "registers" in line or "spill" in line:
            log(line.strip())
    log(f"built csrc/blind_rotate.cu for sm_90a in {time.time() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    Q = from_param_set(ParamSet.STD128).lwe.Q
    timing = kernel_vs_plain(rng, Q)
    toy_gates(rng)
    launches = std128_nand(rng, card)

    print(json.dumps({"kernels": [{
        "name": "blind_rotate", "route": "cuda",
        "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
        "replaces": "tfhe_tpu/ops/pallas_rotate.py:253",
        "launches": launches, **timing}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
