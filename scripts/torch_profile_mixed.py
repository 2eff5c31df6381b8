#!/usr/bin/env python3
"""Where the time of the port's mixed logQ = 11, DM and GEMM cells goes, on
one GPU.

    python3 scripts/torch_profile_mixed.py

The cells: EvalFloor at `from_gpu_style(STD128, False, 11)` with one digit
thrown, batch 4096 (bench.py's floor row); the CHES 256-ciphertext AND at
the same set with none thrown (examples/ches_experiments.py); a STD128_AP
NAND on the DM path at batch 1024; CiphertextMulMatrix 1024 x 1024 mod 2^35
(examples/gemm.py). For each: a first call checked by decryption (or
against the host product), three warm host-clock timings, then one call
under `torch.profiler`, whose per-kernel device times go to
`chiprun_out/profile_<cell>.txt`. Prints one JSON line per cell: wall
seconds, the profiled wall, device-busy seconds (kernel self time on the
one stream), the idle share 1 - busy / profiled wall, the device time of
the blind rotation (`blind_rotate`) and of the key switch's row sums
(`embedding_bag`), and the five kernels with the most device time. Imports
no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tfhe_tpu_torch import BinFHEContext, Gate, Method, ParamSet  # noqa: E402
from tfhe_tpu_torch.ops import lweops  # noqa: E402

OUT_DIR = "chiprun_out"


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def measure(cell: str, fn, card: str) -> None:
    """Three warm host-clock timings of fn (synchronised: each call ends in
    a download), then one profiled call; prints the cell's JSON line."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = {e.key: device_us(e) / 1e6 for e in avgs
               if e.device_type.name == "CUDA" and device_us(e) > 0}
    busy = sum(kernels.values())
    rot = sum(v for k, v in kernels.items() if "blind_rotate" in k)
    ks = sum(v for k, v in kernels.items() if "EmbeddingBag" in k)
    with open(os.path.join(OUT_DIR, f"profile_{cell}.txt"), "w") as f:
        f.write(f"{card}\n{cell}, profiled wall {prof_wall:.6f} s\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    print(json.dumps({"cell": cell, "wall_s": walls, "profiled_wall_s": prof_wall,
                      "device_busy_s": busy, "idle_share": 1 - busy / prof_wall,
                      "rotation_s": rot, "ks_row_sums_s": ks,
                      "top_kernels_s": {k[:80]: v for k, v in top}, "card": card}),
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    rng = np.random.default_rng(chip_smoke.SEED)

    ctxs, sk, _ = chip_smoke.mixed_contexts(ParamSet.STD128)
    floor_cc, and_cc = ctxs[1], ctxs[0]
    for cc in ctxs.values():
        cc.device_setup("cuda")
    ct, m, p = chip_smoke.floor_inputs(floor_cc, sk, rng, 4096)
    if not chip_smoke.floor_ok(floor_cc, sk, floor_cc.eval_floor(ct, 1), m, p):
        raise SystemExit("wrong EvalFloor result")
    measure("floor_logq11_4096", lambda: floor_cc.eval_floor(ct, 1), card)
    m1, m2 = rng.integers(0, 2, 256), rng.integers(0, 2, 256)
    ct1, ct2 = and_cc.encrypt(sk, m1), and_cc.encrypt(sk, m2)
    if not np.array_equal(and_cc.decrypt(sk, and_cc.eval_bin_gate(Gate.AND, ct1, ct2)),
                          m1 & m2):
        raise SystemExit("wrong CHES AND result")
    measure("ches_and_256", lambda: and_cc.eval_bin_gate(Gate.AND, ct1, ct2), card)
    del ctxs, floor_cc, and_cc

    cc = BinFHEContext(seed=chip_smoke.SEED)
    cc.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12)
    mod = cc.params.lwe.q_ks
    gsk = cc.key_gen()
    cts = cc.encrypt(gsk, np.arange(1024) % cc.get_max_plaintext_space(), "FRESH",
                     cc.get_max_plaintext_space(), mod)
    matrix = rng.integers(-100, 101, (1024, 1024))
    got = cc.ciphertext_mul_matrix(cts, matrix, mod)
    want = lweops.ciphertext_mul_matrix(cts, matrix, mod)
    if not (np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)):
        raise SystemExit("wrong GEMM result")
    measure("gemm_1024", lambda: cc.ciphertext_mul_matrix(cts, matrix, mod), card)

    cc = BinFHEContext(seed=chip_smoke.SEED)
    cc.generate_binfhe_context(ParamSet.STD128_AP, Method.AP)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    cc.device_setup("cuda")
    m1, m2 = rng.integers(0, 2, 1024), rng.integers(0, 2, 1024)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    if not np.array_equal(cc.decrypt(sk, cc.eval_bin_gate(Gate.NAND, ct1, ct2)),
                          1 - (m1 & m2)):
        raise SystemExit("wrong STD128_AP NAND result")
    measure("dm_nand_1024", lambda: cc.eval_bin_gate(Gate.NAND, ct1, ct2), card)


if __name__ == "__main__":
    main()
