#!/usr/bin/env python3
"""Where the time of the port's STD128 NAND goes, on one GPU.

    python3 scripts/torch_profile_gate.py [batch ...]     (default 4096 16384)
    python3 scripts/torch_profile_gate.py --kernel-only

For each batch: three warm host-clock timings of
`BinFHEContext.eval_bin_gate(Gate.NAND, ...)`, then one run under
`torch.profiler` whose per-kernel device times go to
`chiprun_out/profile_nand_<batch>.txt`. Prints one JSON line per batch:
wall seconds, bootstraps/s, device-busy seconds (sum of kernel self time on
the one stream), the idle share 1 - busy / wall, and the device time of
the blind rotation and of the key switch (`embedding_bag`) with their
shares of busy time.

With `--kernel-only` (about a minute): builds `csrc/blind_rotate.cu`,
prints what ptxas says of its registers and spills, and runs
`chip_smoke.gate_kernel_vs_plain`: the kernel held to its plain version
(`torch.equal`) at B = 64, n = 16 at STD128 shapes, at every case of
`chip_smoke.gate_cases` below N = 8192 (B = 5, n = 8; N = 8192 is
`scripts/torch_check_ring4096.py --ring 8192`), and at B = 4096, n = 512 and the
mixed logQ = 11 shape (the plain version on a head of rows), where it is
timed with CUDA events against the bound `chip_smoke.py` computes, on
random keys, without keygen. Prints one JSON line. Imports no jax.
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

from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet  # noqa: E402


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def kernel_only(card: str) -> None:
    """Build, check and time blind_rotate alone (see the module doc)."""
    import chip_smoke
    from tfhe_tpu_torch import from_param_set
    from tfhe_tpu_torch.ops import _build

    t0 = time.time()
    _build.build(("blind_rotate",))
    ptxas = _build.ptxas_report("blind_rotate")
    for ln in ptxas:
        print(f"ptxas: {ln}", flush=True)
    rec = {"phase": "gate_kernel", "card": card, "build_s": time.time() - t0, "ptxas": ptxas}
    rng = np.random.default_rng(chip_smoke.SEED)
    line, rec["mixed"] = chip_smoke.gate_kernel_vs_plain(
        rng, from_param_set(ParamSet.STD128).lwe.Q, chip_smoke.int32_peak_per_s())
    rec.update(line)
    print(json.dumps(rec), flush=True)


def main(batches: list[int], kernel: bool) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if kernel:
        return kernel_only(card)
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)

    cc = BinFHEContext(seed=7)
    cc.generate_binfhe_context(ParamSet.STD128)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    cc.device_setup("cuda")
    rng = np.random.default_rng(7)
    for B in batches:
        m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
        ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
        out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        if not np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)):
            raise SystemExit(f"wrong NAND result at batch {B}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            cc.eval_bin_gate(Gate.NAND, ct1, ct2)
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cc.eval_bin_gate(Gate.NAND, ct1, ct2)
            prof_wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        kernels = {e.key: device_us(e) / 1e6 for e in avgs
                   if e.device_type.name == "CUDA" and device_us(e) > 0}
        busy = sum(kernels.values())
        rot = sum(v for k, v in kernels.items() if "blind_rotate" in k)
        ks = sum(v for k, v in kernels.items() if "EmbeddingBag" in k)
        with open(os.path.join(out_dir, f"profile_nand_{B}.txt"), "w") as f:
            f.write(f"{card}\nbatch {B}, profiled wall {prof_wall:.6f} s\n")
            f.write(avgs.table(sort_by="self_device_time_total", row_limit=30))
        print(json.dumps({"batch": B, "wall_s": walls,
                          "bootstraps_per_s": [B / w for w in walls],
                          "profiled_wall_s": prof_wall, "device_busy_s": busy,
                          "idle_share": 1 - busy / prof_wall, "rotation_s": rot,
                          "rotation_share": rot / busy, "ks_row_sums_s": ks,
                          "ks_share": ks / busy, "card": card}),
              flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--kernel-only"]
    main([int(b) for b in args] or [4096, 16384], "--kernel-only" in sys.argv[1:])
