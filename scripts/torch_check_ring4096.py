#!/usr/bin/env python3
"""The N = 4096 kernels alone, on one GPU (about a minute of command), or
the three kernels at N = 8192 (`--ring 8192`, about three and a half
minutes; `--ring 8192 --rns-only`, the RNS kernel alone; `--ring 8192
--r64-only`, the 64-bit kernel alone, about a minute), or the RNS kernel
at N = 16384 (`--ring 16384`, with or without `--rns-only`: the only
kernel that takes that ring).

    python3 scripts/torch_check_ring4096.py [--ring 8192 [--rns-only | --r64-only]]
    python3 scripts/torch_check_ring4096.py --ring 16384 [--rns-only]

Builds the three kernels (`_build.build`, one nvcc per source), prints what
ptxas says of every instantiation's registers and spills (nothing when the
libraries were built before in the same tree: `chip_smoke.py` prints it
too), then runs
`chip_smoke.ring4096_kernels`: `blind_rotate_rns` and `blind_rotate64`
(both as two-block clusters) and `blind_rotate` at N = 4096 held to their
plain versions with tolerance 0 at every digit count (B = 5), at the
accelerated sets' d2 = 4 and 2 (B = 64 for the RNS kernel), and at the
main paths' B = 1024, n = 1305 on a head of rows, each timed with CUDA
events against the bound `chip_smoke.py` computes, and the card's resident
clusters of each cluster kernel. Then `blind_rotate64` at N = 4096 at
B = 64 (`chip_smoke.rotate64_cases`), and the N <= 2048 main shapes beside
them: `blind_rotate_rns` at B = 4096, n = 1305, d2 = 4, `blind_rotate` at
STD128, B = 4096, n = 512, d2 = 8, and `blind_rotate64` at the 54-bit
prime, B = 1024, n = 1305, d2 = 4 and 2 (the plain versions on one row and
the last). Prints the card's name and power limit, and one JSON line of
the timings. Imports no jax.

With `--ring 8192`: `chip_smoke.ring8192_rns_kernels` (`blind_rotate_rns`
as a four-block cluster at d2 2, 4, 6 and 8 with throw 0 and 1, B = 5, at
d2 4 and 2, B = 64, then at B = 1024, n = 1305, d2 = 4 and 2 on a head of
rows, with ptxas's registers and spills and the resident clusters) and
beside it the RNS kernel's main shapes below N = 8192 (B = 4096, n = 1305,
N = 2048, d2 = 4; B = 1024, N = 4096, d2 = 4 and 2); then
`chip_smoke.ring8192_r64_kernels` (`blind_rotate64` as a four-block cluster
at every N = 8192 case of `chip_smoke.rotate64_cases`, B = 5, then at
B = 1024, n = 1305, d2 = 4 and 2 on a head of rows, with ptxas's registers
and spills and the resident clusters) and beside it the 64-bit kernel's
main shapes below N = 8192 (STD128Q at B = 4096, n = 1024; the 54-bit
prime at B = 1024, n = 1305, d2 = 4 and 2, at N = 2048 and 4096); then
`chip_smoke.ring8192_kernels` (`blind_rotate` as a two-block cluster at
every N = 8192 case of `chip_smoke.gate_cases`, B = 5, then at B = 1024,
n = 1305, d2 = 10 and 12 on a head of rows) and beside it the gate
kernel's main shapes below N = 8192: STD128 (B = 4096, n = 512, d2 = 8),
mixed logQ = 11 (B = 4096, n = 1305, N = 1024, d2 = 10) and N = 4096
(B = 1024, n = 1305, d2 = 10), the plain versions on one row and the last.
With `--rns-only`, only the RNS kernel's part (about a minute); with
`--r64-only`, only the 64-bit kernel's.

With `--ring 16384`: `chip_smoke.ring16384_rns_kernels` (`blind_rotate_rns`
as an eight-block cluster at d2 2, 4, 6 and 8 with throw 0 and 1, B = 5,
at d2 4 and 2, B = 64, then at B = 1024, n = 1305, d2 = 4 and 2 on a head
of rows, with ptxas's registers and spills and the resident clusters) and
beside it the RNS kernel's main shapes below N = 16384 (B = 4096, n = 1305,
N = 2048, d2 = 4; B = 1024 at N = 4096 and 8192, d2 = 4 and 2), the plain
versions on one row and the last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tfhe_tpu_torch import ParamSet, from_gpu_style, from_param_set
    from tfhe_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_check_ring4096: no CUDA device", file=sys.stderr)
        return 1
    ring = int(sys.argv[sys.argv.index("--ring") + 1]) if "--ring" in sys.argv else cs.RING_N
    if ring not in (cs.RING_N, cs.RING8192_N, cs.RING16384_N):
        print(f"torch_check_ring4096: --ring takes {cs.RING_N}, {cs.RING8192_N} or "
              f"{cs.RING16384_N}", file=sys.stderr)
        return 2
    t0 = time.time()
    _build.build()
    for name in _build.KERNELS:
        for line in _build.ptxas_report(name):
            cs.log(f"{name}: {line}")
    cs.log(f"built in {time.time() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    peak = cs.int32_peak_per_s()
    rng = np.random.default_rng(cs.SEED)
    if ring == cs.RING16384_N:
        out = {"rns_ring16384": cs.ring16384_rns_kernels(rng, peak)}
        out["rns_N2048"] = cs.rns_case(rng, *from_gpu_style(ParamSet.STD128, True, 12)
                                       .rgsw.rns_primes, peak, cs.FUNC_BATCH, cs.LWE_N_ACC, 4,
                                       rows=[0])
        for N in (cs.RING_N, cs.RING8192_N):
            q1, q2 = from_gpu_style(ParamSet.STD128, True, 12, N=N).rgsw.rns_primes
            for d2 in (4, 2):
                out[f"rns_N{N}_d2={d2}"] = cs.rns_case(rng, q1, q2, peak, cs.RING_BATCH,
                                                      cs.LWE_N_ACC, d2, N, rows=[0])
        print(json.dumps(out), flush=True)
        return 0
    if ring == cs.RING8192_N:
        out = {}
        if "--r64-only" not in sys.argv:
            q1, q2 = from_gpu_style(ParamSet.STD128, True, 12, N=cs.RING_N).rgsw.rns_primes
            out["rns_ring8192"] = cs.ring8192_rns_kernels(rng, peak)
            out["rns_N2048"] = cs.rns_case(rng, *from_gpu_style(ParamSet.STD128, True, 12)
                                           .rgsw.rns_primes, peak, cs.FUNC_BATCH,
                                           cs.LWE_N_ACC, 4, rows=[0])
            for d2 in (4, 2):
                out[f"rns_N4096_d2={d2}"] = cs.rns_case(rng, q1, q2, peak, cs.RING_BATCH,
                                                       cs.LWE_N_ACC, d2, cs.RING_N, rows=[0])
            if "--rns-only" in sys.argv:
                print(json.dumps(out), flush=True)
                return 0
        out["r64_ring8192"] = cs.ring8192_r64_kernels(rng, peak)
        cases = cs.rotate64_cases()
        for name, B in (("STD128Q", cs.GATE_BATCH), ("Q54, base 2^18", cs.SIGN64_BATCH),
                        ("Q54, base 2^27", cs.SIGN64_BATCH),
                        ("N=4096, Q54, base 2^18", cs.RING_BATCH),
                        ("N=4096, Q54, base 2^27", cs.RING_BATCH)):
            n = 1024 if name == "STD128Q" else cs.LWE_N_ACC
            out[f"r64 {name}"] = cs.rotate64_case(rng, peak, name, *cases[name], B, n, [0])
        if "--r64-only" in sys.argv:
            print(json.dumps(out), flush=True)
            return 0
        out["ring8192"] = cs.ring8192_kernels(rng, peak)
        std = from_param_set(ParamSet.STD128).lwe.Q
        mixed = from_gpu_style(ParamSet.STD128, False, 11).lwe.Q
        mixed4k = from_gpu_style(ParamSet.STD128, False, 11, N=cs.RING_N).lwe.Q
        for name, Q, B, n, N, d2, base_g, throw in (
                ("gate_N1024", std, cs.GATE_BATCH, 512, 1024, 8, 1 << 7, 0),
                ("mixed_N1024", mixed, cs.GATE_BATCH, cs.LWE_N_ACC, 1024, 10, 1 << 5, 1),
                ("mixed_N4096", mixed4k, cs.RING_BATCH, cs.LWE_N_ACC, cs.RING_N, 10, 1 << 5, 1)):
            out[name] = cs.gate_rows_case(rng, Q, peak, B, n, N, d2, base_g, throw, [0])
        print(json.dumps(out), flush=True)
        return 0
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12, N=cs.RING_N).rgsw.rns_primes
    Q = from_gpu_style(ParamSet.STD128, False, 11, N=cs.RING_N).lwe.Q
    out = cs.ring4096_kernels(rng, q1, q2, Q, peak)
    out["rns_N2048"] = cs.rns_case(rng, q1, q2, peak, cs.FUNC_BATCH, cs.LWE_N_ACC, 4,
                                   rows=[0])
    out["gate_N1024"] = cs.gate_rows_case(rng, from_param_set(ParamSet.STD128).lwe.Q, peak,
                                          cs.GATE_BATCH, 512, 1024, 8, 1 << 7, 0, [0])
    cases = cs.rotate64_cases()
    for name in ("N=4096, Q54, base 2^18", "N=4096, Q54, base 2^27"):
        cs.rotate64_case(rng, peak, name, *cases[name], 64, 16)
    for name in ("Q54, base 2^18", "Q54, base 2^27"):
        out[f"r64_N2048, {name}"] = cs.rotate64_case(rng, peak, name, *cases[name],
                                                     cs.SIGN64_BATCH, cs.LWE_N_ACC, [0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
