#!/usr/bin/env python3
"""Where the time of the port's accelerated EvalSign goes, on one GPU, and
the key switch's row sums against one alternative.

    python3 scripts/torch_profile_rns.py [--ks-only [--gate]] [--batch B]
    python3 scripts/torch_profile_rns.py --kernel-only [--ncu]

Without `--ks-only`: host keygen of the STD128 accelerated sign context
(logQ 17, time optimization with bases {2^18, 2^27}, numDigitsToThrow 1),
`device_setup("cuda")`, one EvalSign at batch B (default 4096) checked by
decryption, two warm host-clock runs, then one run under `torch.profiler`
whose per-kernel device times go to `chiprun_out/profile_sign_<B>.txt`.
Prints one JSON line: keygen and setup seconds, warm walls, device busy
seconds, idle share and the device time of the rotation kernel, the key
switch's row sums (the `embedding_bag` kernel), the copies between host
and device, and the rest (the chain glue).

Then, on the switching-key table the run holds (with `--ks-only`, a random
table of valid values: the accelerated shape, 458752 rows of 1305 + 1
values below 2^35, or with `--gate` the STD128 gate shape, 262144 rows of
512 + 1 values below 2^14), it times the sums of the selected rows at batch
B two ways with CUDA events: the port's `keyswitch.row_sums`
(`embedding_bag(mode="sum")` over the float64 table, exact because every
partial sum is an integer below 2^53), and the rows gathered from an
integer copy of the table (int32 at the gate shape, int64 above), then
summed, in 256 MB chunks of rows. Prints one JSON line with both times and
whether the sums agree.

With `--kernel-only` (about a minute): builds `csrc/blind_rotate_rns.cu`,
prints what ptxas says of its registers and spills, holds the kernel to its
plain version (`torch.equal`) at B = 64, n = 16 for d2 = 2 and 4 (N = 2048,
the accelerated primes, throw 1), then times it with CUDA events at B = 256
and at B = 4096, n = 1305, d2 = 4 on a key of valid Shoup companions of
random values, without keygen, against the bound `chip_smoke.py` computes.
Prints one JSON line. With `--ncu`, when the toolkit has `ncu`, profiles
the B = 256 launch (occupancy, shared-memory bank conflicts, warp stall
reasons) into `chiprun_out/ncu_rns.txt`, and says so when it has none.
Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfhe_tpu_torch import (BinFHEContext, ParamSet, from_gpu_style,  # noqa: E402
                            from_param_set)
from tfhe_tpu_torch.ops import keyswitch  # noqa: E402
from tfhe_tpu_torch.ops.modmath import round_q_Q  # noqa: E402

OUT = "chiprun_out"


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sign_profile(B: int, card: str):
    """Returns the context's params and its device switching-key table."""
    t0 = time.time()
    cc = BinFHEContext(seed=20261016)
    cc.generate_binfhe_context(ParamSet.STD128, arb_func=False, log_q=17,
                               num_digits_to_throw=1, time_optimization=True)
    sk = cc.key_gen()
    cc.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    keygen_s = time.time() - t0
    t0 = time.time()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    Q_enc = 1 << 17
    P = cc.get_max_plaintext_space() * (Q_enc // cc.params.lwe.q)
    delta = np.random.default_rng(3).integers(-3, 4, B)
    ct = cc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    out = cc.eval_sign(ct)
    if not np.array_equal(cc.decrypt(sk, out, 2), (delta >= 0).astype(np.uint64)):
        raise SystemExit("EvalSign decrypted wrong")
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        cc.eval_sign(ct)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cc.eval_sign(ct)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = {e.key: device_us(e) / 1e6 for e in avgs
               if e.device_type.name == "CUDA" and device_us(e) > 0}
    busy = sum(kernels.values())
    rot = sum(v for k, v in kernels.items() if "blind_rotate_rns" in k)
    ks = sum(v for k, v in kernels.items() if "EmbeddingBag" in k)
    copies = sum(v for k, v in kernels.items() if k.startswith("Memcpy"))
    with open(os.path.join(OUT, f"profile_sign_{B}.txt"), "w") as f:
        f.write(f"{card}\nEvalSign batch {B}, profiled wall {prof_wall:.6f} s\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    print(json.dumps({
        "phase": "sign", "batch": B, "card": card, "keygen_s": keygen_s,
        "device_setup_s": setup_s, "wall_s": walls,
        "ms_per_ct": [w / B * 1e3 for w in walls], "ops_per_s": [B / w for w in walls],
        "profiled_wall_s": prof_wall, "device_busy_s": busy,
        "idle_share": 1 - busy / prof_wall, "rotation_s": rot,
        "ks_row_sums_s": ks, "copies_s": copies,
        "glue_s": busy - rot - ks - copies,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return cc.params, cc.backend._device_key(cc.params, cc.bt_key)["ksk"]


def gather_sums(table: torch.Tensor, rows: torch.Tensor, q_ks: int) -> torch.Tensor:
    """The selected rows of an integer table gathered and summed, 256 MB of
    rows at a time, [B, n + 1] int64 mod qKS: the alternative to
    `embedding_bag`, exact in the table's dtype wherever it cannot overflow."""
    B, R = rows.shape
    sum_dtype = torch.int32 if R * (q_ks - 1) < (1 << 31) else torch.int64
    chunk = max(1, (1 << 28) // (R * table.shape[1] * table.element_size()))
    return torch.cat([table[rows[i:i + chunk]].sum(dim=1, dtype=sum_dtype)
                      for i in range(0, B, chunk)]).to(torch.int64) % q_ks


def ks_compare(params, table: torch.Tensor, B: int, card: str) -> None:
    p = params.lwe
    rng = np.random.default_rng(4)
    a_ext = torch.from_numpy(rng.integers(0, p.Q, (B, p.N))).cuda()
    rows = keyswitch.key_rows(round_q_Q(a_ext, p.q_ks, p.Q), p.N, p.base_ks,
                              p.digit_count_ks)
    table_int = table.to(torch.int32 if p.q_ks <= (1 << 31) else torch.int64)
    gather_sum = lambda: gather_sums(table_int, rows, p.q_ks)  # noqa: E731
    bag = lambda: keyswitch.row_sums(table, rows, p.q_ks)  # noqa: E731
    want, got = gather_sum(), bag()
    torch.cuda.synchronize()
    agree = torch.equal(want, got)
    ms_gather = cuda_ms(gather_sum, 3)
    ms_bag = cuda_ms(bag, 3)
    print(json.dumps({
        "phase": "ks", "batch": B, "card": card, "table_shape": list(table.shape),
        "q_ks": p.q_ks, "gather_sum_ms": ms_gather, "embedding_bag_f64_ms": ms_bag,
        "sums_equal": bool(agree),
        "rows_bytes_per_ct": rows.shape[1] * table.shape[1] * table_int.element_size()}),
        flush=True)
    if not agree:
        raise SystemExit("the two row sums differ")


def rns_inputs(B: int, n: int, d2: int, q1: int, q2: int, N: int = 2048, seed: int = 5):
    """Accumulators of residues, exponents and a key of valid Shoup
    companions of random values (pack_bsk_rns's layout), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc = [torch.randint(0, qi, (B, 2, N), device="cuda", generator=g).to(torch.int32)
           for qi in (q1, q2)]
    a_idx = torch.randint(0, 2 * N, (B, n), device="cuda", generator=g).to(torch.int32)
    key = torch.empty((n, 8 * d2, N), dtype=torch.int64, device="cuda")
    for lane, qi in enumerate((q1, q2)):
        rows = slice(lane * 4 * d2, (lane + 1) * 4 * d2)
        key[:, rows] = (torch.randint(0, qi, (n, 4 * d2, N), device="cuda",
                                      generator=g) << 32) // qi
    key = torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32)
    return acc, a_idx, key


def kernel_only(card: str, ncu: bool) -> None:
    """Build, check and time blind_rotate_rns alone (see the module doc)."""
    import shutil

    import chip_smoke
    from tfhe_tpu_torch.ops import _build, blindrotate_rns, rotate_rns_kernel

    t0 = time.time()
    _build.build(("blind_rotate_rns",))
    ptxas = _build.ptxas_report("blind_rotate_rns")
    for ln in ptxas:
        print(f"ptxas: {ln}", flush=True)
    build_s = time.time() - t0
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12).rgsw.rns_primes
    peak = chip_smoke.int32_peak_per_s()
    rec = {"phase": "rns_kernel", "card": card, "build_s": build_s, "ptxas": ptxas}
    for d2 in (2, 4):
        base_g = 1 << 18 if d2 == 4 else 1 << 27
        acc, a_idx, key = rns_inputs(64, 16, d2, q1, q2)
        got = rotate_rns_kernel.rotate_rns(*acc, a_idx, key, q1, q2, base_g, 1)
        want = blindrotate_rns.blind_rotate_rns(*acc, a_idx, key, q1, q2, base_g, 1)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        rec[f"equal_B64_n16_d2_{d2}"] = ok
        print(f"blind_rotate_rns == plain at B=64 n=16 d2={d2}: {ok}", flush=True)
        if not ok:
            print(json.dumps(rec), flush=True)
            raise SystemExit("the kernel differs from its plain version")
    for B in (256, 4096):
        acc, a_idx, key = rns_inputs(B, 1305, 4, q1, q2)
        run = lambda: rotate_rns_kernel.rotate_rns(*acc, a_idx, key, q1, q2, 1 << 18, 1)  # noqa: E731
        run()
        ms = cuda_ms(run, 2)
        b_ms, b_by = chip_smoke.bound(B, 1305, 2048, 4, 2, peak)
        rec[f"B{B}"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms}
        print(f"blind_rotate_rns B={B} n=1305 d2=4: {ms:.3f} ms, bound {b_ms:.3f} ms "
              f"by {b_by}, {100 * b_ms / ms:.1f}% of it on {card}", flush=True)
    if ncu:
        tool = shutil.which("ncu") or ("/usr/local/cuda/bin/ncu"
                                       if os.path.exists("/usr/local/cuda/bin/ncu") else None)
        rec["ncu"] = tool
        if tool is None:
            print("ncu: the toolkit has none", flush=True)
        else:
            cmd = [tool, "--section", "Occupancy", "--section", "WarpStateStats",
                   "--section", "MemoryWorkloadAnalysis_Tables", "-k",
                   "regex:blind_rotate_rns", "-c", "1", sys.executable,
                   os.path.abspath(__file__), "--ncu-child"]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
                text = res.stdout + res.stderr
                rec["ncu_rc"] = res.returncode
            except subprocess.TimeoutExpired:
                text, rec["ncu_rc"] = "ncu timed out after 300 s", None
            with open(os.path.join(OUT, "ncu_rns.txt"), "w") as f:
                f.write(f"{card}\n{' '.join(cmd)}\n{text}")
            print(f"ncu rc {rec['ncu_rc']}; output in {OUT}/ncu_rns.txt", flush=True)
    print(json.dumps(rec), flush=True)


def ncu_child() -> None:
    """One B = 256 launch for ncu to profile."""
    from tfhe_tpu_torch.ops import rotate_rns_kernel

    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12).rgsw.rns_primes
    acc, a_idx, key = rns_inputs(256, 1305, 4, q1, q2)
    rotate_rns_kernel.rotate_rns(*acc, a_idx, key, q1, q2, 1 << 18, 1)
    torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel-only", action="store_true")
    ap.add_argument("--ncu", action="store_true")
    ap.add_argument("--ncu-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--ks-only", action="store_true")
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    if args.ncu_child:
        return ncu_child()
    if args.kernel_only:
        return kernel_only(card, args.ncu)
    if args.ks_only:
        params = (from_param_set(ParamSet.STD128) if args.gate else
                  from_gpu_style(ParamSet.STD128, False, 17, num_digits_to_throw=1))
        p = params.lwe
        R = p.N * p.base_ks * p.digit_count_ks
        table = torch.randint(0, p.q_ks, (R, p.n + 1), dtype=torch.int64,
                              device="cuda").to(torch.float64)
    else:
        params, table = sign_profile(args.batch, card)
    ks_compare(params, table, args.batch, card)


if __name__ == "__main__":
    main()
