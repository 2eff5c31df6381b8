#!/usr/bin/env python3
"""Where the time of the port's device CKKS multiplication goes, on one GPU.

    python3 scripts/torch_profile_ckks.py

The cell: bench.py's run_ckks configuration (`chip_smoke.ckks_contexts`:
N = 4096, L = 8 limbs of 28 bits, dnum = 3, 28-bit special limbs),
`CKKSDeviceContext.eval_mult` (tensor product, hybrid key-switch
relinearization, rescale) at batch 8 and 64. For each batch: a first call
checked by decryption, three warm host-clock timings (each ends in a
synchronize), then one warm call under `torch.profiler`. The limb-stacked
NTT's transforms (`NTTL.forward`/`inverse`) and the fast base conversions
(`_make_fbc`'s closures) are wrapped in `record_function` ranges for this
run only, so the device time of the kernels launched under each is read
off the trace; the rest (tensor product, key inner product, ModDown and
rescale arithmetic, gathers) is the elementwise remainder. Prints one JSON
line per batch: the warm walls, the profiled wall, device busy (kernel
self time on the one stream), the idle share 1 - busy / profiled wall, the
kernel launches, the device seconds and shares of the NTT, the FBC and the
remainder, and the top kernels by name; the profiler's table goes to
`chiprun_out/profile_ckks_B<batch>.txt`. Imports no jax.

    python3 scripts/torch_profile_ckks.py --boot

profiles the FFT-factored device bootstrap instead, at bench.py's
run_ckksboot width (`chip_smoke.ckksboot_contexts`: N = 1024, L = 18 limbs
of 30 bits, budget (2, 2), Chebyshev degree 44, 31 Galois keys) on batch
8: a first call checked by decryption, three warm host-clock timings, then
one warm call under `torch.profiler` with a `record_function` range around
each stage of `CKKSBootstrapFFTDevice.stages` (ModRaise with the upload,
CoeffsToSlots, EvalMod, SlotsToCoeffs, the download), opened for this run
only. Prints one JSON line: the walls, device busy and idle share, the
kernel launches, each stage's device seconds and host wall, and the host
seconds spent in ModRaise and in plaintext encoding (first call and warm
call); the table goes to `chiprun_out/profile_ckksboot_B8.txt`.

    python3 scripts/torch_profile_ckks.py --bfv

profiles BFV `eval_mult` instead, under HPS (`BFVDeviceContext`) and BEHZ
(`BFVBehzDeviceContext`), at `chip_smoke.py`'s bfv cell
(`chip_smoke.bfv_contexts`: simple-integers.cpp's t = 65537, depth 2,
N = 4096, four 28-bit limbs, dnum 2) at batch 8 and 64, the squares
checked by decryption, with a third range, `bfv::baseconv`, around the
BFV base conversions (HPS: the expansions Q -> R and R -> Q and the t/Q
scale-and-round; BEHZ: the lift into Bsk, the floor and the
Shenoy-Kumaresan conversion). One JSON line per technique and batch, as
above; the tables go to `chiprun_out/profile_bfv_<technique>_B<batch>.txt`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from tfhe_tpu_torch.ops import nttl  # noqa: E402
from tfhe_tpu_torch.pke import bfv_behz_device, bfv_device, ckks_device  # noqa: E402

OUT_DIR = "chiprun_out"
RANGES = ("ckks::ntt", "ckks::fbc")
BFV_RANGES = RANGES + ("bfv::baseconv",)


def annotated(name: str, fn):
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def annotate_layers() -> None:
    """Open a profiler range around every NTT and every FBC. Must run before
    the first `build_*` call: those are cached with their closures."""
    cls = nttl.NTTL.__wrapped__            # the class under its lru_cache
    cls.forward = annotated(RANGES[0], cls.forward)
    cls.inverse = annotated(RANGES[0], cls.inverse)
    make_fbc = ckks_device._make_fbc
    ckks_device._make_fbc = lambda *args: annotated(RANGES[1], make_fbc(*args))


def annotate_bfv() -> None:
    """`annotate_layers`, and a range around every BFV base conversion
    (before the first `build_bfv*_mult` call, for the same reason)."""
    annotate_layers()
    for mod, names in ((bfv_device, ("_make_expand", "_make_scale_round")),
                       (bfv_behz_device, ("_make_lift_bsk", "_make_floor", "_make_conv_sk"))):
        for name in names:
            make = getattr(mod, name)
            setattr(mod, name, lambda *args, _make=make: annotated(BFV_RANGES[2], _make(*args)))


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def measure(B: int, fn, card: str, cell: str = "ckks_mult", ranges=RANGES) -> None:
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # the ranges also appear on the device's timeline, as spans that hold
    # kernels and the gaps between them: they are no kernels of their own
    kernels = {e.key: (device_us(e) / 1e6, e.count) for e in avgs
               if e.device_type.name == "CUDA" and device_us(e) > 0
               and e.key not in ranges}
    busy = sum(s for s, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    # device time of the kernels launched under each range, from the CPU-side
    # range events (the ranges do not nest in each other)
    layer = {name: sum(e.device_time_total for e in prof.events()
                       if e.name == name and e.device_type.name == "CPU") / 1e6
             for name in ranges}
    rest = busy - sum(layer.values())
    with open(os.path.join(OUT_DIR, f"profile_{cell.removesuffix('_mult')}_B{B}.txt"), "w") as f:
        f.write(f"{card}\n{cell} B={B}, profiled wall {prof_wall:.6f} s\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(json.dumps({
        "cell": f"{cell}_B{B}", "wall_s": walls, "ms_per_ctx": min(walls) / B * 1e3,
        "profiled_wall_s": prof_wall, "device_busy_s": busy,
        "idle_share": 1 - busy / prof_wall, "kernel_launches": launches,
        **{f"{name.split('::')[1]}_s": v for name, v in layer.items()}, "rest_s": rest,
        **{f"{name.split('::')[1]}_share": v / busy for name, v in layer.items()},
        "rest_share": rest / busy,
        "top_kernels_s": {k[:80]: v[0] for k, v in top}, "card": card}), flush=True)


BOOT_RANGES = ("boot::mod_raise", "boot::coeffs_to_slots", "boot::eval_mod",
               "boot::slots_to_coeffs", "boot::download")


class HostClock:
    """Host seconds spent in `module.name` while installed (the function
    wrapped with a timer; `seconds` summed over calls, reset by the
    caller)."""

    def __init__(self, module, name: str):
        self.seconds = 0.0
        orig = getattr(module, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(module, name, timed)


def boot_stage_range(name: str) -> str:
    if name == "raise":
        return BOOT_RANGES[0]
    if name.startswith("cts") or name == "partial_sum":
        return BOOT_RANGES[1]
    return BOOT_RANGES[2] if name == "eval_mod" else BOOT_RANGES[3]


def boot_call(bd, cts):
    """One bootstrap_batch, stage by stage, each stage in its range."""
    pre = bd.pre
    names = ["raise"] + (["partial_sum"] if pre.sparse_slots < bd.params.slots else []) \
        + [f"cts{i}" for i in range(len(pre.cts_groups))] + ["eval_mod"] \
        + [f"stc{i}" for i in range(len(pre.stc_groups))]
    stages = bd.stages(cts)
    for name in names:
        with record_function(boot_stage_range(name)):
            got, out = next(stages)
        assert got == name, (got, name)
    with record_function(BOOT_RANGES[4]):
        return bd.dctx.download_batch(out)


def profile_boot(card: str) -> None:
    from tfhe_tpu_torch.pke import ckks_boot_device, ckks_boot_fft_device

    raise_clock = HostClock(ckks_boot_device, "mod_raise")
    encode_clocks = [HostClock(ckks_boot_device, "encode"),
                     HostClock(ckks_boot_fft_device, "encode")]
    ctx, sk, pk, bd = chip_smoke.ckksboot_contexts()
    rng = np.random.default_rng(5)
    B = chip_smoke.BOOT_BATCH
    zs = [rng.uniform(-0.04, 0.04, ctx.params.slots) for _ in range(B)]
    cts = [chip_smoke.exhausted(ctx, pk, z) for z in zs]

    def host_s():
        return raise_clock.seconds, sum(c.seconds for c in encode_clocks)

    t0 = time.perf_counter()
    fresh = boot_call(bd, cts)
    first_wall = time.perf_counter() - t0
    first_raise, first_encode = host_s()
    err = max(np.abs(ctx.decrypt(sk, f).real - z).max() for f, z in zip(fresh, zs))
    if err >= 2e-2:
        raise SystemExit(f"wrong CKKS bootstrap: error {err}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        boot_call(bd, cts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    r0, e0 = host_s()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        boot_call(bd, cts)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    r1, e1 = host_s()
    avgs = prof.key_averages()
    kernels = {e.key: (device_us(e) / 1e6, e.count) for e in avgs
               if e.device_type.name == "CUDA" and device_us(e) > 0
               and e.key not in BOOT_RANGES}
    busy = sum(v for v, _ in kernels.values())
    launches = sum(n for _, n in kernels.values())
    ranges = [e for e in prof.events()
              if e.name in BOOT_RANGES and e.device_type.name == "CPU"]
    stage_dev = {n: sum(e.device_time_total for e in ranges if e.name == n) / 1e6
                 for n in BOOT_RANGES}
    stage_host = {n: sum(e.cpu_time_total for e in ranges if e.name == n) / 1e6
                  for n in BOOT_RANGES}
    with open(os.path.join(OUT_DIR, f"profile_ckksboot_B{B}.txt"), "w") as f:
        f.write(f"{card}\nbootstrap_batch B={B}, profiled wall {prof_wall:.6f} s\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    print(json.dumps({
        "cell": f"ckksboot_B{B}", "N": ctx.params.N, "L": ctx.params.dcrt.L,
        "max_err": float(err), "first_wall_s": first_wall, "wall_s": walls,
        "ms_per_ctx": min(walls) / B * 1e3, "profiled_wall_s": prof_wall,
        "device_busy_s": busy, "idle_share": 1 - busy / prof_wall,
        "kernel_launches": launches,
        "stage_device_s": stage_dev, "stage_host_wall_s": stage_host,
        "mod_raise_host_s": {"first": first_raise, "profiled": r1 - r0},
        "encode_host_s": {"first": first_encode, "profiled": e1 - e0},
        "top_kernels_s": {k[:80]: v[0] for k, v in top}, "card": card}), flush=True)


def profile_bfv(card: str) -> None:
    annotate_bfv()
    rng = np.random.default_rng(chip_smoke.BFV_SEED)
    ctxs = chip_smoke.bfv_contexts()
    hps = ctxs["hps"]
    p = hps.params
    sk, pk = hps.key_gen()
    vs = [rng.integers(0, p.t, p.N) for _ in range(max(chip_smoke.BFV_BATCHES))]
    cts = [hps.encrypt_packed(pk, v) for v in vs]
    for mt, ctx in ctxs.items():
        cls = bfv_device.BFVDeviceContext if mt == "hps" else bfv_behz_device.BFVBehzDeviceContext
        dctx = cls(ctx)
        dctx.load_relin_key(ctx.relin_key_gen(sk))
        for B in chip_smoke.BFV_BATCHES:
            d = dctx.upload_batch(cts[:B])
            outs = dctx.download_batch(dctx.eval_mult(d, d))
            if not all(np.array_equal(ctx.decrypt_packed(sk, o), vs[b] * vs[b] % p.t)
                       for b, o in enumerate(outs)):
                raise SystemExit(f"wrong BFV {mt} square at B={B}")
            measure(B, lambda: dctx.eval_mult(d, d), card, f"bfv_{mt}_mult", BFV_RANGES)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    if "--boot" in sys.argv[1:]:
        profile_boot(card)
        return
    if "--bfv" in sys.argv[1:]:
        profile_bfv(card)
        return
    annotate_layers()
    rng = np.random.default_rng(chip_smoke.SEED)
    ctx, _, dctx, sk, pk, _, _ = chip_smoke.ckks_contexts()
    zs = [rng.uniform(0.1, 0.9, ctx.params.slots) for _ in range(max(chip_smoke.CKKS_BATCHES))]
    cts = [ctx.encrypt(pk, z) for z in zs]
    for B in chip_smoke.CKKS_BATCHES:
        d = dctx.upload_batch(cts[:B])
        outs = dctx.download_batch(dctx.eval_mult(d, d))
        err = max(np.abs(ctx.decrypt(sk, o) - zs[b] ** 2).max() for b, o in enumerate(outs))
        if err >= 1e-3:
            raise SystemExit(f"wrong CKKS product at B={B}: error {err}")
        measure(B, lambda: dctx.eval_mult(d, d), card)


if __name__ == "__main__":
    main()
