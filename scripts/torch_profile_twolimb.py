#!/usr/bin/env python3
"""Where the time of the port's two-limb bootstraps goes, on one GPU.

    python3 scripts/torch_profile_twolimb.py [--nand-batch B] [--sign-batch B]
    python3 scripts/torch_profile_twolimb.py --kernel-only

Two phases, each with host keygen, `device_setup("cuda")`, a first call
checked by decryption, one warm host-clock call, then one call under
`torch.profiler` whose per-kernel device times go to
`chiprun_out/profile_twolimb_<phase>_<B>.txt`:
- `nand`: STD128Q NAND at batch B (default 4096; N = 2048, n = 1024, Q of
  50 bits, qKS = 2^25);
- `sign`: EvalSign at the STD128 accelerated set with the reference's
  single 54-bit prime (rns_modulus=False, logQ 17, bases {2^18, 2^27},
  one digit thrown) at batch B (default 1024).
Both calls of a phase also clock the host functions of the two-limb route
(host clock, summed over the call's bootstraps): the scheme's test
polynomials (`_gate_test_poly`/`_func_test_poly`, Python ints for Q >=
2^31), `_acc_init`, the backend's `split_batch` (object array -> int64,
upload; `host_acc_s`) and `TorchBackend.bootstrap_pipeline` as a whole
(which waits for the device: the rotation, extract, key switch and the
download). Prints one JSON line per phase: walls, the host clocks, device
busy seconds (kernel self time on the one stream), the idle share 1 - busy
/ profiled wall, and the device time of the rotation (`blind_rotate64`),
the key switch's row sums (`embedding_bag`), the copies between host and
device and the rest.

With `--kernel-only` (a few minutes): builds `csrc/blind_rotate64.cu` and
prints what ptxas says of its registers and spills; counts the SASS
instructions of one 64-bit lazy Shoup product, of one key value rebuilt
from its companion (hi64((b' + 1) Q)) and, as a yardstick, of one 32-bit
Shoup product (`cuobjdump -sass` of chains of 8 and 16 of each, compiled
from `csrc/register_ntt64.cuh`; the difference over 8), and writes the
kernel's SASS and its opcode counts to `chiprun_out/blind_rotate64.sass`;
then runs `chip_smoke.rotate64_kernel_vs_plain`: the kernel held to its
plain version (`torch.equal`) in every case of `chip_smoke.rotate64_cases`
below N = 8192 (B = 64, n = 16; N = 4096 among them; the N = 8192 cases
run in `scripts/torch_check_ring4096.py --ring 8192 --r64-only`), and at
the main paths' shapes
(STD128Q B = 4096, n = 1024; the 54-bit prime B = 1024, n = 1305, d2 = 4
and 2; on 33 rows), each timed with CUDA events against
`chip_smoke.bound`, on random keys, without keygen. Prints one JSON line.
Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet, TorchBackend, scheme  # noqa: E402
from tfhe_tpu_torch.ops import backend as backend_mod  # noqa: E402

OUT = "chiprun_out"
SEED = 20261016
HOST_FUNCS = ((scheme, "_gate_test_poly"), (scheme, "_func_test_poly"),
              (scheme, "_acc_init"), (backend_mod, "split_batch"),
              (TorchBackend, "bootstrap_pipeline"))


def device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


class HostClocks:
    """Host seconds spent in each of HOST_FUNCS while entered."""

    def __enter__(self):
        self.secs = {name: 0.0 for _, name in HOST_FUNCS}
        self.orig = [(owner, name, getattr(owner, name)) for owner, name in HOST_FUNCS]
        for owner, name, fn in self.orig:
            setattr(owner, name, self._clocked(name, fn))
        return self

    def _clocked(self, name, fn):
        def clocked(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.secs[name] += time.perf_counter() - t0
        return clocked

    def __exit__(self, *exc):
        for owner, name, fn in self.orig:
            setattr(owner, name, fn)


def nand_phase(B: int):
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.STD128Q)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    rng = np.random.default_rng(1)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    return cc, (lambda: cc.eval_bin_gate(Gate.NAND, ct1, ct2),
                lambda out: np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)))


def sign_phase(B: int):
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.STD128, arb_func=False, log_q=17,
                               num_digits_to_throw=1, time_optimization=True,
                               rns_modulus=False)
    sk = cc.key_gen()
    cc.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    Q_enc = 1 << 17
    P = cc.get_max_plaintext_space() * (Q_enc // cc.params.lwe.q)
    delta = np.random.default_rng(3).integers(-3, 4, B)
    ct = cc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    return cc, (lambda: cc.eval_sign(ct),
                lambda out: np.array_equal(cc.decrypt(sk, out, 2),
                                           (delta >= 0).astype(np.uint64)))


def run_phase(phase: str, B: int, card: str) -> None:
    t0 = time.time()
    cc, (call, ok) = (nand_phase if phase == "nand" else sign_phase)(B)
    keygen_s = time.time() - t0
    t0 = time.time()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    if not ok(call()):
        raise SystemExit(f"{phase} at batch {B} decrypted wrong")

    with HostClocks() as warm:
        t0 = time.perf_counter()
        call()
        wall = time.perf_counter() - t0
    with HostClocks() as clocks, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = {e.key: device_us(e) / 1e6 for e in avgs
               if e.device_type.name == "CUDA" and device_us(e) > 0}
    busy = sum(kernels.values())
    rot = sum(v for k, v in kernels.items() if "blind_rotate64" in k)
    ks = sum(v for k, v in kernels.items() if "EmbeddingBag" in k)
    copies = sum(v for k, v in kernels.items() if k.startswith("Memcpy"))
    with open(os.path.join(OUT, f"profile_twolimb_{phase}_{B}.txt"), "w") as f:
        f.write(f"{card}\n{phase} batch {B}, profiled wall {prof_wall:.6f} s\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))

    def host(secs, total):
        test_poly = secs["_gate_test_poly"] + secs["_func_test_poly"]
        pipeline = secs["bootstrap_pipeline"]
        return {"test_poly_s": test_poly, "acc_init_s": secs["_acc_init"],
                "host_acc_s": secs["split_batch"],
                "pipeline_after_host_acc_s": pipeline - secs["split_batch"],
                "outside_pipeline_s": total - pipeline - test_poly - secs["_acc_init"]}

    print(json.dumps({
        "phase": phase, "batch": B, "card": card, "keygen_s": keygen_s,
        "device_setup_s": setup_s, "wall_s": wall, "per_s": B / wall,
        "host_clocks_warm": host(warm.secs, wall),
        "profiled_wall_s": prof_wall, "host_clocks_profiled": host(clocks.secs, prof_wall),
        "device_busy_s": busy, "idle_share": 1 - busy / prof_wall,
        "rotation_s": rot, "ks_row_sums_s": ks, "copies_s": copies,
        "other_device_s": busy - rot - ks - copies,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    cc.device_clean()
    del cc
    torch.cuda.empty_cache()


PROBE = r"""
#include <cuda_runtime.h>
#include "register_ntt64.cuh"
using rntt64::u64;
template <int K> __global__ void shoup64(u64* o, u64 w, u64 ws, u64 q) {
  u64 x = o[threadIdx.x];
#pragma unroll
  for (int i = 0; i < K; ++i) x = rntt64::mulmod_lazy(x, w, ws, q);
  o[threadIdx.x] = x;
}
template <int K> __global__ void rebuild64(u64* o, u64 q) {
  u64 x = o[threadIdx.x];
#pragma unroll
  for (int i = 0; i < K; ++i) x = __umul64hi(x + 1, q);
  o[threadIdx.x] = x;
}
template <int K> __global__ void shoup32(uint32_t* o, uint32_t w, uint32_t ws, uint32_t q) {
  uint32_t x = o[threadIdx.x];
#pragma unroll
  for (int i = 0; i < K; ++i) x = rntt::mulmod_lazy(x, w, ws, q);
  o[threadIdx.x] = x;
}
template __global__ void shoup64<8>(u64*, u64, u64, u64);
template __global__ void shoup64<16>(u64*, u64, u64, u64);
template __global__ void rebuild64<8>(u64*, u64);
template __global__ void rebuild64<16>(u64*, u64);
template __global__ void shoup32<8>(uint32_t*, uint32_t, uint32_t, uint32_t);
template __global__ void shoup32<16>(uint32_t*, uint32_t, uint32_t, uint32_t);
"""
# IMAD forms that multiply (IMAD.MOV, .IADD and .SHL are moves, adds, shifts)
MULTIPLY = re.compile(r"^IMAD(\.WIDE|\.HI|\.X|\.U32|$)")


def sass_opcodes(path: str) -> dict[str, collections.Counter]:
    """Opcode counts (NOPs left out) of each kernel in the cubin or shared
    library at `path`, by `cuobjdump -sass`."""
    from tfhe_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name and not m.group(1).startswith("NOP"):
            out[name][m.group(1)] += 1
    return out


def probe_costs() -> dict:
    """SASS instructions (and multiplies among them) per 64-bit lazy Shoup
    product, per key value rebuilt from its companion, and per 32-bit lazy
    Shoup product: (chain of 16 - chain of 8) / 8, each op on the result of
    the one before."""
    from tfhe_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "probe64.cu")
    cubin = os.path.join(_build.BUILD_DIR, "probe64.cubin")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", _build._CSRC, "-o", cubin, src], check=True)
    ops = sass_opcodes(cubin)
    costs = {}
    for probe in ("shoup64", "rebuild64", "shoup32"):
        count = {k: next(c for n, c in ops.items() if probe in n and f"ILi{k}E" in n)
                 for k in (8, 16)}
        diff = count[16] - count[8]
        costs[probe] = {
            "instructions": sum(diff.values()) / 8,
            "multiplies": sum(v for op, v in diff.items() if MULTIPLY.match(op)) / 8,
            "by_opcode": {op: v / 8 for op, v in sorted(diff.items())}}
    return costs


def kernel_only(card: str) -> None:
    """Build, count, check and time blind_rotate64 alone (see the module
    doc)."""
    import chip_smoke
    from tfhe_tpu_torch.ops import _build

    t0 = time.time()
    _build.build(("blind_rotate64",))
    ptxas = _build.ptxas_report("blind_rotate64")
    for ln in ptxas:
        print(f"ptxas: {ln}", flush=True)
    rec = {"phase": "rotate64_kernel", "card": card, "build_s": time.time() - t0,
           "ptxas": ptxas}
    rng = np.random.default_rng(chip_smoke.SEED)
    line, rec["shapes"] = chip_smoke.rotate64_kernel_vs_plain(
        rng, chip_smoke.int32_peak_per_s())
    rec.update(line)
    rec["share"] = rec["bound_ms"] / rec["ms"]
    print(json.dumps(rec), flush=True)

    kernels = sass_opcodes(_build._lib_path("blind_rotate64"))
    with open(os.path.join(OUT, "blind_rotate64.sass"), "w") as f:
        for name, ops in kernels.items():
            mult = sum(v for op, v in ops.items() if MULTIPLY.match(op))
            f.write(f"{name}: {sum(ops.values())} instructions, {mult} multiplies\n")
            for op, v in ops.most_common():
                f.write(f"  {op} {v}\n")
    print(json.dumps({"sass_per_op": probe_costs(), "sass_instructions": {
        name: sum(ops.values()) for name, ops in kernels.items()}}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nand-batch", type=int, default=4096)
    ap.add_argument("--sign-batch", type=int, default=1024)
    ap.add_argument("--kernel-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    os.makedirs(OUT, exist_ok=True)
    if args.kernel_only:
        return kernel_only(card)
    run_phase("nand", args.nand_batch, card)
    run_phase("sign", args.sign_batch, card)


if __name__ == "__main__":
    main()
