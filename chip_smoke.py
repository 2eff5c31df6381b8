#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds both hand-written kernels from `tfhe_tpu_torch/csrc` (one nvcc per
source, in parallel, into `tfhe_tpu_torch/_build/`) and holds each bit for
bit against its plain torch version on the card, timed, at the shapes its
main path gives it. Then it drives the port's two paths through
`tfhe_tpu_torch.BinFHEContext`:
- the gate path: all eight gates at TOY against the host oracle, and a
  batch-4096 STD128 NAND checked by decryption and, for its first 8
  outputs, bit for bit against the oracle;
- the RNS functional path: EvalFunc, EvalSign and EvalDecomp on the
  accelerated TOY sets bit for bit against the oracle, then at full width
  on the STD128 accelerated sets (N = 2048, n = 1305, Q = q1*q2 of 54 bits,
  qKS = 2^35) at batch 4096, checked by decryption.
Each path runs with the kernels' launch counts set to 0 just before it and
read just after. At the end no jax or JAX-package module may be loaded.
Exits non-zero on any failure. The line before the last is a JSON record
of the kernels; the last line is the JSON result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 20261016
GATE_BATCH = 4096
FUNC_BATCH = 4096
LWE_N_ACC = 1305           # rounds of the accelerated sets' rotation
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
INT32_LANES_PER_SM = 64     # 32-bit integer multiply lanes per SM per clock


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


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events): one run, no warm-up."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def int32_peak_per_s() -> float:
    """The card's 32-bit integer multiply rate: SMs x 64 lanes x the maximum
    SM clock that nvidia-smi reports."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"int32 multiply peak: {sms} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz")
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def shoup_products(N: int, digits: int) -> int:
    """Lazy Shoup products that one single-lane round needs: per digit the
    forward NTT of the pair (N log N) and the external product (8N); then
    the inverse NTT of four polynomials (2N log N). The kernels' separate
    twist (2N per digit) and untwist (4N) passes are not counted: a
    negacyclic NTT with merged twiddles, N^-1 folded into the key, needs
    neither."""
    logn = N.bit_length() - 1
    return digits * (N * logn + 8 * N) + 2 * N * logn


def bound(B: int, n: int, N: int, d2: int, lanes: int, peak: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one rotation. Bytes: each
    input and output read or written once, the key as values and Shoup
    companions (the RNS kernel stores companions only and rebuilds the
    values with 2 multiplies each; a layout that stores both needs none of
    them, so they are not counted), over the memory rate. Operations: the
    32-bit multiplies, 3 per Shoup product and 4 per coefficient for the
    CRT of two lanes, over the int32 peak."""
    key_bytes = 4 * n * 8 * d2 * N * (2 if lanes == 2 else 1)
    nbytes = 4 * (2 * lanes * B * 2 * N + B * n + lanes * 8 * N) + key_bytes
    digits = d2 // 2
    per_round = lanes * 3 * shoup_products(N, digits)
    if lanes == 2:
        per_round += 4 * 2 * N
    ops = B * n * per_round
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, want) -> int:
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def gate_kernel_vs_plain(rng, Q: int, peak: float) -> dict:
    """blind_rotate against its plain version on the card, at STD128 shapes
    (N = 1024, d2 = 8, baseG = 2^7), with tolerance 0 (torch.equal: the
    arithmetic is exact and modular), each case timed: B = 64 over 16
    rounds, then the main path's B = GATE_BATCH over all 512 rounds."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate, rotate_kernel

    N, d2, base_g = 1024, 8, 1 << 7
    worst = 0

    def compare(B, n):
        nonlocal worst
        t0 = time.time()
        acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32)).cuda()
        a_idx = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32)).cuda()
        bsk_hat = rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64)
        bsk = rotate_kernel.pack_bsk(bsk_hat, Q).cuda()
        kernel = lambda: rotate_kernel.rotate(acc, a_idx, bsk, Q, base_g)  # noqa: E731
        plain = lambda: blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g)  # noqa: E731
        got = kernel()
        want, plain_ms = timed_once(plain)
        err = max_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"blind_rotate != plain at B={B}, n={n} (max abs err {err})")
        ms = cuda_ms(kernel, reps=3)
        b_ms, b_by = bound(B, n, N, d2, 1, peak)
        log(f"blind_rotate == plain at N={N} d2={d2} B={B} n={n} (torch.equal, "
            f"tolerance 0): max_abs_err {err}; kernel {ms:.3f} ms, plain torch "
            f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by} "
            f"({time.time() - t0:.1f} s)")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}

    compare(64, 16)
    timing = compare(GATE_BATCH, 512)
    return {"max_abs_err": worst, **timing}


def rns_kernel_vs_plain(rng, q1: int, q2: int, peak: float) -> dict:
    """blind_rotate_rns against its plain version on the card at N = 2048 and
    the accelerated sets' q1, q2, throw = 1, with tolerance 0 (torch.equal),
    each case timed: d2 = 4 (base 2^18, EvalSign/EvalDecomp) and d2 = 2
    (base 2^27, EvalFunc) at B = 64 over 16 rounds and at B = 256 over all
    1305 rounds, then the main path's B = FUNC_BATCH, n = 1305 at d2 = 4.
    The key holds valid Shoup companions of random values < qi."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate_rns, rotate_rns_kernel

    N = 2048
    worst = 0

    def compare(B, n, d2):
        nonlocal worst
        t0 = time.time()
        base_g = 1 << 18 if d2 == 4 else 1 << 27
        acc = [torch.from_numpy(rng.integers(0, qi, (B, 2, N)).astype(np.int32)).cuda()
               for qi in (q1, q2)]
        a_idx = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32)).cuda()
        key = torch.empty((n, 8 * d2, N), dtype=torch.int64, device="cuda")
        for lane, qi in enumerate((q1, q2)):
            rows = slice(lane * 4 * d2, (lane + 1) * 4 * d2)
            key[:, rows] = (torch.randint(0, qi, (n, 4 * d2, N), device="cuda") << 32) // qi
        key = torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32)
        kernel = lambda: rotate_rns_kernel.rotate_rns(*acc, a_idx, key, q1, q2, base_g, 1)  # noqa: E731
        plain = lambda: blindrotate_rns.blind_rotate_rns(*acc, a_idx, key, q1, q2, base_g, 1)  # noqa: E731
        got = kernel()
        want, plain_ms = timed_once(plain)
        err = max(max_err(g, w) for g, w in zip(got, want))
        worst = max(worst, err)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"blind_rotate_rns != plain at B={B}, n={n}, d2={d2} (max abs err {err})")
        ms = cuda_ms(kernel, reps=2)
        b_ms, b_by = bound(B, n, N, d2, 2, peak)
        log(f"blind_rotate_rns == plain at N={N} d2={d2} throw=1 B={B} n={n} "
            f"(torch.equal, tolerance 0): max_abs_err {err}; kernel {ms:.3f} ms, "
            f"plain torch {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}, "
            f"kernel at {100 * b_ms / ms:.1f}% of it ({time.time() - t0:.1f} s)")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}

    for d2 in (4, 2):
        compare(64, 16, d2)
        compare(256, LWE_N_ACC, d2)
    timing = compare(FUNC_BATCH, LWE_N_ACC, 4)
    return {"max_abs_err": worst, **timing}


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
    outs = {g: cc.eval_bin_gate(g, ct1, ct2) for g in truth}   # on the card
    check(cc.backend.device.type == "cuda", "the TOY context does not run on the card")
    cc.device_clean()
    for g, want in truth.items():
        ref = cc.eval_bin_gate(g, ct1, ct2)
        check(np.array_equal(cc.decrypt(sk, outs[g]), want), f"TOY {g.name} truth table")
        check(np.array_equal(outs[g].a, ref.a) and np.array_equal(outs[g].b, ref.b),
              f"TOY {g.name} differs from the host oracle")
    log(f"TOY: all 8 gates decrypt right and equal the host oracle bit for bit "
        f"({time.time() - t0:.1f} s)")


def std128_nand(rng, card: str) -> None:
    """The gate path at full width: STD128 NAND at batch 4096."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet

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
    cc.device_clean()
    ref = cc.eval_bin_gate(Gate.NAND, *head)
    log(f"host oracle NAND on 8 ciphertexts {time.time() - t0:.1f} s")

    t0 = time.time()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup (key to eval domain, pack, upload) {time.time() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
    first_s = time.time() - t0
    check(out.a.shape == (GATE_BATCH, cc.params.lwe.n) and out.b.shape == (GATE_BATCH,),
          f"output shapes {out.a.shape}, {out.b.shape}")
    check(np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)), "STD128 NAND decryption")
    check(np.array_equal(out.a[:8], ref.a) and np.array_equal(out.b[:8], ref.b),
          "STD128 NAND: first 8 outputs differ from the host oracle")
    log(f"STD128 NAND B={GATE_BATCH}: all decrypt to 1-(m1&m2), first 8 equal the "
        f"host oracle bit for bit, first call {first_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for _ in range(2):
        t0 = time.time()
        cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        s = time.time() - t0
        log(f"STD128 NAND B={GATE_BATCH} warm: {s:.4f} s, "
            f"{GATE_BATCH / s:.1f} bootstraps/s on {card}")


def accelerated_contexts(param_set, log_qs=(17, 12)):
    """The sign/decomp context (logQ 17, time optimization, bases {2^18,
    2^27}; logQ 23 resolves to the same parameters) and the EvalFunc
    context (logQ 12, arbFunc), numDigitsToThrow 1, keys made on the host
    once per LWE block: the func context reuses the ring secret and the
    switching key. Returns (sign_cc, func_cc, sk, keygen seconds)."""
    from tfhe_tpu_torch import BinFHEContext

    t0 = time.time()
    sign_cc = BinFHEContext(seed=SEED)
    sign_cc.generate_binfhe_context(param_set, arb_func=False, log_q=log_qs[0],
                                    num_digits_to_throw=1, time_optimization=True)
    sk = sign_cc.key_gen()
    sign_cc.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    func_cc = BinFHEContext(seed=SEED + 1)
    func_cc.generate_binfhe_context(param_set, arb_func=True, log_q=log_qs[1],
                                    num_digits_to_throw=1)
    key = sign_cc.bt_key
    func_cc.bt_key_gen(sk, sk_n=key.sk_n, ksk=key.ksk)
    return sign_cc, func_cc, sk, time.time() - t0


def func_inputs(cc, sk, rng, B):
    """EvalFunc of the cube LUT (bench.py's, not negacyclic)."""
    import numpy as np

    p = cc.get_max_plaintext_space()

    def cube(m, p1):
        return (m * m * m) % p1 if m < p1 else ((m - p1 // 2) ** 3) % p1

    lut = cc.generate_lut_via_function(cube, p)
    m = rng.integers(0, p, B)
    return cc.encrypt(sk, m, "FRESH", p), lut, np.array([cube(int(x), p) for x in m]), p


def sign_inputs(cc, sk, rng, B):
    Q_enc = 1 << 17
    P = cc.get_max_plaintext_space() * (Q_enc // cc.params.lwe.q)
    delta = rng.integers(-3, 4, B)
    return cc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc), delta


def decomp_inputs(cc, sk, rng, B):
    Q_enc = 1 << 23
    p = cc.get_max_plaintext_space()
    P = p * (Q_enc // cc.params.lwe.q)
    m = rng.integers(0, P, B)
    return cc.encrypt(sk, m, "FRESH", P, Q_enc), m, p, P


def decomp_ok(cc, sk, out, m, p, P) -> bool:
    """Digit k holds (m // p^k) mod p; the last lives in the remaining
    plaintext space P // p^(len-1)."""
    import numpy as np

    vals = m.copy()
    for d in out[:-1]:
        if not np.array_equal(np.asarray(cc.decrypt(sk, d, p), dtype=np.int64), vals % p):
            return False
        vals //= p
    p_last = max(2, P // p ** (len(out) - 1))
    return np.array_equal(np.asarray(cc.decrypt(sk, out[-1], p_last), dtype=np.int64),
                          vals % p_last)


def same(x, y) -> bool:
    import numpy as np

    return (x.modulus == y.modulus and np.array_equal(x.a, y.a)
            and np.array_equal(x.b, y.b))


def toy_accelerated(rng) -> None:
    """EvalFunc, EvalSign and EvalDecomp on the accelerated TOY sets (N =
    2048, n = 32, the same Q and kernel shapes as STD128) on the card, each
    output decrypted and held bit for bit against the port's host oracle."""
    import numpy as np

    from tfhe_tpu_torch import ParamSet

    t0 = time.time()
    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.TOY)
    B = 8
    ct_f, lut, want_f, p = func_inputs(func_cc, sk, rng, B)
    ct_s, delta = sign_inputs(sign_cc, sk, rng, B)
    ct_d, m_d, p_d, P_d = decomp_inputs(sign_cc, sk, rng, B)
    got = (func_cc.eval_func(ct_f, lut), sign_cc.eval_sign(ct_s), sign_cc.eval_decomp(ct_d))
    for cc in (sign_cc, func_cc):
        check(cc.backend.device.type == "cuda", "the TOY accelerated contexts are not on the card")
        cc.device_clean()
    ref = (func_cc.eval_func(ct_f, lut), sign_cc.eval_sign(ct_s), sign_cc.eval_decomp(ct_d))
    check(np.array_equal(np.asarray(func_cc.decrypt(sk, got[0], p), dtype=np.int64), want_f),
          "TOY EvalFunc decryption")
    check(np.array_equal(sign_cc.decrypt(sk, got[1], 2), (delta >= 0).astype(np.uint64)),
          "TOY EvalSign decryption")
    check(decomp_ok(sign_cc, sk, got[2], m_d, p_d, P_d), "TOY EvalDecomp decryption")
    check(same(got[0], ref[0]) and same(got[1], ref[1]) and len(got[2]) == len(ref[2])
          and all(same(g, r) for g, r in zip(got[2], ref[2])),
          "TOY accelerated results differ from the host oracle")
    log(f"TOY accelerated (N=2048, n=32, Q=q1*q2): EvalFunc (cube LUT), EvalSign "
        f"(bases 2^18, 2^27) and EvalDecomp ({len(got[2])} digits) at B={B} decrypt "
        f"right and equal the host oracle bit for bit (keygen {keygen_s:.1f} s, "
        f"{time.time() - t0:.1f} s in all)")


def std128_accelerated(rng, card: str) -> None:
    """The RNS functional path at full width, batch FUNC_BATCH: EvalSign,
    EvalDecomp and EvalFunc on the STD128 accelerated sets, checked by
    decryption, one warm run of each timed."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import ParamSet

    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.STD128)
    p = sign_cc.params
    log(f"STD128 accelerated: N={p.lwe.N} n={p.lwe.n} Q={p.lwe.Q} = "
        f"{p.rgsw.rns_primes[0]} * {p.rgsw.rns_primes[1]}, qKS=2^35, baseKS=32; "
        f"host keygen (sign map 2^18, 2^27 + func 2^27, one switching key) "
        f"{keygen_s:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sign_cc.device_setup("cuda")
    func_cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup of both contexts (RNS key pack, one switching-key table) "
        f"{time.time() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    B = FUNC_BATCH
    ct_s, delta = sign_inputs(sign_cc, sk, rng, B)
    ct_d, m_d, p_d, P_d = decomp_inputs(sign_cc, sk, rng, B)
    ct_f, lut, want_f, p_f = func_inputs(func_cc, sk, rng, B)
    ops = {
        "EvalSign": (lambda: sign_cc.eval_sign(ct_s),
                     lambda out: np.array_equal(sign_cc.decrypt(sk, out, 2),
                                                (delta >= 0).astype(np.uint64))),
        "EvalDecomp": (lambda: sign_cc.eval_decomp(ct_d),
                       lambda out: decomp_ok(sign_cc, sk, out, m_d, p_d, P_d)),
        "EvalFunc": (lambda: func_cc.eval_func(ct_f, lut),
                     lambda out: np.array_equal(
                         np.asarray(func_cc.decrypt(sk, out, p_f), dtype=np.int64), want_f)),
    }
    for name, (run, ok) in ops.items():
        t0 = time.time()
        out = run()
        first_s = time.time() - t0
        check(ok(out), f"STD128 accelerated {name} decryption at B={B}")
        t0 = time.time()
        run()
        s = time.time() - t0
        log(f"STD128 accelerated {name} B={B}: all decrypt right; first call "
            f"{first_s:.3f} s; warm {s:.4f} s = {s / B * 1e3:.4f} ms/ciphertext, "
            f"{B / s:.1f} ops/s on {card}")
    log(f"STD128 accelerated peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    t_start = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from tfhe_tpu_torch import ParamSet, from_gpu_style, from_param_set
    from tfhe_tpu_torch.ops import _build, rotate_kernel, rotate_rns_kernel

    t0 = time.time()
    _build.build()
    for name in _build.KERNELS:
        for line in _build.LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    log(f"built csrc/{{{','.join(_build.KERNELS)}}}.cu for sm_90a in "
        f"{time.time() - t0:.1f} s")
    peak = int32_peak_per_s()

    rng = np.random.default_rng(SEED)
    t0 = time.time()
    gate_timing = gate_kernel_vs_plain(rng, from_param_set(ParamSet.STD128).lwe.Q, peak)
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12).rgsw.rns_primes
    rns_timing = rns_kernel_vs_plain(rng, q1, q2, peak)
    log(f"kernels against their plain versions: {time.time() - t0:.1f} s")

    # the gate path, counts read just after it
    rotate_kernel.LAUNCHES = rotate_rns_kernel.LAUNCHES = 0
    t0 = time.time()
    toy_gates(rng)
    std128_nand(rng, card)
    gate_launches = rotate_kernel.LAUNCHES
    check(gate_launches > 0, "the gate path did not launch blind_rotate")
    log(f"gate path: blind_rotate launches {gate_launches} ({time.time() - t0:.1f} s)")

    # the RNS functional path, counts read just after it
    rotate_kernel.LAUNCHES = rotate_rns_kernel.LAUNCHES = 0
    t0 = time.time()
    toy_accelerated(rng)
    std128_accelerated(rng, card)
    rns_launches = rotate_rns_kernel.LAUNCHES
    check(rns_launches > 0, "the functional path did not launch blind_rotate_rns")
    log(f"RNS functional path: blind_rotate_rns launches {rns_launches} "
        f"({time.time() - t0:.1f} s)")

    loaded = [m for m in sys.modules if m in ("jax", "tfhe_tpu")
              or m.startswith(("jax.", "tfhe_tpu."))]
    check(not loaded, f"JAX or the JAX package was loaded: {loaded[:5]}")
    log(f"no jax or tfhe_tpu module loaded; {time.time() - t_start:.1f} s in all")

    print(json.dumps({"kernels": [
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_rotate.py:253",
         "launches": gate_launches, **gate_timing, "library_ms": None},
        {"name": "blind_rotate_rns", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_rns.cu",
         "replaces": "tfhe_tpu/ops/pallas_rotate_rns.py:278",
         "launches": rns_launches, **rns_timing, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
