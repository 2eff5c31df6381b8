#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfhe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the three hand-written kernels from `tfhe_tpu_torch/csrc` (one nvcc
per source, in parallel, into `tfhe_tpu_torch/_build/`) and holds each bit
for bit against its plain torch version on the card, timed, at the shapes
its main path gives it (where a main path's full batch would hold the
plain version for minutes, it runs on a head of rows of the same inputs).
Then it drives the port's paths through `tfhe_tpu_torch.BinFHEContext`
(the matrix through `TorchBackend`):
- the gate path: all eight gates at TOY against the host oracle, and a
  batch-4096 STD128 NAND checked by decryption and, for its first 8
  outputs, bit for bit against the oracle;
- the RNS functional path: EvalFunc, EvalSign and EvalDecomp on the
  accelerated TOY sets bit for bit against the oracle, then at full width
  on the STD128 accelerated sets (N = 2048, n = 1305, Q = q1*q2 of 54 bits,
  qKS = 2^35) at batch 4096, checked by decryption;
- the same path with bench.py's seeded (threefry) switching key: its
  <A, s> summed on the card at keygen and its table regenerated there; TOY
  bit for bit against the oracle on the A block materialized on the host,
  STD128 at batch 1024 checked by decryption, the table's rows 0-63, the
  first chunk boundary and the last row torch.equal to the host threefry;
- the 17 GINX classic sets (LWE dimension cut to 12) against the oracle;
- the two-limb paths: a batch-4096 STD128Q NAND checked by decryption and,
  for its first 8 outputs, bit for bit against the oracle; EvalFunc,
  EvalSign and EvalDecomp on the TOY accelerated sets at the single 54-bit
  prime bit for bit against the oracle, and EvalSign at full width on the
  STD128 accelerated set with that prime at batch 256, checked by
  decryption;
- the mixed logQ = 11 path (blind_rotate with the 35-bit key switch): the
  8 gates, EvalFloor and EvalFunc at TOY against the oracle, then at STD128
  width (N = 1024, n = 1305) EvalFloor at batch 4096 and the CHES
  256-ciphertext AND, checked by decryption and on their first 8 outputs
  against the oracle;
- ring dimension N = 4096: blind_rotate_rns (a cluster of two blocks, one
  per residue lane), blind_rotate64 (a cluster of two blocks, one per
  polynomial, at the single prime ntt_prime(54, 8192)) and blind_rotate at
  N = 4096 against their plain versions, at batch 1024 and n = 1305 on a
  head of rows; then the STD128 accelerated sets at N = 4096 (seeded
  switching key) EvalSign and EvalFunc, and the logQ = 11 set on the same
  keys EvalFloor and NAND, at batch 1024 (bench.py's 4096, cut for the
  run's time limit), checked by decryption and on their first output
  against the oracle; then the same accelerated sets at the reference's
  single 54-bit prime (`rns_modulus=False`) on the same secrets and
  switching key, EvalSign, EvalDecomp and EvalFunc at batch 256 on
  blind_rotate64, checked by decryption and, for EvalSign and EvalFunc, on
  their first output against the oracle;
- ring dimension N = 8192 on the gate kernel: blind_rotate as a cluster
  of two blocks a ciphertext against its plain version (B = 5 at d2 2, 8
  and 12, then B = 1024, n = 1305 at d2 10 and 12 on a head of rows), then
  the STD128 logQ = 11 sets at N = 8192 (seeded switching key, a
  [1835008, 1306] float64 table on the card) NAND and EvalFloor (one digit
  thrown) and EvalFunc (arbFunc) at batch 1024, checked by decryption and
  against the oracle on their first output, or for EvalFloor and EvalFunc,
  whose rows decrypt wrong at a rate the parameters' noise sets (Q stays
  27 bits at this ring), on their first output that decrypts wrong;
- ring dimension N = 8192 on the RNS kernel: blind_rotate_rns as a
  cluster of four blocks a ciphertext (two a residue lane) against its
  plain version (B = 5 at d2 2, 4, 6 and 8, B = 64 at d2 4 and 2, then
  B = 1024, n = 1305 at d2 4 and 2 on a head of rows), then the STD128
  accelerated sets at N = 8192 (Q = q1*q2 of 54 bits) on the logQ = 11
  phase's secrets and seeded switching key: EvalSign and EvalFunc at
  batch 1024, every row checked by decryption and the first against the
  oracle, and EvalDecomp at batch 64, every row's digits decrypted;
- ring dimension N = 16384 on the RNS kernel, after the N = 8192 phases
  (and the single 54-bit prime at N = 8192) have freed their keys:
  blind_rotate_rns as a cluster of eight blocks a ciphertext (four a
  residue lane) against its plain version (B = 5 at d2 2, 4, 6 and 8, B =
  64 at d2 4 and 2, then B = 1024, n = 1305 at d2 4 and 2 on a head of
  rows), then the STD128 accelerated sets at N = 16384 (Q = 133857281 *
  132710401) on keys of their own (a [3670016, 1306] float64 switching
  table, 35.7 GiB, on the card): EvalSign and EvalFunc at batch 256, every
  row checked by decryption and the first against the oracle (whose key
  switch draws only the A rows it selects), and EvalDecomp at batch 64;
- CiphertextMulMatrix at 1024 x 1024 mod 2^35 against the host product,
  and the DM/AP accumulator: the 8 gates at TOY AP against the oracle and
  a batch-1024 STD128_AP NAND, checked by decryption and on its first 8
  outputs against the oracle;
- device RNS-CKKS (`tfhe_tpu_torch.pke`, torch ops, no hand kernel) at
  bench.py's `run_ckks` width (N = 4096, L = 8 limbs of 28 bits, scale
  2^28, dnum = 3, 28-bit special limbs): `eval_mult` (tensor product,
  hybrid key-switch relinearization, rescale) at batch 8 and 64, a slot
  rotation and a hoisted one at batch 8, add and sub; every slot decrypts
  within 1e-3, and two ciphertexts of each batch are `torch.equal` to the
  host `CKKSRnsContext`;
- CKKS bootstrapping (`CKKSBootstrapFFTDevice`, torch ops) at bench.py's
  `run_ckksboot` width (N = 1024, L = 18 limbs of 30 bits, sparse secret,
  level budget (2, 2), degree 44, 31 Galois keys) at batch 8: every stage
  on the card, every slot within 2e-2, ciphertexts 0 and 7 `torch.equal`
  to a CPU evaluator on the same keys; and the BSGS `CKKSBootstrapDevice`
  at N = 64, checked by decryption;
- the advanced SHE layer on the device evaluator at the CKKS width:
  `eval_sum`, `eval_linear_wsum` and `eval_logistic` at batch 8, checked
  by decryption and on ciphertext 0 against a CPU evaluator;
- the automatic-scaling CKKS layer (`CKKSAutoDeviceContext`) on the CKKS
  contexts under FLEXIBLEAUTO and FIXEDAUTO at batch 8: a lazily rescaled
  chain, a mixed-level add and a plaintext multiply and add, every slot
  within 1e-3 (FIXEDAUTO 5e-3), ciphertexts 0 and 7 torch.equal to the host
  `CKKSAutoContext`; one noise-flooded decryption on the host;
- BGV on the card (`BGVDeviceContext`, N = 4096, t = 257, 8 limbs of 27-28
  bits): eval_mult at batch 8 and 64, eval_rotate, eval_add and eval_sub,
  every result decrypted, ciphertexts 0 and B-1 torch.equal to the host
  `BGVRnsContext`;
- BFV on the card at simple-integers.cpp's configuration (t = 65537,
  depth 2) built by the ported `gen_crypto_context` (N = 4096, four 28-bit
  limbs, dnum = 2), once with HPS (`BFVDeviceContext`) and once with BEHZ
  (`BFVBehzDeviceContext`), on keys written and read back with
  `pke/serial`: the depth-2 chain x*y*z at batch 8 and 64, eval_rotate,
  eval_add and eval_sub at batch 8, every slot decrypted, ciphertexts 0
  and B-1 torch.equal to the host `BFVRnsContext` or `BFVBehzContext`;
- save and load (`BinFHEContext.save`/`load`): the STD128 NAND context,
  saved in a thread of its own while the phases from the RNS functional
  path to the single-prime one run, reloaded on the card gives the pre-save
  batch-4096 NAND outputs, and the seeded TOY accelerated context reloads
  with its key still seed and B and gives the host oracle's EvalSign bit
  for bit;
- several devices (`parallel/mesh.py`, `parallel/limb_ntt.py`) on the
  contexts of the phases above: a ("batch",) mesh of every GPU, or of two
  shards on cuda:0 on a one-card machine, runs the batch-4096 STD128 NAND
  and the batch-4096 STD128 accelerated EvalSign (outputs equal to the
  one-device outputs, bootstraps/s beside the one-device rate), a TOY
  logQ = 11 EvalFloor and a TOY two-limb EvalSign at batch 5 (equal to
  the host oracle); `eval_mult_limb` at the CKKS width on a ("limb",)
  mesh of 2 and 4 shards equals the device and host `eval_mult`.
The timings of the functional, CKKS, BGV, BFV, serialization and mesh
phases, and the run's total seconds, are a JSON line of their own.
Each path runs with the kernels' launch counts set to 0 just before it and
read just after. At the end no jax or JAX-package module may be loaded.
Exits non-zero on any failure. The line before the last is a JSON record
of the kernels; the last line is the JSON result.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import warnings

SEED = 20261016
GATE_BATCH = 4096
FUNC_BATCH = 4096
SEEDED_BATCH = 1024         # the seeded functional path's batch, cut for the run's time
SIGN64_BATCH = 1024         # blind_rotate64's single-prime main shape
CHES_BATCH = 256            # the CHES AND's batch (examples/ches_experiments.py)
CHES_ITERS = 20             # warm iterations of the CHES AND timed
GEMM_DIM = 1024             # K = M of the ciphertext-matrix product (examples/gemm.py)
GEMM_ITERS = 5
DM_BATCH = 1024             # STD128_AP NAND batch on the DM path
LWE_N_ACC = 1305           # rounds of the accelerated sets' rotation
ROWS = list(range(32))      # rows held to the plain version at a main path's batch
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
INT32_LANES_PER_SM = 64     # 32-bit integer multiply lanes per SM per clock
# blind_rotate_rns at B = 4096, n = 1305, d2 = 4 in its earlier design (the
# two lanes one after the other, every NTT stage through shared memory), on
# an NVIDIA H100 80GB HBM3 at 700 W, by this script
EARLIER_RNS_MS = 1925.602
# blind_rotate at B = 4096, n = 512, d2 = 8 in its earlier design (every NTT
# stage through shared memory, values and companions read), on an NVIDIA H100
# 80GB HBM3 at 700 W, by this script
EARLIER_GATE_MS = 245.621
# blind_rotate64 at STD128Q, B = 4096, n = 1024 in its earlier design (every
# NTT stage through shared memory, separate twist and untwist passes, a
# Barrett pass), on an NVIDIA H100 80GB HBM3 at 700 W, by this script
EARLIER_R64_MS = 1743.611
CKKS_SEED = 20260817        # bench.py's run_ckks context seed
CKKS_N, CKKS_L, CKKS_BITS = 4096, 8, 28
CKKS_BATCHES = (8, 64)      # bench.py's --ckks-batch default, and a wide batch
CKKS_ITERS = 5              # warm calls timed per measurement
BOOT_SEED = 20260818        # bench.py's run_ckksboot context seed
BOOT_N, BOOT_BITS, BOOT_HW = 1024, 30, 64
BOOT_BUDGET, BOOT_K, BOOT_DEG = (2, 2), 28.0, 44
BOOT_BATCH = 8              # bench.py's --ckks-batch default
BOOT_ITERS = 2              # warm bootstraps timed
SHE_BATCH = 8
SHE_DEG = 15                # eval_logistic's degree: 5 of the 7 levels below L = 8
SHE_ITERS = 3
AUTO_BATCH = 8
# every slot of the auto-scaled programs. FIXEDAUTO declares the fixed
# scale 2^28 where a rescale by the 28-bit limb q_l leaves 2^56 / q_l, a
# relative drift |2^28 / q_l - 1| of up to 1.5e-3 per rescale on this chain
AUTO_BOUND = {"flexibleauto": 1e-3, "fixedauto": 5e-3}
BGV_SEED = 20260819
BGV_N = 4096                # the CKKS phase's ring
BGV_T = 257
BGV_DEPTH = 7               # 8 limbs: 4 x 28 + 4 x 27 bits
BGV_BATCHES = (8, 64)
BGV_KS_BITS = 30
# simple-integers.cpp (OpenFHE src/pke/examples): BFV, t = 65537, depth 2;
# the port's gen_crypto_context derives N = 4096 at 128_classic, four
# 28-bit limbs
BFV_SEED = 20260820
BFV_T = 65537
BFV_DEPTH = 2
BFV_LIMB_BITS = 28
BFV_BATCHES = (8, 64)
RING_N = 4096              # the ring of the N = 4096 phase
RING_BATCH = 1024           # its batch: bench.py's 4096, cut for the run's time limit
RING_ROWS = list(range(8))   # rows of its full-width launches held to the plain version
RING_HEAD = 1               # rows of each of its operations held to the host oracle
PRIME_BATCH = 256           # the single-prime paths' batch, cut for the run's time
RING8192_N = 8192           # the ring of the N = 8192 phase
RING8192_Q = 133857281      # from_gpu_style(STD128, ..., log_q=11, N=8192).lwe.Q
RING8192_BATCH = 1024       # its batch: bench.py's 4096, cut for the run's time limit
RING8192_DECOMP_BATCH = 64  # EvalDecomp's batch on the RNS path at N = 8192
RING16384_N = 16384         # the ring of the N = 16384 RNS phase
RING16384_Q = (133857281, 132710401)   # from_gpu_style(STD128, True, 12, N=16384) primes
RING16384_KERNEL_BATCH = 1024   # the kernel's full shape there (bench.py's 4096, cut)
RING16384_BATCH = 256       # EvalSign's and EvalFunc's batch there, cut for the run's time
RING16384_DECOMP_BATCH = 64  # EvalDecomp's batch there
MESH_TOY_BATCH = 5          # TOY ciphertexts over the two-shard mesh: an uneven split
LIMB_SHARDS = (2, 4)        # shards of the ring-sharded eval_mult_limb
LIMB_ITERS = 3


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


def plain_rounds(fn, accs, a_idx, key, *args):
    """fn(*accs, a_idx, key, *args), a plain rotation over the n rounds of
    key [n, rows, N] and a_idx [B, n], run as n replays of a CUDA graph of
    one round of fn, each fed the next round's exponents and key rows and
    the last one's accumulators: the same torch kernels on the same values
    as one eager call over all rounds, launched by the card instead of one
    by one from Python (the eager call's ~1000 launches a round set its
    time). `accs` is one accumulator or a tuple; returns what fn does."""
    import torch

    single = isinstance(accs, torch.Tensor)
    state = [a.clone() for a in ((accs,) if single else accs)]
    idx, rows = a_idx[:, :1].clone(), key[:1].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*state, idx, rows, *args)    # uploads the tables before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*state, idx, rows, *args)
    out = (out,) if single else out
    for r in range(key.shape[0]):
        idx.copy_(a_idx[:, r:r + 1])
        rows.copy_(key[r:r + 1])
        graph.replay()
        for s, o in zip(state, out):
            s.copy_(o)
    return state[0] if single else tuple(state)


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


def bound(B: int, n: int, N: int, d2: int, lanes: int, peak: float,
          word: int = 4) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one rotation with residues
    of `word` bytes (8 for the 64-bit kernel). Bytes: each input and output
    read or written once, the key as values and Shoup companions (the RNS
    and 64-bit kernels store companions only and rebuild the values with
    multiplies; a layout that stores both needs none of them, so they are
    not counted), over the memory rate. Operations: the 32-bit multiplies
    over the int32 peak: 3 per 32-bit Shoup product (lo(a w), hi(a w'),
    lo(q_hat Q)); 15 per 64-bit one (7 for the high word of the 128-bit
    a w', from four 32x32 products of which the lowest needs only its high
    half, 4 each for the low words of a w and q_hat Q); 4 per coefficient
    for the CRT of two lanes."""
    key_bytes = word * n * 8 * d2 * N * (2 if lanes == 2 else 1)
    nbytes = word * (2 * lanes * B * 2 * N + lanes * 8 * N) + 4 * B * n + key_bytes
    digits = d2 // 2
    per_round = lanes * (3 if word == 4 else 15) * shoup_products(N, digits)
    if lanes == 2:
        per_round += 4 * 2 * N
    ops = B * n * per_round
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(got, want) -> int:
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


GATE_MODULI = (134215681, 268369921, 134176769)  # STD128/TOY, MEDIUM, STD256Q
GATE_BASES = {2: 1 << 14, 6: 1 << 10, 8: 1 << 7, 12: 1 << 5}   # gadget base by d2


def gate_cases():
    """(N, Q, d2, base, throw) of every ring size, digit count and modulus
    the gate kernel serves: Q 134215681 at N <= 1024, 268369921 at d2 <= 8,
    134176769 at N = 2048, each with throw 0 and 1; one base above 2Q,
    whose only digit is the centred value itself; and the two-block cluster
    at N = 8192 with the logQ = 11 set's prime there (RING8192_Q) at d2 2, 8
    and 12, throw 0 and 1 (N = 4096's cases are `ring4096_kernels`')."""
    cases = [(RING8192_N, RING8192_Q, d2, GATE_BASES[d2], throw)
             for d2 in (2, 8, 12) for throw in (0, 1)]
    for N in (256, 512, 1024, 2048):
        for d2 in (2, 6, 8, 12):
            for Q in GATE_MODULI:
                if ((Q == 134215681 and N > 1024) or (Q == 134176769 and N != 2048)
                        or (2 * Q - 1) * d2 >= 1 << 32):
                    continue
                cases += [(N, Q, d2, GATE_BASES[d2], throw) for throw in (0, 1)]
    return cases + [(512, 268369921, 2, 1 << 31, 1)]


def rotate64_cases() -> dict:
    """name -> (N, Q, base, d2, throw) of every case blind_rotate64 is held
    to: each two-limb row of the 17-set matrix with distinct (N, Q, base,
    d2), namely STD128Q (Q of 50 bits, base 2^25, d2 = 4), STD192 (37 bits,
    2^14, d2 = 6), STD192_OPT (2^13), STD192Q (35 bits, 2^14, d2 = 6),
    STD192Q_OPT (2^12) and STD256 (29 bits, 2^8, d2 = 8), the _OPT rows of
    STD128Q and STD256 sharing their rows' shapes; the reference's 54-bit
    prime at the accelerated sets' bases (2^18, d2 = 4, and 2^27, d2 = 2,
    throw 1); the same two at N = 4096 and its prime ntt_prime(54, 8192)
    (the cluster layout; base 2^27 keeps one digit a round) and at N = 8192
    and ntt_prime(54, 16384) (the four-block layout), with base 2^9 and
    three kept digits, none thrown, beside them; and the smaller rings at
    54-bit primes: N = 256 as the accelerated sets' 2^18, N = 512 at base
    2^27 with no throw, N = 1024 at base 2^9 with four kept digits and two
    thrown, and N = 512 at base 2 (a 40-bit prime, 36 digits thrown)."""
    from tfhe_tpu_torch import ParamSet, from_param_set
    from tfhe_tpu_torch.utils.numtheory import ntt_prime

    cases = {}
    for ps in (ParamSet.STD128Q, ParamSet.STD192, ParamSet.STD192_OPT, ParamSet.STD192Q,
               ParamSet.STD192Q_OPT, ParamSet.STD256):
        rg = from_param_set(ps).rgsw
        cases[ps.name] = (rg.N, rg.Q, rg.base_g, rg.digits_g2, rg.num_digits_to_throw)
    q54 = ntt_prime(54, 2 * 2048)
    cases["Q54, base 2^18"] = (2048, q54, 1 << 18, 4, 1)
    cases["Q54, base 2^27"] = (2048, q54, 1 << 27, 2, 1)
    q54_4k = ntt_prime(54, 2 * RING_N)
    cases["N=4096, Q54, base 2^18"] = (RING_N, q54_4k, 1 << 18, 4, 1)
    cases["N=4096, Q54, base 2^27"] = (RING_N, q54_4k, 1 << 27, 2, 1)
    q54_8k = ntt_prime(54, 2 * RING8192_N)
    cases["N=8192, Q54, base 2^18"] = (RING8192_N, q54_8k, 1 << 18, 4, 1)
    cases["N=8192, Q54, base 2^27"] = (RING8192_N, q54_8k, 1 << 27, 2, 1)
    cases["N=8192, Q54, base 2^9"] = (RING8192_N, q54_8k, 1 << 9, 6, 0)
    cases["N=256, Q54, base 2^18"] = (256, ntt_prime(54, 2 * 256), 1 << 18, 4, 1)
    cases["N=512, Q54, base 2^27"] = (512, ntt_prime(54, 2 * 512), 1 << 27, 2, 0)
    cases["N=1024, Q54, base 2^9"] = (1024, ntt_prime(54, 2 * 1024), 1 << 9, 8, 2)
    cases["N=512, Q40, base 2"] = (512, ntt_prime(40, 2 * 512), 2, 8, 36)
    return cases


def gate_kernel_vs_plain(rng, Q: int, peak: float) -> tuple[dict, dict]:
    """blind_rotate against its plain version on the card with tolerance 0
    (torch.equal: the arithmetic is exact and modular), each case timed: at
    STD128 shapes (N = 1024, d2 = 8, baseG = 2^7) B = 64 over 16 rounds;
    then every case of `gate_cases` below N = 8192 (those run in
    `ring8192_kernels`) at a small odd batch (B = 5, the ragged edge of a
    batch) over 8 rounds, rows 0, 1 and 2 of the exponents 0, N
    and 2N - 1 in all rounds; then the main path's B = GATE_BATCH over all
    512 rounds (`gate_rows_case`: the plain version on ROWS and the last
    row), which is returned and set beside EARLIER_GATE_MS. Last, the mixed
    logQ = 11 shape of EvalFloor (B = GATE_BATCH, n = LWE_N_ACC, N = 1024,
    d2 = 10: base 2^5, one digit thrown) the same way, whose timing is
    returned second."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate, rotate_kernel

    worst = 0

    def compare(B, n, N=1024, Q=Q, d2=8, base_g=1 << 7, throw=0, edge=False):
        nonlocal worst
        t0 = time.time()
        acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32)).cuda()
        a_np = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
        if edge:
            a_np[:3] = np.array([0, N, 2 * N - 1], dtype=np.int32)[:, None]
        a_idx = torch.from_numpy(a_np).cuda()
        bsk_hat = rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64)
        bsk = rotate_kernel.pack_bsk(bsk_hat, Q).cuda()
        kernel = lambda: rotate_kernel.rotate(acc, a_idx, bsk, Q, base_g, throw)  # noqa: E731
        plain = lambda: blindrotate.blind_rotate(acc, a_idx, bsk, Q, base_g, throw)  # noqa: E731
        got = kernel()
        want, plain_ms = timed_once(plain)
        err = max_err(got, want)
        worst = max(worst, err)
        check(torch.equal(got, want), f"blind_rotate != plain at N={N}, Q={Q}, d2={d2}, "
              f"base 2^{base_g.bit_length() - 1}, throw={throw}, B={B}, n={n} "
              f"(max abs err {err})")
        ms = cuda_ms(kernel, reps=3)
        b_ms, b_by = bound(B, n, N, d2, 1, peak)
        log(f"blind_rotate == plain at N={N} Q={Q} d2={d2} base 2^{base_g.bit_length() - 1} "
            f"throw={throw} B={B} n={n} (torch.equal, tolerance 0): max_abs_err {err}; "
            f"kernel {ms:.3f} ms, plain torch {plain_ms:.3f} ms, bound {b_ms:.3f} ms by "
            f"{b_by}, kernel at {100 * b_ms / ms:.1f}% of it ({time.time() - t0:.1f} s)")

    compare(64, 16)
    for N, Qc, d2, base_g, throw in gate_cases():
        if N < RING8192_N:
            compare(5, 8, N, Qc, d2, base_g, throw, edge=True)
    timing = gate_rows_case(rng, Q, peak, GATE_BATCH, 512, 1024, 8, 1 << 7, 0, ROWS)
    worst = max(worst, timing["max_abs_err"])
    log(f"blind_rotate at B={GATE_BATCH} n=512 d2=8: {timing['ms']:.3f} ms, "
        f"{100 * timing['bound_ms'] / timing['ms']:.1f}% of its bound; the earlier design "
        f"(every NTT stage through shared memory, values and companions read) took "
        f"{EARLIER_GATE_MS} ms ({100 * timing['bound_ms'] / EARLIER_GATE_MS:.1f}%) on an "
        f"NVIDIA H100 80GB HBM3 at 700 W: {EARLIER_GATE_MS / timing['ms']:.2f}x")

    mixed = gate_rows_case(rng, Q, peak, GATE_BATCH, LWE_N_ACC, 1024, 10, 1 << 5, 1, ROWS)
    worst = max(worst, mixed["max_abs_err"])
    return {**timing, "max_abs_err": worst}, mixed


def card_bsk(seed: int, Q: int, n: int, d2: int, N: int):
    """A random key in `rotate_kernel.pack_bsk`'s layout [n, 8 d2, N] int32,
    drawn on the card from `seed`: values uniform mod Q and beside them
    their Shoup companions, as pack_bsk stores them (the order of a random
    row's points does not matter). The host would take minutes over the
    full shapes at N = 8192 (half a billion values at d2 = 12)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.empty((n, 2, 4 * d2, N), dtype=torch.int32, device="cuda")
    step = max(1, (1 << 26) // (4 * d2 * N))
    for r in range(0, n, step):
        vals = torch.randint(0, Q, (min(step, n - r), 4 * d2, N), generator=gen,
                             device="cuda", dtype=torch.int64)
        for vs, x in enumerate((vals, (vals << 32) // Q)):
            out[r:r + step, vs] = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return out.reshape(n, 8 * d2, N)


def kernel_resources(name: str, logn: int) -> str:
    """What ptxas said of the LOGN = logn instantiation of csrc/<name>.cu's
    kernel in this run's build: its stack and spill line and its register
    line."""
    from tfhe_tpu_torch.ops import _build

    lines = _build.ptxas_report(name)
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and f"ILi{logn}E" in ln:
            return "; ".join(lines[i + 1:i + 3])
    return "not in this run's build log"


def gate_rows_case(rng, Q: int, peak: float, B: int, n: int, N: int, d2: int,
                   base_g: int, throw: int, rows: list) -> dict:
    """blind_rotate at a main path's full shape: the kernel over the whole
    batch (a first launch, then timed), the plain version (`plain_rounds`)
    on `rows` and the last row of the same inputs, held equal with
    tolerance 0; rows 0, 1 and 2 of the exponents hold 0, N and 2N - 1 in
    all rounds. The key is drawn on the card from a seed of `rng`."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate, rotate_kernel

    t0 = time.time()
    acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N)).astype(np.int32)).cuda()
    a_np = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_np[:3] = np.array([0, N, 2 * N - 1], dtype=np.int32)[:, None]
    a_idx = torch.from_numpy(a_np).cuda()
    bsk = card_bsk(int(rng.integers(1 << 62)), Q, n, d2, N)
    kernel = lambda: rotate_kernel.rotate(acc, a_idx, bsk, Q, base_g, throw)  # noqa: E731
    got, first_ms = timed_once(kernel)
    rows = rows + [B - 1]
    want, plain_ms = timed_once(lambda: plain_rounds(
        blindrotate.blind_rotate, acc[rows], a_idx[rows], bsk, Q, base_g, throw))
    err = max_err(got[rows], want)
    check(torch.equal(got[rows], want), f"blind_rotate != plain at N={N}, B={B}, n={n}, "
          f"d2={d2}, rows 0..{len(rows) - 2} and {B - 1} (max abs err {err})")
    ms = cuda_ms(kernel, reps=2)
    b_ms, b_by = bound(B, n, N, d2, 1, peak)
    log(f"blind_rotate == plain at N={N} Q={Q} d2={d2} base 2^{base_g.bit_length() - 1} "
        f"throw={throw} B={B} n={n} on rows 0..{len(rows) - 2} and {B - 1} (torch.equal, "
        f"tolerance 0): max_abs_err {err}; kernel over all {B} rows {first_ms:.3f} ms (first "
        f"launch) and {ms:.3f} ms, plain torch on the {len(rows)} rows (a graph a round) "
        f"{plain_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms by {b_by}, kernel at {100 * b_ms / ms:.1f}% of it "
        f"({time.time() - t0:.1f} s)")
    return {"ms": ms, "plain_ms": plain_ms, "plain_rows": len(rows), "bound_ms": b_ms,
            "bound_by": b_by, "share": b_ms / ms, "max_abs_err": err}


def rns_case(rng, q1: int, q2: int, peak: float, B: int, n: int, d2: int, N: int = 2048,
             throw: int = 1, rows: list | None = None) -> dict:
    """blind_rotate_rns against its plain version on the card at q1, q2
    with tolerance 0 (torch.equal), timed: the kernel over the whole batch,
    the plain version over it too or, with `rows`, on those rows and the
    last one of the same inputs (`plain_rounds`). Rows 0, 1 and 2 of the
    exponents hold 0, N and 2N - 1 in all rounds; the key holds valid Shoup
    companions of random values < qi."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate_rns, rotate_rns_kernel

    t0 = time.time()
    base_g = {2: 1 << 27, 4: 1 << 18, 6: 1 << 9, 8: 1 << 7}[d2]
    acc = [torch.from_numpy(rng.integers(0, qi, (B, 2, N)).astype(np.int32)).cuda()
           for qi in (q1, q2)]
    a_np = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_np[:3] = np.array([0, N, 2 * N - 1], dtype=np.int32)[:, None]
    a_idx = torch.from_numpy(a_np).cuda()
    key = torch.empty((n, 8 * d2, N), dtype=torch.int64, device="cuda")
    for lane, qi in enumerate((q1, q2)):
        sl = slice(lane * 4 * d2, (lane + 1) * 4 * d2)
        key[:, sl] = (torch.randint(0, qi, (n, 4 * d2, N), device="cuda") << 32) // qi
    key = torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32)
    kernel = lambda: rotate_rns_kernel.rotate_rns(  # noqa: E731
        *acc, a_idx, key, q1, q2, base_g, throw)
    got, first_ms = timed_once(kernel)
    p_acc, p_idx = acc, a_idx
    if rows is not None:
        rows = rows + [B - 1]
        p_acc, p_idx, got = [a[rows] for a in acc], a_idx[rows], [g[rows] for g in got]
    if rows is None:
        want, plain_ms = timed_once(lambda: blindrotate_rns.blind_rotate_rns(
            *p_acc, p_idx, key, q1, q2, base_g, throw))
    else:
        want, plain_ms = timed_once(lambda: plain_rounds(
            blindrotate_rns.blind_rotate_rns, p_acc, p_idx, key, q1, q2, base_g, throw))
    err = max(max_err(g, w) for g, w in zip(got, want))
    on = "" if rows is None else f" on rows 0..{len(rows) - 2} and {B - 1}"
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"blind_rotate_rns != plain at N={N}, B={B}, n={n}, d2={d2}, throw={throw}{on} "
          f"(max abs err {err})")
    ms = cuda_ms(kernel, reps=2)
    b_ms, b_by = bound(B, n, N, d2, 2, peak)
    plain = ("plain torch" if rows is None
             else f"plain torch on the {len(rows)} rows (a graph a round)")
    log(f"blind_rotate_rns == plain at N={N} d2={d2} throw={throw} B={B} n={n}{on} "
        f"(torch.equal, tolerance 0): max_abs_err {err}; kernel {ms:.3f} ms (first launch "
        f"{first_ms:.3f} ms), {plain} {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}, "
        f"kernel at {100 * b_ms / ms:.1f}% of it ({time.time() - t0:.1f} s)")
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "share": b_ms / ms, "max_abs_err": err}
    if rows is not None:
        out["plain_rows"] = len(rows)
    return out


def rns_kernel_vs_plain(rng, q1: int, q2: int, peak: float) -> dict:
    """blind_rotate_rns against its plain version on the card at the
    accelerated sets' q1, q2 (`rns_case`): at N = 2048 and throw = 1,
    d2 = 4 (base 2^18, EvalSign/EvalDecomp) and d2 = 2 (base 2^27,
    EvalFunc) at B = 64 over 16 rounds; then every ring size and digit
    count of the one-block layout at a small odd batch (B = 5, the ragged
    edge of a batch) over 8 rounds with throw = 0: N in {256, 512, 1024,
    2048}, d2 in {2, 6, 8}; then the main
    path's B = FUNC_BATCH, n = 1305 at d2 = 4, the plain version on ROWS
    and the last row, which is returned and set beside EARLIER_RNS_MS."""
    worst = 0
    for d2 in (4, 2):
        worst = max(worst, rns_case(rng, q1, q2, peak, 64, 16, d2)["max_abs_err"])
    for N in (256, 512, 1024, 2048):
        for d2 in (2, 6, 8):
            worst = max(worst, rns_case(rng, q1, q2, peak, 5, 8, d2, N, throw=0)["max_abs_err"])
    timing = rns_case(rng, q1, q2, peak, FUNC_BATCH, LWE_N_ACC, 4, rows=ROWS)
    log(f"blind_rotate_rns at B={FUNC_BATCH} n={LWE_N_ACC} d2=4: {timing['ms']:.3f} ms, "
        f"{100 * timing['share']:.1f}% of its bound; the earlier design "
        f"(lanes one after the other, every NTT stage through shared memory) took "
        f"{EARLIER_RNS_MS} ms ({100 * timing['bound_ms'] / EARLIER_RNS_MS:.1f}%) on an "
        f"NVIDIA H100 80GB HBM3 at 700 W: {EARLIER_RNS_MS / timing['ms']:.2f}x")
    return {**timing, "max_abs_err": max(worst, timing["max_abs_err"])}


def rotate64_key(rng, Q: int, d2: int, n: int, N: int):
    """A random key in pack_bsk64's layout [n, 4 d2, N] int64, drawn on the
    card from a seed taken of `rng`: valid companions of random values < Q
    (`modmath.shoup64_tensor`; the host's long division would take
    seconds over the full shapes at N = 4096 and 8192)."""
    import torch

    from tfhe_tpu_torch.ops.modmath import shoup64_tensor

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 62)))
    out = torch.empty((n, 4 * d2, N), dtype=torch.int64, device="cuda")
    step = max(1, (1 << 26) // (4 * d2 * N))
    for r in range(0, n, step):
        vals = torch.randint(0, Q, (min(step, n - r), 4 * d2, N), generator=gen,
                             device="cuda", dtype=torch.int64)
        out[r:r + step] = shoup64_tensor(vals, Q)
    return out


def fewer_digits(key, d2: int):
    """The rows of a pack_bsk64 key for the first d2 / 2 digits: a key of
    d2 rows a (key, out) pair, from one with more."""
    n, rows, N = key.shape
    if rows == 4 * d2:
        return key
    return key.view(n, 4, rows // 4, N)[:, :, :d2].reshape(n, 4 * d2, N).contiguous()


def rotate64_case(rng, peak: float, label: str, N: int, Q: int, base_g: int, d2: int,
                  throw: int, B: int, n: int, rows: list | None = None, key=None) -> dict:
    """blind_rotate64 against its plain version on the card with tolerance
    0 (torch.equal), timed: the kernel over the whole batch (a first launch,
    then timed), the plain version over it too or, with `rows`, on those
    rows and the last one of the same inputs (`plain_rounds`). Rows 0, 1
    and 2 of the exponents hold 0, N and 2N - 1 in all rounds; `key` (else a new
    `rotate64_key`) holds valid companions of random values < Q."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import blindrotate64, rotate64_kernel

    t0 = time.time()
    acc = torch.from_numpy(rng.integers(0, Q, (B, 2, N))).cuda()
    a_np = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_np[:3] = np.array([0, N, 2 * N - 1], dtype=np.int32)[:, None]
    a_idx = torch.from_numpy(a_np).cuda()
    if key is None:
        key = rotate64_key(rng, Q, d2, n, N)
    kernel = lambda: rotate64_kernel.rotate64(acc, a_idx, key, Q, base_g, throw)  # noqa: E731
    got, first_ms = timed_once(kernel)
    p_acc, p_idx = acc, a_idx
    if rows is not None:
        rows = rows + [B - 1]
        p_acc, p_idx, got = acc[rows], a_idx[rows], got[rows]
    if rows is None:
        want, plain_ms = timed_once(
            lambda: blindrotate64.blind_rotate64(p_acc, p_idx, key, Q, base_g, throw))
    else:
        want, plain_ms = timed_once(lambda: plain_rounds(
            blindrotate64.blind_rotate64, p_acc, p_idx, key, Q, base_g, throw))
    err = max_err(got, want)
    on = "" if rows is None else f" on rows 0..{len(rows) - 2} and {B - 1}"
    check(torch.equal(got, want), f"blind_rotate64 != plain at {label}, B={B}, n={n}{on} "
          f"(max abs err {err})")
    ms = cuda_ms(kernel, reps=2 if rows is None else 1)
    b_ms, b_by = bound(B, n, N, d2, 1, peak, word=8)
    plain = ("plain torch" if rows is None
             else f"plain torch on the {len(rows)} rows (a graph a round)")
    log(f"blind_rotate64 == plain at {label} (N={N} d2={d2} throw={throw}) B={B} n={n}{on} "
        f"(torch.equal, tolerance 0): max_abs_err {err}; kernel {ms:.3f} ms (first launch "
        f"{first_ms:.3f} ms), {plain} {plain_ms:.3f} ms, bound {b_ms:.3f} ms by {b_by}, "
        f"kernel at {100 * b_ms / ms:.1f}% of it ({time.time() - t0:.1f} s)")
    out = {"ms": ms, "first_ms": first_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "share": b_ms / ms, "max_abs_err": err}
    if rows is not None:
        out["plain_rows"] = len(rows)
    return out


def rotate64_kernel_vs_plain(rng, peak: float) -> tuple[dict, dict]:
    """blind_rotate64 against its plain version on the card with tolerance
    0 (`rotate64_case`): every case of `rotate64_cases` below N = 8192
    (those run in `ring8192_r64_kernels`) at B = 64 over 16 rounds; then the
    main paths' own shapes, all rounds: STD128Q at B = GATE_BATCH, n = 1024
    (the NAND), set beside EARLIER_R64_MS and returned for the kernels line,
    and the 54-bit prime at B = SIGN64_BATCH, n = 1305, d2 = 4 and d2 = 2
    (EvalSign); there the plain version runs on ROWS and the last row of the
    same inputs (its time over the whole batch would be minutes). Last, the
    kernel alone at the 54-bit prime, B = GATE_BATCH, n = 1305, d2 = 4.
    Returns (the kernels line's numbers, the main shapes' timings)."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.ops import rotate64_kernel

    cases = rotate64_cases()
    worst = 0

    def case(name, B, n, rows=None, key=None):
        nonlocal worst
        out = rotate64_case(rng, peak, name, *cases[name], B, n, rows, key)
        worst = max(worst, out["max_abs_err"])
        return out

    for name, (N, *_) in cases.items():
        if N < RING8192_N:
            case(name, 64, 16)
    shapes = {}
    N, Q, base_g, d2, throw = cases["Q54, base 2^18"]
    key = rotate64_key(rng, Q, d2, LWE_N_ACC, N)
    for name, B, n, k in (("STD128Q", GATE_BATCH, 1024, None),
                          ("Q54, base 2^18", SIGN64_BATCH, LWE_N_ACC, key),
                          ("Q54, base 2^27", SIGN64_BATCH, LWE_N_ACC, fewer_digits(key, 2))):
        shapes[f"{name}, B={B}, n={n}"] = case(name, B, n, ROWS, k)
    timing = shapes[f"STD128Q, B={GATE_BATCH}, n=1024"]
    log(f"blind_rotate64 at STD128Q B={GATE_BATCH} n=1024: {timing['ms']:.3f} ms; the earlier "
        f"design (every NTT stage through shared memory, twist and untwist passes, a "
        f"Barrett pass) took {EARLIER_R64_MS} ms on an NVIDIA H100 80GB HBM3 at 700 W: "
        f"{EARLIER_R64_MS / timing['ms']:.2f}x")

    acc = torch.from_numpy(rng.integers(0, Q, (GATE_BATCH, 2, N))).cuda()
    a_idx = torch.from_numpy(rng.integers(0, 2 * N, (GATE_BATCH, LWE_N_ACC)).astype(
        np.int32)).cuda()
    kernel = lambda: rotate64_kernel.rotate64(acc, a_idx, key, Q, base_g, throw)  # noqa: E731
    kernel()
    ms = cuda_ms(kernel, reps=1)
    b_ms, b_by = bound(GATE_BATCH, LWE_N_ACC, N, d2, 1, peak, word=8)
    log(f"blind_rotate64 alone at Q54, base 2^18 B={GATE_BATCH} n={LWE_N_ACC}: {ms:.3f} "
        f"ms, bound {b_ms:.3f} ms by {b_by}, kernel at {100 * b_ms / ms:.1f}% of it")
    shapes[f"Q54, base 2^18, B={GATE_BATCH}, n={LWE_N_ACC}"] = {
        "ms": ms, "bound_ms": b_ms, "share": b_ms / ms}
    line = {k: timing[k] for k in ("ms", "plain_ms", "plain_rows", "bound_ms", "bound_by")}
    return {"max_abs_err": worst, **line}, shapes


GATE_TRUTH = {
    "OR": lambda a, b: a | b, "AND": lambda a, b: a & b, "NOR": lambda a, b: 1 - (a | b),
    "NAND": lambda a, b: 1 - (a & b), "XOR_FAST": lambda a, b: a ^ b,
    "XNOR_FAST": lambda a, b: 1 - (a ^ b), "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: 1 - (a ^ b),
}


def gates_against_oracle(cc, sk, rng, label: str) -> None:
    """All eight gates of `cc` at batch 16 on the card, each decrypted and
    held bit for bit against the host oracle."""
    import numpy as np

    from tfhe_tpu_torch import Gate

    m1, m2 = rng.integers(0, 2, 16), rng.integers(0, 2, 16)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    outs = {g: cc.eval_bin_gate(g, ct1, ct2) for g in Gate}      # on the card
    check(cc.backend.device.type == "cuda", f"the {label} context does not run on the card")
    cc.device_clean()
    for g in Gate:
        check(np.array_equal(cc.decrypt(sk, outs[g]), GATE_TRUTH[g.name](m1, m2)),
              f"{label} {g.name} truth table")
        check(same(outs[g], cc.eval_bin_gate(g, ct1, ct2)),
              f"{label} {g.name} differs from the host oracle")


def toy_gates(rng, method_name: str = "GINX") -> None:
    """All eight gates at TOY on the GPU (CGGI, or the DM accumulator with
    method_name "AP"), bit for bit against the oracle."""
    from tfhe_tpu_torch import BinFHEContext, Method, ParamSet

    t0 = time.time()
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.TOY, Method[method_name])
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    label = "TOY" if method_name == "GINX" else f"TOY {method_name}"
    gates_against_oracle(cc, sk, rng, label)
    log(f"{label}: all 8 gates decrypt right and equal the host oracle bit for bit "
        f"({time.time() - t0:.1f} s)")


def std128_nand(rng, card: str) -> dict:
    """The gate path at full width: STD128 NAND at batch 4096. Returns the
    context, secret, inputs and outputs for the serialization phase."""
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
    return {"cc": cc, "sk": sk, "cts": (ct1, ct2), "out": out, "m": (m1, m2)}


def accelerated_contexts(param_set, log_qs=(17, 12), rns_modulus=None, func=True,
                         seeded=False, N=0, shared=None):
    """The sign/decomp context (logQ 17, time optimization, bases {2^18,
    2^27}; logQ 23 resolves to the same parameters) and, with `func`, the
    EvalFunc context (logQ 12, arbFunc), numDigitsToThrow 1, keys made on
    the host once per LWE block: the func context takes the sign context's
    base-2^27 bootstrapping key (the same Q, N, base and digits thrown),
    and with it the ring secret and the switching key. With `seeded`, the
    switching key is the seeded (threefry) key of bench.py's accelerated
    rows, its <A, s> summed on the card. Q is q1*q2, or with rns_modulus=False the reference's single
    54-bit prime. N is the ring dimension asked of `from_gpu_style` (0: the
    set's own). `shared` = {"sk": LWE secret, "sk_n": ring secret, "ksk":
    switching key} of another context of the same n, N, qKS and baseKS
    gives the keys other than the bootstrapping keys. Returns (sign_cc,
    func_cc or None, sk, keygen seconds)."""
    from tfhe_tpu_torch import BinFHEContext

    t0 = time.time()
    sign_cc = BinFHEContext(seed=SEED, seeded_ksk=seeded)
    sign_cc.generate_binfhe_context(param_set, arb_func=False, log_q=log_qs[0], N=N,
                                    num_digits_to_throw=1, time_optimization=True,
                                    rns_modulus=rns_modulus)
    if shared is None:
        sk = sign_cc.key_gen()
        sign_cc.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    else:
        sk = shared["sk"]
        sign_cc.bt_key_gen(sk, sk_n=shared["sk_n"], ksk=shared["ksk"],
                           bases={1 << 18, 1 << 27})
    func_cc = None
    if func:
        func_cc = BinFHEContext(seed=SEED + 1, seeded_ksk=seeded)
        func_cc.generate_binfhe_context(param_set, arb_func=True, log_q=log_qs[1], N=N,
                                        num_digits_to_throw=1, rns_modulus=rns_modulus)
        ps, pf = sign_cc.params.rgsw, func_cc.params.rgsw
        check((ps.N, ps.Q, pf.base_g, ps.num_digits_to_throw)
              == (pf.N, pf.Q, 1 << 27, pf.num_digits_to_throw),
              "the func context cannot take the sign context's 2^27 key")
        func_cc.bt_key_load(sign_cc.bt_key_map[1 << 27])
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


def decomp_rows(cc, sk, out, m, p, P):
    """Per row, whether EvalDecomp's digits decrypt right: digit k holds
    (m // p^k) mod p; the last lives in the remaining plaintext space
    P // p^(len-1)."""
    import numpy as np

    vals, ok = m.copy(), np.ones(len(m), dtype=bool)
    for d in out[:-1]:
        ok &= np.asarray(cc.decrypt(sk, d, p), dtype=np.int64) == vals % p
        vals //= p
    p_last = max(2, P // p ** (len(out) - 1))
    return ok & (np.asarray(cc.decrypt(sk, out[-1], p_last), dtype=np.int64) == vals % p_last)


def decomp_ok(cc, sk, out, m, p, P) -> bool:
    return bool(decomp_rows(cc, sk, out, m, p, P).all())


def same(x, y) -> bool:
    import numpy as np

    return (x.modulus == y.modulus and np.array_equal(x.a, y.a)
            and np.array_equal(x.b, y.b))


def toy_accelerated(rng, rns_modulus=None, seeded=False) -> None:
    """EvalFunc, EvalSign and EvalDecomp on the accelerated TOY sets (N =
    2048, n = 32, the same Q and kernel shapes as STD128) on the card, each
    output decrypted and held bit for bit against the port's host oracle.
    With rns_modulus=False, Q is the single 54-bit prime. With `seeded`,
    the switching key is the seeded key, and the oracle runs on its A
    block materialized on the host from the seed."""
    import numpy as np

    from tfhe_tpu_torch import ParamSet, lwe

    t0 = time.time()
    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.TOY,
                                                          rns_modulus=rns_modulus,
                                                          seeded=seeded)
    form = "Q=q1*q2" if rns_modulus is None else f"one prime Q={sign_cc.params.lwe.Q}"
    if seeded:
        check(isinstance(sign_cc.bt_key.ksk, lwe.SeededSwitchingKey)
              and func_cc.bt_key.ksk is sign_cc.bt_key.ksk,
              "the TOY contexts do not share one seeded switching key")
        form += ", seeded switching key"
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
    log(f"TOY accelerated (N=2048, n=32, {form}): EvalFunc (cube LUT), EvalSign "
        f"(bases 2^18, 2^27) and EvalDecomp ({len(got[2])} digits) at B={B} decrypt "
        f"right and equal the host oracle bit for bit (keygen {keygen_s:.1f} s, "
        f"{time.time() - t0:.1f} s in all)")


def seeded_table_rows(ksk, table) -> list:
    """The seeded key's device table against rows regenerated by the
    threefry stream on the host's CPU: rows 0-63, the chunk boundary
    KSK_ROW_CHUNK - 1 .. KSK_ROW_CHUNK and the last row, A columns and B.
    Returns the rows checked."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import lwe

    R, n = ksk.rows, ksk.n
    spans = [(0, 64), (lwe.KSK_ROW_CHUNK - 1, lwe.KSK_ROW_CHUNK + 1), (R - 1, R)]
    b = np.asarray(ksk.B, dtype=np.uint64).reshape(-1)
    for r0, r1 in spans:
        a = lwe.seeded_rows(ksk.seed, n, ksk.q_ks, r0, r1, "cpu").to(torch.float64)
        want = torch.cat([a, torch.from_numpy(b[r0:r1].astype(np.float64))[:, None]], 1)
        check(torch.equal(table[r0:r1].cpu(), want),
              f"seeded switching table rows {r0}..{r1 - 1} differ from the host threefry")
    return spans


def std128_accelerated(rng, card: str, seeded: bool = False,
                       B: int = FUNC_BATCH) -> tuple[dict, dict]:
    """The RNS functional path at full width, batch B: EvalSign,
    EvalDecomp and EvalFunc on the STD128 accelerated sets, checked by
    decryption, one warm run of each timed. With `seeded`, bench.py's
    configuration: the seeded switching key, generated on the card, its
    device table's spot rows held to the host threefry. Returns the
    timings, and the EvalSign context, secret, input and first output for
    the mesh phase."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import ParamSet, convert, lwe

    torch.cuda.reset_peak_memory_stats()
    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.STD128, seeded=seeded)
    p = sign_cc.params
    ksk = sign_cc.bt_key.ksk
    kind = "seeded switching key, <A, s> on the card" if seeded else "host switching key"
    check(isinstance(ksk, lwe.SeededSwitchingKey) == seeded and func_cc.bt_key.ksk is ksk,
          f"STD128 accelerated: not one {kind} for both contexts")
    log(f"STD128 accelerated: N={p.lwe.N} n={p.lwe.n} Q={p.lwe.Q} = "
        f"{p.rgsw.rns_primes[0]} * {p.rgsw.rns_primes[1]}, qKS=2^35, baseKS=32; "
        f"keygen (sign map 2^18, 2^27, the func context on its 2^27 key, one {kind}) "
        f"{keygen_s:.1f} s")
    t0 = time.time()
    sign_cc.device_setup("cuda")
    func_cc.device_setup("cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    mem = torch.cuda.memory_allocated() / 2**30
    log(f"device_setup of both contexts (RNS key pack, one switching-key table) "
        f"{setup_s:.1f} s, device memory {mem:.2f} GiB")
    timing = {"card": card, "seeded": seeded, "keygen_s": keygen_s,
              "device_setup_s": setup_s, "device_GiB": mem}
    if seeded:
        dev = sign_cc.backend.device
        spans = seeded_table_rows(ksk, convert.switching_table(ksk, dev))
        chunk = [(r0, r1) for r0, r1 in lwe.seeded_blocks(ksk.rows, ksk.n, dev)
                 if r1 <= lwe.KSK_ROW_CHUNK]
        timing["threefry_chunk_ms"] = cuda_ms(lambda: [
            lwe.seeded_rows(ksk.seed, ksk.n, ksk.q_ks, r0, r1, dev) for r0, r1 in chunk], 2)
        log(f"seeded switching table [{ksk.rows}, {ksk.n + 1}] on the card: rows "
            f"{', '.join(f'{a}..{b - 1}' for a, b in spans)} torch.equal to the host "
            f"threefry; one chunk of A ({lwe.KSK_ROW_CHUNK} rows, 2 planes of u32 words) "
            f"regenerated in {timing['threefry_chunk_ms']:.3f} ms on {card}")

    timing["batch"] = B
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
    firsts = {}
    for name, (run, ok) in ops.items():
        t0 = time.time()
        out = firsts[name] = run()
        first_s = time.time() - t0
        check(ok(out), f"STD128 accelerated {name} decryption at B={B}")
        t0 = time.time()
        run()
        s = time.time() - t0
        timing[f"{name}_ms_per_ct"] = s / B * 1e3
        log(f"STD128 accelerated {name} B={B}: all decrypt right; first call "
            f"{first_s:.3f} s; warm {s:.4f} s = {s / B * 1e3:.4f} ms/ciphertext, "
            f"{B / s:.1f} ops/s on {card}")
    timing["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"STD128 accelerated peak device memory {timing['peak_device_GiB']:.2f} GiB")
    return timing, {"cc": sign_cc, "sk": sk, "ct": ct_s, "delta": delta,
                    "out": firsts["EvalSign"]}


def floor_inputs(cc, sk, rng, B):
    """EvalFloor with roundbits 1 (bench.py's floor row): m // 2 in p / 2."""
    p = cc.get_max_plaintext_space()
    m = rng.integers(0, p, B)
    return cc.encrypt(sk, m, "FRESH", p), m, p


def floor_right(cc, sk, out, m, p):
    """Which rows of an EvalFloor output decrypt to m // 2 in p / 2."""
    import numpy as np

    return np.asarray(cc.decrypt(sk, out, p // 2), dtype=np.int64) == m // 2


def floor_ok(cc, sk, out, m, p) -> bool:
    return bool(floor_right(cc, sk, out, m, p).all())


def head(ct, rows: int = 8):
    return type(ct)(ct.a[:rows], ct.b[:rows], ct.modulus)


def take(ct, rows):
    """The ciphertexts of `rows` (an index array) of a batch."""
    return type(ct)(ct.a[rows], ct.b[rows], ct.modulus)


def mixed_contexts(param_set, throws=(0, 1), arb_func=False, N=0, sk=None, shared=None,
                   seeded=False):
    """`from_gpu_style(param_set, arb_func, 11, N, num_digits_to_throw=t)`
    for each t of `throws`, keys made on the host once per LWE block: the
    contexts share the LWE secret, the ring secret and the switching key,
    or take `sk` and `shared` = {"sk_n": ring secret, "ksk": switching key}
    from another context of the same n, N, qKS and baseKS. With `seeded`,
    a switching key made here is the seeded (threefry) one, its <A, s>
    summed on the card. Returns ({throw: context}, sk, keygen seconds)."""
    from tfhe_tpu_torch import BinFHEContext

    t0 = time.time()
    out, shared = {}, shared or {}
    for t in throws:
        cc = BinFHEContext(seed=SEED + t, seeded_ksk=seeded)
        cc.generate_binfhe_context(param_set, arb_func=arb_func, log_q=11, N=N,
                                   num_digits_to_throw=t)
        if sk is None:
            sk = cc.key_gen()
        cc.bt_key_gen(sk, **shared)
        shared = {"sk_n": cc.bt_key.sk_n, "ksk": cc.bt_key.ksk}
        out[t] = cc
    return out, sk, time.time() - t0


def toy_mixed(rng) -> None:
    """The mixed logQ = 11 path at TOY (N = 1024, n = 32, Q = 134215681,
    qKS = 2^35) on the card, bit for bit against the host oracle: all eight
    gates at `from_gpu_style(TOY, False, 11)` (q = 2N), EvalFloor there,
    with one digit thrown, and EvalFunc at `from_gpu_style(TOY, True, 11)`."""
    import numpy as np

    from tfhe_tpu_torch import ParamSet

    t0 = time.time()

    ctxs, sk, _ = mixed_contexts(ParamSet.TOY)
    gates_against_oracle(ctxs[0], sk, rng, "TOY logQ=11")
    cc = ctxs[1]
    ct, m, p = floor_inputs(cc, sk, rng, 16)
    out = cc.eval_floor(ct, 1)
    check(cc.backend.device.type == "cuda" and cc.backend._path(cc.params) == "mixed",
          "TOY logQ=11 EvalFloor is not on the card's mixed path")
    check(floor_ok(cc, sk, out, m, p), "TOY logQ=11 EvalFloor decryption")
    cc.device_clean()
    check(same(out, cc.eval_floor(ct, 1)), "TOY logQ=11 EvalFloor differs from the host oracle")

    fctx, fsk, _ = mixed_contexts(ParamSet.TOY, throws=(0,), arb_func=True)
    cc = fctx[0]
    ct, lut, want, p = func_inputs(cc, fsk, rng, 16)
    out = cc.eval_func(ct, lut)
    check(cc.backend.device.type == "cuda", "TOY logQ=11 EvalFunc is not on the card")
    check(np.array_equal(np.asarray(cc.decrypt(fsk, out, p), dtype=np.int64), want),
          "TOY logQ=11 EvalFunc decryption")
    cc.device_clean()
    check(same(out, cc.eval_func(ct, lut)), "TOY logQ=11 EvalFunc differs from the host oracle")
    log(f"TOY logQ=11 (N=1024, n=32, qKS=2^35): all 8 gates, EvalFloor (throw 1) and "
        f"EvalFunc (arbFunc, cube LUT) at B=16 decrypt right and equal the host oracle bit "
        f"for bit ({time.time() - t0:.1f} s)")


def std128_mixed(rng, card: str) -> None:
    """The mixed path at full width: `from_gpu_style(STD128, False, 11)`,
    N = 1024, n = 1305, Q = 134215681, q = 2048, qKS = 2^35, baseKS = 32,
    baseG = 2^5. EvalFloor at batch GATE_BATCH with one digit thrown
    (bench.py's floor row, d2 = 10) and the CHES 256-ciphertext AND with
    none (examples/ches_experiments.py, d2 = 12): every output decrypts
    right, the first 8 equal the host oracle bit for bit; a first and a
    warm EvalFloor are timed, and CHES_ITERS warm ANDs."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import Gate, ParamSet

    ctxs, sk, keygen_s = mixed_contexts(ParamSet.STD128)
    p = ctxs[0].params.lwe
    log(f"STD128 logQ=11: N={p.N} n={p.n} Q={p.Q} q={p.q} qKS=2^35 baseKS={p.base_ks} "
        f"baseG=2^5 (d2 12, and 10 with one digit thrown); host keygen (two bootstrapping "
        f"keys, one switching key) {keygen_s:.1f} s")
    floor_cc, and_cc = ctxs[1], ctxs[0]
    ct_f, m_f, p_f = floor_inputs(floor_cc, sk, rng, GATE_BATCH)
    m1, m2 = rng.integers(0, 2, CHES_BATCH), rng.integers(0, 2, CHES_BATCH)
    ct1, ct2 = and_cc.encrypt(sk, m1), and_cc.encrypt(sk, m2)
    t0 = time.time()
    for cc in ctxs.values():
        cc.device_clean()
    ref_f = floor_cc.eval_floor(head(ct_f), 1)
    ref_and = and_cc.eval_bin_gate(Gate.AND, head(ct1), head(ct2))
    log(f"host oracle EvalFloor and AND on 8 ciphertexts each {time.time() - t0:.1f} s")

    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    floor_cc.device_setup("cuda")
    and_cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup of both contexts (pack_bsk, one switching-key table) "
        f"{time.time() - t0:.1f} s, device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    for call in ("first", "warm"):
        t0 = time.time()
        out = floor_cc.eval_floor(ct_f, 1)
        s = time.time() - t0
        check(out.a.shape == (GATE_BATCH, p.n), f"EvalFloor output shape {out.a.shape}")
        check(floor_ok(floor_cc, sk, out, m_f, p_f),
              f"STD128 logQ=11 EvalFloor decryption at B={GATE_BATCH}")
        check(same(head(out), ref_f), "STD128 logQ=11 EvalFloor: first 8 outputs differ "
              "from the host oracle")
        log(f"STD128 logQ=11 EvalFloor B={GATE_BATCH} (throw 1) {call} call: all decrypt to "
            f"m // 2, first 8 equal the host oracle; {s:.4f} s = {s / GATE_BATCH * 1e3:.4f} "
            f"ms/ciphertext on {card}")

    out = and_cc.eval_bin_gate(Gate.AND, ct1, ct2)
    check(np.array_equal(and_cc.decrypt(sk, out), m1 & m2), "CHES AND decryption")
    check(same(head(out), ref_and), "CHES AND: first 8 outputs differ from the host oracle")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(CHES_ITERS):
        out = and_cc.eval_bin_gate(Gate.AND, ct1, ct2)
    s = (time.time() - t0) / CHES_ITERS
    check(np.array_equal(and_cc.decrypt(sk, out), m1 & m2), "CHES AND decryption (warm)")
    log(f"CHES AND B={CHES_BATCH} (STD128 logQ=11, no throw, d2=12): all decrypt to m1&m2, "
        f"first 8 equal the host oracle; {s * 1e3:.3f} ms/iteration over {CHES_ITERS} warm "
        f"iterations, {CHES_BATCH / s:.1f} gates/s on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def ring4096_kernels(rng, q1: int, q2: int, Q: int, peak: float) -> dict:
    """The three kernels at N = 4096 against their plain versions on the
    card, with tolerance 0: blind_rotate_rns (the two-block cluster) at
    every digit count at B = 5 over 8 rounds with throw 0, at the
    accelerated sets' d2 = 4 and 2 at B = 64 over 16 rounds, then at the
    main path's B = RING_BATCH, n = LWE_N_ACC, d2 = 4 and 2, the plain
    version on RING_ROWS and the last row; blind_rotate at Q (the logQ = 11
    set's 27-bit prime) at d2 in {2, 8, 12}, throw 0 and 1, B = 5 over 8
    rounds, then at the EvalFloor and NAND shape (B = RING_BATCH,
    n = LWE_N_ACC, base 2^5, one digit thrown, d2 = 10) the same way;
    blind_rotate64 (the two-block cluster) at the single prime
    ntt_prime(54, 8192) at d2 in {2, 4, 6, 8}, throw 0 and 1, B = 5 over 8
    rounds (its B = 64 cases are `rotate64_cases`' N = 4096 rows), then at
    the single-prime path's B = RING_BATCH, n = LWE_N_ACC, d2 = 4 (base
    2^18) and d2 = 2 (base 2^27), one digit thrown, the same way. Returns
    the full shapes' timings by kernel."""
    from tfhe_tpu_torch.ops import rotate64_kernel, rotate_rns_kernel
    from tfhe_tpu_torch.utils.numtheory import ntt_prime

    clusters = rotate_rns_kernel.max_active_clusters(RING_N)
    log(f"blind_rotate_rns at N={RING_N}: one ciphertext on a cluster of two blocks of "
        f"{RING_N // 8} threads, 56 N = {56 * RING_N // 1024} KB of shared memory each; "
        f"the card holds {clusters} such clusters at once (cudaOccupancyMaxActiveClusters)")
    for d2 in (2, 6, 8):
        rns_case(rng, q1, q2, peak, 5, 8, d2, RING_N, throw=0)
    for d2 in (4, 2):
        rns_case(rng, q1, q2, peak, 64, 16, d2, RING_N)
    rns = {f"d2={d2}": rns_case(rng, q1, q2, peak, RING_BATCH, LWE_N_ACC, d2, RING_N,
                                rows=RING_ROWS) for d2 in (4, 2)}
    rns["max_active_clusters"] = clusters
    for d2, base_g in ((2, 1 << 14), (8, 1 << 7), (12, 1 << 5)):
        for throw in (0, 1):
            gate_rows_case(rng, Q, peak, 5, 8, RING_N, d2, base_g, throw, [0, 1, 2, 3])
    gate = {"d2=10": gate_rows_case(rng, Q, peak, RING_BATCH, LWE_N_ACC, RING_N, 10,
                                    1 << 5, 1, RING_ROWS)}

    clusters = rotate64_kernel.max_active_clusters(RING_N)
    log(f"blind_rotate64 at N={RING_N}: one ciphertext on a cluster of two blocks of "
        f"{RING_N // 8} threads, 32 N = {32 * RING_N // 1024} KB of shared memory each; "
        f"the card holds {clusters} such clusters at once (cudaOccupancyMaxActiveClusters)")
    q54 = ntt_prime(54, 2 * RING_N)
    bases = {2: 1 << 27, 4: 1 << 18, 6: 1 << 14, 8: 1 << 9}
    for d2, base_g in bases.items():
        for throw in (0, 1):
            rotate64_case(rng, peak, f"N={RING_N}, Q54", RING_N, q54, base_g, d2, throw, 5, 8)
    key = rotate64_key(rng, q54, 4, LWE_N_ACC, RING_N)
    r64 = {f"d2={d2}": rotate64_case(rng, peak, f"N={RING_N}, Q54", RING_N, q54, bases[d2],
                                     d2, 1, RING_BATCH, LWE_N_ACC, RING_ROWS,
                                     fewer_digits(key, d2))
           for d2 in (4, 2)}
    del key
    r64["max_active_clusters"] = clusters
    return {"blind_rotate_rns": rns, "blind_rotate": gate, "blind_rotate64": r64}


def ring4096_contexts(rng) -> dict:
    """Ring dimension N = 4096 at full width: the STD128 accelerated sets
    `from_gpu_style(STD128, ..., N=4096)` (n = 1305, Q = q1*q2, qKS = 2^35,
    baseKS = 32, one digit thrown, bench.py's seeded switching key) for
    EvalSign (logQ 17, bases 2^18 and 2^27) and EvalFunc (logQ 12,
    arbFunc, the cube LUT), and the logQ = 11 set on the same LWE secret,
    ring secret and switching key for EvalFloor and NAND (base 2^5, one
    digit thrown, d2 = 10); keys made on the host, inputs at batch
    RING_BATCH. Returns the phase's state for `ring_path`."""
    import numpy as np

    from tfhe_tpu_torch import Gate, ParamSet

    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.STD128, seeded=True,
                                                          N=RING_N)
    key = sign_cc.bt_key
    mixed, _, mixed_keygen_s = mixed_contexts(ParamSet.STD128, throws=(1,), N=RING_N, sk=sk,
                                              shared={"sk_n": key.sk_n, "ksk": key.ksk})
    floor_cc = mixed[1]
    p, pm = sign_cc.params, floor_cc.params
    check(p.lwe.N == pm.lwe.N == RING_N and floor_cc.bt_key.ksk is key.ksk,
          "the N = 4096 contexts do not share one ring and switching key")
    log(f"N={RING_N}: accelerated STD128 n={p.lwe.n} Q={p.lwe.Q} = {p.rgsw.rns_primes[0]} * "
        f"{p.rgsw.rns_primes[1]}, logQ=11 Q={pm.lwe.Q} q={pm.lwe.q}, qKS=2^35, "
        f"baseKS={p.lwe.base_ks}; keygen (sign map 2^18, 2^27, the func context on its 2^27 "
        f"key, one seeded switching key, <A, s> on the card) {keygen_s:.1f} s, logQ=11 key "
        f"(base 2^5) "
        f"{mixed_keygen_s:.1f} s")
    timing = {"N": RING_N, "batch": RING_BATCH, "keygen_s": keygen_s,
              "mixed_keygen_s": mixed_keygen_s}

    B = RING_BATCH
    ct_s, delta = sign_inputs(sign_cc, sk, rng, B)
    ct_f, lut, want_f, p_f = func_inputs(func_cc, sk, rng, B)
    ct_fl, m_fl, p_fl = floor_inputs(floor_cc, sk, rng, B)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    ct1, ct2 = floor_cc.encrypt(sk, m1), floor_cc.encrypt(sk, m2)
    # name -> (context, run(context, inputs), inputs, right(outputs, rows):
    # which of the rows decrypt right, and whether the parameters' noise lets
    # some rows decrypt wrong)
    ops = {
        "EvalSign": (sign_cc, lambda c, x: c.eval_sign(x[0]), (ct_s,),
                     lambda out, r: sign_cc.decrypt(sk, out, 2) == (delta[r] >= 0), False),
        "EvalFunc": (func_cc, lambda c, x: c.eval_func(x[0], lut), (ct_f,),
                     lambda out, r: np.asarray(func_cc.decrypt(sk, out, p_f),
                                               dtype=np.int64) == want_f[r], False),
        "EvalFloor": (floor_cc, lambda c, x: c.eval_floor(x[0], 1), (ct_fl,),
                      lambda out, r: floor_right(floor_cc, sk, out, m_fl[r], p_fl), False),
        "NAND": (floor_cc, lambda c, x: c.eval_bin_gate(Gate.NAND, *x), (ct1, ct2),
                 lambda out, r: floor_cc.decrypt(sk, out) == 1 - (m1[r] & m2[r]), False),
    }
    return {"contexts": (sign_cc, func_cc, floor_cc), "key": key, "sk": sk, "ops": ops,
            "timing": timing}


def ring_path(state: dict, card: str) -> dict:
    """The contexts of `ring4096_contexts`, `ring8192_contexts` or
    `ring_rns_contexts` on the card (contexts on one bootstrapping key
    share one backend): device setup, the seeded table's spot rows held to
    the host threefry, then each operation at the batch of its inputs, a
    first and a warm call timed: every row decrypts right, except where the
    parameters' noise lets rows decrypt wrong (at most a third of them),
    whose count is logged; the contexts' device state is freed (a switching
    table stays with its key). Then the host oracle (its switching key the
    seeded A block, of which each key switch draws the rows it selects on
    the card, `SeededSwitchingKey.select_rows_on`, held to the host threefry
    on the same spot rows) on the first RING_HEAD rows of each
    operation in the state's "oracle" (all by default), or on the first row
    that decrypts wrong: the card's outputs equal it bit for bit, so that
    the oracle's output decrypts wrong there too."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import convert, lwe
    from tfhe_tpu_torch.ops import rotate64_kernel, rotate_kernel, rotate_rns_kernel

    def launches():
        return rotate_kernel.LAUNCHES + rotate_rns_kernel.LAUNCHES + rotate64_kernel.LAUNCHES

    contexts = state["contexts"]
    ops, timing = state["ops"], {"card": card, **state["timing"]}
    N, h, ksk = timing["N"], RING_HEAD, state["key"].ksk
    oracle_ops = state.get("oracle", tuple(ops))
    table = ("already on the card with its key" if "_device_tables" in ksk.__dict__
             else "regenerated on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    backends = {}
    for cc in contexts:
        if id(cc.bt_key) in backends:
            cc.use_backend(backends[id(cc.bt_key)])
        else:
            cc.device_setup("cuda")
            backends[id(cc.bt_key)] = cc.backend
    torch.cuda.synchronize()
    timing["device_setup_s"] = time.time() - t0
    timing["device_GiB"] = torch.cuda.memory_allocated() / 2**30
    log(f"N={N}: device_setup of the {len(contexts)} contexts ({len(backends)} backend(s): "
        f"their kernels' keys, one {ksk.rows} x {ksk.n + 1} float64 switching table "
        f"{table}) {timing['device_setup_s']:.1f} s, device memory "
        f"{timing['device_GiB']:.2f} GiB")
    spans = seeded_table_rows(ksk, convert.switching_table(ksk, contexts[0].backend.device))
    log(f"seeded switching table: rows {', '.join(f'{a}..{b - 1}' for a, b in spans)} equal "
        f"to the host threefry")
    outs, held = {}, {}
    for name, (cc, run, cts, right, noisy) in ops.items():
        B = cts[0].a.shape[0]
        t0 = time.time()
        out = run(cc, cts)
        first_s = time.time() - t0
        check(cc.backend.device.type == "cuda", f"N={N} {name} is not on the card")
        for o in out if isinstance(out, list) else [out]:
            check(o.a.shape == (B, cc.params.lwe.n), f"N={N} {name} output shape {o.a.shape}")
        wrong = np.nonzero(~right(out, slice(None)))[0]
        check(len(wrong) <= (B // 3 if noisy else 0),
              f"N={N} {name} decryption at B={B}: {len(wrong)} rows wrong")
        before, t0 = launches(), time.time()
        run(cc, cts)
        s = time.time() - t0
        outs[name], held[name] = out, wrong[:1] if len(wrong) else np.arange(h)
        timing[f"{name}_batch"] = B
        timing[f"{name}_launches"] = launches() - before
        timing[f"{name}_first_s"] = first_s
        timing[f"{name}_ms_per_ct"] = s / B * 1e3
        timing[f"{name}_rows_wrong"] = int(len(wrong))
        log(f"N={N} STD128 {name} B={B}: {B - len(wrong)} of {B} rows decrypt right"
            f"{f' ({100 * len(wrong) / B:.1f}% wrong, the first row {wrong[0]})' if len(wrong) else ''}"
            f"; first call {first_s:.3f} s; warm {s:.4f} s = {s / B * 1e3:.4f} ms/ciphertext, "
            f"{B / s:.1f} ops/s, {timing[f'{name}_launches']} rotation launches, on {card}")
    timing["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"N={N} peak device memory {timing['peak_device_GiB']:.2f} GiB on {card}")
    del backends
    for cc in contexts:
        cc.device_clean()
    torch.cuda.empty_cache()

    # the oracle's switching key: only the rows of the seeded A block that
    # each key switch selects, drawn on the card at each read (the whole
    # block is 38.3 GB at N = 16384), the drawn rows held to the host
    # threefry on the spot rows
    t0 = time.time()
    ksk.select_rows_on("cuda")
    check(all(np.array_equal(lwe.seeded_select(
        ksk.seed, ksk.n, ksk.q_ks, torch.arange(r0, r1), "cuda").cpu().numpy(),
        lwe.seeded_rows(ksk.seed, ksk.n, ksk.q_ks, r0, r1, "cpu").numpy()) for r0, r1 in spans),
        f"N={N}: the oracle's A rows differ from the host threefry")
    timing["host_A_s"] = time.time() - t0
    log(f"the seeded key's A block [{ksk.rows}, {ksk.n}] for the oracle: each key switch "
        f"draws the rows it selects on the card (SeededRows), the same rows as the host "
        f"threefry ({timing['host_A_s']:.1f} s)")
    t0 = time.time()
    for name, (cc, run, cts, _, _) in ops.items():
        if name not in oracle_ops:
            continue
        rows = held[name]
        ref = run(cc, [take(c, rows) for c in cts])
        check(same(take(outs[name], rows), ref),
              f"N={N} {name}: rows {rows.tolist()} differ from the host oracle")
        timing[f"{name}_oracle_rows"] = rows.tolist()
    timing["oracle_s"] = time.time() - t0
    log(f"N={N} host oracle on "
        f"{', '.join(f'{n} row(s) {held[n].tolist()}' for n in oracle_ops)}: the "
        f"card's outputs equal it bit for bit, so where the card's decrypt wrong the oracle's "
        f"do too ({timing['oracle_s']:.1f} s)")
    return timing


def ring_single_prime(rng, card: str, shared: dict, N: int) -> dict:
    """The single-prime path at ring N (4096 or 8192) on the card: the STD128
    accelerated sets `from_gpu_style(STD128, ..., N=N, rns_modulus=False)`
    (n = 1305, Q = ntt_prime(54, 2N), qKS = 2^35, baseKS = 32, one digit
    thrown) on the LWE secret, ring secret and seeded switching key of the
    RNS contexts at that ring (`shared`; the key's A block is already drawn
    for the host oracle), so that only the bootstrapping keys of bases 2^18
    and 2^27 are made. EvalSign (a first and a warm call) and EvalDecomp on
    the sign context (logQ 17, bases 2^18 and 2^27), EvalFunc (the cube LUT)
    on the func context (logQ 12, arbFunc), at batch PRIME_BATCH: every
    output decrypts right, the first RING_HEAD of EvalSign and EvalFunc
    equal the host oracle bit for bit. Each call's wall time and
    blind_rotate64's launches and device seconds in it are logged; returns
    them with the keygen, oracle and set-up seconds and the peak device
    memory."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import ParamSet, TorchBackend
    from tfhe_tpu_torch.ops import backend as backend_mod
    from tfhe_tpu_torch.utils.numtheory import ntt_prime

    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(
        ParamSet.STD128, rns_modulus=False, seeded=True, N=N, shared=shared)
    p = sign_cc.params
    check(p.lwe.N == N and p.lwe.Q == ntt_prime(54, 2 * N) and p.rgsw.rns_primes is None
          and all(TorchBackend._path(cc.params) == "two_limb" for cc in (sign_cc, func_cc))
          and func_cc.bt_key.ksk is sign_cc.bt_key.ksk is shared["ksk"],
          f"the N = {N} single-prime contexts are not two-limb sets on the shared keys")
    log(f"N={N} accelerated STD128, one prime: n={p.lwe.n} Q={p.lwe.Q} qKS=2^35 "
        f"baseKS={p.lwe.base_ks}; keygen (bootstrapping keys for bases 2^18 and 2^27, the "
        f"func context on the 2^27 one, on the RNS contexts' secrets and seeded switching "
        f"key) {keygen_s:.1f} s")
    timing = {"card": card, "N": N, "batch": PRIME_BATCH, "Q": p.lwe.Q,
              "keygen_s": keygen_s}

    B, h = PRIME_BATCH, RING_HEAD
    ct_s, delta = sign_inputs(sign_cc, sk, rng, B)
    ct_d, m_d, p_d, P_d = decomp_inputs(sign_cc, sk, rng, B)
    ct_f, lut, want_f, p_f = func_inputs(func_cc, sk, rng, B)
    t0 = time.time()
    for cc in (sign_cc, func_cc):
        cc.device_clean()
    ref = {"EvalSign": sign_cc.eval_sign(head(ct_s, h)),
           "EvalFunc": func_cc.eval_func(head(ct_f, h), lut)}
    timing["oracle_s"] = time.time() - t0
    log(f"N={N} single-prime host oracle EvalSign and EvalFunc on the first {h} of each "
        f"{timing['oracle_s']:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for cc in (sign_cc, func_cc):
        cc.device_setup("cuda")
    torch.cuda.synchronize()
    timing["device_setup_s"] = time.time() - t0
    log(f"N={N} single-prime device_setup of both contexts (pack_bsk64 on the card, the "
        f"shared switching table) "
        f"{timing['device_setup_s']:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    sign_ok = lambda out: np.array_equal(sign_cc.decrypt(sk, out, 2),  # noqa: E731
                                         (delta >= 0).astype(np.uint64))
    # (name, call, run, check of the outputs); the first EvalSign also
    # converts and uploads the second gadget base's key
    calls = [
        ("EvalSign", "first", lambda: sign_cc.eval_sign(ct_s), sign_ok),
        ("EvalSign", "warm", lambda: sign_cc.eval_sign(ct_s), sign_ok),
        ("EvalDecomp", "first", lambda: sign_cc.eval_decomp(ct_d),
         lambda out: decomp_ok(sign_cc, sk, out, m_d, p_d, P_d)),
        ("EvalFunc", "first", lambda: func_cc.eval_func(ct_f, lut),
         lambda out: np.array_equal(
             np.asarray(func_cc.decrypt(sk, out, p_f), dtype=np.int64), want_f)),
    ]
    for name, call, run, ok in calls:
        with KernelClock(backend_mod, "rotate64") as clock:
            t0 = time.time()
            out = run()
            wall = time.time() - t0
            kernel_s = clock.ms() / 1e3
        check(sign_cc.backend.device.type == "cuda" and func_cc.backend.device.type == "cuda",
              f"N={N} single-prime {name} is not on the card")
        check(ok(out), f"N={N} single-prime {name} decryption at B={B}")
        if name in ref:
            check(same(head(out, h), ref[name]), f"N={N} single-prime {name}: the first "
                  f"{h} outputs differ from the host oracle")
        key = f"{name}_{call}"
        timing[f"{key}_ms_per_ct"] = wall / B * 1e3
        timing[f"{key}_kernel_s"] = kernel_s
        timing[f"{key}_launches"] = len(clock.events)
        log(f"N={N} single-prime {name} B={B} {call} call: all decrypt right"
            f"{f', the first {h} equal the host oracle bit for bit' if name in ref else ''}; "
            f"wall {wall:.4f} s = {wall / B * 1e3:.4f} ms/ciphertext; blind_rotate64 "
            f"{kernel_s:.4f} s in {len(clock.events)} launches; outside it (wall - kernel) "
            f"{wall - kernel_s:.4f} s ({100 * (wall - kernel_s) / wall:.1f}%) on {card}")
    timing["peak_device_GiB"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"N={N} single-prime peak device memory {timing['peak_device_GiB']:.2f} GiB")
    return timing


def ring8192_kernels(rng, peak: float) -> dict:
    """blind_rotate at N = 8192 (a cluster of two blocks of 512 threads per
    ciphertext) against its plain version on the card, with tolerance 0:
    every N = 8192 case of `gate_cases` (RING8192_Q, d2 2, 8 and 12, throw 0
    and 1) at B = 5 over 8 rounds, rows 0, 1 and 2 of the exponents 0, N and
    2N - 1; then the path's shapes, B = RING8192_BATCH, n = LWE_N_ACC, base
    2^5: d2 = 10 (one digit thrown: NAND, EvalFloor) and d2 = 12 (none:
    EvalFunc), the plain version on RING_ROWS and the last row. Logs the
    card's resident clusters and
    ptxas's registers and spills; returns the full shapes' timings."""
    from tfhe_tpu_torch.ops import rotate_kernel

    N, Q = RING8192_N, RING8192_Q
    clusters = rotate_kernel.max_active_clusters()
    resources = kernel_resources("blind_rotate", 13)
    log(f"blind_rotate at N={N}: one ciphertext on a cluster of two blocks of {N // 16} "
        f"threads, 28 N = {28 * N // 1024} KB of shared memory each; ptxas: {resources}; "
        f"the card holds {clusters} such clusters at once (cudaOccupancyMaxActiveClusters)")
    for Nc, Qc, d2, base_g, throw in gate_cases():
        if Nc == N:
            gate_rows_case(rng, Qc, peak, 5, 8, N, d2, base_g, throw, [0, 1, 2, 3])
    out = {"max_active_clusters": clusters, "ptxas": resources}
    for d2, throw in ((10, 1), (12, 0)):
        out[f"d2={d2}"] = gate_rows_case(rng, Q, peak, RING8192_BATCH, LWE_N_ACC, N, d2,
                                         1 << 5, throw, RING_ROWS)
    return out


def ring8192_rns_kernels(rng, peak: float) -> dict:
    """blind_rotate_rns at N = 8192 (a cluster of four blocks of 512 threads
    a ciphertext, two a residue lane) against its plain version on the card
    at the accelerated sets' primes there, with tolerance 0 (`rns_case`):
    every d2 in {2, 4, 6, 8} with throw 0 and 1 at B = 5 over 8 rounds, rows
    0, 1 and 2 of the exponents 0, N and 2N - 1; d2 = 4 and 2 at B = 64 over
    16 rounds; then the path's shapes, B = RING8192_BATCH, n = LWE_N_ACC,
    one digit thrown, d2 = 4 (base 2^18) and d2 = 2 (base 2^27: EvalFunc;
    EvalSign uses both bases), the plain version on
    RING_ROWS and the last row. Logs the card's resident clusters and
    ptxas's registers and spills; returns the full shapes' timings."""
    from tfhe_tpu_torch import ParamSet, from_gpu_style
    from tfhe_tpu_torch.ops import rotate_rns_kernel

    N = RING8192_N
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12, N=N).rgsw.rns_primes
    check(q1 == RING8192_Q, f"the N = {N} sets' first prime is {q1}, not {RING8192_Q}")
    clusters = rotate_rns_kernel.max_active_clusters(N)
    resources = kernel_resources("blind_rotate_rns", 13)
    log(f"blind_rotate_rns at N={N} (q1={q1}, q2={q2}): one ciphertext on a cluster of four "
        f"blocks of {N // 16} threads, two a residue lane, 22 N = {22 * N // 1024} KB of "
        f"shared memory each; ptxas: {resources}; the card holds {clusters} such clusters at "
        f"once (cudaOccupancyMaxActiveClusters)")
    for d2 in (2, 4, 6, 8):
        for throw in (0, 1):
            rns_case(rng, q1, q2, peak, 5, 8, d2, N, throw=throw)
    for d2 in (4, 2):
        rns_case(rng, q1, q2, peak, 64, 16, d2, N)
    out = {"max_active_clusters": clusters, "ptxas": resources}
    for d2 in (4, 2):
        out[f"d2={d2}"] = rns_case(rng, q1, q2, peak, RING8192_BATCH, LWE_N_ACC, d2, N,
                                   rows=RING_ROWS)
    return out


def ring16384_refusals() -> None:
    """At N = 16384 only the RNS sets run: the single 54-bit prime and the
    logQ = 11 sets there, and every set at N = 32768, raise
    NotImplementedError in the card's backend set-up, before any key is
    read."""
    from tfhe_tpu_torch import ParamSet, TorchBackend, from_gpu_style

    be = TorchBackend("cuda")
    check(be.supports(from_gpu_style(ParamSet.STD128, True, 12, N=RING16384_N)),
          f"the RNS sets at N = {RING16384_N} are not supported")
    refused = []
    for N in (RING16384_N, 2 * RING16384_N):
        refused.append((f"the single prime at N={N}", from_gpu_style(
            ParamSet.STD128, False, 17, N=N, rns_modulus=False)))
        for log_q, arb in ((11, False), (12, True), (17, False), (23, False)):
            if N > RING16384_N or log_q == 11:
                refused.append((f"logQ {log_q} at N={N}",
                                from_gpu_style(ParamSet.STD128, arb, log_q, N=N)))
    for name, params in refused:
        check(not be.supports(params), f"{name} is supported")
        try:
            be.setup(params, None)
        except NotImplementedError:
            continue
        check(False, f"{name}: the backend's set-up did not raise NotImplementedError")
    log(f"N={RING16384_N} refusals: {', '.join(name for name, _ in refused)} raise "
        "NotImplementedError in TorchBackend('cuda').setup")


def ring16384_rns_kernels(rng, peak: float) -> dict:
    """blind_rotate_rns at N = 16384 (a cluster of eight blocks of 512
    threads a ciphertext, four a residue lane) against its plain version on
    the card at the accelerated sets' primes there, with tolerance 0
    (`rns_case`): every d2 in {2, 4, 6, 8} with throw 0 and 1 at B = 5 over
    8 rounds, rows 0, 1 and 2 of the exponents 0, N and 2N - 1; d2 = 4 and
    2 at B = 64 over 16 rounds; then the full shapes, B =
    RING16384_KERNEL_BATCH, n = LWE_N_ACC, one digit thrown, d2 = 4 (base
    2^18) and d2 = 2 (base 2^27), the plain version on RING_ROWS and the
    last row. Logs the card's resident clusters and ptxas's registers and
    spills; returns the full shapes' timings."""
    from tfhe_tpu_torch import ParamSet, from_gpu_style
    from tfhe_tpu_torch.ops import rotate_rns_kernel

    N = RING16384_N
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12, N=N).rgsw.rns_primes
    check((q1, q2) == RING16384_Q, f"the N = {N} sets' primes are {q1}, {q2}, not "
          f"{RING16384_Q}")
    clusters = rotate_rns_kernel.max_active_clusters(N)
    resources = kernel_resources("blind_rotate_rns", 14)
    log(f"blind_rotate_rns at N={N} (q1={q1}, q2={q2}): one ciphertext on a cluster of eight "
        f"blocks of {N // 32} threads, four a residue lane, 11 N = {11 * N // 1024} KB of "
        f"shared memory each; ptxas: {resources}; the card holds {clusters} such clusters at "
        f"once (cudaOccupancyMaxActiveClusters)")
    for d2 in (2, 4, 6, 8):
        for throw in (0, 1):
            rns_case(rng, q1, q2, peak, 5, 8, d2, N, throw=throw)
    for d2 in (4, 2):
        rns_case(rng, q1, q2, peak, 64, 16, d2, N)
    out = {"max_active_clusters": clusters, "ptxas": resources}
    for d2 in (4, 2):
        out[f"d2={d2}"] = rns_case(rng, q1, q2, peak, RING16384_KERNEL_BATCH, LWE_N_ACC, d2,
                                   N, rows=RING_ROWS)
    return out


def ring8192_r64_kernels(rng, peak: float) -> dict:
    """blind_rotate64 at N = 8192 (a cluster of four blocks of 512 threads
    a ciphertext, two a polynomial) against its plain version on the card
    at the single prime there, ntt_prime(54, 16384), with tolerance 0
    (`rotate64_case`): every N = 8192 case of `rotate64_cases` (bases 2^18
    and 2^27 with one digit thrown, 2^9 with three kept digits and none) at
    B = 5 over 8 rounds, rows 0, 1 and 2 of the exponents 0, N and 2N - 1;
    then the path's shapes, B = RING8192_BATCH, n = LWE_N_ACC, one digit
    thrown, d2 = 4 (base 2^18) and d2 = 2 (base 2^27), on one card-drawn
    key, the plain version on RING_ROWS and the last row. Logs the card's
    resident clusters and ptxas's registers and spills; returns the full
    shapes' timings."""
    from tfhe_tpu_torch.ops import rotate64_kernel

    N = RING8192_N
    cases = {k: v for k, v in rotate64_cases().items() if v[0] == N}
    clusters = rotate64_kernel.max_active_clusters(N)
    resources = kernel_resources("blind_rotate64", 13)
    log(f"blind_rotate64 at N={N}: one ciphertext on a cluster of four blocks of {N // 16} "
        f"threads, two a polynomial, 24 N = {24 * N // 1024} KB of shared memory each; "
        f"ptxas: {resources}; the card holds {clusters} such clusters at once "
        f"(cudaOccupancyMaxActiveClusters)")
    for name, case in cases.items():
        rotate64_case(rng, peak, name, *case, 5, 8)
    out = {"max_active_clusters": clusters, "ptxas": resources}
    _, Q, _, _, throw = cases["N=8192, Q54, base 2^18"]
    key = rotate64_key(rng, Q, 4, LWE_N_ACC, N)
    for d2, base_log in ((4, 18), (2, 27)):
        out[f"d2={d2}"] = rotate64_case(rng, peak, f"N={N}, Q54, base 2^{base_log}", N, Q,
                                        1 << base_log, d2, throw, RING8192_BATCH, LWE_N_ACC,
                                        RING_ROWS, fewer_digits(key, d2))
    return out


def ring8192_contexts(rng) -> dict:
    """Ring dimension N = 8192 at full width on the mixed logQ = 11 path:
    `from_gpu_style(STD128, False, 11, N=8192)` (n = 1305, Q = RING8192_Q,
    q = 16384, qKS = 2^35, baseKS = 32, base 2^5, one digit thrown: d2 =
    10) with bench.py's seeded switching key for NAND and EvalFloor, and
    `from_gpu_style(STD128, True, 11, N=8192)` (arbFunc, q = 8192, one digit
    thrown) on the same keys (the bootstrapping key does not depend on q)
    for EvalFunc (the cube LUT); keys made on the host, inputs at batch
    RING8192_BATCH. At this ring Q stays 27 bits while q doubles, and the
    bootstraps' output noise, about 67 in units of q = 16384 against 25 at
    N = 4096 (an H100 run at B = 1024), makes some rows of EvalFloor and
    EvalFunc, whose second bootstraps need it below beta = 128, decrypt
    wrong: `ring_path` holds the first such row to the host oracle. Returns
    the phase's state for `ring_path`."""
    import numpy as np

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet

    N, B = RING8192_N, RING8192_BATCH
    free = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout
    log(f"host memory (free -g) before the N={N} keys:\n{free.rstrip()}")
    mixed, sk, keygen_s = mixed_contexts(ParamSet.STD128, throws=(1,), N=N, seeded=True)
    floor_cc = mixed[1]
    key = floor_cc.bt_key
    func_cc = BinFHEContext(seed=SEED + 2, seeded_ksk=True)
    func_cc.generate_binfhe_context(ParamSet.STD128, arb_func=True, log_q=11, N=N,
                                    num_digits_to_throw=1)
    p, pf = floor_cc.params, func_cc.params
    check((p.rgsw.N, p.rgsw.Q, p.rgsw.base_g, p.rgsw.num_digits_to_throw, p.lwe.n)
          == (pf.rgsw.N, pf.rgsw.Q, pf.rgsw.base_g, pf.rgsw.num_digits_to_throw, pf.lwe.n)
          and p.lwe.Q == RING8192_Q, f"the N = {N} arbFunc context cannot take the key")
    func_cc.bt_key_load(key)
    log(f"N={N} STD128 logQ=11: n={p.lwe.n} Q={p.lwe.Q} q={p.lwe.q} (arbFunc {pf.lwe.q}) "
        f"qKS=2^35 baseKS={p.lwe.base_ks} base 2^5, one digit thrown (d2 = 10); keygen (one "
        f"bootstrapping key for both contexts, one seeded switching key, <A, s> on the "
        f"card) {keygen_s:.1f} s")
    timing = {"N": N, "batch": B, "keygen_s": keygen_s}

    ct_fl, m_fl, p_fl = floor_inputs(floor_cc, sk, rng, B)
    m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
    ct1, ct2 = floor_cc.encrypt(sk, m1), floor_cc.encrypt(sk, m2)
    ct_f, lut, want_f, p_f = func_inputs(func_cc, sk, rng, B)
    ops = {
        "NAND": (floor_cc, lambda c, x: c.eval_bin_gate(Gate.NAND, *x), (ct1, ct2),
                 lambda out, r: floor_cc.decrypt(sk, out) == 1 - (m1[r] & m2[r]), False),
        "EvalFloor": (floor_cc, lambda c, x: c.eval_floor(x[0], 1), (ct_fl,),
                      lambda out, r: floor_right(floor_cc, sk, out, m_fl[r], p_fl), True),
        "EvalFunc": (func_cc, lambda c, x: c.eval_func(x[0], lut), (ct_f,),
                     lambda out, r: np.asarray(func_cc.decrypt(sk, out, p_f),
                                               dtype=np.int64) == want_f[r], True),
    }
    return {"contexts": (floor_cc, func_cc), "key": key, "sk": sk, "ops": ops,
            "timing": timing}


def ring_rns_contexts(rng, N: int, B: int, decomp_B: int, shared: dict | None = None) -> dict:
    """Ring dimension N (8192 or 16384) on the RNS path: the STD128
    accelerated sets `from_gpu_style(STD128, ..., N=N)` (n = 1305, Q = q1*q2
    of 54 bits: 133857281 * 133644289 at 8192, 133857281 * 132710401 at
    16384; qKS = 2^35, baseKS = 32, one digit thrown, bench.py's seeded
    switching key). With `shared`, on the LWE secret, ring secret and
    switching key of the logQ = 11 contexts at this ring (the key's device
    table is made once for both phases), so that only the bootstrapping keys
    of bases 2^18 and 2^27 are made; without, every key is made here.
    EvalSign (logQ 17, q = 2N) and EvalFunc (logQ 12, arbFunc, q = N, the
    cube LUT) at batch B, every row right and the first held to the host
    oracle; EvalDecomp on a logQ = 23 context on the sign context's
    bootstrapping keys at batch decomp_B, every row's digits right. Returns
    the phase's state for `ring_path`."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, ParamSet

    if shared is None:
        free = subprocess.run(["free", "-g"], capture_output=True, text=True).stdout
        log(f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB in use and host "
            f"memory (free -g) before the N={N} keys:\n{free.rstrip()}")
    sign_cc, func_cc, sk, keygen_s = accelerated_contexts(ParamSet.STD128, seeded=True, N=N,
                                                          shared=shared)
    decomp_cc = BinFHEContext(seed=SEED + 3, seeded_ksk=True)
    decomp_cc.generate_binfhe_context(ParamSet.STD128, arb_func=False, log_q=23, N=N,
                                      num_digits_to_throw=1, time_optimization=True)
    p, pd = sign_cc.params, decomp_cc.params
    check((p.rgsw.N, p.rgsw.Q, p.rgsw.base_g, p.lwe.n, p.lwe.q)
          == (pd.rgsw.N, pd.rgsw.Q, pd.rgsw.base_g, pd.lwe.n, pd.lwe.q)
          and func_cc.bt_key.ksk is sign_cc.bt_key.ksk
          and (shared is None or sign_cc.bt_key.ksk is shared["ksk"]),
          f"the N = {N} RNS contexts are not on one ring and the shared keys")
    for base in sorted(sign_cc.bt_key_map, key=lambda b: b == pd.rgsw.base_g):
        decomp_cc.bt_key_load(sign_cc.bt_key_map[base])
    made = ("on the logQ=11 contexts' secrets and seeded switching key" if shared
            else "the LWE and ring secrets and the seeded switching key made here too, "
                 "<A, s> on the card")
    log(f"N={N} accelerated STD128: n={p.lwe.n} Q={p.lwe.Q} = {p.rgsw.rns_primes[0]} * "
        f"{p.rgsw.rns_primes[1]}, q={p.lwe.q} (arbFunc {func_cc.params.lwe.q}), qKS=2^35, "
        f"baseKS={p.lwe.base_ks}; keygen (bootstrapping keys for bases 2^18 and 2^27, the "
        f"func and decomp contexts on them, {made}) {keygen_s:.1f} s")
    timing = {"N": N, "batch": B, "keygen_s": keygen_s}

    ct_s, delta = sign_inputs(sign_cc, sk, rng, B)
    ct_f, lut, want_f, p_f = func_inputs(func_cc, sk, rng, B)
    ct_d, m_d, p_d, P_d = decomp_inputs(decomp_cc, sk, rng, decomp_B)
    ops = {
        "EvalSign": (sign_cc, lambda c, x: c.eval_sign(x[0]), (ct_s,),
                     lambda out, r: sign_cc.decrypt(sk, out, 2) == (delta[r] >= 0), False),
        "EvalFunc": (func_cc, lambda c, x: c.eval_func(x[0], lut), (ct_f,),
                     lambda out, r: np.asarray(func_cc.decrypt(sk, out, p_f),
                                               dtype=np.int64) == want_f[r], False),
        "EvalDecomp": (decomp_cc, lambda c, x: c.eval_decomp(x[0]), (ct_d,),
                       lambda out, r: decomp_rows(decomp_cc, sk, out, m_d[r], p_d, P_d),
                       False),
    }
    return {"contexts": (sign_cc, func_cc, decomp_cc), "key": sign_cc.bt_key, "sk": sk,
            "ops": ops, "timing": timing, "oracle": ("EvalSign", "EvalFunc")}


def gemm(rng, card: str) -> None:
    """CiphertextMulMatrix on the card at examples/gemm.py's config: TOY
    logQ 12 ciphertexts (n = 32) mod qKS = 2^35, K = M = GEMM_DIM, a matrix
    in [-100, 100]; element for element against the host product, one
    big-int spot check, and the warm time. Then a ragged shape (K = 5,
    M = 3) that `torch._int_mm` takes only padded."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, ParamSet
    from tfhe_tpu_torch.ops import lweops

    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12)
    sk = cc.key_gen()
    mod, K = cc.params.lwe.q_ks, GEMM_DIM
    p = cc.get_max_plaintext_space()
    cts = cc.encrypt(sk, np.arange(K) % p, "FRESH", p, mod)
    matrix = rng.integers(-100, 101, (K, K))
    t0 = time.time()
    want = lweops.ciphertext_mul_matrix(cts, matrix, mod)
    host_s = time.time() - t0
    t0 = time.time()
    out = cc.ciphertext_mul_matrix(cts, matrix, mod)      # no keys: on the context's card
    first_s = time.time() - t0
    check(np.array_equal(out.a, want.a) and np.array_equal(out.b, want.b),
          "GEMM differs from the host product")
    j = 7
    check(int(out.b[j]) == sum(int(matrix[k, j]) * int(cts.b[k]) for k in range(K)) % mod
          and int(out.a[j, 0]) == sum(int(matrix[k, j]) * int(cts.a[k, 0])
                                      for k in range(K)) % mod, "GEMM big-int spot check")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(GEMM_ITERS):
        cc.ciphertext_mul_matrix(cts, matrix, mod)
    s = (time.time() - t0) / GEMM_ITERS
    small = type(cts)(cts.a[:5], cts.b[:5], mod)
    got = lweops.ciphertext_mul_matrix_device(small, matrix[:5, :3], mod, "cuda")
    ref = lweops.ciphertext_mul_matrix(small, matrix[:5, :3], mod)
    check(np.array_equal(got.a, ref.a) and np.array_equal(got.b, ref.b),
          "GEMM K=5, M=3 differs from the host product")
    log(f"GEMM {K}x{K} mod 2^35 (n+1=33): equal to the host product element for element, "
        f"big-int spot check right, K=5 M=3 equal too; host {host_s:.3f} s, card first "
        f"call {first_s:.4f} s, warm {s * 1e3:.3f} ms/call over {GEMM_ITERS} (host clock, "
        f"limb split and copies included) on {card}")


def std128_ap_nand(rng, card: str) -> None:
    """DM at full width: STD128_AP (N = 1024, n = 512, q = 1024, baseR = 32,
    digitsR = 2, baseG = 2^9, d2 = 6, qKS = 2^14, baseKS = 128) NAND at batch
    DM_BATCH: every output decrypts, the first 8 equal the host oracle; a
    first and a warm call timed, with the peak device memory."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, Gate, Method, ParamSet

    t0 = time.time()
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.STD128_AP, Method.AP)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    p = cc.params.lwe
    log(f"STD128_AP: N={p.N} n={p.n} q={p.q} Q={p.Q} baseR={cc.params.rgsw.base_r} "
        f"digitsR={len(cc.params.rgsw.digits_r)} d2={2 * cc.params.rgsw.digits_g} "
        f"qKS={p.q_ks} baseKS={p.base_ks}; host keygen {time.time() - t0:.1f} s")
    m1, m2 = rng.integers(0, 2, DM_BATCH), rng.integers(0, 2, DM_BATCH)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    t0 = time.time()
    cc.device_clean()
    ref = cc.eval_bin_gate(Gate.NAND, head(ct1), head(ct2))
    log(f"host oracle NAND on 8 ciphertexts {time.time() - t0:.1f} s")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    table = cc.backend._device_key(cc.params, cc.bt_key)["dm_table"]
    log(f"device_setup (DM table {tuple(table.shape)} int32, switching-key table) "
        f"{time.time() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check(cc.backend._path(cc.params) == "dm", "STD128_AP does not take the DM path")
    for call in ("first", "warm"):
        t0 = time.time()
        out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        s = time.time() - t0
        check(np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)), "STD128_AP NAND decryption")
        check(same(head(out), ref), "STD128_AP NAND: first 8 outputs differ from the oracle")
        log(f"STD128_AP NAND B={DM_BATCH} {call} call: all decrypt to 1-(m1&m2), first 8 "
            f"equal the host oracle; {s:.4f} s, {DM_BATCH / s:.1f} bootstraps/s on {card}")
    log(f"STD128_AP NAND peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def ckks_contexts():
    """bench.py's run_ckks configuration in the port: CKKSParams(N=4096,
    DCRTParams.create(4096, 8, 28), scale 2^28), seed 20260817, hybrid keys
    with dnum = 3 and 28-bit special limbs (one full-chain relin key and the
    rotation-by-1 Galois key), on the card. Returns (ctx, rctx, dctx, sk,
    pk, rlk, gk)."""
    from tfhe_tpu_torch.pke import (CKKSContext, CKKSDeviceContext, CKKSParams,
                                    CKKSRnsContext, DCRTParams)

    p = CKKSParams(N=CKKS_N, dcrt=DCRTParams.create(CKKS_N, CKKS_L, CKKS_BITS),
                   scale=float(1 << CKKS_BITS))
    ctx = CKKSContext(p, seed=CKKS_SEED)
    sk, pk = ctx.key_gen()
    rctx = CKKSRnsContext(ctx, dnum=3, ks_limb_bits=CKKS_BITS)
    rlk = rctx.relin_key_gen_single(sk)
    gk = rctx.galois_key_gen_single(sk, 1)
    dctx = CKKSDeviceContext(rctx)
    dctx.load_relin_keys(rlk)
    dctx.load_galois_keys(1, gk)
    return ctx, rctx, dctx, sk, pk, rlk, gk


def ckks(rng, card: str, contexts) -> dict:
    """Device CKKS at full width (`ckks_contexts`, passed in): eval_mult at each batch
    of CKKS_BATCHES, eval_rotate and a hoisted rotation by one slot at batch
    8, eval_add and eval_sub; every tower on the card, every slot of every
    result within 1e-3 of its expected value, the first and last ciphertext
    of each result torch.equal to the host CKKSRnsContext. Returns the
    timings (CUDA events over CKKS_ITERS warm calls)."""
    import numpy as np
    import torch

    ctx, rctx, dctx, sk, pk, rlk, gk = contexts
    p = ctx.params
    log(f"CKKS N={p.N} L={p.dcrt.L} ({CKKS_BITS}-bit limbs) dnum=3, PQ limbs "
        f"{len(rlk.pq_params.moduli)}, groups {rlk.groups}")
    t0 = time.time()
    zs = [rng.uniform(0.1, 0.9, p.slots) for _ in range(max(CKKS_BATCHES))]
    cts = [ctx.encrypt(pk, z) for z in zs]
    log(f"CKKS: {len(cts)} encryptions on the host {time.time() - t0:.1f} s")

    def on_card(dct) -> bool:
        return dct.c0.is_cuda and dct.c1.is_cuda

    def holds(dct, want, host_fn, what: str) -> None:
        """Every slot of dct within 1e-3 of want(b); ciphertexts 0 and B-1
        torch.equal to host_fn(b)."""
        check(on_card(dct), f"CKKS {what}: towers not on the card")
        outs = dctx.download_batch(dct)
        err = max(np.abs(ctx.decrypt(sk, o) - want(b)).max() for b, o in enumerate(outs))
        check(err < 1e-3, f"CKKS {what}: decryption error {err}")
        for b in (0, len(outs) - 1):
            host = host_fn(b)
            check(host.scale == dct.scale, f"CKKS {what}: scale differs from the host")
            for i, poly in enumerate(host.polys):
                tower = torch.from_numpy(poly.to_eval().rns.astype(np.int64))
                check(torch.equal((dct.c0, dct.c1)[i][:, b].cpu(), tower),
                      f"CKKS {what}: ciphertext {b} differs from the host CKKSRnsContext")
        log(f"CKKS {what}: {len(outs)} ciphertexts on the card, every slot within "
            f"{err:.2e} of the expected value, ciphertexts 0 and {len(outs) - 1} "
            "torch.equal to the host CKKSRnsContext")

    out = {"card": card, "N": p.N, "L": p.dcrt.L, "dnum": 3}
    for B in CKKS_BATCHES:
        d = dctx.upload_batch(cts[:B])
        check(on_card(d) and tuple(d.c0.shape) == (p.dcrt.L, B, p.N),
              "CKKS upload_batch: towers not [L, B, N] on the card")
        t0 = time.time()
        prod = dctx.eval_mult(d, d)
        torch.cuda.synchronize()
        first = time.time() - t0
        holds(prod, lambda b: zs[b] ** 2,
              lambda b: rctx.eval_mult(cts[b], cts[b], rlk), f"eval_mult B={B}")
        ms = cuda_ms(lambda: dctx.eval_mult(d, d), CKKS_ITERS)
        out[f"mult_ms_per_ctx_B{B}"] = ms / B
        log(f"CKKS eval_mult B={B}: first call {first:.4f} s, warm {ms:.3f} ms a call, "
            f"{ms / B:.4f} ms/ctx on {card}")
    B = CKKS_BATCHES[0]
    d = dctx.upload_batch(cts[:B])
    rot = dctx.eval_rotate(d, 1)
    holds(rot, lambda b: np.roll(zs[b], -1),
          lambda b: rctx.eval_rotate(cts[b], 1, gk), f"eval_rotate B={B}")
    pre = dctx.rotation_precompute(d)
    hoisted = dctx.eval_rotate_hoisted(d, 1, pre)
    check(torch.equal(hoisted.c0, rot.c0) and torch.equal(hoisted.c1, rot.c1),
          "CKKS hoisted rotation differs from eval_rotate")
    holds(hoisted, lambda b: np.roll(zs[b], -1),
          lambda b: rctx.eval_rotate_hoisted(cts[b], 1, gk, rctx.rotation_precompute(cts[b], gk)),
          f"eval_rotate_hoisted B={B}")
    e = cts[B:2 * B]
    d2 = dctx.upload_batch(e)
    holds(dctx.eval_add(d, d2), lambda b: zs[b] + zs[B + b],
          lambda b: rctx.eval_add(cts[b], e[b]), f"eval_add B={B}")
    diff = dctx.eval_sub(d, d2)
    check(on_card(diff), "CKKS eval_sub: towers not on the card")
    err = max(np.abs(ctx.decrypt(sk, o) - (zs[b] - zs[B + b])).max()
              for b, o in enumerate(dctx.download_batch(diff)))
    check(err < 1e-3, f"CKKS eval_sub: decryption error {err}")
    back = dctx.eval_add(diff, d2)
    check(torch.equal(back.c0, d.c0) and torch.equal(back.c1, d.c1),
          "CKKS eval_sub then eval_add does not give the input back")
    log(f"CKKS eval_sub B={B}: every slot within {err:.2e}; adding back gives the input")
    out[f"rotate_ms_B{B}"] = cuda_ms(lambda: dctx.eval_rotate(d, 1), CKKS_ITERS)
    out[f"precompute_ms_B{B}"] = cuda_ms(lambda: dctx.rotation_precompute(d), CKKS_ITERS)
    out[f"hoisted_rotate_ms_B{B}"] = cuda_ms(lambda: dctx.eval_rotate_hoisted(d, 1, pre),
                                             CKKS_ITERS)
    out[f"add_ms_B{B}"] = cuda_ms(lambda: dctx.eval_add(d, d2), CKKS_ITERS)
    log(f"CKKS B={B}: eval_rotate {out[f'rotate_ms_B{B}']:.3f} ms, rotation_precompute "
        f"{out[f'precompute_ms_B{B}']:.3f} ms, eval_rotate_hoisted "
        f"{out[f'hoisted_rotate_ms_B{B}']:.3f} ms, eval_add {out[f'add_ms_B{B}']:.3f} ms "
        f"a call on {card}")
    return out


def exhausted(ctx, pk, z):
    """z encrypted on the host and dropped to one limb (a bootstrap's
    input), as bench.py's run_ckksboot does."""
    from tfhe_tpu_torch.pke.ckks_boot import mult_const

    ct = ctx.encrypt(pk, z)
    while ct.level_params.L > 1:
        ct = ctx.rescale(mult_const(ctx, ct, 1.0, rescale=False))
    return ct


def ckksboot_contexts():
    """bench.py's run_ckksboot configuration in the port: CKKSParams(N=1024,
    DCRTParams.create(1024, 18, 30), scale 2^30) with 18 = bootstrap_depth
    + 2, seed 20260818, a sparse ternary secret of weight 64, hybrid keys
    with dnum = 3 and 28-bit special limbs, eval_bootstrap_setup_fft with
    level budget (2, 2), K = 28 and Chebyshev degree 44, and the FFT
    bootstrap's relin and Galois keys. Returns (ctx, sk, pk, bd)."""
    from tfhe_tpu_torch.pke import (CKKSBootstrapFFTDevice, CKKSContext, CKKSParams,
                                    CKKSRnsContext, DCRTParams, bootstrap_depth,
                                    eval_bootstrap_setup_fft)

    L = bootstrap_depth(BOOT_BUDGET, cheb_deg=BOOT_DEG, double_angles=3) + 2
    p = CKKSParams(N=BOOT_N, dcrt=DCRTParams.create(BOOT_N, L, BOOT_BITS),
                   scale=float(1 << BOOT_BITS))
    ctx = CKKSContext(p, seed=BOOT_SEED)
    sk, pk = ctx.key_gen(secret_dist="sparse", hamming_weight=BOOT_HW)
    pre = eval_bootstrap_setup_fft(ctx, level_budget=BOOT_BUDGET, K=BOOT_K, cheb_deg=BOOT_DEG)
    bd = CKKSBootstrapFFTDevice(CKKSRnsContext(ctx, dnum=3, ks_limb_bits=28), pre)
    bd.keygen(sk)
    return ctx, sk, pk, bd


def ckksboot(card: str) -> dict:
    """The batched FFT-factored device bootstrap at bench.py's run_ckksboot
    width (`ckksboot_contexts`, batch BOOT_BATCH, inputs uniform in +-0.04
    from default_rng(5)): every stage's towers on the card, every slot of
    every refreshed ciphertext within 2e-2 (bench.py's check), ciphertexts
    0 and BOOT_BATCH-1 torch.equal to the same bootstrap on a CPU evaluator
    with the same keys; the first call and BOOT_ITERS warm calls timed by
    CUDA events. Then the BSGS CKKSBootstrapDevice once at N = 64, checked
    by decryption. Returns the timings."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.pke import (CKKSBootstrapDevice, CKKSBootstrapFFTDevice, CKKSContext,
                                    CKKSParams, CKKSRnsContext, DCRTParams, eval_bootstrap_setup)

    t0 = time.time()
    ctx, sk, pk, bd = ckksboot_contexts()
    keygen_s = time.time() - t0
    p = ctx.params
    log(f"CKKS bootstrap N={p.N} L={p.dcrt.L} ({BOOT_BITS}-bit limbs) budget {BOOT_BUDGET}, "
        f"{len(bd.galois_keys)} Galois keys; host context and keygen {keygen_s:.1f} s")
    rng = np.random.default_rng(5)
    zs = [rng.uniform(-0.04, 0.04, p.slots) for _ in range(BOOT_BATCH)]
    t0 = time.time()
    cts = [exhausted(ctx, pk, z) for z in zs]
    log(f"CKKS bootstrap: {len(cts)} encryptions dropped to one limb on the host "
        f"{time.time() - t0:.1f} s")

    def staged(ev, batch):
        """The bootstrap stage by stage; the last stage's device towers."""
        out = {}
        for name, d in ev.stages(batch):
            out[name] = d
        return out

    t0 = time.time()
    stages = staged(bd, cts)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    check(all(d.c0.is_cuda and d.c1.is_cuda for d in stages.values()),
          "CKKS bootstrap: a stage's towers are not on the card")
    last = stages[list(stages)[-1]]
    check(tuple(last.c0.shape)[1:] == (BOOT_BATCH, p.N),
          f"CKKS bootstrap: output towers of shape {tuple(last.c0.shape)}")
    fresh = bd.dctx.download_batch(last)
    err = max(float(np.abs(ctx.decrypt(sk, f).real - z).max()) for f, z in zip(fresh, zs))
    check(err < 2e-2 and all(f.level_params.L >= 2 for f in fresh),
          f"CKKS bootstrap: decryption error {err}")
    log(f"CKKS bootstrap B={BOOT_BATCH}: stages {list(stages)} on the card, refreshed to "
        f"{fresh[0].level_params.L} limbs, every slot within {err:.3e} (bound 2e-2)")

    t0 = time.time()
    cpu = CKKSBootstrapFFTDevice(bd.rns, bd.pre, device="cpu")
    cpu.load_keys(bd.relin_key, bd.galois_keys)
    ends = (0, BOOT_BATCH - 1)
    ref = staged(cpu, [cts[b] for b in ends])
    ref_last = ref[list(ref)[-1]]
    for i, b in enumerate(ends):
        check(torch.equal(last.c0[:, b].cpu(), ref_last.c0[:, i])
              and torch.equal(last.c1[:, b].cpu(), ref_last.c1[:, i])
              and last.scale == ref_last.scale,
              f"CKKS bootstrap: ciphertext {b} differs from the CPU evaluator's")
    log(f"CKKS bootstrap: ciphertexts {ends} torch.equal to the CPU evaluator on the same "
        f"keys ({time.time() - t0:.1f} s on the host's CPU)")

    ms = cuda_ms(lambda: bd.bootstrap_batch(cts), BOOT_ITERS)
    out = {"card": card, "N": p.N, "L": p.dcrt.L, "batch": BOOT_BATCH,
           "level_budget": list(BOOT_BUDGET), "galois_keys": len(bd.galois_keys),
           "max_err": err, "keygen_s": keygen_s, "first_call_s": first_s,
           "ms_per_call": ms, "ms_per_ctx": ms / BOOT_BATCH}
    log(f"CKKS bootstrap B={BOOT_BATCH}: first call {first_s:.3f} s, warm {ms:.3f} ms a call, "
        f"{ms / BOOT_BATCH:.3f} ms/ctx on {card}")

    # the BSGS driver once, at a smaller ring
    t0 = time.time()
    p = CKKSParams(N=64, dcrt=DCRTParams.create(64, 16, 28), scale=float(1 << 28))
    ctx = CKKSContext(p, seed=BOOT_SEED)
    sk, pk = ctx.key_gen(secret_dist="sparse", hamming_weight=8)
    bsgs = CKKSBootstrapDevice(CKKSRnsContext(ctx, dnum=3, ks_limb_bits=28),
                               eval_bootstrap_setup(ctx, cheb_deg=22))
    bsgs.keygen(sk)
    zs = [np.linspace(-0.04, 0.04, p.slots), np.linspace(0.03, -0.03, p.slots)]
    fresh = bsgs.bootstrap_batch([exhausted(ctx, pk, z) for z in zs])
    err = max(float(np.abs(ctx.decrypt(sk, f).real - z).max()) for f, z in zip(fresh, zs))
    check(err < 5e-3 and all(f.level_params.L >= 2 for f in fresh),
          f"BSGS CKKS bootstrap N=64: decryption error {err}")
    log(f"BSGS CKKS bootstrap N=64 L=16 B=2: every slot within {err:.3e} (bound 5e-3), "
        f"{time.time() - t0:.1f} s with keygen")
    out["bsgs_n64_max_err"] = err
    return out


def advancedshe(rng, card: str, contexts) -> dict:
    """The advanced SHE layer on the device evaluator at `ckks_contexts`'
    width (N = 4096, L = 8) on batch SHE_BATCH: eval_sum over every slot,
    eval_linear_wsum of two batches and eval_logistic (degree SHE_DEG on
    [-4, 4]); each checked slot by slot by decryption against numpy, and on
    ciphertext 0 torch.equal to a CPU evaluator with the same keys; each
    timed by CUDA events. Returns the timings."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.pke import CKKSDeviceEvaluator
    from tfhe_tpu_torch.pke import advancedshe_device as ashd
    from tfhe_tpu_torch.pke.ckks_boot import galois_element

    ctx, rctx, dctx, sk, pk, rlk, gk = contexts
    p = ctx.params
    t0 = time.time()
    ev = CKKSDeviceEvaluator(rctx)
    ev.load_keys(rlk, {galois_element(1, p.N): gk})
    ev.load_galois_elements(sk, [galois_element(1 << j, p.N)
                                 for j in range(1, p.slots.bit_length() - 1)])
    log(f"advanced SHE N={p.N} L={p.dcrt.L}: {len(ev.galois_keys)} Galois keys, host "
        f"keygen {time.time() - t0:.1f} s")
    t0 = time.time()
    za = [rng.uniform(-1, 1, p.slots) / 64 for _ in range(SHE_BATCH)]
    zb = [rng.uniform(-3.5, 3.5, p.slots) for _ in range(SHE_BATCH)]
    a_cts, b_cts = [ctx.encrypt(pk, z) for z in za], [ctx.encrypt(pk, z) for z in zb]
    log(f"advanced SHE: {2 * SHE_BATCH} encryptions on the host {time.time() - t0:.1f} s")
    a, b = ev.dctx.upload_batch(a_cts), ev.dctx.upload_batch(b_cts)
    cpu = CKKSDeviceEvaluator(rctx, device="cpu")
    cpu.load_keys(ev.relin_key, ev.galois_keys)
    a0, b0 = cpu.dctx.upload_batch(a_cts[:1]), cpu.dctx.upload_batch(b_cts[:1])
    w = (0.5, -1.25)
    runs = {
        # the sum carries every slot's encryption noise and 11 key switches'
        "eval_sum": (lambda e, x, y: ashd.eval_sum(e, x),
                     lambda bi: np.full(p.slots, za[bi].sum()), 1e-2),
        "eval_linear_wsum": (lambda e, x, y: ashd.eval_linear_wsum(e, [x, y], w),
                             lambda bi: w[0] * za[bi] + w[1] * zb[bi], 1e-3),
        "eval_logistic": (lambda e, x, y: ashd.eval_logistic(e, y, -4.0, 4.0, SHE_DEG),
                          lambda bi: 1.0 / (1.0 + np.exp(-zb[bi])), 1e-2),
    }
    out = {"card": card, "N": p.N, "L": p.dcrt.L, "batch": SHE_BATCH}
    for name, (fn, want, bound) in runs.items():
        got = fn(ev, a, b)
        check(got.c0.is_cuda and got.c1.is_cuda, f"{name}: towers not on the card")
        err = max(float(np.abs(ctx.decrypt(sk, o).real - want(bi)).max())
                  for bi, o in enumerate(ev.dctx.download_batch(got)))
        check(err < bound, f"{name}: decryption error {err}")
        ref = fn(cpu, a0, b0)
        check(torch.equal(got.c0[:, 0].cpu(), ref.c0[:, 0])
              and torch.equal(got.c1[:, 0].cpu(), ref.c1[:, 0]) and got.scale == ref.scale,
              f"{name}: ciphertext 0 differs from the CPU evaluator's")
        ms = cuda_ms(lambda: fn(ev, a, b), SHE_ITERS)
        out[f"{name}_ms"] = ms
        out[f"{name}_max_err"] = err
        log(f"{name} B={SHE_BATCH}: {len(got.moduli)} limbs left, every slot within "
            f"{err:.3e} (bound {bound:g}), ciphertext 0 torch.equal to the CPU evaluator; "
            f"{ms:.3f} ms a call on {card}")
    return out


def ckks_auto(rng, card: str, contexts) -> dict:
    """The automatic-scaling layer (`CKKSAutoDeviceContext` over the
    `ckks_contexts` device context, no new keygen) under FLEXIBLEAUTO and
    FIXEDAUTO at batch AUTO_BATCH: a lazily rescaled chain x*y*x, a
    mixed-level add x^4 + y and a plaintext multiply and add x^2*w + 0.25.
    Every slot within AUTO_BOUND of its technique; ciphertexts 0 and
    AUTO_BATCH-1 torch.equal to the host `CKKSAutoContext` (run one by one),
    their scale and noise degree equal; each program timed warm by CUDA
    events. Then one two-phase noise-flooded
    decryption on the host. Returns the timings."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.pke import CKKSAutoContext, CKKSAutoDeviceContext

    ctx, rctx, dctx, sk, pk, rlk, gk = contexts
    p, B = ctx.params, AUTO_BATCH
    t0 = time.time()
    zs = [[rng.uniform(0.2, 0.9, p.slots) for _ in range(B)] for _ in range(2)]
    w = rng.uniform(-1.0, 1.0, p.slots)
    out = {"card": card, "N": p.N, "L": p.dcrt.L, "batch": B}

    def chain(c, x, y, *k):                 # lazily rescaled: x*y, then *x
        return c.eval_mult(c.eval_mult(x, y, *k), x, *k)

    def mixed_add(c, x, y, *k):             # x^4 two levels down, plus a fresh y
        x2 = c.eval_mult(x, x, *k)
        return c.eval_add(c.eval_mult(x2, x2, *k), y)

    def plain(c, x, y, *k):
        return c.eval_add_plain(c.eval_mult_plain(c.eval_mult(x, x, *k), w), 0.25)

    programs = {"chain": (chain, lambda x, y: x * x * y),
                "mixed_add": (mixed_add, lambda x, y: x ** 4 + y),
                "plain": (plain, lambda x, y: x * x * w + 0.25)}
    for tech in ("flexibleauto", "fixedauto"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the 28-bit first limb: no level is spent to it
            host = CKKSAutoContext(rctx, technique=tech)
            dev = CKKSAutoDeviceContext(dctx, technique=tech)
        cts = [[host.encrypt(pk, z) for z in zz] for zz in zs]
        dx, dy = dev.upload_batch(cts[0]), dev.upload_batch(cts[1])
        for name, (prog, want) in programs.items():
            got = prog(dev, dx, dy)
            check(got.c0.is_cuda and got.c1.is_cuda, f"{tech} {name}: towers not on the card")
            err = max(float(np.abs(ctx.decrypt(sk, o).real - want(zs[0][b], zs[1][b])).max())
                      for b, o in enumerate(dev.download_batch(got)))
            check(err < AUTO_BOUND[tech], f"{tech} {name}: decryption error {err}")
            for b in (0, B - 1):
                ref = prog(host, cts[0][b], cts[1][b], rlk)
                check(ref.scale == got.scale and ref.noise_deg == got.noise_deg,
                      f"{tech} {name}: scale or degree differs from the host")
                for i, poly in enumerate(ref.polys):
                    tower = torch.from_numpy(poly.to_eval().rns.astype(np.int64))
                    check(torch.equal((got.c0, got.c1)[i][:, b].cpu(), tower),
                          f"{tech} {name}: ciphertext {b} differs from CKKSAutoContext")
            ms = cuda_ms(lambda: prog(dev, dx, dy), CKKS_ITERS)
            out[f"{tech}_{name}_ms"] = ms
            out[f"{tech}_{name}_max_err"] = err
            log(f"CKKS {tech} {name} B={B}: {len(got.moduli)} limbs, degree "
                f"{got.noise_deg}, every slot within {err:.3e} (bound {AUTO_BOUND[tech]:g}), "
                f"ciphertexts 0 and {B - 1} torch.equal to CKKSAutoContext; {ms:.3f} ms "
                f"a call on {card}")
    out["flooded_max_err"] = flooded_decrypt()
    log(f"CKKS auto-scaling phase {time.time() - t0:.1f} s")
    return out


def flooded_decrypt() -> float:
    """examples/ckks_noise_flooding.py's two-phase protocol on the host, in
    the port (N = 128, limbs 52/40/40, scale 2^40, FIXEDAUTO): the noise of
    v1*v2*v1 + v1 estimated under one key, the same circuit decrypted with
    flooding under a fresh key. Returns the largest slot error."""
    import numpy as np

    from tfhe_tpu_torch.pke import (CKKSAutoContext, CKKSContext, CKKSParams,
                                    CKKSRnsContext, DCRTParams, decrypt_flooded,
                                    estimate_noise, flooding_sigma)
    from tfhe_tpu_torch.pke.dcrt import _moduli_chain_pattern

    v1 = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    v2 = np.array([1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0])

    def run(seed):
        p = CKKSParams(N=128, dcrt=DCRTParams(N=128, moduli=_moduli_chain_pattern(
            128, (52, 40, 40))), scale=float(1 << 40))
        actx = CKKSAutoContext(CKKSRnsContext(CKKSContext(p, seed=seed), dnum=2),
                               technique="fixedauto")
        sk, pk = actx.key_gen()
        rlk = actx.relin_key_gen(sk)
        c1, c2 = actx.encrypt(pk, v1), actx.encrypt(pk, v2)
        return actx, sk, actx.eval_add(actx.eval_mult(actx.eval_mult(c1, c2, rlk), c1, rlk), c1)

    actx, sk, ct = run(1001)
    est = estimate_noise(actx.ctx, sk, ct)
    actx, sk, ct = run(2002)
    got = decrypt_flooded(actx.ctx, sk, ct, est, rng=np.random.default_rng(5)).real[:8]
    err = float(np.abs(got - (v1 * v2 * v1 + v1)).max())
    check(err < 1e-2, f"noise-flooded decryption error {err}")
    log(f"noise flooding on the host: estimate {est:.2f} bits, sigma "
        f"2^{np.log2(flooding_sigma(est)):.1f}, flooded decryption within {err:.2e}")
    return err


def bgv_contexts():
    """BGV at the CKKS phase's width: BGVParams.create(N=4096, t=257,
    mult_depth=7, limb_bits=28) (four 28-bit and four 27-bit limbs = 1 mod
    t), seed BGV_SEED, hybrid keys with dnum = 3 and four 30-bit special
    limbs = 1 mod t (too few 28-bit primes = 1 mod 2N*t are left after the
    chain): one full-chain relin key and the rotation-by-1 Galois key, on
    the card.
    Returns (ctx, rctx, dctx, sk, pk, rlk, gk)."""
    from tfhe_tpu_torch.pke import (BGVContext, BGVDeviceContext, BGVParams,
                                    BGVRnsContext)

    ctx = BGVContext(BGVParams.create(N=BGV_N, t=BGV_T, mult_depth=BGV_DEPTH,
                                      limb_bits=CKKS_BITS), seed=BGV_SEED)
    sk, pk = ctx.key_gen()
    rctx = BGVRnsContext(ctx, dnum=3, ks_limb_bits=BGV_KS_BITS)
    rlk = rctx.relin_key_gen_single(sk)
    gk = rctx.galois_key_gen_single(sk, 1)
    dctx = BGVDeviceContext(rctx)
    dctx.load_relin_keys(rlk)
    dctx.load_galois_keys(1, gk)
    return ctx, rctx, dctx, sk, pk, rlk, gk


def bgv(rng, card: str) -> dict:
    """BGV on the card (`bgv_contexts`): eval_mult (tensor product, t-noise
    hybrid relinearization with the t-exact ModDown, BGV ModReduce) at each
    batch of BGV_BATCHES, eval_rotate, eval_add and eval_sub at batch 8, on
    coefficient-encoded messages (no prime t = 1 mod 2N exists below 2^31
    at N = 4096). Every product decrypts to the negacyclic product mod t,
    every rotation to m(X^k), every sum and difference to (m1 +- m2) mod t;
    ciphertexts 0 and B-1 torch.equal to the host BGVRnsContext; each
    operation timed warm by CUDA events. Returns the timings."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.pke.encoding import (apply_automorphism_coeff,
                                             rotation_automorphism_index)

    t0 = time.time()
    ctx, rctx, dctx, sk, pk, rlk, gk = bgv_contexts()
    p = ctx.params
    log(f"BGV N={p.N} t={p.t} chain {[m.bit_length() for m in p.dcrt.moduli]} bits, "
        f"dnum=3, PQ limbs {len(rlk.pq_params.moduli)}; host keygen {time.time() - t0:.1f} s")
    Bmax = max(BGV_BATCHES)
    t0 = time.time()
    ms_ = [[rng.integers(0, p.t, p.N) for _ in range(Bmax)] for _ in range(2)]
    cts = [[ctx.encrypt(pk, m) for m in mm] for mm in ms_]
    log(f"BGV: {2 * Bmax} encryptions on the host {time.time() - t0:.1f} s")

    def negacyclic(a, b):
        full = np.convolve(a, b)
        full = np.concatenate([full, np.zeros(1, dtype=full.dtype)])
        return (full[:p.N] - full[p.N:]) % p.t

    def holds(d, want, host_fn, what: str) -> None:
        check(d.c0.is_cuda and d.c1.is_cuda, f"BGV {what}: towers not on the card")
        outs = dctx.download_batch(d)
        for b, o in enumerate(outs):
            check(np.array_equal(ctx.decrypt(sk, o), want(b)),
                  f"BGV {what}: ciphertext {b} decrypts wrong")
        for b in (0, len(outs) - 1):
            for i, poly in enumerate(host_fn(b).polys):
                tower = torch.from_numpy(poly.to_eval().rns.astype(np.int64))
                check(torch.equal((d.c0, d.c1)[i][:, b].cpu(), tower),
                      f"BGV {what}: ciphertext {b} differs from the host BGVRnsContext")
        log(f"BGV {what}: {len(outs)} ciphertexts on the card, {len(d.moduli)} limbs, all "
            f"decrypt right, ciphertexts 0 and {len(outs) - 1} torch.equal to the host "
            "BGVRnsContext")

    out = {"card": card, "N": p.N, "t": p.t, "L": p.dcrt.L, "dnum": 3}
    for B in BGV_BATCHES:
        x, y = dctx.upload_batch(cts[0][:B]), dctx.upload_batch(cts[1][:B])
        holds(dctx.eval_mult(x, y), lambda b: negacyclic(ms_[0][b], ms_[1][b]),
              lambda b: rctx.eval_mult(cts[0][b], cts[1][b], rlk), f"eval_mult B={B}")
        ms = cuda_ms(lambda: dctx.eval_mult(x, y), CKKS_ITERS)
        out[f"mult_ms_per_ctx_B{B}"] = ms / B
        log(f"BGV eval_mult B={B}: warm {ms:.3f} ms a call, {ms / B:.4f} ms/ctx on {card}")
    B = BGV_BATCHES[0]
    x, y = dctx.upload_batch(cts[0][:B]), dctx.upload_batch(cts[1][:B])
    k = rotation_automorphism_index(p.N, 1)
    holds(dctx.eval_rotate(x, 1),
          lambda b: apply_automorphism_coeff(ms_[0][b].astype(np.uint64), k, p.t).astype(np.int64),
          lambda b: rctx.eval_rotate(cts[0][b], 1, gk), f"eval_rotate B={B}")
    holds(dctx.eval_add(x, y), lambda b: (ms_[0][b] + ms_[1][b]) % p.t,
          lambda b: rctx.eval_add(cts[0][b], cts[1][b]), f"eval_add B={B}")
    diff = dctx.eval_sub(x, y)
    check(all(np.array_equal(ctx.decrypt(sk, o), (ms_[0][b] - ms_[1][b]) % p.t)
              for b, o in enumerate(dctx.download_batch(diff))), "BGV eval_sub decryption")
    back = dctx.eval_add(diff, y)
    check(torch.equal(back.c0, x.c0) and torch.equal(back.c1, x.c1),
          "BGV eval_sub then eval_add does not give the input back")
    for name, fn in (("rotate", lambda: dctx.eval_rotate(x, 1)),
                     ("add", lambda: dctx.eval_add(x, y)),
                     ("sub", lambda: dctx.eval_sub(x, y))):
        out[f"{name}_ms_B{B}"] = cuda_ms(fn, CKKS_ITERS)
    log(f"BGV B={B}: eval_sub decrypts right, adding back gives the input; eval_rotate "
        f"{out[f'rotate_ms_B{B}']:.3f} ms, eval_add {out[f'add_ms_B{B}']:.3f} ms, eval_sub "
        f"{out[f'sub_ms_B{B}']:.3f} ms a call on {card}")
    return out


def bfv_contexts():
    """simple-integers.cpp's configuration through the ported front end:
    gen_crypto_context("BFV", plaintext_modulus=65537, mult_depth=2,
    limb_bits=28, multiplication_technique=..., seed=BFV_SEED) at the
    default 128_classic and dnum = 2, once with "hps" and once with "behz"
    (one seed, so one secret). Returns {technique: context}."""
    from tfhe_tpu_torch.pke import BFVBehzContext, BFVRnsContext, gen_crypto_context

    ctxs = {mt: gen_crypto_context("BFV", plaintext_modulus=BFV_T, mult_depth=BFV_DEPTH,
                                   limb_bits=BFV_LIMB_BITS, multiplication_technique=mt,
                                   seed=BFV_SEED)
            for mt in ("hps", "behz")}
    check(type(ctxs["hps"]) is BFVRnsContext and type(ctxs["behz"]) is BFVBehzContext,
          "gen_crypto_context did not return the HPS and BEHZ contexts")
    return ctxs


def bfv_keys_through_files(ctx, sk, pk, rlk, gk):
    """Write the context's keys (secret and public) and its relinearization
    and Galois hybrid keys with the port's pke/serial, outside the repo,
    and read them back. Returns the reloaded (sk, pk, rlk, gk)."""
    import os
    import tempfile

    import numpy as np

    from tfhe_tpu_torch.pke import serial as pke_serial

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("keys.npz", "rlk.npz", "gk.npz")]
        pke_serial.save_keys(paths[0], ctx.params, sk, pk)
        pke_serial.save_hybrid_keys(paths[1], rlk)
        pke_serial.save_hybrid_keys(paths[2], gk)
        params, sk2, pk2, _ = pke_serial.load_keys(paths[0])
        rlk2, gk2 = (pke_serial.load_hybrid_keys(x) for x in paths[1:])
    check(params == ctx.params and np.array_equal(sk2.s_signed, sk.s_signed)
          and np.array_equal(pk2.b.rns, pk.b.rns), "BFV keys differ after pke/serial")
    for a, b in ((rlk, rlk2), (gk, gk2)):
        check(a.groups == b.groups and a.p_moduli == b.p_moduli
              and getattr(a, "galois_k", None) == getattr(b, "galois_k", None)
              and all(np.array_equal(x.rns, y.rns) for x, y in zip(a.bs + a.as_, b.bs + b.as_)),
              "BFV hybrid keys differ after pke/serial")
    return sk2, pk2, rlk2, gk2


def bfv(rng, card: str) -> dict:
    """BFV on the card (`bfv_contexts`), once per technique: HPS through
    BFVDeviceContext, BEHZ through BFVBehzDeviceContext, on keys written and
    read back with pke/serial. At each batch of BFV_BATCHES the depth-2
    chain x*y*z through eval_mult; at batch 8 eval_rotate by 1, eval_add and
    eval_sub. Every slot of every result decrypts to its plaintext value
    mod 65537 (decrypt_packed after download), ciphertexts 0 and B-1 of
    each result torch.equal to the host BFVRnsContext or BFVBehzContext on
    the same inputs, each operation timed warm by CUDA events. Returns the
    timings."""
    import numpy as np
    import torch

    from tfhe_tpu_torch.pke import BFVBehzDeviceContext, BFVDeviceContext

    t0 = time.time()
    ctxs = bfv_contexts()
    hps = ctxs["hps"]
    p = hps.params
    sk, pk = hps.key_gen()
    sk_b, _ = ctxs["behz"].key_gen()
    check(np.array_equal(sk.s_signed, sk_b.s_signed), "the BFV contexts' secrets differ")
    keys = {}
    for mt, ctx in ctxs.items():
        rlk, gk = ctx.relin_key_gen(sk), ctx.galois_key_gen(sk, 1)
        sk2, pk2, rlk2, gk2 = bfv_keys_through_files(ctx, sk, pk, rlk, gk)
        keys[mt] = (rlk2, gk2)
    sk, pk = sk2, pk2
    log(f"BFV (simple-integers.cpp): N={p.N} t={p.t} depth {BFV_DEPTH}, derived "
        f"{hps.derived.security_level}, Q limbs {list(p.dcrt.moduli)}, HPS R limbs "
        f"{len(hps.r_moduli)}, BEHZ Bsk limbs {len(ctxs['behz'].bsk_moduli)}, dnum=2, PQ "
        f"limbs {len(rlk2.pq_params.moduli)}; keygen, keys written and read back with "
        f"pke/serial {time.time() - t0:.1f} s")
    Bmax = max(BFV_BATCHES)
    t0 = time.time()
    vs = [[rng.integers(0, p.t, p.N) for _ in range(Bmax)] for _ in range(3)]
    cts = [[hps.encrypt_packed(pk, v) for v in vv] for vv in vs]
    log(f"BFV: {3 * Bmax} packed encryptions on the host {time.time() - t0:.1f} s")
    half = p.N // 2

    def rotated(v):
        return np.concatenate([np.roll(v[:half], -1), np.roll(v[half:], -1)])

    out = {"card": card, "N": p.N, "t": p.t, "L": p.dcrt.L, "dnum": 2}
    for mt, ctx in ctxs.items():
        t1 = time.time()
        rlk, gk = keys[mt]
        dctx = (BFVDeviceContext if mt == "hps" else BFVBehzDeviceContext)(ctx)
        dctx.load_relin_key(rlk)
        dctx.load_galois_key(1, gk)
        name = f"BFV {mt.upper()}"

        def holds(d, want, host_fn, what: str) -> None:
            check(d.c0.is_cuda and d.c1.is_cuda, f"{name} {what}: towers not on the card")
            outs = dctx.download_batch(d)
            for b, o in enumerate(outs):
                check(np.array_equal(ctx.decrypt_packed(sk, o), want(b)),
                      f"{name} {what}: ciphertext {b} decrypts wrong")
            for b in (0, len(outs) - 1):
                for i, poly in enumerate(host_fn(b).polys):
                    tower = torch.from_numpy(poly.to_eval().rns.astype(np.int64))
                    check(torch.equal((d.c0, d.c1)[i][:, b].cpu(), tower),
                          f"{name} {what}: ciphertext {b} differs from the host context")
            log(f"{name} {what}: {len(outs)} ciphertexts on the card, every slot "
                f"decrypts right, ciphertexts 0 and {len(outs) - 1} torch.equal to the "
                f"host {type(ctx).__name__}")

        for B in BFV_BATCHES:
            x, y, z = (dctx.upload_batch(c[:B]) for c in cts)
            xy = dctx.eval_mult(x, y)
            holds(xy, lambda b: vs[0][b] * vs[1][b] % p.t,
                  lambda b: ctx.eval_mult(cts[0][b], cts[1][b], rlk), f"x*y B={B}")
            holds(dctx.eval_mult(xy, z), lambda b: vs[0][b] * vs[1][b] % p.t * vs[2][b] % p.t,
                  lambda b: ctx.eval_mult(ctx.eval_mult(cts[0][b], cts[1][b], rlk),
                                          cts[2][b], rlk), f"x*y*z B={B}")
            ms = cuda_ms(lambda: dctx.eval_mult(x, y), CKKS_ITERS)
            out[f"{mt}_mult_ms_per_ctx_B{B}"] = ms / B
            log(f"{name} eval_mult B={B}: warm {ms:.3f} ms a call, {ms / B:.4f} ms/ctx "
                f"on {card}")
        B = BFV_BATCHES[0]
        x, y = (dctx.upload_batch(c[:B]) for c in cts[:2])
        holds(dctx.eval_rotate(x, 1), lambda b: rotated(vs[0][b]),
              lambda b: ctx.eval_rotate(cts[0][b], 1, gk), f"eval_rotate B={B}")
        holds(dctx.eval_add(x, y), lambda b: (vs[0][b] + vs[1][b]) % p.t,
              lambda b: ctx.eval_add(cts[0][b], cts[1][b]), f"eval_add B={B}")
        holds(dctx.eval_sub(x, y), lambda b: (vs[0][b] - vs[1][b]) % p.t,
              lambda b: ctx.ctx.eval_sub(cts[0][b], cts[1][b]), f"eval_sub B={B}")
        for op, fn in (("rotate", lambda: dctx.eval_rotate(x, 1)),
                       ("add", lambda: dctx.eval_add(x, y)),
                       ("sub", lambda: dctx.eval_sub(x, y))):
            out[f"{mt}_{op}_ms_B{B}"] = cuda_ms(fn, CKKS_ITERS)
        log(f"{name} B={B}: eval_rotate {out[f'{mt}_rotate_ms_B{B}']:.3f} ms, eval_add "
            f"{out[f'{mt}_add_ms_B{B}']:.3f} ms, eval_sub {out[f'{mt}_sub_ms_B{B}']:.3f} ms "
            f"a call on {card} ({time.time() - t1:.1f} s)")
    return out


class Saver:
    """`cc.save` of the STD128 gate context in a thread of its own, into a
    temporary directory outside the repo: its 1 GiB switching-key block
    goes through zlib on one host core (which releases the GIL) while the
    card-bound phases run, torch keeping the other cores. `join()` waits
    for it, gives torch its threads back and re-raises what the save
    raised; `close()` removes the directory."""

    def __init__(self, cc):
        import os
        import tempfile
        import threading

        import torch

        self.dir = tempfile.TemporaryDirectory()
        self.path = os.path.join(self.dir.name, "std128.npz")
        self.error, self.seconds = None, None
        # one core for zlib: torch's parallel host loops would otherwise
        # wait on the thread that shares its core
        self.threads = torch.get_num_threads()
        torch.set_num_threads(max(1, self.threads - 1))

        def run():
            t0 = time.time()
            try:
                cc.save(self.path)
            except Exception as e:  # re-raised by join()
                self.error = e
            self.seconds = time.time() - t0

        self.thread = threading.Thread(target=run, name="std128-save", daemon=True)
        self.thread.start()

    def join(self) -> str:
        import torch

        self.thread.join()
        torch.set_num_threads(self.threads)
        if self.error is not None:
            raise self.error
        return self.path

    def close(self) -> None:
        self.thread.join()
        self.dir.cleanup()


def serial_round_trip(rng, card: str, std: dict, saver: Saver) -> dict:
    """BinFHEContext.save and load on the main path: the STD128 NAND
    context of `std128_nand`, saved by `saver` while earlier phases ran,
    is loaded into a new context on the card, and its batch-4096 NAND on
    the same inputs must equal the pre-save outputs; then the TOY
    accelerated context with the seeded switching key is saved and loaded
    (the key still seed and B, its A never materialized) and its EvalSign
    on the card must equal the saved context's host oracle bit for bit.
    Returns the file sizes, the save's seconds (in its thread), the wait
    for it, and the load and device_setup seconds."""
    import os
    import tempfile

    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet, lwe

    out = {"card": card}
    cc = std["cc"]
    t0 = time.time()
    path = saver.join()
    out["std128_save_wait_s"] = time.time() - t0
    out["std128_save_s"] = saver.seconds
    out["std128_file_MB"] = os.path.getsize(path) / 1e6
    t0 = time.time()
    loaded = BinFHEContext.load(path)
    out["std128_load_s"] = time.time() - t0
    saver.close()
    key, key2 = cc.bt_key, loaded.bt_key
    check(loaded.params == cc.params and np.array_equal(key2.bsk_coeff, key.bsk_coeff)
          and np.array_equal(key2.ksk.A, key.ksk.A) and np.array_equal(key2.ksk.B, key.ksk.B),
          "STD128: the loaded keys differ from the saved ones")
    t0 = time.time()
    loaded.device_setup()
    torch.cuda.synchronize()
    out["std128_device_setup_s"] = time.time() - t0
    got = loaded.eval_bin_gate(Gate.NAND, *std["cts"])
    check(loaded.backend.device.type == "cuda", "the loaded STD128 context is not on the card")
    check(np.array_equal(got.a, std["out"].a) and np.array_equal(got.b, std["out"].b),
          "STD128: the reloaded NAND differs from the pre-save outputs")
    m1, m2 = std["m"]
    check(np.array_equal(loaded.decrypt(std["sk"], got), 1 - (m1 & m2)),
          "STD128 reloaded NAND decryption")
    log(f"STD128 context saved ({out['std128_file_MB']:.1f} MB, {out['std128_save_s']:.1f} s "
        f"in its thread beside the phases before this one, {out['std128_save_wait_s']:.1f} s "
        f"waited for here), loaded ({out['std128_load_s']:.1f} s), "
        f"device_setup {out['std128_device_setup_s']:.1f} s: NAND B={GATE_BATCH} on the "
        f"card equal to the pre-save outputs")
    del loaded

    sign_cc, _, sk, keygen_s = accelerated_contexts(ParamSet.TOY, func=False, seeded=True)
    ksk = sign_cc.bt_key.ksk
    check(isinstance(ksk, lwe.SeededSwitchingKey), "the TOY key is not seeded")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "toy_seeded.npz")
        t0 = time.time()
        sign_cc.save(path)
        out["toy_seeded_save_s"] = time.time() - t0
        out["toy_seeded_file_MB"] = os.path.getsize(path) / 1e6
        t0 = time.time()
        loaded = BinFHEContext.load(path)
        out["toy_seeded_load_s"] = time.time() - t0
    for base, k in sign_cc.bt_key_map.items():
        k2 = loaded.bt_key_map[base].ksk
        check(isinstance(k2, lwe.SeededSwitchingKey) and k2._A is None
              and k2.seed == ksk.seed and np.array_equal(k2.B, ksk.B),
              "TOY: the loaded switching key is not the seeded key")
    t0 = time.time()
    loaded.device_setup()
    torch.cuda.synchronize()
    out["toy_seeded_device_setup_s"] = time.time() - t0
    ct, delta = sign_inputs(sign_cc, sk, rng, 8)
    got = loaded.eval_sign(ct)
    check(loaded.backend.device.type == "cuda", "the loaded TOY context is not on the card")
    check(loaded.bt_key.ksk._A is None, "the loaded seeded key was materialized")
    sign_cc.device_clean()
    check(same(got, sign_cc.eval_sign(ct)), "TOY: the reloaded EvalSign differs from the oracle")
    check(np.array_equal(loaded.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64)),
          "TOY reloaded EvalSign decryption")
    log(f"TOY accelerated seeded context (keygen {keygen_s:.1f} s) saved "
        f"({out['toy_seeded_file_MB']:.1f} MB, {out['toy_seeded_save_s']:.1f} s), loaded "
        f"({out['toy_seeded_load_s']:.1f} s) with its key still seed and B, device_setup "
        f"{out['toy_seeded_device_setup_s']:.1f} s: EvalSign B=8 on the card equal to the "
        f"host oracle bit for bit")
    return out


class KernelClock:
    """Device time of every call of `module.name` (a kernel wrapper that
    launches one kernel) while the clock is entered: CUDA events around
    each call, summed by `ms()` after a synchronize."""

    def __init__(self, module, name: str):
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        import torch

        self.orig = orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def paramset_matrix(rng) -> None:
    """Every GINX row of the classic table on the card, with the LWE
    dimension cut to 12 (full N, Q, qKS and bases): TorchBackend's eval_acc
    and mkm_switch at B = 2 bit for bit against the host oracle (its native
    engine, fed uint64 accumulators). The 9 single-limb sets run
    blind_rotate (STD256Q and MEDIUM at N = 2048), the 8 two-limb sets
    blind_rotate64."""
    import dataclasses

    import numpy as np

    from tfhe_tpu_torch import ParamSet, TorchBackend, from_param_set, lwe, scheme
    from tfhe_tpu_torch.params import BinFHEParams
    from tfhe_tpu_torch.ref.backend import RefBackend
    from tfhe_tpu_torch.ref.rgsw import poly_transpose
    from tfhe_tpu_torch.utils.rng import BinFHERng

    t0 = time.time()
    for ps in ParamSet:
        full = from_param_set(ps)
        params = BinFHEParams(lwe=dataclasses.replace(full.lwe, n=12), rgsw=full.rgsw)
        p = params.lwe
        brng = BinFHERng(SEED + int(ps))
        key = scheme.key_gen(brng, params, lwe.key_gen(brng, p.n, p.q_ks))
        acc = rng.integers(0, p.Q, (2, 2, p.N)).astype(np.uint64)
        a = rng.integers(0, p.q, (2, p.n)).astype(np.uint64)
        dev, ref = TorchBackend("cuda"), RefBackend()
        got = dev.eval_acc(params, key, acc.copy(), a, p.q)
        want = ref.eval_acc(params, key, acc.copy(), a, p.q)
        check(np.array_equal(got, want), f"{ps.name}: eval_acc differs from the oracle")
        a_t = poly_transpose(want[:, 0, :], p.Q)
        b = (want[:, 1, 0] + np.uint64(p.Q // 8 + 1)) % np.uint64(p.Q)
        got_ct = dev.mkm_switch(params, key, a_t, b, p.q)
        check(same(got_ct, ref.mkm_switch(params, key, a_t, b, p.q)),
              f"{ps.name}: mkm_switch differs from the oracle")
    log(f"17 GINX classic sets (n=12, B=2): eval_acc and mkm_switch on the card "
        f"equal the host oracle bit for bit ({time.time() - t0:.1f} s)")


def std128q_nand(rng, card: str) -> None:
    """The two-limb gate path at full width: STD128Q (N = 2048, n = 1024,
    Q of 50 bits, baseG 2^25, qKS 2^25, baseKS 32) NAND at batch
    GATE_BATCH. Every output decrypts; the first 8 equal the host oracle's
    native engine (`RefBackend.eval_acc` fed uint64 accumulators of the
    scheme's gate test polynomial, then `mkm_switch`); the scheme's
    object-dtype oracle would take hours at n = 1024."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet, lwe, scheme
    from tfhe_tpu_torch.ops import backend as backend_mod
    from tfhe_tpu_torch.ref.backend import RefBackend
    from tfhe_tpu_torch.ref.rgsw import poly_transpose

    t0 = time.time()
    cc = BinFHEContext(seed=SEED)
    cc.generate_binfhe_context(ParamSet.STD128Q)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    p = cc.params.lwe
    log(f"STD128Q: N={p.N} n={p.n} Q={p.Q} qKS={p.q_ks} baseKS={p.base_ks} "
        f"baseG=2^{cc.params.rgsw.base_g.bit_length() - 1}; host keygen "
        f"{time.time() - t0:.1f} s")

    m1 = rng.integers(0, 2, GATE_BATCH)
    m2 = rng.integers(0, 2, GATE_BATCH)
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    t0 = time.time()
    prep = type(ct1)(ct1.a[:8], ct1.b[:8], ct1.modulus)
    lwe.add_eq(prep, type(ct2)(ct2.a[:8], ct2.b[:8], ct2.modulus))
    m = scheme._gate_test_poly(cc.params, Gate.NAND, prep.b, prep.modulus)
    ref = RefBackend()
    acc = ref.eval_acc(cc.params, cc.bt_key, scheme._acc_init(m.astype(np.uint64)),
                       prep.a, prep.modulus)
    b = (acc[:, 1, 0] + np.uint64(p.Q // 8 + 1)) % np.uint64(p.Q)
    want = ref.mkm_switch(cc.params, cc.bt_key, poly_transpose(acc[:, 0, :], p.Q), b, p.q)
    log(f"host oracle (native engine) NAND on 8 ciphertexts {time.time() - t0:.1f} s")

    t0 = time.time()
    cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup (key to eval domain, pack_bsk64, switching-key table) "
        f"{time.time() - t0:.1f} s, device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    for call in ("first", "warm"):
        with KernelClock(backend_mod, "rotate64") as clock:
            t0 = time.time()
            out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
            wall = time.time() - t0
            kernel_s = clock.ms() / 1e3
        check(np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2)), "STD128Q NAND decryption")
        check(np.array_equal(out.a[:8], want.a) and np.array_equal(out.b[:8], want.b),
              "STD128Q NAND: first 8 outputs differ from the host oracle")
        log(f"STD128Q NAND B={GATE_BATCH} {call} call: all decrypt to 1-(m1&m2), first 8 "
            f"equal the host oracle; wall {wall:.4f} s, {GATE_BATCH / wall:.1f} "
            f"bootstraps/s; blind_rotate64 {kernel_s:.4f} s in {len(clock.events)} "
            f"launch(es); outside it (wall - kernel: host, key switch, copies) "
            f"{wall - kernel_s:.4f} s "
            f"({100 * (wall - kernel_s) / wall:.1f}%) on {card}")
    log(f"STD128Q NAND peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def single_prime_sign(rng, card: str) -> None:
    """EvalSign at the STD128 accelerated set with the reference's single
    54-bit prime (rns_modulus=False): N = 2048, n = 1305, qKS = 2^35,
    bases {2^18, 2^27}, one digit thrown, batch PRIME_BATCH, a first and
    a warm call, each checked by decryption. The two-limb sets have no device chain (as in the JAX
    package): each bootstrap's test polynomial is built on the host."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import ParamSet
    from tfhe_tpu_torch.ops import backend as backend_mod

    sign_cc, _, sk, keygen_s = accelerated_contexts(ParamSet.STD128, rns_modulus=False,
                                                    func=False)
    p = sign_cc.params.lwe
    log(f"STD128 accelerated, one prime: N={p.N} n={p.n} Q={p.Q} qKS=2^35; host keygen "
        f"(bases 2^18, 2^27) {keygen_s:.1f} s")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    sign_cc.device_setup("cuda")
    torch.cuda.synchronize()
    log(f"device_setup {time.time() - t0:.1f} s")
    ct, delta = sign_inputs(sign_cc, sk, rng, PRIME_BATCH)
    # the first call also converts and uploads the second gadget base's key
    for call in ("first", "warm"):
        with KernelClock(backend_mod, "rotate64") as clock:
            t0 = time.time()
            out = sign_cc.eval_sign(ct)
            wall = time.time() - t0
            kernel_s = clock.ms() / 1e3
        check(np.array_equal(sign_cc.decrypt(sk, out, 2), (delta >= 0).astype(np.uint64)),
              f"single-prime EvalSign decryption at B={PRIME_BATCH}")
        log(f"single-prime EvalSign B={PRIME_BATCH} {call} call: all decrypt right; wall "
            f"{wall:.4f} s = {wall / PRIME_BATCH * 1e3:.4f} ms/ciphertext; blind_rotate64 "
            f"{kernel_s:.4f} s in {len(clock.events)} launches; outside it (wall - kernel) "
            f"{100 * (wall - kernel_s) / wall:.1f}% on {card}")
    log(f"single-prime EvalSign peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def batch_mesh():
    """The mesh phase's ("batch",) mesh: every GPU when there are several
    (`make_mesh()`), else two shards on cuda:0."""
    import torch

    from tfhe_tpu_torch.parallel.mesh import Mesh, make_mesh

    return make_mesh() if torch.cuda.device_count() > 1 else Mesh(["cuda:0", "cuda:0"])


def synced_ms(fn, devices, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs on the host clock, every
    device of `devices` synchronized before and after (a mesh's work spans
    their streams). The caller has run fn once already."""
    import torch

    def sync():
        for d in dict.fromkeys(str(x) for x in devices):
            torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def same_towers(a, b) -> bool:
    import numpy as np

    return len(a.polys) == len(b.polys) and all(
        np.array_equal(x.to_eval().rns, y.to_eval().rns) for x, y in zip(a.polys, b.polys))


def mesh_phase(rng, card: str, std: dict, accel: dict, contexts) -> dict:
    """Several devices (`parallel/mesh.py`, `parallel/limb_ntt.py`) on the
    contexts of earlier phases: `TorchBackend(mesh=batch_mesh())` runs the
    STD128 NAND at batch GATE_BATCH (outputs equal to the one-device ones of
    the same inputs, bootstraps/s beside the one-device rate of this run)
    and the STD128 accelerated EvalSign at FUNC_BATCH (the device chain
    shard by shard on `blind_rotate_rns`, outputs equal to the one-device
    ones); at TOY, the mixed path's EvalFloor and the two-limb EvalSign at
    an uneven batch, equal to the host oracle; then eval_mult_limb at the
    CKKS cell's context on a ("limb",) mesh of each of LIMB_SHARDS shards,
    tower for tower equal to the device eval_mult and the host
    CKKSRnsContext.eval_mult, ms a call on the host clock. Returns the
    numbers."""
    import numpy as np
    import torch

    from tfhe_tpu_torch import Gate, ParamSet, TorchBackend
    from tfhe_tpu_torch.parallel.limb_ntt import build_limb_mult, scatter
    from tfhe_tpu_torch.parallel.mesh import Mesh

    mesh = batch_mesh()
    out = {"card": card, "mesh": [str(d) for d in mesh.devices]}
    log(f"mesh phase: {mesh} ({torch.cuda.device_count()} GPU(s) visible)")

    cc, sk = std["cc"], std["sk"]
    ct1, ct2 = std["cts"]
    one = cc.backend
    t0 = time.time()
    sharded = TorchBackend(mesh=mesh)
    sharded.setup(cc.params, cc.bt_key)
    torch.cuda.synchronize()
    out["nand_setup_s"] = time.time() - t0
    rates = {"one device": [], "mesh": []}
    for _ in range(3):
        for name, be in (("mesh", sharded), ("one device", one)):
            cc.use_backend(be)
            t0 = time.time()
            got = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
            rates[name].append(GATE_BATCH / (time.time() - t0))
            check(same(got, std["out"]), f"mesh STD128 NAND ({name}) differs from the "
                  "one-device outputs of the same inputs")
    m1, m2 = std["m"]
    check(np.array_equal(cc.decrypt(sk, got), 1 - (m1 & m2)), "mesh STD128 NAND decryption")
    out["nand_bootstraps_per_s"] = rates["mesh"][1:]
    out["nand_one_device_bootstraps_per_s"] = rates["one device"][1:]
    log(f"mesh STD128 NAND B={GATE_BATCH}: outputs equal to the one-device outputs; key "
        f"set-up {out['nand_setup_s']:.1f} s; warm {', '.join(f'{r:.1f}' for r in rates['mesh'][1:])} "
        f"bootstraps/s against {', '.join(f'{r:.1f}' for r in rates['one device'][1:])} on one "
        f"device, interleaved, on {card}")

    sc = accel["cc"]
    sharded = TorchBackend(mesh=mesh)
    sc.use_backend(sharded)
    for call in ("first", "warm"):
        t0 = time.time()
        got = sc.eval_sign(accel["ct"])
        s = time.time() - t0
        check(same(got, accel["out"]), "mesh STD128 accelerated EvalSign differs from the "
              "one-device outputs")
        out[f"sign_{call}_ms_per_ct"] = s / FUNC_BATCH * 1e3
    check(np.array_equal(sc.decrypt(accel["sk"], got, 2),
                         (accel["delta"] >= 0).astype(np.uint64)),
          "mesh STD128 accelerated EvalSign decryption")
    check(len(sharded._device_keys) == 2, "the mesh EvalSign did not use both gadget bases")
    log(f"mesh STD128 accelerated EvalSign B={FUNC_BATCH}: outputs equal to the one-device "
        f"outputs; first call (both bases' keys converted) {out['sign_first_ms_per_ct']:.4f}, "
        f"warm {out['sign_warm_ms_per_ct']:.4f} ms/ciphertext on {card}")

    B = MESH_TOY_BATCH
    ctxs, tsk, _ = mixed_contexts(ParamSet.TOY, throws=(1,))
    fc = ctxs[1]
    ct, m, p = floor_inputs(fc, tsk, rng, B)
    fc.use_backend(TorchBackend(mesh=mesh))
    check(fc.backend._path(fc.params) == "mixed", "TOY logQ=11 is not the mixed path")
    got = fc.eval_floor(ct, 1)
    check(floor_ok(fc, tsk, got, m, p), "mesh TOY logQ=11 EvalFloor decryption")
    fc.device_clean()
    check(same(got, fc.eval_floor(ct, 1)), "mesh TOY EvalFloor differs from the host oracle")
    sign_cc, _, tsk, _ = accelerated_contexts(ParamSet.TOY, rns_modulus=False, func=False)
    ct, delta = sign_inputs(sign_cc, tsk, rng, B)
    sign_cc.use_backend(TorchBackend(mesh=mesh))
    check(sign_cc.backend._path(sign_cc.params) == "two_limb",
          "TOY at the single prime is not the two-limb path")
    got = sign_cc.eval_sign(ct)
    check(np.array_equal(sign_cc.decrypt(tsk, got, 2), (delta >= 0).astype(np.uint64)),
          "mesh TOY two-limb EvalSign decryption")
    sign_cc.device_clean()
    check(same(got, sign_cc.eval_sign(ct)), "mesh TOY two-limb EvalSign differs from the "
          "host oracle")
    log(f"mesh TOY EvalFloor (logQ=11, throw 1) and two-limb EvalSign at B={B}: decrypt "
        f"right and equal the host oracle bit for bit")

    ctx, rctx, dctx, csk, pk, rlk, _ = contexts
    zs = [rng.uniform(-0.9, 0.9, ctx.params.slots) for _ in range(2)]
    cts = [ctx.encrypt(pk, z) for z in zs]
    host = rctx.eval_mult(*cts, rlk)
    d = [dctx.upload(c) for c in cts]
    check(same_towers(dctx.download(dctx.eval_mult(*d)), host),
          "CKKS device eval_mult differs from the host")
    out["device_mult_ms_B1"] = cuda_ms(lambda: dctx.eval_mult(*d), LIMB_ITERS)
    gpus = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    for D in LIMB_SHARDS:
        lmesh = Mesh([gpus[i % len(gpus)] for i in range(D)], "limb")
        got = rctx.eval_mult_limb(*cts, rlk, lmesh)
        check(same_towers(got, host), f"eval_mult_limb D={D} differs from eval_mult")
        err = np.abs(ctx.decrypt(csk, got) - zs[0] * zs[1]).max()
        check(err < 1e-3, f"eval_mult_limb D={D}: decryption error {err}")
        mult, key_shards = build_limb_mult(cts[0].polys[0].params, rlk, lmesh)
        args = [scatter(lmesh, x.to_coeff().rns) for c in cts for x in c.polys]
        mult(*args, key_shards)
        out[f"mult_limb_ms_D{D}"] = synced_ms(lambda: mult(*args, key_shards),
                                              lmesh.devices, LIMB_ITERS)
        log(f"eval_mult_limb N={ctx.params.N} L={ctx.params.dcrt.L} on {lmesh}: towers equal "
            f"to the device and host eval_mult, every slot within {err:.2e}; the sharded "
            f"multiplication {out[f'mult_limb_ms_D{D}']:.3f} ms a call (host clock) against "
            f"{out['device_mult_ms_B1']:.3f} ms for the one-device eval_mult of one "
            f"ciphertext, on {card}")
    return out


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
    from tfhe_tpu_torch.ops import _build, rotate64_kernel, rotate_kernel, rotate_rns_kernel

    def reset_counts():
        rotate_kernel.LAUNCHES = rotate_rns_kernel.LAUNCHES = rotate64_kernel.LAUNCHES = 0

    t0 = time.time()
    _build.build()
    for name in _build.KERNELS:
        for line in _build.ptxas_report(name):
            log(f"{name}: {line}")
    log(f"built csrc/{{{','.join(_build.KERNELS)}}}.cu for sm_90a in "
        f"{time.time() - t0:.1f} s")
    peak = int32_peak_per_s()

    rng = np.random.default_rng(SEED)
    t0 = time.time()
    gate_timing, _ = gate_kernel_vs_plain(rng, from_param_set(ParamSet.STD128).lwe.Q, peak)
    q1, q2 = from_gpu_style(ParamSet.STD128, True, 12).rgsw.rns_primes
    rns_timing = rns_kernel_vs_plain(rng, q1, q2, peak)
    r64_timing, _ = rotate64_kernel_vs_plain(rng, peak)
    log(f"kernels against their plain versions: {time.time() - t0:.1f} s")

    # the gate path, counts read just after it
    reset_counts()
    t0 = time.time()
    toy_gates(rng)
    std = std128_nand(rng, card)
    gate_launches = rotate_kernel.LAUNCHES
    check(gate_launches > 0, "the gate path did not launch blind_rotate")
    log(f"gate path: blind_rotate launches {gate_launches} ({time.time() - t0:.1f} s)")
    # the STD128 context's save runs in a thread from here to the
    # serialization phase
    saver = Saver(std["cc"])

    # the RNS functional path, counts read just after it
    reset_counts()
    t0 = time.time()
    toy_accelerated(rng)
    plain_timing, accel = std128_accelerated(rng, card)
    rns_launches = rotate_rns_kernel.LAUNCHES
    check(rns_launches > 0, "the functional path did not launch blind_rotate_rns")
    log(f"RNS functional path: blind_rotate_rns launches {rns_launches} "
        f"({time.time() - t0:.1f} s)")

    t0 = time.time()
    contexts = ckks_contexts()
    log(f"CKKS host keygen {time.time() - t0:.1f} s")

    # several devices on the contexts above: the batch-sharded gate, RNS,
    # mixed and two-limb paths and the ring-sharded eval_mult_limb, counts
    # read just after
    reset_counts()
    t0 = time.time()
    mesh_timing = mesh_phase(rng, card, std, accel, contexts)
    del accel
    mesh_launches = (rotate_kernel.LAUNCHES, rotate_rns_kernel.LAUNCHES,
                     rotate64_kernel.LAUNCHES)
    check(all(n > 0 for n in mesh_launches), "the mesh phase did not launch blind_rotate, "
          f"blind_rotate_rns and blind_rotate64: {mesh_launches}")
    mesh_timing["phase_s"] = time.time() - t0
    log(f"mesh phase: blind_rotate launches {mesh_launches[0]}, blind_rotate_rns "
        f"{mesh_launches[1]}, blind_rotate64 {mesh_launches[2]} "
        f"({mesh_timing['phase_s']:.1f} s)")

    # the same path with bench.py's seeded switching key, counts read just
    # after it
    reset_counts()
    t0 = time.time()
    toy_accelerated(rng, seeded=True)
    seeded_timing, _ = std128_accelerated(rng, card, seeded=True, B=SEEDED_BATCH)
    seeded_launches = rotate_rns_kernel.LAUNCHES
    check(seeded_launches > 0, "the seeded functional path did not launch blind_rotate_rns")
    log(f"seeded functional path: blind_rotate_rns launches {seeded_launches} "
        f"({time.time() - t0:.1f} s); keygen {seeded_timing['keygen_s']:.1f} s against "
        f"{plain_timing['keygen_s']:.1f} s with the host switching key")

    # the 17 classic GINX sets through TorchBackend, counts read just after
    reset_counts()
    paramset_matrix(rng)
    check(rotate_kernel.LAUNCHES > 0 and rotate64_kernel.LAUNCHES > 0,
          "the 17-set matrix did not launch blind_rotate and blind_rotate64")
    log(f"17-set matrix: blind_rotate launches {rotate_kernel.LAUNCHES}, "
        f"blind_rotate64 launches {rotate64_kernel.LAUNCHES}")

    # the two-limb paths: the STD128Q gate, then the single 54-bit prime's
    # functional bootstraps, counts read just after each
    reset_counts()
    t0 = time.time()
    std128q_nand(rng, card)
    nand_launches = rotate64_kernel.LAUNCHES
    check(nand_launches > 0, "the STD128Q NAND path did not launch blind_rotate64")
    log(f"STD128Q gate path: blind_rotate64 launches {nand_launches} "
        f"({time.time() - t0:.1f} s)")
    reset_counts()
    t0 = time.time()
    toy_accelerated(rng, rns_modulus=False)
    single_prime_sign(rng, card)
    prime_launches = rotate64_kernel.LAUNCHES
    check(prime_launches > 0, "the single-prime path did not launch blind_rotate64")
    log(f"single-prime functional path: blind_rotate64 launches {prime_launches} "
        f"({time.time() - t0:.1f} s)")

    # save and load: the STD128 gate context (saved by `saver` beside the
    # phases since the gate path) and the seeded TOY context, reloaded on
    # the card, counts read just after
    reset_counts()
    t0 = time.time()
    serial_timing = serial_round_trip(rng, card, std, saver)
    del std
    serial_gate_launches = rotate_kernel.LAUNCHES
    serial_rns_launches = rotate_rns_kernel.LAUNCHES
    check(serial_gate_launches > 0 and serial_rns_launches > 0,
          "the reloaded contexts did not launch blind_rotate and blind_rotate_rns")
    log(f"serialization phase: blind_rotate launches {serial_gate_launches}, "
        f"blind_rotate_rns launches {serial_rns_launches} ({time.time() - t0:.1f} s)")

    # the mixed logQ = 11 path (blind_rotate with the 35-bit key switch),
    # counts read just after it
    reset_counts()
    t0 = time.time()
    toy_mixed(rng)
    std128_mixed(rng, card)
    mixed_launches = rotate_kernel.LAUNCHES
    check(mixed_launches > 0, "the mixed path did not launch blind_rotate")
    log(f"mixed logQ=11 path: blind_rotate launches {mixed_launches} "
        f"({time.time() - t0:.1f} s)")

    # ring dimension N = 4096: both kernels against their plain versions at
    # its full-width shapes, then the accelerated and logQ = 11 sets through
    # the contexts (keys, inputs and the host oracle first), counts read just
    # after the contexts' run
    t0 = time.time()
    q1_4k, q2_4k = from_gpu_style(ParamSet.STD128, True, 12, N=RING_N).rgsw.rns_primes
    ring_kernels = ring4096_kernels(rng, q1_4k, q2_4k,
                                    from_gpu_style(ParamSet.STD128, False, 11, N=RING_N).lwe.Q,
                                    peak)
    log(f"N={RING_N} kernels against their plain versions: {time.time() - t0:.1f} s")
    reset_counts()
    state = ring4096_contexts(rng)
    ring_timing = ring_path(state, card)
    ring_launches = (rotate_kernel.LAUNCHES, rotate_rns_kernel.LAUNCHES)
    check(all(n > 0 for n in ring_launches), "the N = 4096 path did not launch blind_rotate "
          f"and blind_rotate_rns: {ring_launches}")
    shared = {"sk": state["sk"], "sk_n": state["key"].sk_n, "ksk": state["key"].ksk}
    del state
    torch.cuda.empty_cache()
    ring_timing["phase_s"] = time.time() - t0
    log(f"N={RING_N} phase: blind_rotate launches {ring_launches[0]}, blind_rotate_rns "
        f"launches {ring_launches[1]} ({ring_timing['phase_s']:.1f} s)")
    # the single 54-bit prime at N = 4096 on the same secrets and switching
    # key (blind_rotate64 as two-block clusters), counts read just after
    reset_counts()
    t0 = time.time()
    prime4k_timing = ring_single_prime(rng, card, shared, RING_N)
    prime4k_launches = rotate64_kernel.LAUNCHES
    check(prime4k_launches > 0, "the N = 4096 single-prime path did not launch blind_rotate64")
    del shared
    torch.cuda.empty_cache()
    prime4k_timing["phase_s"] = time.time() - t0
    log(f"N={RING_N} single-prime phase: blind_rotate64 launches {prime4k_launches} "
        f"({prime4k_timing['phase_s']:.1f} s)")

    # ring dimension N = 8192 on the gate kernel: blind_rotate (a cluster of
    # two blocks a ciphertext) against its plain version, then the logQ = 11
    # gates, EvalFloor and EvalFunc through the contexts (keys, inputs and
    # the host oracle first), counts read just after the contexts' run
    t0 = time.time()
    ring8k_kernels = ring8192_kernels(rng, peak)
    log(f"N={RING8192_N} blind_rotate against its plain version: {time.time() - t0:.1f} s")
    reset_counts()
    state = ring8192_contexts(rng)
    ring8k_timing = ring_path(state, card)
    ring8k_launches = rotate_kernel.LAUNCHES
    check(ring8k_launches > 0, "the N = 8192 path did not launch blind_rotate")
    # its secrets and switching key (with the key's device table and A
    # block) go on to the RNS phase at this ring
    shared = {"sk": state["sk"], "sk_n": state["key"].sk_n, "ksk": state["key"].ksk}
    del state
    torch.cuda.empty_cache()
    ring8k_timing["phase_s"] = time.time() - t0
    log(f"N={RING8192_N} phase: blind_rotate launches {ring8k_launches} "
        f"({ring8k_timing['phase_s']:.1f} s)")

    # ring dimension N = 8192 on the RNS kernel: blind_rotate_rns (a cluster
    # of four blocks a ciphertext) against its plain version, then the
    # accelerated sets' EvalSign, EvalFunc and EvalDecomp through the
    # contexts on the logQ = 11 phase's secrets and switching key, counts
    # read just after the contexts' run
    t0 = time.time()
    rns8k_kernels = ring8192_rns_kernels(rng, peak)
    log(f"N={RING8192_N} blind_rotate_rns against its plain version: "
        f"{time.time() - t0:.1f} s")
    reset_counts()
    rns8k_timing = ring_path(ring_rns_contexts(rng, RING8192_N, RING8192_BATCH,
                                               RING8192_DECOMP_BATCH, shared), card)
    rns8k_launches = rotate_rns_kernel.LAUNCHES
    check(rns8k_launches > 0, "the N = 8192 RNS path did not launch blind_rotate_rns")
    torch.cuda.empty_cache()
    rns8k_timing["phase_s"] = time.time() - t0
    log(f"N={RING8192_N} RNS phase: blind_rotate_rns launches {rns8k_launches} "
        f"({rns8k_timing['phase_s']:.1f} s)")

    # the single 54-bit prime at N = 8192 on the same secrets and switching
    # key: blind_rotate64 (a cluster of four blocks a ciphertext) against its
    # plain version, then EvalSign, EvalDecomp and EvalFunc through the
    # contexts, counts read just after the contexts' run
    t0 = time.time()
    r64_8k_kernels = ring8192_r64_kernels(rng, peak)
    log(f"N={RING8192_N} blind_rotate64 against its plain version: {time.time() - t0:.1f} s")
    reset_counts()
    prime8k_timing = ring_single_prime(rng, card, shared, RING8192_N)
    prime8k_launches = rotate64_kernel.LAUNCHES
    check(prime8k_launches > 0, "the N = 8192 single-prime path did not launch blind_rotate64")
    # the N = 8192 switching key's device table (17.9 GiB) is freed before
    # the N = 16384 phase makes its 35.7 GiB one, whoever still holds the key
    shared["ksk"].__dict__.pop("_device_tables", None)
    del shared
    gc.collect()
    torch.cuda.empty_cache()
    prime8k_timing["phase_s"] = time.time() - t0
    log(f"N={RING8192_N} single-prime phase: blind_rotate64 launches {prime8k_launches} "
        f"({prime8k_timing['phase_s']:.1f} s)")

    # ring dimension N = 16384 on the RNS kernel, after the N = 8192 phases
    # have freed their table and keys: blind_rotate_rns (a cluster of eight
    # blocks a ciphertext) against its plain version, then the accelerated
    # sets' EvalSign, EvalFunc and EvalDecomp through the contexts on keys
    # of their own, counts read just after the contexts' run
    t0 = time.time()
    ring16384_refusals()
    rns16k_kernels = ring16384_rns_kernels(rng, peak)
    log(f"N={RING16384_N} blind_rotate_rns against its plain version: "
        f"{time.time() - t0:.1f} s")
    reset_counts()
    rns16k_timing = ring_path(ring_rns_contexts(rng, RING16384_N, RING16384_BATCH,
                                                RING16384_DECOMP_BATCH), card)
    rns16k_launches = rotate_rns_kernel.LAUNCHES
    check(rns16k_launches > 0, "the N = 16384 RNS path did not launch blind_rotate_rns")
    torch.cuda.empty_cache()
    rns16k_timing["phase_s"] = time.time() - t0
    log(f"N={RING16384_N} RNS phase: blind_rotate_rns launches {rns16k_launches} "
        f"({rns16k_timing['phase_s']:.1f} s)")

    # CiphertextMulMatrix and the DM accumulator: torch ops, no hand kernel
    t0 = time.time()
    gemm(rng, card)
    toy_gates(rng, "AP")
    std128_ap_nand(rng, card)
    log(f"GEMM and DM phases {time.time() - t0:.1f} s")

    # device RNS-CKKS: torch ops, no hand kernel
    t0 = time.time()
    ckks_timing = ckks(rng, card, contexts)
    log(f"CKKS phase {time.time() - t0:.1f} s")

    # CKKS bootstrapping and the advanced SHE layer on the device evaluator:
    # torch ops, no hand kernel
    t0 = time.time()
    boot_timing = ckksboot(card)
    log(f"CKKS bootstrap phase {time.time() - t0:.1f} s")
    t0 = time.time()
    she_timing = advancedshe(rng, card, contexts)
    log(f"advanced SHE phase {time.time() - t0:.1f} s")

    # the automatic-scaling CKKS layer and BGV: torch ops, no hand kernel
    auto_timing = ckks_auto(rng, card, contexts)
    del contexts
    t0 = time.time()
    bgv_timing = bgv(rng, card)
    log(f"BGV phase {time.time() - t0:.1f} s")

    # BFV through the ported front end, HPS and BEHZ: torch ops, no hand kernel
    t0 = time.time()
    bfv_timing = bfv(rng, card)
    log(f"BFV phase {time.time() - t0:.1f} s")

    loaded = [m for m in sys.modules if m in ("jax", "tfhe_tpu")
              or m.startswith(("jax.", "tfhe_tpu."))]
    check(not loaded, f"JAX or the JAX package was loaded: {loaded[:5]}")
    log(f"no jax or tfhe_tpu module loaded; {time.time() - t_start:.1f} s in all")

    print(json.dumps({"ckks": ckks_timing, "ckksboot": boot_timing,
                      "advancedshe": she_timing, "functional": plain_timing,
                      "seeded": seeded_timing, "ckks_auto": auto_timing,
                      "bgv": bgv_timing, "bfv": bfv_timing, "serial": serial_timing,
                      "mesh": mesh_timing, "ring4096": ring_timing,
                      "ring4096_single_prime": prime4k_timing, "ring8192": ring8k_timing,
                      "ring8192_rns": rns8k_timing, "ring8192_single_prime": prime8k_timing,
                      "ring16384_rns": rns16k_timing, "total_s": time.time() - t_start}),
          flush=True)
    print(json.dumps({"kernels": [
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_rotate.py:253",
         "launches": (gate_launches + mixed_launches + serial_gate_launches + mesh_launches[0]
                      + ring_launches[0] + ring8k_launches),
         **gate_timing, "ring4096": ring_kernels["blind_rotate"], "ring8192": ring8k_kernels,
         "library_ms": None},
        {"name": "blind_rotate_rns", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate_rns.cu",
         "replaces": "tfhe_tpu/ops/pallas_rotate_rns.py:278",
         "launches": (rns_launches + seeded_launches + serial_rns_launches + mesh_launches[1]
                      + ring_launches[1] + rns8k_launches + rns16k_launches),
         **rns_timing, "ring4096": ring_kernels["blind_rotate_rns"], "ring8192": rns8k_kernels,
         "ring16384": rns16k_kernels, "library_ms": None},
        {"name": "blind_rotate64", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate64.cu",
         "replaces": "tfhe_tpu/ops/pallas_rotate64.py:324",
         "launches": (nand_launches + prime_launches + mesh_launches[2] + prime4k_launches
                      + prime8k_launches),
         **r64_timing, "ring4096": ring_kernels["blind_rotate64"], "ring8192": r64_8k_kernels,
         "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
