#!/usr/bin/env python3
"""Decryption failures and bootstrap output noise of the STD128 logQ = 11
sets on one GPU, at N = 4096 and N = 8192 (about five minutes of command).

    python3 scripts/torch_noise_logq11.py

For each ring: `from_gpu_style(STD128, False, 11, N, num_digits_to_throw=1)`
with a seeded switching key (`chip_smoke.mixed_contexts`), and the arbFunc
set with no digit thrown on the same secrets and switching key; at batch
1024 a NAND, an EvalFloor (roundbits 1) and an EvalFunc (the cube LUT) on
the card. Prints one JSON line a ring: the standard deviation and largest
magnitude of the NAND outputs' error (their phase b - <a, s> less m q/4, in
units of q), the rows of each operation that decrypt wrong, and the
EvalFunc outputs' error. At N = 8192 the first two EvalFloor rows that
decrypt wrong are held to the port's host oracle (its switching key the
seeded A block drawn on the card): the card's outputs equal it bit for
bit, and it decrypts them wrong too. Q is a 27-bit prime at every ring
while q = 2N, so the bootstraps' noise in units of q grows with N. Prints
the card's name and power limit first. Imports no jax.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tfhe_tpu_torch import Gate, ParamSet  # noqa: E402


def phase(cc, sk, ct):
    return np.asarray(cc.decrypt_without_scale(sk, ct), dtype=np.int64)


def centred(x, q):
    x = x % q
    return np.where(x >= q // 2, x - q, x)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_noise_logq11: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(cs.SEED)
    B = 1024
    for N in (4096, 8192):
        t0 = time.time()
        mixed, sk, kg = cs.mixed_contexts(ParamSet.STD128, throws=(1,), N=N, seeded=True)
        fl = mixed[1]
        key = fl.bt_key
        arb, _, kg2 = cs.mixed_contexts(ParamSet.STD128, throws=(0,), arb_func=True, N=N, sk=sk,
                                        shared={"sk_n": key.sk_n, "ksk": key.ksk}, seeded=True)
        fc = arb[0]
        print(f"N={N} keygen {kg:.1f} + {kg2:.1f} s", flush=True)
        fl.device_setup("cuda")
        fc.device_setup("cuda")
        q = fl.params.lwe.q
        # NAND output noise: encoding m q/4 with p = 4 after the +q/8 shift
        m1, m2 = rng.integers(0, 2, B), rng.integers(0, 2, B)
        ct = fl.eval_bin_gate(Gate.NAND, fl.encrypt(sk, m1), fl.encrypt(sk, m2))
        want = 1 - (m1 & m2)
        ph = phase(fl, sk, ct)
        err_nand = centred(ph - want * (q // 4), q)
        # EvalFloor
        ctf, mf, pf = cs.floor_inputs(fl, sk, rng, B)
        of = fl.eval_floor(ctf, 1)
        dec = np.asarray(fl.decrypt(sk, of, pf // 2), dtype=np.int64)
        bad_floor = np.nonzero(dec != mf // 2)[0]
        # EvalFunc (arbFunc, cube LUT)
        ctu, lut, wantu, pu = cs.func_inputs(fc, sk, rng, B)
        ou = fc.eval_func(ctu, lut)
        decu = np.asarray(fc.decrypt(sk, ou, pu), dtype=np.int64)
        bad_func = np.nonzero(decu != wantu)[0]
        qf = fc.params.lwe.q
        err_func = centred(phase(fc, sk, ou) - wantu * (qf // pu), qf)
        rec = {"N": N, "q": q, "nand_err_std": float(err_nand.std()),
               "nand_err_maxabs": int(np.abs(err_nand).max()),
               "nand_bad": int((np.asarray(fl.decrypt(sk, ct)) != want).sum()),
               "floor_bad": int(len(bad_floor)), "floor_bad_rows": bad_floor[:20].tolist(),
               "func_bad": int(len(bad_func)), "func_err_std": float(err_func.std()),
               "func_q": qf, "func_p": pu, "beta": fl.get_beta()}
        print(json.dumps(rec), flush=True)
        if N == 8192 and len(bad_floor):
            key.ksk.materialize("cuda")
            fl.device_clean()
            rows = bad_floor[:2]
            ref = fl.eval_floor(type(ctf)(ctf.a[rows], ctf.b[rows], ctf.modulus), 1)
            same = (np.array_equal(np.asarray(ref.a), np.asarray(of.a)[rows])
                    and np.array_equal(np.asarray(ref.b), np.asarray(of.b)[rows]))
            rdec = np.asarray(fl.decrypt(sk, ref, pf // 2), dtype=np.int64)
            print(json.dumps({"oracle_rows": rows.tolist(), "card_equals_oracle": bool(same),
                              "oracle_decrypts_wrong": (rdec != mf[rows] // 2).tolist()}),
                  flush=True)
        del fl, fc, mixed, arb
        torch.cuda.empty_cache()
        print(f"N={N} done in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
