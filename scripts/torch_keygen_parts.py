#!/usr/bin/env python3
"""Where the host keygen of one accelerated bootstrapping key spends its
time, and the same ring products on the card.

    python3 scripts/torch_keygen_parts.py [--rings 8192,16384] [--n 1305]

For each ring: the STD128 accelerated set `from_gpu_style(STD128, False, 17,
N=ring, num_digits_to_throw=1)` (Q = q1 * q2, base 2^18, d2 = 4), one key's
2 n d2 RGSW rows of `ref/rgsw.keygen_acc_cggi`, timed part by part on the
host clock: the uniform draw (`rng.discrete_uniform`), the Gaussian draw
(`rng.discrete_gaussian`), the host ring products (forward NTT through the
native engine, the Montgomery product with the secret's NTT, inverse NTT),
and the same products by `ops/keygen.ring_mul` on the card, which must give
the same words. Prints the card's name and power limit and one JSON line.
Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def arg(name: str, default: str) -> str:
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else default


def main() -> int:
    import numpy as np
    import torch

    from tfhe_tpu_torch import ParamSet, from_gpu_style, lwe
    from tfhe_tpu_torch.ops import keygen
    from tfhe_tpu_torch.ref import modmath, ntt
    from tfhe_tpu_torch.utils.rng import BinFHERng

    if not torch.cuda.is_available():
        print("torch_keygen_parts: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    n = int(arg("--n", "1305"))
    out = {"n": n, "host_cores": os.cpu_count()}
    for N in (int(r) for r in arg("--rings", "8192,16384").split(",")):
        p = from_gpu_style(ParamSet.STD128, False, 17, N=N, num_digits_to_throw=1)
        rp, Q = p.rgsw, p.lwe.Q
        rng = BinFHERng(20261016)
        s_coeff = modmath.asarray(lwe.key_gen(rng, N, Q).s, Q)
        s_ntt = ntt.forward(s_coeff, Q)
        R, t = n * 2 * rp.digits_g2, {}
        c = time.time()
        a = rng.discrete_uniform(R * N, Q).reshape(R, N).astype(np.uint64, copy=False)
        t["uniform_s"] = time.time() - c
        c = time.time()
        rng.discrete_gaussian(R * N, rp.std, Q)
        t["gaussian_s"] = time.time() - c
        c = time.time()
        a_hat = ntt.forward(a, Q)
        t["host_forward_s"] = time.time() - c
        c = time.time()
        prod = modmath.mul(a_hat, s_ntt[None, :], Q)
        del a_hat
        t["host_product_s"] = time.time() - c
        c = time.time()
        b_host = ntt.inverse(prod, Q)
        del prod
        t["host_inverse_s"] = time.time() - c
        for rep in ("first", "warm"):
            torch.cuda.synchronize()
            c = time.time()
            b_card = keygen.ring_mul(s_coeff, Q, rp.rns_primes, "cuda")(a)
            t[f"card_products_{rep}_s"] = time.time() - c
        if not np.array_equal(b_host, b_card):
            print(f"torch_keygen_parts: the card's products differ at N = {N}",
                  file=sys.stderr)
            return 1
        host = t["host_forward_s"] + t["host_product_s"] + t["host_inverse_s"]
        draws = t["uniform_s"] + t["gaussian_s"]
        print(f"[keygen] N={N} n={n} d2={rp.digits_g2} ({R} rows): uniform {t['uniform_s']:.2f} s, "
              f"gaussian {t['gaussian_s']:.2f} s, host products {host:.2f} s (forward "
              f"{t['host_forward_s']:.2f}, product {t['host_product_s']:.2f}, inverse "
              f"{t['host_inverse_s']:.2f}): {100 * host / (host + draws):.1f}% of the "
              f"draws and products; on the card {t['card_products_warm_s']:.2f} s warm "
              f"({t['card_products_first_s']:.2f} first), the same words", flush=True)
        out[f"N={N}"] = t
        del a, b_host, b_card
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
