"""Carry the JAX package's bootstrapping keys across to the port's tensors.

Counterpart of the single-limb branch of `JaxBackend._get_device_key`
(`tfhe_tpu/ops/backend.py:710-718`). Keygen stays on the host in the JAX
package's jax-free layers, so both packages compute on the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu.params import BinFHEParams
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.scheme import BTKey

from .ops.keyswitch import ksk_table
from .ops.rotate_kernel import pack_bsk


def device_key(params: BinFHEParams, key: BTKey,
               device: str | torch.device) -> dict[str, torch.Tensor]:
    """BTKey -> {"bsk_pack": int32 [n, 8*d2, N], "ksk": int32
    [N*baseKS*dc, n + 1]} on `device`. The CGGI key `bsk_coeff`
    [n, 2, d2, 2, N] goes to the evaluation domain with the host NTT and
    then to the kernel's layout."""
    Q = params.lwe.Q
    bsk_hat = ref_ntt.forward(np.asarray(key.bsk_coeff, dtype=np.uint64), Q)
    return {
        "bsk_pack": pack_bsk(bsk_hat, Q).to(device),
        "ksk": ksk_table(key.ksk.A, key.ksk.B).to(device),
    }
