"""Device-resident DCRT tower primitives (limb moduli < 2^31).

Port of `tfhe_tpu/pke/dcrt_device.py`: the [L, N] residue towers of the
pure-RNS pke stack (pke/ckks_rns.py) as int64 torch tensors, with the
limb-stacked NTT (`ops/nttl.py`) and vectorized modular pointwise ops
(`ops/modmathv.py`). Every step is exact integer arithmetic, so device
towers are bit-identical to the host tower. Each `build_*` is cached per
chain and device and returns a function of towers on that device; the
host-facing wrappers run on the card unless the caller names the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import modmathv as mv
from ..ops.nttl import NTTL
from .dcrt import DCRTParams, DCRTPoly


def _check(params: DCRTParams) -> None:
    if not all(m < (1 << 31) for m in params.moduli):
        raise ValueError("device tower needs limb moduli < 2^31 "
                         "(use DCRTParams.create(bits<=30))")


@functools.lru_cache(maxsize=None)
def build_to_eval(params: DCRTParams, device: str):
    _check(params)
    return NTTL(params.N, tuple(params.moduli), device=device).forward


@functools.lru_cache(maxsize=None)
def build_to_coeff(params: DCRTParams, device: str):
    _check(params)
    return NTTL(params.N, tuple(params.moduli), device=device).inverse


@functools.lru_cache(maxsize=None)
def build_tensor_mult(params: DCRTParams, device: str):
    """(a0, a1, b0, b1) eval-form towers -> (d0, d1, d2) of the CKKS tensor
    product: d0 = a0*b0, d1 = a0*b1 + a1*b0, d2 = a1*b1."""
    _check(params)
    lm = mv.LimbModuli(tuple(params.moduli), device=device)

    def tensor(a0, a1, b0, b1):
        d0 = mv.barrett_mulmod_v(a0, b0, lm)
        d1 = mv.addmod_v(mv.barrett_mulmod_v(a0, b1, lm),
                         mv.barrett_mulmod_v(a1, b0, lm), lm)
        d2 = mv.barrett_mulmod_v(a1, b1, lm)
        return d0, d1, d2

    return tensor


@functools.lru_cache(maxsize=None)
def build_rescale(params: DCRTParams, device: str):
    """RNS ModReduce: drop the last limb, scale by 1/q_last (the device form
    of ckks_rns.rescale_rns; input and output in coefficient form — compose
    with to_coeff/to_eval for eval-form towers)."""
    _check(params)
    q_last = params.moduli[-1]
    keep = tuple(params.moduli[:-1])
    lm = mv.LimbModuli(keep, device=device)
    inv = np.array([pow(q_last, -1, m) for m in keep], dtype=np.int64)
    inv_t, inv_sh = lm.tensor(inv), lm.tensor(lm.shoup(inv))
    q_last_mod = lm.tensor([q_last % m for m in keep])

    def rescale(rns):                               # [L, N] coeff-form
        nd = rns.ndim
        c_last = rns[-1:]
        # reduce both operands mod each kept limb before the centered
        # subtraction (mixed-width chains: m < q_last)
        cl_m = mv.mod_u32_v(c_last, lm)
        cl = torch.where(c_last > q_last // 2,
                         mv.submod_v(cl_m, lm.bc(q_last_mod, nd), lm), cl_m)
        diff = mv.submod_v(mv.mod_u32_v(rns[:-1], lm), cl, lm)
        return mv.mulmod_shoup_v(diff, lm.bc(inv_t, nd), lm.bc(inv_sh, nd), lm)

    return rescale


# -- host-facing wrappers ---------------------------------------------------

def to_device(rns: np.ndarray, device: str) -> torch.Tensor:
    """A host uint64 tower as an int64 tensor on `device`."""
    return torch.as_tensor(np.asarray(rns, dtype=np.uint64).astype(np.int64),
                           device=device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A device tower as a host uint64 array."""
    return t.cpu().numpy().astype(np.uint64)


def to_eval_device(poly: DCRTPoly, device: str = "cuda") -> DCRTPoly:
    fn = build_to_eval(poly.params, device)
    out = to_host(fn(to_device(poly.to_coeff().rns, device)))
    return DCRTPoly(poly.params, out, eval_form=True)


def tensor_mult_device(a: list[DCRTPoly], b: list[DCRTPoly],
                       device: str = "cuda") -> list[DCRTPoly]:
    """CKKS tensor product of two 2-poly ciphertext towers on the device."""
    lp = a[0].params
    fn = build_tensor_mult(lp, device)
    args = [to_device(p.to_eval().rns, device) for p in (a[0], a[1], b[0], b[1])]
    return [DCRTPoly(lp, to_host(d), True) for d in fn(*args)]


def rescale_device(poly: DCRTPoly, device: str = "cuda") -> DCRTPoly:
    lp = poly.params
    fn = build_rescale(lp, device)
    out = to_host(fn(to_device(poly.to_coeff().rns, device)))
    new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])
    return DCRTPoly(new_lp, out, eval_form=False).to_eval()
