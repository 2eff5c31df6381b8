"""TorchBackend: the `scheme.Backend` of the port, for the CGGI gate path.

Port of the single-limb gate branch of `tfhe_tpu/ops/backend.py`
(`JaxBackend`, `build_full_gate_pipeline`). A gate bootstrap runs on one
device from the raw u16 ciphertexts to the u16 result: the gate's LWE
combination, the scaled indices and test polynomial of `_gate_core`, the
blind rotation (`rotate_kernel.rotate`: the hand-written kernel on CUDA, its
plain version on the CPU), transpose/extract, +Q/8, and the fused MKM
switch. Configurations outside the slice raise in `setup`, and `scheme`
keeps to its generic route for every operation this class does not define.
"""

from __future__ import annotations

import numpy as np
import torch

from tfhe_tpu import lwe
from tfhe_tpu.params import BinFHEParams, Gate, Method

from ..convert import device_key
from .blindrotate import transpose_extract
from .keyswitch import mkm_switch
from .modmath import addmod, negmod, submod
from .rotate_kernel import rotate


class TorchBackend:
    """Implements `scheme.Backend` and the fast paths `gate_bootstrap` and
    `gate_bootstrap_pair` on one torch device."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchBackend: no CUDA device is available")
        self._device_keys: dict[int, dict[str, torch.Tensor]] = {}
        self._staging: dict[int, torch.Tensor] = {}

    # -- setup -------------------------------------------------------------

    @staticmethod
    def supports(params: BinFHEParams) -> bool:
        p, rg = params.lwe, params.rgsw
        d2 = 2 * (rg.digits_g - rg.num_digits_to_throw)
        return (rg.method == Method.GINX and p.Q < (1 << 28)
                and p.q_ks < (1 << 31) and (2 * p.Q - 1) * d2 < (1 << 32)
                and p.q <= (1 << 16))

    def setup(self, params: BinFHEParams, key) -> None:
        self._device_key(params, key)

    def _device_key(self, params: BinFHEParams, key) -> dict[str, torch.Tensor]:
        if not self.supports(params):
            raise NotImplementedError(
                "TorchBackend requires GINX with Q < 2^28, qKS < 2^31, "
                "(2Q - 1) * d2 < 2^32 and q <= 2^16; other configurations "
                "run on the host oracle backend")
        cache_id = id(key.bsk_coeff)
        if cache_id not in self._device_keys:
            self._device_keys[cache_id] = device_key(params, key, self.device)
        return self._device_keys[cache_id]

    # -- protocol ----------------------------------------------------------

    def eval_acc(self, params: BinFHEParams, key, acc_init: np.ndarray,
                 a_batch: np.ndarray, a_modulus: int) -> np.ndarray:
        dk = self._device_key(params, key)
        rg = params.rgsw
        acc = torch.from_numpy(np.asarray(acc_init).astype(np.int32))
        a = torch.from_numpy(np.asarray(a_batch).astype(np.int64))
        a_idx = self._scaled_indices(a.to(self.device), a_modulus, rg.N)
        out = rotate(acc.to(self.device), a_idx, dk["bsk_pack"], rg.Q,
                     rg.base_g, rg.num_digits_to_throw)
        return out.cpu().numpy().astype(np.uint64)

    def mkm_switch(self, params: BinFHEParams, key, a_ext: np.ndarray,
                   b_ext: np.ndarray, fmod: int) -> lwe.LWECiphertext:
        dk = self._device_key(params, key)
        p = params.lwe
        a = torch.from_numpy(np.asarray(a_ext).astype(np.int64)).to(self.device)
        b = torch.from_numpy(np.asarray(b_ext).astype(np.int64)).to(self.device)
        a_out, b_out = mkm_switch(a, b, dk["ksk"], p.Q, p.q_ks, p.base_ks,
                                  p.digit_count_ks, int(fmod))
        return lwe.LWECiphertext(a_out.cpu().numpy().astype(np.uint64),
                                 b_out.cpu().numpy().astype(np.uint64),
                                 int(fmod))

    # -- fused gate bootstrap ----------------------------------------------

    @staticmethod
    def _gate_ok(params: BinFHEParams, q: int, fmod: int) -> bool:
        return (q == params.lwe.q and (2 * params.rgsw.N) % q == 0
                and q <= (1 << 16) and int(fmod) == q)

    def gate_bootstrap(self, params: BinFHEParams, key, gate: Gate,
                       ct: lwe.LWECiphertext, fmod: int):
        """Gate bootstrap of the prepped (combined) batch; None when this
        configuration takes the generic accumulator path."""
        q = int(ct.modulus)
        if not self._gate_ok(params, q, fmod):
            return None
        a, b = self._upload([ct.a, ct.b])
        return self._gate(params, key, gate, a, b)

    def gate_bootstrap_pair(self, params: BinFHEParams, key, gate: Gate,
                            ct1: lwe.LWECiphertext, ct2: lwe.LWECiphertext,
                            neg2: bool, fmod: int):
        """Gate bootstrap of two raw batches: ct1 + ct2, or 2 (ct1 - ct2)
        when `neg2`, combined on the device. None when this configuration
        takes the generic path."""
        q = int(ct1.modulus)
        if not self._gate_ok(params, q, fmod):
            return None
        a1, b1, a2, b2 = self._upload([ct1.a, ct1.b, ct2.a, ct2.b])
        if neg2:
            a, b = submod(a1, a2, q), submod(b1, b2, q)
            a, b = addmod(a, a, q), addmod(b, b, q)
        else:
            a, b = addmod(a1, a2, q), addmod(b1, b2, q)
        return self._gate(params, key, gate, a, b)

    def _gate(self, params: BinFHEParams, key, gate: Gate, a: torch.Tensor,
              b: torch.Tensor) -> lwe.LWECiphertext:
        """a [B, n], b [B] int64 residues mod q on the device -> the
        bootstrapped ciphertexts mod q (binfhe-base-scheme.cpp:1087-1145)."""
        dk = self._device_key(params, key)
        p, rg = params.lwe, params.rgsw
        N, Q, q = rg.N, rg.Q, p.q
        q_half = q >> 1
        q1 = int(rg.gate_const(gate)) % q
        q2 = (q1 + q_half) % q
        factor = 2 * N // q
        q8 = Q // 8 + 1
        B = a.shape[0]

        a_idx = self._scaled_indices(a, q, N)
        # test polynomial m[j*factor] = +-(Q/8 + 1) by window membership
        temp = submod(b[:, None], torch.arange(q_half, device=a.device), q)
        if q1 < q2:
            in_win = (temp >= q1) & (temp < q2)
        else:
            in_win = ~((temp >= q2) & (temp < q1))
        acc = torch.zeros((B, 2, N), dtype=torch.int32, device=a.device)
        acc[:, 1, ::factor] = torch.where(in_win, Q - q8, q8).to(torch.int32)

        acc = rotate(acc, a_idx, dk["bsk_pack"], Q, rg.base_g,
                     rg.num_digits_to_throw)
        a_t, b_t = transpose_extract(acc.to(torch.int64), Q)
        a_out, b_out = mkm_switch(a_t, addmod(b_t, q8, Q), dk["ksk"], Q, p.q_ks,
                                  p.base_ks, p.digit_count_ks, q)
        return self._download(a_out, b_out, q)

    # -- host <-> device ---------------------------------------------------

    @staticmethod
    def _bucket(B: int) -> int:
        """Batch size rounded up to a power of two (at least 8): the staging
        buffers are reused across calls of similar size."""
        b = 8
        while b < B:
            b *= 2
        return b

    def _upload(self, arrays) -> list[torch.Tensor]:
        """Host arrays [B, k] or [B] of residues < 2^16 -> int64 device
        tensors of the same shapes, in one copy of u16 words from a staging
        buffer (pinned for CUDA)."""
        B = np.shape(arrays[0])[0]
        cols = [int(np.prod(np.shape(x)[1:])) for x in arrays]
        width = sum(cols)
        # Refilling the buffer is safe: the previous call's asynchronous copy
        # out of it finished before that call's `_download` returned.
        buf = self._staging.get(width)
        if buf is None or buf.shape[0] < B:
            buf = torch.empty((self._bucket(B), width), dtype=torch.int16,
                              pin_memory=self.device.type == "cuda")
            self._staging[width] = buf
        view = buf.numpy().view(np.uint16)
        c = 0
        for x, k in zip(arrays, cols):
            view[:B, c:c + k] = np.asarray(x).reshape(B, k)
            c += k
        dev = buf[:B].to(self.device, non_blocking=True).to(torch.int64) & 0xFFFF
        return [t.reshape(np.shape(x)) for t, x in
                zip(torch.split(dev, cols, dim=1), arrays)]

    @staticmethod
    def _download(a: torch.Tensor, b: torch.Tensor, q: int) -> lwe.LWECiphertext:
        """int64 device results < 2^16 -> u16 host ciphertexts, one copy."""
        both = torch.cat([a, b[:, None]], dim=1)
        both = torch.where(both >= (1 << 15), both - (1 << 16), both)
        host = both.to(torch.int16).cpu().numpy().view(np.uint16)
        n = a.shape[1]
        return lwe.LWECiphertext(np.ascontiguousarray(host[:, :n]),
                                 np.ascontiguousarray(host[:, n]), q)

    @staticmethod
    def _scaled_indices(a: torch.Tensor, q: int, N: int) -> torch.Tensor:
        """int64 a (any representative mod q) -> contiguous int32 exponents
        (q - a) * (2N / q) mod 2N (rgsw-acc-cggi.cpp:151-154)."""
        idx = negmod(a, q) * (2 * N // q) % (2 * N)
        return idx.to(torch.int32).contiguous()
