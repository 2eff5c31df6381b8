"""TorchBackend: the `scheme.Backend` of the port.

Port of the branches of `tfhe_tpu/ops/backend.py` (`JaxBackend`):
- the single-limb gate slice (`build_full_gate_pipeline`): a gate bootstrap
  runs on one device from the raw u16 ciphertexts to the u16 result: the
  gate's LWE combination, the scaled indices and test polynomial of
  `_gate_core`, the blind rotation (`rotate_kernel.rotate`), transpose/
  extract, +Q/8, and the fused MKM switch;
- the mixed logQ = 11 sets (`_is_mixed`, a 27-bit Q with qKS = 2^35): the
  same rotation kernel and layout, followed by the MKM switch that scales
  the extracted ciphertext up from Q to qKS (`build_full_gate_pipeline`'s
  `mixed` branch, `build_func_acc32` and `build_tail64_from32`), with the
  gate fast path and the device chain of EvalFunc/EvalFloor;
- the RNS functional path of the accelerated sets (Q = q1*q2, qKS = 2^35):
  the device-built functional test polynomial (`build_func_acc_rns`), the
  two-lane blind rotation (`rotate_rns_kernel.rotate_rns`), Garner CRT,
  transpose/extract and the 35-bit MKM switch (`build_mkm_switch64`), and
  the device-resident chain glue of EvalFunc/EvalSign/EvalDecomp
  (`DeviceLWE`, `func_bootstrap_dev`, `dev_*`);
- the two-limb sets, one ring modulus 2^28 <= Q < 2^54 (the big-Q classic
  sets STD192, STD128Q, STD192Q and their _OPT rows, STD256/STD256_OPT,
  and the accelerated sets at the reference's single 54-bit prime): the
  64-bit rotation (`rotate64_kernel.rotate64`), transpose/extract and the
  MKM switch from the big Q;
- the DM/AP accumulator on the small-modulus sets (`blindrotate_dm`, torch
  ops: the JAX package runs it as XLA code, outside any Pallas kernel).
The CGGI rotations are hand-written kernels on CUDA and their plain
versions on the CPU. Configurations outside the slices raise
NotImplementedError in `setup`. Every operation without a fast path here
(gates on the RNS, two-limb and DM sets, every function on the two-limb and
DM sets, functions that are not a value table) reaches `bootstrap_pipeline`
from `scheme` with a host-built accumulator, as in the JAX package, and
stays on the device from the rotation to the key switch.

Several devices (`JaxBackend(num_devices, mesh)`,
`tfhe_tpu/ops/backend.py:481-549`): every batched entry point splits its
batch over the shards of a `("batch",)` mesh (`parallel/mesh.py`), each
distinct device holding one copy of the keys; without a mesh the backend
is a mesh of one shard. Every shard's work is launched before any shard's
result is downloaded, so distinct GPUs overlap. The device chain stays on
the devices under a mesh, shard by shard (`DeviceLWE`), where the JAX
package takes the host accumulator path; the outputs are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import lwe
from ..convert import device_key
from ..params import BinFHEParams, Gate, Method
from ..parallel.mesh import Mesh, gather, make_mesh, replicate, shard_rows, split_batch
from .blindrotate import transpose_extract
from .blindrotate_dm import dm_digits, dm_limbs, dm_rotate
from .keyswitch import mkm_switch
from .modmath import addmod, crt_combine, mod, negmod, submod
from . import rotate64_kernel, rotate_kernel, rotate_rns_kernel
from .rotate64_kernel import rotate64
from .rotate_kernel import rotate
from .rotate_rns_kernel import rotate_rns

_FUNC_CHUNK = 8192   # ciphertexts per functional or DM bootstrap on the device


class DeviceLWE:
    """Device-resident LWE ciphertext batch of B for the functional chains,
    split over the backend's shards: `parts[i]` is shard i's (a [rows, n],
    b [rows]) int64 tensors on its device, None for a shard without rows
    (`parallel.mesh.shard_rows`). Under a process group only this process's
    shards are held. Values are residues mod `modulus`, or a raw retag of a
    larger modulus (the EvalDecomp digit convention, lwe.py set_modulus)."""

    __slots__ = ("parts", "modulus", "B")

    def __init__(self, parts: list, modulus: int, B: int):
        self.parts, self.modulus, self.B = parts, modulus, B

    def map(self, fn, modulus: int | None = None) -> "DeviceLWE":
        """fn(a, b) -> (a, b) on every shard's tensors."""
        return DeviceLWE([None if p is None else fn(*p) for p in self.parts],
                         self.modulus if modulus is None else int(modulus), self.B)


class TorchBackend:
    """Implements `scheme.Backend` and the fast paths `scheme` probes for
    (`gate_bootstrap`, `gate_bootstrap_pair`, `func_bootstrap`,
    `chain_supported` and the device chain) on one torch device, or with
    every batch split over the shards of a `("batch",)` mesh:
    `num_devices > 1` takes the first CUDA devices (`make_mesh`, which
    raises when there are fewer), `mesh` any list of devices."""

    def __init__(self, device: str | torch.device = "cuda", num_devices: int = 0,
                 mesh: Mesh | None = None):
        if mesh is None and num_devices > 1:
            mesh = make_mesh(num_devices)
        if mesh is not None and mesh.axis != "batch":
            raise ValueError("TorchBackend shards batches over a 'batch' mesh")
        self.mesh = mesh
        self._shards = mesh if mesh is not None else Mesh([device], span_processes=False)
        self.device = self._shards.devices[0]
        if (any(d.type == "cuda" for d in self._shards.devices)
                and not torch.cuda.is_available()):
            raise RuntimeError("TorchBackend: no CUDA device is available")
        # id(key.bsk_coeff) -> one device key per shard (shards on one
        # device share its copy)
        self._device_keys: dict[int, list[dict[str, torch.Tensor]]] = {}
        self._staging: dict[int, torch.Tensor] = {}

    # -- setup -------------------------------------------------------------

    @staticmethod
    def _is_gate_set(params: BinFHEParams) -> bool:
        """Single-limb GINX: the STD128-class gate slice."""
        p, rg = params.lwe, params.rgsw
        return (rg.method == Method.GINX and p.Q < (1 << 28)
                and p.q_ks < (1 << 31) and (2 * p.Q - 1) * rg.digits_g2 < (1 << 32)
                and p.q <= (1 << 16) and rg.N in rotate_kernel.RING_DIMS)

    @staticmethod
    def _is_mixed_set(params: BinFHEParams) -> bool:
        """Q < 2^28 for the single-limb rotation with a power-of-two qKS in
        (2^32, 2^40) and baseKS: the accelerated logQ = 11 sets
        (`JaxBackend._is_mixed`), with the conditions of the kernel they
        run (the JAX package's `pallas_ok`)."""
        p, rg = params.lwe, params.rgsw
        return (rg.method == Method.GINX and p.Q < (1 << 28)
                and (1 << 32) < p.q_ks < (1 << 40)
                and p.q_ks & (p.q_ks - 1) == 0
                and p.base_ks & (p.base_ks - 1) == 0
                and (2 * p.Q - 1) * rg.digits_g2 < (1 << 32)
                and rg.N in rotate_kernel.RING_DIMS and p.q <= (1 << 16))

    @staticmethod
    def _is_rns_set(params: BinFHEParams) -> bool:
        """Composite Q = q1*q2 with a power-of-two qKS in (2^32, 2^40): the
        accelerated sets (`JaxBackend._use_rns`, `supports`)."""
        p, rg = params.lwe, params.rgsw
        pr = rg.rns_primes
        if rg.method != Method.GINX or pr is None:
            return False
        q1, q2 = pr
        return (q2 < q1 < (1 << 28) and (2 * q1 - 1) * rg.digits_g2 < (1 << 32)
                and rg.base_g <= (1 << 27) and (rg.base_g >> 1) < q2
                and rg.N in rotate_rns_kernel.RING_DIMS
                and (1 << 32) < p.q_ks < (1 << 40)
                and p.q_ks & (p.q_ks - 1) == 0
                and p.base_ks & (p.base_ks - 1) == 0)

    @classmethod
    def _is_two_limb_set(cls, params: BinFHEParams) -> bool:
        """One ring modulus 2^28 <= Q < 2^54 that the RNS predicate does
        not take, with qKS < 2^31 (the big-Q classic sets and STD256) or a
        power-of-two qKS in (2^32, 2^40) and baseKS (the accelerated sets
        with `rns_modulus=False`): GINX as in `JaxBackend.supports`. Below
        2^28 a Q with qKS = 2^35 is the mixed path."""
        p, rg = params.lwe, params.rgsw
        if (rg.method != Method.GINX or cls._is_gate_set(params)
                or cls._is_rns_set(params)):
            return False
        if not ((1 << 28) <= p.Q < (1 << 54) and rg.N in rotate64_kernel.RING_DIMS
                and 2 * p.Q * rg.digits_g2 < (1 << 62) and rg.base_g <= (1 << 27)):
            return False
        if p.q_ks < (1 << 31):
            return True
        return ((1 << 32) < p.q_ks < (1 << 40) and p.q_ks & (p.q_ks - 1) == 0
                and p.base_ks & (p.base_ks - 1) == 0)

    @staticmethod
    def _is_dm_set(params: BinFHEParams) -> bool:
        """AP with Q and qKS below 2^31 and a DM key table under the JAX
        package's guard, computed with its formula (the bytes of its
        7-bit-limb bf16 table), so both packages take the same sets
        (`JaxBackend.supports`)."""
        p, rg = params.lwe, params.rgsw
        if rg.method != Method.AP or p.Q >= (1 << 31) or p.q_ks >= (1 << 31):
            return False
        table_bytes = (p.n * len(rg.digits_r) * rg.base_r * dm_limbs(rg.Q)
                       * 2 * rg.digits_g * 2 * rg.N * 2)
        return table_bytes < 6e9

    @classmethod
    def _path(cls, params: BinFHEParams) -> str | None:
        """"gate", "mixed", "rns", "two_limb" or "dm": the slice that runs
        these parameters; None when none does."""
        for path, pred in (("gate", cls._is_gate_set), ("mixed", cls._is_mixed_set),
                           ("rns", cls._is_rns_set), ("two_limb", cls._is_two_limb_set),
                           ("dm", cls._is_dm_set)):
            if pred(params):
                return path
        return None

    @classmethod
    def supports(cls, params: BinFHEParams) -> bool:
        return cls._path(params) is not None

    def setup(self, params: BinFHEParams, key) -> None:
        self._device_key(params, key)

    def _device_key(self, params: BinFHEParams, key,
                    shard: int = 0) -> dict[str, torch.Tensor]:
        """The device key of `key` on shard `shard`'s device, cached by the
        key object (never by the current gadget base, which EvalSign
        switches under it). The key is converted on the host once, for the
        first device, and its tensors copied to the others. Raises when the
        key's digit count does not match the current base."""
        path = self._path(params)
        if path is None:
            raise NotImplementedError(
                "TorchBackend runs GINX with Q < 2^28, (2Q - 1) * d2 < 2^32, "
                "q <= 2^16 and qKS < 2^31 (the classic gate sets) or a "
                "power-of-two qKS in (2^32, 2^40) (the mixed logQ = 11 sets), "
                f"both at N in {rotate_kernel.RING_DIMS}; Q = q1*q2 with "
                "q2 < q1 < 2^28 and a power-of-two qKS in (2^32, 2^40) (the "
                f"accelerated RNS sets) at N in {rotate_rns_kernel.RING_DIMS}; "
                "one modulus 2^28 <= Q < 2^54 with qKS < 2^31 or a "
                "power-of-two qKS in (2^32, 2^40) (the two-limb sets) at N in "
                f"{rotate64_kernel.RING_DIMS}; and AP with Q, qKS < 2^31 and a "
                "DM table under the JAX package's guard; these parameters are "
                "not ported")
        rg = params.rgsw
        # CGGI keys [n, 2, d2, 2, N]; DM keys [n, baseR, digitsR, d2, 2, N]
        # with every digit (DM throws none)
        if (np.shape(key.bsk_coeff)[-3] != (2 * rg.digits_g if path == "dm"
                                            else rg.digits_g2)):
            raise ValueError("the key's digit count does not match the "
                             "current gadget base")
        cache_id = id(key.bsk_coeff)
        if cache_id not in self._device_keys:
            dk = device_key(params, key, self.device, path)
            copies = {name: replicate(self._shards, t) for name, t in dk.items()}
            self._device_keys[cache_id] = [
                {name: c[i] for name, c in copies.items()}
                for i in range(len(self._shards.devices))]
        return self._device_keys[cache_id][shard]

    def _rotate(self, params: BinFHEParams, dk, acc: torch.Tensor,
                a_idx: torch.Tensor) -> torch.Tensor:
        """The blind rotation of acc [B, 2, N] int64 residues mod Q on the
        device by the kernel of the key's path -> int64 [B, 2, N]."""
        rg = params.rgsw
        throw = rg.num_digits_to_throw
        if "bsk_rns" in dk:
            q1, q2 = rg.rns_primes
            o1, o2 = rotate_rns(*[(acc % qi).to(torch.int32) for qi in (q1, q2)],
                                a_idx, dk["bsk_rns"], q1, q2, rg.base_g, throw)
            return crt_combine(o1.to(torch.int64), o2.to(torch.int64), q1, q2)
        if "bsk64" in dk:
            return rotate64(acc.contiguous(), a_idx, dk["bsk64"], rg.Q,
                            rg.base_g, throw)
        return rotate(acc.to(torch.int32), a_idx, dk["bsk_pack"], rg.Q,
                      rg.base_g, throw).to(torch.int64)

    def _dm_rotate(self, params: BinFHEParams, dk, acc: torch.Tensor,
                   a: torch.Tensor, a_modulus: int) -> torch.Tensor:
        """The DM accumulation of acc [B, 2, N] int64 residues mod Q by the
        LWE a-vectors a [B, n] (any representatives mod a_modulus), in
        slices of _FUNC_CHUNK ciphertexts -> int64 [B, 2, N]. DM takes the
        base-R digits of (q - a), never the CGGI exponents, and every
        gadget digit (`build_dm_rotate` is built with none thrown)."""
        rg = params.rgsw
        digits = dm_digits(a, a_modulus, rg.base_r, len(rg.digits_r))
        return torch.cat([dm_rotate(acc[i:i + _FUNC_CHUNK], digits[i:i + _FUNC_CHUNK],
                                    dk["dm_table"], rg.Q, rg.base_g, rg.digits_g)
                          for i in range(0, acc.shape[0], _FUNC_CHUNK)])

    def _accumulate(self, params: BinFHEParams, dk, acc: torch.Tensor,
                    a: torch.Tensor, a_modulus: int) -> torch.Tensor:
        """The blind rotation of an accumulator batch acc [B, 2, N] by its
        LWE a-vectors a [B, n] (int64 on one device), by the key's path:
        the DM accumulation, or a CGGI kernel on the scaled exponents ->
        int64 [B, 2, N] residues mod Q."""
        if "dm_table" in dk:
            return self._dm_rotate(params, dk, acc, a, a_modulus)
        return self._rotate(params, dk, acc,
                            self._scaled_indices(a, a_modulus, params.rgsw.N))

    # -- shards ------------------------------------------------------------

    def _each(self, fn, *batches) -> list:
        """fn(shard, *rows) on every shard of this process that holds rows
        of the host batches (`split_batch`), launched in shard order with
        nothing downloaded; None for a shard without rows."""
        parts = [split_batch(self._shards, x) for x in batches]
        return [fn(i, *rows) if rows[0].shape[0] else None
                for i, rows in enumerate(zip(*parts))]

    def _gather(self, outs: list, k: int = 2, dtype=np.uint64) -> list[np.ndarray]:
        """Every shard's tuple of k result tensors (None for a shard without
        rows), downloaded after all were launched -> each result of the
        whole batch as a host array of `dtype`, in the input order."""
        host = [None if o is None else [t.cpu().numpy() for t in o] for o in outs]
        return [gather(self._shards, [None if h is None else h[j].astype(dtype, copy=False)
                                      for h in host]) for j in range(k)]

    def _lwe_out(self, outs: list, fmod: int) -> lwe.LWECiphertext:
        a, b = self._gather(outs)
        return lwe.LWECiphertext(a, b, int(fmod))

    # -- protocol ----------------------------------------------------------

    def eval_acc(self, params: BinFHEParams, key, acc_init: np.ndarray,
                 a_batch: np.ndarray, a_modulus: int) -> np.ndarray:
        outs = self._each(lambda i, acc, a: (self._accumulate(
            params, self._device_key(params, key, i), acc, a, a_modulus),),
            acc_init, a_batch)
        return self._gather(outs, 1)[0]

    def mkm_switch(self, params: BinFHEParams, key, a_ext: np.ndarray,
                   b_ext: np.ndarray, fmod: int) -> lwe.LWECiphertext:
        p = params.lwe

        def switch(i, a, b):
            return mkm_switch(a, b, self._device_key(params, key, i)["ksk"], p.Q,
                              p.q_ks, p.base_ks, p.digit_count_ks, int(fmod))

        return self._lwe_out(self._each(switch, a_ext, b_ext), fmod)

    def bootstrap_pipeline(self, params: BinFHEParams, key, acc_init: np.ndarray,
                           a_batch: np.ndarray, a_modulus: int, fmod: int,
                           add_q8: bool) -> lwe.LWECiphertext:
        """Bootstrap of a host-built accumulator batch
        (`JaxBackend.bootstrap_pipeline`, `tfhe_tpu/ops/backend.py:1164-1234`):
        the rotation, transpose/extract, +Q/8 when `add_q8` and the MKM
        switch to fmod, on the device from the rotation to the key switch
        (the reference pays a round trip between EvalAcc_CUDA and
        MKMSwitch_CUDA, binfhe-base-scheme.cpp:659-675). The DM branch
        stays there too, where the JAX package takes its host round trip
        (`tfhe_tpu/ops/backend.py:1173-1180`): the values are the same."""
        p, Q = params.lwe, params.rgsw.Q

        def pipeline(i, acc, a):
            dk = self._device_key(params, key, i)
            a_t, b = transpose_extract(self._accumulate(params, dk, acc, a, a_modulus), Q)
            if add_q8:
                b = addmod(b, Q // 8 + 1, Q)
            return mkm_switch(a_t, b, dk["ksk"], Q, p.q_ks, p.base_ks,
                              p.digit_count_ks, int(fmod))

        return self._lwe_out(self._each(pipeline, acc_init, a_batch), fmod)

    # -- fused gate bootstrap ----------------------------------------------

    def _gate_ok(self, params: BinFHEParams, q: int, fmod: int) -> bool:
        return (self._path(params) in ("gate", "mixed") and q == params.lwe.q
                and (2 * params.rgsw.N) % q == 0 and int(fmod) == q)

    def gate_bootstrap(self, params: BinFHEParams, key, gate: Gate,
                       ct: lwe.LWECiphertext, fmod: int):
        """Gate bootstrap of the prepped (combined) batch; None when this
        configuration takes the generic accumulator path."""
        q = int(ct.modulus)
        if not self._gate_ok(params, q, fmod):
            return None
        return self._download([None if up is None else self._gate(
            params, self._device_key(params, key, i), gate, *up)
            for i, up in enumerate(self._upload([ct.a, ct.b]))], q)

    def gate_bootstrap_pair(self, params: BinFHEParams, key, gate: Gate,
                            ct1: lwe.LWECiphertext, ct2: lwe.LWECiphertext,
                            neg2: bool, fmod: int):
        """Gate bootstrap of two raw batches: ct1 + ct2, or 2 (ct1 - ct2)
        when `neg2`, combined on the device. None when this configuration
        takes the generic path."""
        q = int(ct1.modulus)
        if not self._gate_ok(params, q, fmod):
            return None

        def combine(a1, b1, a2, b2):
            if neg2:
                a, b = submod(a1, a2, q), submod(b1, b2, q)
                return addmod(a, a, q), addmod(b, b, q)
            return addmod(a1, a2, q), addmod(b1, b2, q)

        return self._download([None if up is None else self._gate(
            params, self._device_key(params, key, i), gate, *combine(*up))
            for i, up in enumerate(self._upload([ct1.a, ct1.b, ct2.a, ct2.b]))], q)

    def _gate(self, params: BinFHEParams, dk, gate: Gate, a: torch.Tensor,
              b: torch.Tensor):
        """a [B, n], b [B] int64 residues mod q on one device -> the
        bootstrapped ciphertexts (a, b) mod q there, not yet downloaded
        (binfhe-base-scheme.cpp:1087-1145)."""
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
        return mkm_switch(a_t, addmod(b_t, q8, Q), dk["ksk"], Q, p.q_ks,
                          p.base_ks, p.digit_count_ks, q)

    # -- functional bootstrap (EvalFunc, EvalFloor, EvalSign, EvalDecomp) --

    def _func_core(self, params: BinFHEParams, dk, fv: np.ndarray,
                   a: torch.Tensor, b: torch.Tensor, ct_mod: int,
                   fmod: int):
        """One functional bootstrap on the device (the batched
        BootstrapFuncCore, binfhe-base-scheme.cpp:1147-1192): the test
        polynomial m[j * 2N/ctMod] = (Q // fmod) * fv[(b - j) mod ctMod]
        from the value table fv ([ctMod] shared, or [B, ctMod] per
        ciphertext), the blind rotation, extract and the MKM switch. a
        [B, n], b [B] int64 on the device are reduced mod ct_mod first (the
        raw-retag convention). Returns (a, b) int64 residues mod fmod."""
        p, rg = params.lwe, params.rgsw
        N, Q = rg.N, rg.Q
        a, b = mod(a, ct_mod), mod(b, ct_mod)
        a_idx = self._scaled_indices(a, ct_mod, N)
        gQ = np.asarray(fv, dtype=np.uint64) * np.uint64(Q // fmod) % np.uint64(Q)
        gQ = torch.from_numpy(gQ.astype(np.int64)).to(a.device)
        half, factor = ct_mod >> 1, 2 * N // ct_mod
        temp = mod(b[:, None] - torch.arange(half, device=a.device), ct_mod)
        vals = torch.gather(gQ, 1, temp) if gQ.ndim == 2 else gQ[temp]  # [B, half]
        acc = torch.zeros((a.shape[0], 2, N), dtype=torch.int64, device=a.device)
        acc[:, 1, ::factor] = vals
        a_t, b_t = transpose_extract(self._rotate(params, dk, acc, a_idx), Q)
        return mkm_switch(a_t, b_t, dk["ksk"], Q, p.q_ks, p.base_ks,
                          p.digit_count_ks, int(fmod))

    def func_bootstrap(self, params: BinFHEParams, key, fv: np.ndarray,
                       ct: lwe.LWECiphertext, fmod: int):
        """Functional bootstrap of a host batch with the test polynomial
        built on the device from the value table fv; None on the two-limb
        and DM sets (the JAX package's `_func_path` has no such path for
        them) and when the ciphertext modulus does not divide 2N or exceeds
        2^16 (the caller then builds the accumulators on the host)."""
        ct_mod = int(ct.modulus)
        if (not self.chain_supported(params, key)
                or (2 * params.rgsw.N) % ct_mod or ct_mod > (1 << 16)):
            return None
        fv = np.asarray(fv)
        rows = shard_rows(self._shards, np.shape(ct.a)[0])
        return self._lwe_out(self._each(lambda i, a, b: self._func_core(
            params, self._device_key(params, key, i),
            fv[rows[i][0]:rows[i][1]] if fv.ndim == 2 else fv, a, b, ct_mod,
            int(fmod)), ct.a, ct.b), fmod)

    # -- device-resident functional chains (EvalFloor/Sign/Decomp) ---------

    def chain_supported(self, params: BinFHEParams, key) -> bool:
        """True when scheme may keep the ciphertext on the device between
        the bootstraps of EvalFunc/EvalFloor/EvalSign/EvalDecomp: the gate,
        mixed and RNS sets, not the two-limb and DM sets (whose functions
        take the host route of the JAX package). Decided from the parameters
        alone: the key of another gadget base is converted when its base is
        current."""
        return self._path(params) in ("gate", "mixed", "rns")

    def lwe_upload(self, ct: lwe.LWECiphertext) -> DeviceLWE:
        """Host LWECiphertext batch -> int64 tensors on the shards' devices,
        values kept."""
        return DeviceLWE(self._each(lambda i, a, b: (a, b), ct.a, ct.b),
                         int(ct.modulus), np.shape(ct.a)[0])

    def lwe_download(self, dct: DeviceLWE) -> lwe.LWECiphertext:
        """Device batch -> host LWECiphertext; raw values are kept."""
        return self._lwe_out(dct.parts, dct.modulus)

    def func_bootstrap_dev(self, params: BinFHEParams, key, fv: np.ndarray,
                           dct: DeviceLWE, ct_mod: int,
                           fmod: int) -> DeviceLWE:
        """Functional bootstrap of a device batch: inputs are reduced mod
        ct_mod on the device, outputs stay there mod fmod. `fv` is a
        [ctMod] value table or [B, ctMod] per ciphertext. Batches above
        8192 run as sequential slices, which bounds the work buffers; the
        keys are shared. Under a mesh every shard runs its own rows on its
        device. Callers have checked chain_supported and that ct_mod
        divides 2N and is at most 2^16."""
        fv = np.asarray(fv)

        def shard(i, lo, a, b):
            dk = self._device_key(params, key, i)
            parts = [self._func_core(params, dk, fv[lo + j:lo + j + _FUNC_CHUNK]
                                     if fv.ndim == 2 else fv, a[j:j + _FUNC_CHUNK],
                                     b[j:j + _FUNC_CHUNK], int(ct_mod), int(fmod))
                     for j in range(0, a.shape[0], _FUNC_CHUNK)]
            return torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])

        rows = shard_rows(self._shards, dct.B)
        return DeviceLWE([None if p is None else shard(i, rows[i][0], *p)
                          for i, p in enumerate(dct.parts)], int(fmod), dct.B)

    def dev_add_const(self, dct: DeviceLWE, c: int) -> DeviceLWE:
        """lwe.add_const_eq on the device."""
        return dct.map(lambda a, b: (a, mod(b + c, dct.modulus)))

    def dev_sub_const(self, dct: DeviceLWE, c: int) -> DeviceLWE:
        return dct.map(lambda a, b: (a, mod(b - c, dct.modulus)))

    def dev_sub(self, d1: DeviceLWE, d2: DeviceLWE) -> DeviceLWE:
        """(d1 - d2) mod d1's modulus, elementwise, shard by shard."""
        m = d1.modulus
        return DeviceLWE([None if p is None else (mod(p[0] - q[0], m), mod(p[1] - q[1], m))
                          for p, q in zip(d1.parts, d2.parts)], m, d1.B)

    def dev_mod_switch(self, dct: DeviceLWE, new_mod: int) -> DeviceLWE:
        """RoundqQ between powers of two: ((v + 2^(s-1)) >> s) mod new with
        s = log2(old / new), bit-identical to modmath.round_q_Q
        (lwe-pke.cpp:41-46)."""
        old = dct.modulus
        if old & (old - 1) or new_mod & (new_mod - 1) or new_mod >= old:
            raise ValueError("dev_mod_switch needs powers of two, new < old")
        s = old.bit_length() - new_mod.bit_length()
        half = 1 << (s - 1)
        return dct.map(lambda a, b: (mod((a + half) >> s, new_mod),
                                     mod((b + half) >> s, new_mod)), new_mod)

    def dev_retag(self, dct: DeviceLWE, new_mod: int) -> DeviceLWE:
        """Raw modulus retag (lwe.set_modulus): values unchanged."""
        return dct.map(lambda a, b: (a, b), new_mod)

    # -- host <-> device ---------------------------------------------------

    @staticmethod
    def _bucket(B: int) -> int:
        """Batch size rounded up to a power of two (at least 8): the staging
        buffers are reused across calls of similar size."""
        b = 8
        while b < B:
            b *= 2
        return b

    def _upload(self, arrays) -> list:
        """Host arrays [B, k] or [B] of residues < 2^16 -> for every shard
        of this process, its rows as int64 tensors of the same trailing
        shapes on its device (None for a shard without rows), each shard in
        one copy of u16 words from its own rows of a staging buffer (pinned
        for CUDA)."""
        B = np.shape(arrays[0])[0]
        rows = shard_rows(self._shards, B)
        lo, hi = rows[0][0], rows[-1][1]        # this process's block
        cols = [int(np.prod(np.shape(x)[1:])) for x in arrays]
        width = sum(cols)
        # Refilling the buffer is safe: every shard's asynchronous copy out
        # of it finished before the previous call's `_download` returned.
        buf = self._staging.get(width)
        if buf is None or buf.shape[0] < hi - lo:
            buf = torch.empty((self._bucket(hi - lo), width), dtype=torch.int16,
                              pin_memory=any(d.type == "cuda" for d in self._shards.devices))
            self._staging[width] = buf
        view = buf.numpy().view(np.uint16)
        c = 0
        for x, k in zip(arrays, cols):
            view[:hi - lo, c:c + k] = np.asarray(x)[lo:hi].reshape(hi - lo, k)
            c += k
        out = []
        for dev, (r0, r1) in zip(self._shards.devices, rows):
            if r0 == r1:
                out.append(None)
                continue
            t = buf[r0 - lo:r1 - lo].to(dev, non_blocking=True).to(torch.int64) & 0xFFFF
            out.append([p.reshape((r1 - r0,) + np.shape(x)[1:])
                        for p, x in zip(torch.split(t, cols, dim=1), arrays)])
        return out

    def _download(self, outs: list, q: int) -> lwe.LWECiphertext:
        """Every shard's (a, b) int64 results < 2^16 (None for a shard
        without rows) -> u16 host ciphertexts of the whole batch, one copy a
        shard, each made after every shard was launched."""
        packed = []
        for o in outs:
            if o is None:
                packed.append(None)
                continue
            both = torch.cat([o[0], o[1][:, None]], dim=1)
            packed.append((torch.where(both >= (1 << 15), both - (1 << 16),
                                       both).to(torch.int16),))
        host = self._gather(packed, 1, np.int16)[0].view(np.uint16)
        n = host.shape[1] - 1
        return lwe.LWECiphertext(np.ascontiguousarray(host[:, :n]),
                                 np.ascontiguousarray(host[:, n]), q)

    @staticmethod
    def _scaled_indices(a: torch.Tensor, q: int, N: int) -> torch.Tensor:
        """int64 a (any representative mod q) -> contiguous int32 exponents
        (q - a) * (2N / q) mod 2N (rgsw-acc-cggi.cpp:151-154)."""
        idx = negmod(a, q) * (2 * N // q) % (2 * N)
        return idx.to(torch.int32).contiguous()
