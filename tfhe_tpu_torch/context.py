"""BinFHEContext: the user-facing API of the PyTorch/CUDA BinFHE port.

A copy of `tfhe_tpu/context.py` (itself mirroring `BinFHEContext`,
`src/binfhe/include/binfhecontext.h:58-445`, `src/binfhe/lib/binfhecontext.cpp`):
context generation (3 overloads), key generation, encryption/decryption,
scalar and batched gate/functional evaluation, LUT generation, the
ciphertext-matrix product, and device setup.

Differences from the JAX package's context:
- evaluation runs on a `TorchBackend` on the context's `device` ("cuda" by
  default, "cpu" for the plain torch path), or on several GPUs with
  `device_setup(num_devices=...)`. The backend is set up lazily,
  at the first evaluation after the keys exist, or eagerly by
  `device_setup`; parameters outside the port's slices raise
  NotImplementedError there and never run on the host oracle;
- the exact host oracle (`RefBackend`) runs only when asked for, through
  `device_clean()` or `use_backend(RefBackend())`;
- the seeded (threefry) switching key is generated on the context's
  device (its <A, s> and, at the first evaluation, its switching table);
- `load` takes the device the new context evaluates on.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from . import lwe, params as params_mod, scheme
from .params import BinFHEParams, Gate, Method, ParamSet
from .ref.backend import RefBackend
from .utils.rng import BinFHERng


class BinFHEContext:
    def __init__(self, seed: int | None = None,
                 seeded_ksk: bool | None = None, device: str = "cuda"):
        """`device` is where evaluation runs: "cuda" (the hand-written
        kernels) or "cpu" (their plain torch versions). `seeded_ksk`
        opts the accelerated power-of-two-qKS sets into the seeded
        (threefry) switching key (`lwe.SeededSwitchingKey`), generated on
        `device`; None = decide from TFHE_TPU_SEEDED_KSK, as in the JAX
        package."""
        self.params: BinFHEParams | None = None
        self.rng = BinFHERng(seed)
        self.seeded_ksk = seeded_ksk
        self.device = device
        self._bt_key: scheme.BTKey | None = None
        self._bt_key_map: dict[int, scheme.BTKey] = {}
        self._backend: scheme.Backend | None = None
        self._time_optimization = False

    # -- context generation ------------------------------------------------

    def generate_binfhe_context(self, param_set: ParamSet | str,
                                method: Method = Method.GINX,
                                arb_func: bool | None = None,
                                log_q: int | None = None,
                                N: int = 0,
                                time_optimization: bool = False,
                                base_g: int = 0,
                                num_digits_to_throw: int = 0,
                                rns_modulus: bool | None = None) -> None:
        """Classic-table form when only (set, method) are given
        (binfhecontext.cpp:115-181); the batched/accelerated form when
        arb_func/log_q are provided (binfhecontext.cpp:51-113)."""
        if isinstance(param_set, str):
            param_set = ParamSet[param_set]
        if arb_func is None and log_q is None:
            self.params = params_mod.from_param_set(param_set, method)
            self._time_optimization = False
        else:
            self.params = params_mod.from_gpu_style(
                param_set, bool(arb_func), 11 if log_q is None else log_q, N,
                method, time_optimization, base_g, num_digits_to_throw,
                rns_modulus)
            self._time_optimization = time_optimization

    def generate_binfhe_context_custom(self, n: int, N: int, q: int, Q: int,
                                       std: float, base_ks: int, base_g: int,
                                       base_r: int, method: Method = Method.GINX) -> None:
        self.params = params_mod.from_custom(n, N, q, Q, std, base_ks, base_g, base_r, method)
        self._time_optimization = False

    # -- keys --------------------------------------------------------------

    def key_gen(self) -> lwe.LWEPrivateKey:
        p = self.params.lwe
        return lwe.key_gen(self.rng, p.n, p.q_ks)

    def key_gen_n(self) -> lwe.LWEPrivateKey:
        p = self.params.lwe
        return lwe.key_gen(self.rng, p.N, p.Q)

    def bt_key_gen(self, sk: lwe.LWEPrivateKey,
                   sk_n: lwe.LWEPrivateKey | None = None,
                   ksk: lwe.LWESwitchingKey | None = None,
                   bases: set[int] | None = None) -> None:
        """BTKeyGen (binfhecontext.cpp:224-246); with time_optimization, one key
        per gadget base in the sign-eval map — sharing one ring secret and one
        switching key across the map (the KSK is base-independent).

        `sk_n`/`ksk` allow reusing another context's ring secret + switching
        key when the LWE parameters match (all accelerated logQ configs share
        n=1305, N=2048, qKS=2^35 — one switching key serves them all, and
        the backend keeps one device table per switching-key object).

        `bases` restricts the time_optimization map to the listed gadget
        bases (plus the default): EvalSign/EvalDecomp schedules at logQ <= 26
        statically never reach the 2^14 base. New keys drop any backend set
        up for the old ones."""
        rgsw_p = self.params.rgsw
        temp = rgsw_p.base_g
        if self._time_optimization:
            for base in sorted(rgsw_p.g_power_map):
                if bases is not None and base != temp and base not in bases:
                    continue
                rgsw_p.change_base_g(base)
                key = scheme.key_gen(self.rng, self.params, sk, sk_n, ksk,
                                     seeded_ksk=self.seeded_ksk,
                                     device=self.device)
                sk_n, ksk = key.sk_n, key.ksk
                self._bt_key_map[base] = key
            rgsw_p.change_base_g(temp)
        if self._bt_key_map:
            self._bt_key = self._bt_key_map[temp]
        else:
            self._bt_key = scheme.key_gen(self.rng, self.params, sk, sk_n, ksk,
                                          seeded_ksk=self.seeded_ksk,
                                          device=self.device)
            self._bt_key_map[temp] = self._bt_key
        self._backend = None

    @property
    def bt_key(self) -> scheme.BTKey:
        return self._bt_key

    @property
    def bt_key_map(self) -> dict[int, scheme.BTKey]:
        return self._bt_key_map

    def bt_key_load(self, key: scheme.BTKey) -> None:
        self._bt_key = key
        self._bt_key_map[key.base_g] = key
        self._backend = None

    # -- encryption --------------------------------------------------------

    def encrypt(self, sk: lwe.LWEPrivateKey, m, output: str = "BOOTSTRAPPED",
                p: int = 4, mod: int | None = None) -> lwe.LWECiphertext:
        """LWE encryption (binfhecontext.cpp:193-206; note the reference's
        auto-bootstrap-after-encrypt is disabled there too). `m` may be an int
        or an array (batched)."""
        return lwe.encrypt(self.rng, self.params.lwe, sk, m, p, mod)

    def decrypt(self, sk: lwe.LWEPrivateKey, ct: lwe.LWECiphertext, p: int = 4):
        return lwe.decrypt(self.params.lwe, sk, ct, p)

    def decrypt_without_scale(self, sk: lwe.LWEPrivateKey, ct: lwe.LWECiphertext, p: int = 4):
        return lwe.decrypt_without_scale(self.params.lwe, sk, ct, p)

    def key_switch_gen(self, sk: lwe.LWEPrivateKey, sk_n: lwe.LWEPrivateKey) -> lwe.LWESwitchingKey:
        return lwe.key_switch_gen(self.rng, self.params.lwe, sk, sk_n)

    # -- evaluation --------------------------------------------------------

    def eval_bin_gate(self, gate: Gate, ct1: lwe.LWECiphertext,
                      ct2: lwe.LWECiphertext) -> lwe.LWECiphertext:
        return scheme.eval_bin_gate(self.backend, self.params, gate, self._bt_key, ct1, ct2)

    def bootstrap(self, ct: lwe.LWECiphertext) -> lwe.LWECiphertext:
        return scheme.bootstrap(self.backend, self.params, self._bt_key, ct)

    def eval_not(self, ct: lwe.LWECiphertext) -> lwe.LWECiphertext:
        return scheme.eval_not(self.params, ct)

    def eval_constant(self, value: bool) -> lwe.LWECiphertext:
        return lwe.noiseless_embedding(self.params.lwe, int(value))

    def eval_func(self, ct: lwe.LWECiphertext, lut, per_ct_luts: bool = False) -> lwe.LWECiphertext:
        return scheme.eval_func(self.backend, self.params, self._bt_key, ct,
                                lut, self.get_beta(), per_ct_luts)

    def eval_floor(self, ct: lwe.LWECiphertext, roundbits: int = 0) -> lwe.LWECiphertext:
        return scheme.eval_floor(self.backend, self.params, self._bt_key, ct,
                                 self.get_beta(), roundbits)

    def eval_sign(self, ct: lwe.LWECiphertext) -> lwe.LWECiphertext:
        keys = self._bt_key_map if self._bt_key_map else {self.params.rgsw.base_g: self._bt_key}
        return scheme.eval_sign(self.backend, self.params, keys, ct, self.get_beta())

    def eval_decomp(self, ct: lwe.LWECiphertext) -> list[lwe.LWECiphertext]:
        keys = self._bt_key_map if self._bt_key_map else {self.params.rgsw.base_g: self._bt_key}
        return scheme.eval_decomp(self.backend, self.params, keys, ct, self.get_beta())

    def ciphertext_mul_matrix(self, cts: lwe.LWECiphertext,
                              matrix: np.ndarray, modulus: int) -> lwe.LWECiphertext:
        """Batched LWE x integer-matrix product (lwe-operation.cu:50-141):
        K input ciphertexts x [K, M] int64 matrix -> M output ciphertexts,
        component-wise mod `modulus`, exact. Runs on the device of the
        backend (the context's device before one is set up; no keys are
        needed), or on the host when the backend is the oracle."""
        from .ops.lweops import ciphertext_mul_matrix, ciphertext_mul_matrix_device
        if isinstance(self._backend, RefBackend):
            return ciphertext_mul_matrix(cts, matrix, modulus)
        return ciphertext_mul_matrix_device(
            cts, matrix, modulus, getattr(self._backend, "device", self.device))

    # -- helpers -----------------------------------------------------------

    def get_beta(self) -> int:
        return self.params.beta

    def get_max_plaintext_space(self) -> int:
        return self.params.max_plaintext_space

    def get_params(self) -> BinFHEParams:
        return self.params

    def generate_lut_via_function(self, f: Callable[[int, int], int], p: int) -> np.ndarray:
        """LUT over Z_q from f: Z_p -> Z_p; p must be a power of two
        (binfhecontext.cpp:291-313)."""
        if p & (p - 1):
            raise NotImplementedError("Only support plaintext space to be power-of-two.")
        q = self.params.lwe.q
        interval = q // p
        lut = np.zeros(q, dtype=np.uint64)
        for i in range(q):
            v = int(f(i // interval, p))
            if v >= p:
                raise ValueError("input function should output in Z_{p_output}.")
            lut[i] = v * interval
        return lut

    # -- device management -------------------------------------------------

    @property
    def backend(self) -> scheme.Backend:
        """The evaluation backend: a `TorchBackend` on `self.device`, set up
        here at the first evaluation unless `device_setup`, `device_clean`
        or `use_backend` chose one already."""
        if self._backend is None:
            self.device_setup()
        return self._backend

    def device_setup(self, device: str | None = None, num_devices: int = 0) -> None:
        """Move evaluation to a `TorchBackend` on `device` (default: the
        context's own), the analogue of GPUSetup (binfhecontext.cpp:349-360).
        With `num_devices` > 1 every batch is split over the first
        `num_devices` GPUs, each holding a copy of the keys (`JaxBackend`'s
        mesh, `tfhe_tpu/context.py:222-233`); this raises ValueError when
        there are fewer GPUs and never runs on the CPU. A mesh of any
        devices is `use_backend(TorchBackend(mesh=parallel.mesh.Mesh(...)))`.
        Requires bt_key_gen first; raises NotImplementedError for parameters
        outside the port's slices. The key for the default gadget base is
        converted and uploaded now, the other bases of a time-optimization
        map at first use."""
        if self._bt_key is None:
            raise RuntimeError("Need to call bt_key_gen before calling device_setup")
        from .ops.backend import TorchBackend

        if device is not None:
            self.device = device
        backend = TorchBackend(self.device, num_devices=num_devices)
        temp = self.params.rgsw.base_g
        try:
            for base in self._bt_key_map or {temp: self._bt_key}:
                self.params.rgsw.change_base_g(base)
                if not backend.supports(self.params):
                    raise NotImplementedError(
                        f"TorchBackend does not support gadget base 2^"
                        f"{base.bit_length() - 1} at these parameters")
        finally:
            self.params.rgsw.change_base_g(temp)
        backend.setup(self.params, self._bt_key)
        self._backend = backend

    def device_clean(self) -> None:
        """Evaluate on the exact host oracle from now on."""
        self._backend = RefBackend()

    def use_backend(self, backend: scheme.Backend) -> None:
        self._backend = backend

    # -- serialization (cereal analogue, utils/serial.h) ---------------------

    def save(self, path: str) -> None:
        """Serialize parameters + all bootstrapping keys to one .npz file, in
        the JAX package's format (`utils/serial.py`). A seeded switching key
        is saved as its seed and B. Device state is not saved."""
        from .utils import serial
        serial.save_context(path, self.params, self._bt_key, self._bt_key_map)

    @classmethod
    def load(cls, path: str, seed: int | None = None,
             device: str = "cuda") -> "BinFHEContext":
        """Recreate a context (params + keys) from `save` output, or from
        the JAX package's; the analogue of deserializing the cryptocontext +
        BTKeyLoad (binfhecontext.h:208-220, 321-334). The new context
        evaluates on `device`, whose state is rebuilt at the first
        evaluation or by `device_setup()`."""
        from .utils import serial
        cc = cls(seed, device=device)
        cc.params, keys = serial.load_context(path)
        cc._bt_key_map = keys
        if keys:
            base = cc.params.rgsw.base_g
            cc._bt_key = keys.get(base) or next(iter(keys.values()))
        cc._time_optimization = cc.params.time_optimization
        return cc
