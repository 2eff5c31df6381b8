"""BinFHEContext of the port: the JAX package's context, with
`device_setup` installing the torch backend.

Parameters, keygen, encryption and the scheme's host logic are the JAX
package's jax-free host layers, used as they are; only the device backend
differs.
"""

from __future__ import annotations

import numpy as np

from tfhe_tpu import context as _context
from tfhe_tpu import lwe

from .ops.backend import TorchBackend


class BinFHEContext(_context.BinFHEContext):
    def device_setup(self, device: str = "cuda") -> None:
        """Move evaluation to a `TorchBackend` on `device` (the analogue of
        GPUSetup, binfhecontext.cpp:349-360). Requires bt_key_gen first;
        raises NotImplementedError for parameters outside the port's slice.
        The key for the default gadget base is converted and uploaded now,
        the other bases of a time-optimization map at first use."""
        if self._bt_key is None:
            raise RuntimeError("Need to call bt_key_gen before calling device_setup")
        backend = TorchBackend(device)
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

    def ciphertext_mul_matrix(self, cts: lwe.LWECiphertext, matrix: np.ndarray,
                              modulus: int) -> lwe.LWECiphertext:
        if isinstance(self._backend, TorchBackend):
            raise NotImplementedError(
                "CiphertextMulMatrix is not ported to the torch backend yet")
        return super().ciphertext_mul_matrix(cts, matrix, modulus)
