"""The port's pke stack: RNS-CKKS on the host and on the device.

Port of the CKKS path of `tfhe_tpu/pke`: DCRT towers (`dcrt`), encodings,
hybrid key switching, the exact host CKKS (`ckks`), its pure-RNS form
(`ckks_rns`), the device-resident form on torch tensors (`ckks_device`,
on `dcrt_device`, `ops/modmathv.py` and `ops/nttl.py`), CKKS bootstrapping
on the host (`ckks_boot`, `ckks_boot_fft`) and on the device
(`ckks_boot_device`, `ckks_boot_fft_device`, on the evaluator
`CKKSDeviceEvaluator`), and the advanced SHE layer on both
(`advancedshe`, `advancedshe_device`), each bit-identical to its JAX twin.
The other pke families (BFV, BGV, the automatic-scaling CKKS layer, the
crypto-context front end) are not ported yet (ROADMAP item 14).
"""

from .ckks import CKKSCiphertext, CKKSContext, CKKSParams  # noqa: F401
from .ckks_boot import (BootstrapPrecom, bsgs_key_indices,  # noqa: F401
                        eval_bootstrap_setup, mod_raise)
from .ckks_boot_device import CKKSBootstrapDevice, CKKSDeviceEvaluator  # noqa: F401
from .ckks_boot_fft import (BootstrapFFTPrecom, bootstrap_depth,  # noqa: F401
                            eval_bootstrap_setup_fft, fft_key_indices)
from .ckks_boot_fft_device import CKKSBootstrapFFTDevice  # noqa: F401
from .ckks_device import CKKSDeviceContext, DeviceCKKSCiphertext  # noqa: F401
from .ckks_rns import CKKSRnsContext, RnsHybridKey  # noqa: F401
from .dcrt import DCRTParams, DCRTPoly  # noqa: F401
