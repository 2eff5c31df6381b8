"""The port's pke stack: BFV, BGV and RNS-CKKS on the host and on the device.

Port of `tfhe_tpu/pke`: DCRT towers (`dcrt`), encodings, hybrid key
switching, the crypto-context front end with security-driven parameter
generation (`context.gen_crypto_context`, `parametergen`), the exact host
CKKS (`ckks`), its pure-RNS form (`ckks_rns`), the device-resident form on
torch tensors (`ckks_device`, on `dcrt_device`, `ops/modmathv.py` and
`ops/nttl.py`), the automatic-scaling layer on both (`ckks_auto`,
`ckks_auto_device`), noise flooding (`noise_flooding`), CKKS bootstrapping
on the host (`ckks_boot`, `ckks_boot_fft`) and on the device
(`ckks_boot_device`, `ckks_boot_fft_device`, on the evaluator
`CKKSDeviceEvaluator`), the advanced SHE layer on both (`advancedshe`,
`advancedshe_device`), BFV (the exact host base `bfv`, the pure-RNS HPS and
BEHZ multiplications `bfv_rns` and `bfv_behz`, their device forms
`bfv_device` and `bfv_behz_device`, and EvalSum, proxy re-encryption and
threshold decryption in `advanced`), BGV (`bgv`, its pure-RNS form
`bgv_rns`, the automatic level management `bgv_auto` and the device form
`bgv_device`), and the serialization of keys and ciphertexts (`serial`),
each bit-identical to its JAX twin.
"""

from .bfv import BFVCiphertext, BFVContext, BFVParams  # noqa: F401
from .bfv_behz import BFVBehzContext  # noqa: F401
from .bfv_behz_device import BFVBehzDeviceContext  # noqa: F401
from .bfv_device import BFVDeviceContext, DeviceBFVCiphertext  # noqa: F401
from .bfv_rns import BFVRnsContext  # noqa: F401
from .bgv import BGVContext, BGVParams  # noqa: F401
from .bgv_auto import BGVAutoContext  # noqa: F401
from .bgv_device import BGVDeviceContext, DeviceBGVCiphertext  # noqa: F401
from .bgv_rns import BGVRnsContext, mod_reduce_rns  # noqa: F401
from .ckks import CKKSCiphertext, CKKSContext, CKKSParams  # noqa: F401
from .ckks_auto import CKKSAutoContext  # noqa: F401
from .ckks_auto_device import CKKSAutoDeviceContext  # noqa: F401
from .ckks_boot import (BootstrapPrecom, bsgs_key_indices,  # noqa: F401
                        eval_bootstrap_setup, mod_raise)
from .ckks_boot_device import CKKSBootstrapDevice, CKKSDeviceEvaluator  # noqa: F401
from .ckks_boot_fft import (BootstrapFFTPrecom, bootstrap_depth,  # noqa: F401
                            eval_bootstrap_setup_fft, fft_key_indices)
from .ckks_boot_fft_device import CKKSBootstrapFFTDevice  # noqa: F401
from .ckks_device import CKKSDeviceContext, DeviceCKKSCiphertext  # noqa: F401
from .ckks_rns import CKKSRnsContext, RnsHybridKey  # noqa: F401
from .context import SecurityError, gen_crypto_context  # noqa: F401
from .dcrt import DCRTParams, DCRTPoly  # noqa: F401
from .noise_flooding import (decrypt_flooded, estimate_noise,  # noqa: F401
                             flooding_sigma)
