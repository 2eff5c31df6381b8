"""The port's pke stack: RNS-CKKS and BGV on the host and on the device.

Port of `tfhe_tpu/pke` without its BFV device tiers: DCRT towers (`dcrt`),
encodings, hybrid key switching, the exact host CKKS (`ckks`), its
pure-RNS form (`ckks_rns`), the device-resident form on torch tensors
(`ckks_device`, on `dcrt_device`, `ops/modmathv.py` and `ops/nttl.py`), the
automatic-scaling layer on both (`ckks_auto`, `ckks_auto_device`), noise
flooding (`noise_flooding`), CKKS bootstrapping on the host (`ckks_boot`,
`ckks_boot_fft`) and on the device (`ckks_boot_device`,
`ckks_boot_fft_device`, on the evaluator `CKKSDeviceEvaluator`), the
advanced SHE layer on both (`advancedshe`, `advancedshe_device`), and BGV:
the exact host BFV base (`bfv`), `bgv`, its pure-RNS form (`bgv_rns`), the
automatic level management (`bgv_auto`) and the device form (`bgv_device`),
each bit-identical to its JAX twin. Not ported yet: the BFV RNS and device
tiers (`bfv_rns`, `bfv_behz`, `bfv_device`, ROADMAP item 14.4), the
crypto-context front end and serialization (items 14.5 and 15).
"""

from .bfv import BFVCiphertext, BFVContext, BFVParams  # noqa: F401
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
from .dcrt import DCRTParams, DCRTPoly  # noqa: F401
from .noise_flooding import (decrypt_flooded, estimate_noise,  # noqa: F401
                             flooding_sigma)
