"""The port's pke stack: RNS-CKKS on the host and on the device.

Port of the CKKS path of `tfhe_tpu/pke`: DCRT towers (`dcrt`), encodings,
hybrid key switching, the exact host CKKS (`ckks`), its pure-RNS form
(`ckks_rns`) and the device-resident form on torch tensors (`ckks_device`,
on `dcrt_device`, `ops/modmathv.py` and `ops/nttl.py`), each bit-identical
to its JAX twin. The other pke families (BFV, BGV, CKKS bootstrapping, the
crypto-context front end) are not ported yet (ROADMAP item 14).
"""

from .ckks import CKKSCiphertext, CKKSContext, CKKSParams  # noqa: F401
from .ckks_device import CKKSDeviceContext, DeviceCKKSCiphertext  # noqa: F401
from .ckks_rns import CKKSRnsContext, RnsHybridKey  # noqa: F401
from .dcrt import DCRTParams, DCRTPoly  # noqa: F401
