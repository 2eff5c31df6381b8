"""tfhe_tpu_torch: the PyTorch/CUDA port of tfhe_tpu's BinFHE device path.

Imports torch and never jax. `BinFHEContext.device_setup("cuda")` runs the
batched CGGI gate bootstrap on an NVIDIA GPU (the blind rotation is the
hand-written kernel `csrc/blind_rotate.cu`); `device_setup("cpu")` runs the
same path with the kernel's plain torch version.
"""

from tfhe_tpu.params import Gate, Method, ParamSet, from_param_set

from .context import BinFHEContext
from .ops.backend import TorchBackend

__all__ = ["BinFHEContext", "Gate", "Method", "ParamSet", "TorchBackend",
           "from_param_set"]
