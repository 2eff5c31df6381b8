"""tfhe_tpu_torch: the PyTorch/CUDA port of tfhe_tpu's BinFHE scheme.

Imports torch and never jax, and nothing of the JAX package: its host
layers (parameters, keygen, encryption, the scheme, the exact host oracle)
are the port's own copies. `BinFHEContext(seed=...)` evaluates on the GPU
(`device="cuda"`, the default) or with the kernels' plain torch versions
(`device="cpu"`): batched CGGI gates on the classic single-limb sets
(hand-written kernel `csrc/blind_rotate.cu`), EvalFunc, EvalFloor,
EvalSign and EvalDecomp on the accelerated RNS sets
(`csrc/blind_rotate_rns.cu`), and gates and functions on the two-limb sets:
the big-Q classic sets, STD256 and the accelerated sets at the single 54-bit
prime (`csrc/blind_rotate64.cu`). `device_setup(num_devices=...)` splits
every batch over several GPUs, and `parallel/` holds the meshes, the
processes of `torch.distributed` and the ring-sharded NTT. `save`/`load`
keep a context's keys in the JAX package's file format
(`utils/serial.py`); the pke schemes are in `tfhe_tpu_torch.pke`.
"""

from .context import BinFHEContext
from .ops.backend import TorchBackend
from .params import Gate, Method, ParamSet, from_gpu_style, from_param_set

__all__ = ["BinFHEContext", "Gate", "Method", "ParamSet", "TorchBackend",
           "from_gpu_style", "from_param_set"]
