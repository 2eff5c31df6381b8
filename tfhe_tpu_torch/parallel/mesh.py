"""Device meshes and batch sharding.

Port of `tfhe_tpu/parallel/mesh.py`. The reference scales by spreading
ciphertexts round-robin over CUDA streams and GPUs, with a copy of every
key on each GPU (bootstrapping.cu:1616-1638, key copies at 1005-1069). The
port does the same with explicit torch devices: a `Mesh` lists them, a
ciphertext batch is split into contiguous blocks of rows, one per shard
(`shard_rows`, `split_batch`), keys are copied once to each device
(`replicate`), and the shards' results come back in the input order
(`gather`). `TorchBackend(num_devices=..., mesh=...)` runs every batched
entry point this way; `parallel/limb_ntt.py` uses a `"limb"` mesh to shard
the ring dimension instead.

Several processes: after `distributed_initialize`, a `"batch"` mesh spans
the processes of the group, as a JAX mesh spans those of
`jax.distributed`. Every process holds the whole host batch, runs its own
block of it on its own devices, and `gather` returns the whole output to
every process (an all-gather over the group).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A 1-D mesh: an axis name ("batch" or "limb") and an ordered list of
    torch devices, one per shard.

    The list may name the same device more than once. Shards on one device
    share its copy of the keys and run one after another on its current
    stream: that is how a one-card machine (`Mesh(["cuda:0", "cuda:0"])`)
    and the CPU tests (`Mesh(["cpu"] * 4)`) stand in for several devices,
    as the JAX package's tests use `--xla_force_host_platform_device_count`.

    A "batch" mesh made while a process group of more than one process is
    initialized spans the group (unless `span_processes` is False): it
    lists this process's devices, and the batch is split over
    `world_size * len(devices)` shards, process by process."""

    def __init__(self, devices, axis: str = "batch", *, span_processes: bool = True):
        if axis not in ("batch", "limb"):
            raise ValueError(f"a mesh axis is 'batch' or 'limb', not {axis!r}")
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        spans = (span_processes and axis == "batch" and dist.is_available()
                 and dist.is_initialized() and dist.get_world_size() > 1)
        self.world_size = dist.get_world_size() if spans else 1
        self.rank = dist.get_rank() if spans else 0

    @property
    def size(self) -> int:
        """Shards over every process of the mesh."""
        return self.world_size * len(self.devices)

    def __repr__(self) -> str:
        procs = f", process {self.rank} of {self.world_size}" if self.world_size > 1 else ""
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r}{procs})"


def make_mesh(num_devices: int = 0, axis: str = "batch") -> Mesh:
    """A mesh over the first `num_devices` CUDA devices (all of them if 0).
    Raises ValueError when more are asked for than there are; it never
    falls back to the CPU."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = num_devices if num_devices > 0 else avail
    if n > avail or n == 0:
        raise ValueError(f"requested {n} CUDA devices, only {avail} available")
    return Mesh([f"cuda:{i}" for i in range(n)], axis)


def shard_rows(mesh: Mesh, B: int) -> list[tuple[int, int]]:
    """The rows [lo, hi) of a batch of B that each of this process's
    shards holds: contiguous blocks in shard order, their sizes differing
    by one at most. A shard holds no rows when B is below the shard count."""
    S, D = mesh.size, len(mesh.devices)
    g0 = mesh.rank * D
    return [((g0 + i) * B // S, (g0 + i + 1) * B // S) for i in range(D)]


def split_batch(mesh: Mesh, x) -> list[torch.Tensor]:
    """A host batch x [B, ...] (numpy residues of any integer dtype, or
    Python ints below 2^64) -> one int64 tensor per shard of this process,
    its rows of x on its device (a [0, ...] tensor for a shard without
    rows)."""
    t = torch.from_numpy(np.asarray(x, dtype=np.uint64).astype(np.int64))
    return [t[lo:hi].to(dev) for dev, (lo, hi) in zip(mesh.devices, shard_rows(mesh, t.shape[0]))]


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """One tensor per shard of this process: x copied once to each distinct
    device, and shards on one device given the same copy."""
    copies: dict[str, torch.Tensor] = {}
    for dev in mesh.devices:
        if str(dev) not in copies:
            copies[str(dev)] = x.to(dev)
    return [copies[str(dev)] for dev in mesh.devices]


def gather(mesh: Mesh, parts: list) -> np.ndarray:
    """Host arrays of this process's shards, in shard order (None for a
    shard without rows) -> the whole batch on every process: across the
    process group by an all-gather, as the JAX backend's `_to_host` does."""
    local = [p for p in parts if p is not None]
    mine = None if not local else local[0] if len(local) == 1 else np.concatenate(local)
    if mesh.world_size == 1:
        return mine
    every: list = [None] * mesh.world_size
    dist.all_gather_object(every, mine)
    return np.concatenate([p for p in every if p is not None])


def distributed_initialize(**kwargs) -> None:
    """Join a process group: `torch.distributed.init_process_group` with
    NCCL when CUDA is available and gloo otherwise (`backend=` overrides),
    the rest of `kwargs` passed on (`init_method="tcp://host:port"`,
    `world_size`, `rank`). With NCCL each process must own its GPUs
    (`CUDA_VISIBLE_DEVICES`, or `torch.cuda.set_device` before this call):
    NCCL refuses two processes on one GPU."""
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)
