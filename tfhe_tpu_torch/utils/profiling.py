"""Tracing / profiling helpers — the analogue of the reference's
`src/core/include/utils/debug.h` (TIC/TOC, PROFILELOG, OPENFHE_DEBUG).

Enabled by the TFHE_TPU_PROFILE env var (the reference's compile-time
`#define PROFILE` becomes a runtime switch). Device timelines come from
`torch.profiler` (scripts/torch_profile_gate.py); the JAX package's
`jax_profile` wrapper has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_ENABLED = os.environ.get("TFHE_TPU_PROFILE", "") not in ("", "0")


def tic() -> float:
    """TIC(t) (debug.h:94-124)."""
    return time.perf_counter()


def toc(t0: float) -> float:
    """TOC(t): elapsed milliseconds."""
    return (time.perf_counter() - t0) * 1000.0


def profile_log(msg: str, t0: float | None = None) -> None:
    """PROFILELOG: stderr timing line when profiling is enabled."""
    if not _ENABLED:
        return
    if t0 is None:
        print(f"[tfhe_tpu] {msg}", file=sys.stderr, flush=True)
    else:
        print(f"[tfhe_tpu] {msg}: {toc(t0):.3f} ms", file=sys.stderr, flush=True)


@contextlib.contextmanager
def timed(label: str):
    """with timed('EvalAcc'): ... — prints when TFHE_TPU_PROFILE is set."""
    t0 = tic()
    try:
        yield
    finally:
        profile_log(label, t0)
