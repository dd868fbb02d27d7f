"""Device dispatch and launch counters for the port's kernels.

A kernel wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on a CUDA device; any other device
raises.  There is no fallback from the card to the plain version.  Each
launch adds one to the kernel's count in ``LAUNCHES``, so a run can show
that its path went through the kernels.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

LAUNCHES: Dict[str, int] = {"gather_rows": 0, "hash_accumulate": 0}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)


def dispatch(plain: Callable, kernel: Callable, x: torch.Tensor, *args):
    """``plain(x, *args)`` on the CPU, ``kernel(x, *args)`` on CUDA."""
    if x.device.type == "cpu":
        return plain(x, *args)
    if x.device.type == "cuda":
        return kernel(x, *args)
    raise ValueError(f"no kernel for tensors on {x.device}")


def check_launch(name: str, rc: int) -> None:
    """Count one launch of ``name``, or raise on a non-zero CUDA error code
    returned by the launch (a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


def expect(x: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{x.dtype} of shape {tuple(x.shape)} (contiguous="
            f"{x.is_contiguous()})")
