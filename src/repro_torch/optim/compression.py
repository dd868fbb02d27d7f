"""Int8 gradient compression: per-tensor symmetric int8 with a float32
scale.

Counterpart of ``int8_compress`` and ``int8_decompress`` of
``repro.optim.compression``.  Its ``compressed_psum``, the int8 all-reduce,
is a collective and waits for the port's multi-device pieces (ROADMAP).
"""
from __future__ import annotations

import torch


def int8_compress(x: torch.Tensor):
    """(q, scale): ``q = clip(round(x / scale), -127, 127)`` in int8,
    ``scale = max|x| / 127`` (1 for an all-zero ``x``), float32."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
