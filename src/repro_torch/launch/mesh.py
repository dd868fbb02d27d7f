"""The SpGEMM executor's mesh (counterpart of ``repro.launch.mesh``'s
``make_spgemm_mesh``).

A mesh in the port is a list of ``torch.device``s, one a shard
(``launch.sharding``).  Logical shards, several on one device, are an
explicit list such as ``[torch.device("cuda:0")] * 4`` or
``[torch.device("cpu")] * 4``.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def make_spgemm_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` visible CUDA devices (all of them by
    default), one shard each.  Raises ``ValueError`` when fewer are
    visible; it never returns CPU devices."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(
            f"requested {n} shard devices but only {visible} CUDA devices "
            "are visible; for logical shards pass an explicit list, e.g. "
            "[torch.device('cuda:0')] * 4")
    return [torch.device("cuda", i) for i in range(n)]
