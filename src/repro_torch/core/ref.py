"""Dense oracle for the SpGEMM pipeline (test ground truth)."""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import CSR, csr_to_dense


def spgemm_dense(a: CSR, b: CSR) -> torch.Tensor:
    """densify(A) @ densify(B) — the semantic ground truth for C = AB."""
    return csr_to_dense(a) @ csr_to_dense(b)
