"""Dense oracles for the SpGEMM pipeline (test ground truth)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.formats import CSR, csr_to_dense


def spgemm_dense(a: CSR, b: CSR) -> torch.Tensor:
    """densify(A) @ densify(B) — the semantic ground truth for C = AB."""
    return csr_to_dense(a) @ csr_to_dense(b)


def intermediate_products_dense(a: CSR, b: CSR) -> np.ndarray:
    """Algorithm 1's ground truth by explicit loops on the host: each row
    of A's count of intermediate products, int64."""
    indptr_a = a.indptr.cpu().numpy()
    indices_a = a.indices.cpu().numpy()
    indptr_b = b.indptr.cpu().numpy()
    out = np.zeros(a.n_rows, np.int64)
    for i in range(a.n_rows):
        for p in range(indptr_a[i], indptr_a[i + 1]):
            col = indices_a[p]
            out[i] += indptr_b[col + 1] - indptr_b[col]
    return out
