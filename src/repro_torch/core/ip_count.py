"""Algorithm 1 — Intermediate Product Counting.

For C = A·B (Gustavson row-wise), row i of C is built from
``IP[i] = Σ_{j ∈ row_i(A)} nnz(B[col_A[j]])`` intermediate products.
IP drives the Table-I load balancing and the hash-table sizing.  Here it
is a gather of B's row lengths plus a segment sum over A's rows.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import CSR


def intermediate_products(a: CSR, b: CSR) -> torch.Tensor:
    """IP per row of A (int32, shape (a.n_rows,)), on A's device."""
    row_nnz_b = b.row_nnz()
    cols = a.indices.clamp(0, max(b.n_rows - 1, 0)).long()
    contrib = torch.where(a.valid_mask(), row_nnz_b[cols], 0)
    ip = torch.zeros(a.n_rows + 1, dtype=torch.int32, device=a.device)
    ip.index_add_(0, a.row_ids().long(), contrib.to(torch.int32))
    return ip[: a.n_rows]
