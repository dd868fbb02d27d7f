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


def total_intermediate_products(a: CSR, b: CSR) -> torch.Tensor:
    """Sum of IP, the paper's FLOP basis (GFLOPS = 2 * total IP / time):
    a 0-d tensor on A's device."""
    return intermediate_products(a, b).sum()


def ip_histogram(ip: torch.Tensor, boundaries=(32, 512, 8192)
                 ) -> torch.Tensor:
    """Row count of each Table-I group (log-binned), int32, on ``ip``'s
    device."""
    ip = torch.as_tensor(ip)
    b = torch.as_tensor(boundaries, dtype=ip.dtype, device=ip.device)
    group = torch.searchsorted(b, ip, right=True)
    return torch.bincount(group, minlength=len(boundaries) + 1).to(
        torch.int32)
