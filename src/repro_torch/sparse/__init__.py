"""Sparse formats with a capacity kept separate from occupancy, and the
paper's TopK sparsification (Eq. 1-3)."""
from repro_torch.sparse.formats import (
    BSR,
    CSR,
    ELL,
    TopKRows,
    bsr_from_arrays,
    bsr_from_dense,
    bsr_to_dense,
    csr_from_arrays,
    csr_from_coo,
    csr_from_dense,
    csr_to_dense,
    csr_to_ell,
    ell_to_csr,
    from_numpy,
    topk_rows_from_arrays,
)
from repro_torch.sparse.topk import (
    block_topk_rows,
    topk_mask,
    topk_rows,
    topk_rows_st,
)

__all__ = [
    "BSR", "CSR", "ELL", "TopKRows", "bsr_from_arrays", "bsr_from_dense",
    "bsr_to_dense", "csr_from_arrays", "csr_from_coo", "csr_from_dense",
    "csr_to_dense", "csr_to_ell", "ell_to_csr", "from_numpy",
    "topk_rows_from_arrays", "block_topk_rows", "topk_mask", "topk_rows",
    "topk_rows_st",
]
