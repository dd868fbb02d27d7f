"""Sparse formats with a capacity kept separate from occupancy, the CSR
primitives the applications are built on, and the paper's TopK
sparsification (Eq. 1-3)."""
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
    ell_from_dense,
    ell_to_csr,
    ell_to_dense,
    from_numpy,
    topk_rows_from_arrays,
)
from repro_torch.sparse.ops import (
    csr_column_normalize,
    csr_column_sums,
    csr_hadamard_power,
    csr_permute_rows,
    csr_prune_columns,
    csr_row_nnz,
    csr_scale_columns,
    csr_scale_rows,
    csr_spmm,
    csr_spmv,
    csr_transpose,
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
    "csr_to_dense", "csr_to_ell", "ell_from_dense", "ell_to_csr",
    "ell_to_dense", "from_numpy",
    "topk_rows_from_arrays", "block_topk_rows", "topk_mask", "topk_rows",
    "topk_rows_st", "csr_column_normalize", "csr_column_sums",
    "csr_hadamard_power", "csr_permute_rows", "csr_prune_columns",
    "csr_row_nnz", "csr_scale_columns", "csr_scale_rows", "csr_spmm",
    "csr_spmv", "csr_transpose",
]
