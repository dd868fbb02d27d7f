"""Sparse formats with a capacity kept separate from occupancy."""
from repro_torch.sparse.formats import (
    CSR,
    ELL,
    csr_from_arrays,
    csr_from_coo,
    csr_from_dense,
    csr_to_dense,
    csr_to_ell,
    ell_to_csr,
)

__all__ = [
    "CSR", "ELL", "csr_from_arrays", "csr_from_coo", "csr_from_dense",
    "csr_to_dense", "csr_to_ell", "ell_to_csr",
]
