"""Workload generators for the paper's Table II / Table III matrices."""
from repro_torch.apps.graphs import (
    TABLE_II_SCALED, TABLE_III_SCALED, rmat_graph, table_ii_matrix,
    uniform_graph,
)

__all__ = ["rmat_graph", "uniform_graph", "table_ii_matrix",
           "TABLE_II_SCALED", "TABLE_III_SCALED"]
