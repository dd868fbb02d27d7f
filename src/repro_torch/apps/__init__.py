"""Paper applications (§V) and the workload generators of Tables II/III:
Markov Clustering, Graph Contraction, full-batch and mini-batch GNN
training with TopK, and the SpGEMM-expressed bulk sampler."""
from repro_torch.apps.gnn import (
    GNNConfig, gnn_forward, gnn_forward_minibatch, init_gnn, train_gnn,
    train_gnn_minibatch,
)
from repro_torch.apps.graph_contraction import graph_contraction
from repro_torch.apps.graphs import (
    TABLE_II_SCALED, TABLE_III_SCALED, rmat_graph, table_ii_matrix,
    uniform_graph,
)
from repro_torch.apps.markov_clustering import MCLResult, mcl
from repro_torch.apps.sampling import bulk_sample

__all__ = ["rmat_graph", "uniform_graph", "table_ii_matrix",
           "TABLE_II_SCALED", "TABLE_III_SCALED",
           "mcl", "MCLResult", "graph_contraction",
           "GNNConfig", "init_gnn", "gnn_forward", "train_gnn",
           "gnn_forward_minibatch", "train_gnn_minibatch", "bulk_sample"]
