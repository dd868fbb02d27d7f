"""Synthetic graph generators matched to the paper's workload tables.

The paper evaluates on UF Sparse Matrix Collection matrices (Table II) and
OGB/GraphSAINT datasets (Table III).  Those files are not available offline,
so matrices are generated *matched on the characteristics the paper
reports*: rows, nnz/row (Table II) and nodes, average degree (Table III).
RMAT gives the power-law degree tails of web/citation graphs; uniform gives
road-network-like flat degrees.  The generators draw from numpy exactly as
``repro.apps.graphs`` does, so one seed gives the same arrays in both
packages; only the placement on ``device`` differs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.formats import CSR, csr_from_coo


def rmat_graph(n: int, avg_deg: float, seed: int = 0,
               a=0.57, b=0.19, c=0.19, values: str = "uniform",
               device="cuda") -> CSR:
    """R-MAT power-law digraph as CSR (self-loop-free, deduped)."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    n_edges = int(n * avg_deg)
    rows = np.zeros(n_edges, np.int64)
    cols = np.zeros(n_edges, np.int64)
    for level in range(scale):
        r = rng.random(n_edges)
        half = 1 << (scale - level - 1)
        # quadrant probabilities a, b, c, d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        rows += np.where(go_down, half, 0)
        cols += np.where(go_right, half, 0)
    keep = (rows < n) & (cols < n) & (rows != cols)
    rows, cols = rows[keep], cols[keep]
    if values == "uniform":
        vals = rng.random(len(rows)).astype(np.float32) + 0.1
    else:
        vals = np.ones(len(rows), np.float32)
    return csr_from_coo(rows, cols, vals, (n, n), device=device)


def uniform_graph(n: int, avg_deg: float, seed: int = 0,
                  values: str = "uniform", device="cuda") -> CSR:
    """Uniform random digraph (flat degree distribution, RoadTX-like)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n * avg_deg)
    rows = rng.integers(0, n, n_edges)
    cols = rng.integers(0, n, n_edges)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = (rng.random(len(rows)).astype(np.float32) + 0.1
            if values == "uniform" else np.ones(len(rows), np.float32))
    return csr_from_coo(rows, cols, vals, (n, n), device=device)


# Table II workloads, scaled to CPU feasibility while preserving the
# NNZ/row and skew characteristics the paper reports (``n_override`` of
# ``table_ii_matrix`` restores a paper size).  `kind` picks the generator
# that matches the degree distribution family.
TABLE_II_SCALED = {
    #  name            n      avg_deg  kind       paper: (rows, nnz/row, max/row)
    "RoadTX":        (8192,   2.8,  "uniform"),   # 1.39M, 2.8, 51
    "p2p-Gnutella04": (8192,  3.7,  "rmat"),      # 10.9k, 3.7, 497
    "amazon0601":    (8192,   8.4,  "rmat"),      # 403k, 8.4, 100
    "web-Google":    (8192,   5.6,  "rmat"),      # 916k, 5.6, 4334
    "scircuit":      (8192,   5.6,  "uniform"),   # 171k, 5.6, 353
    "cit-Patents":   (8192,   4.4,  "rmat"),      # 3.77M, 4.4, 770
    "Economics":     (8192,   6.2,  "uniform"),   # 206k, 6.2, 44
    "webbase-1M":    (8192,   3.1,  "rmat"),      # 1M, 3.1, 4700
    "wb-edu":        (8192,   5.8,  "rmat"),      # 9.8M, 5.8, 3841
    "cage15":        (8192,  19.2,  "uniform"),   # 5.2M, 19.2, 47
    "WindTunnel":    (4096,  53.4,  "uniform"),   # 218k, 53.4, 180
    "Protein":       (2048, 119.3,  "uniform"),   # 36k, 119.3, 204
}

# Table III GNN datasets, scaled (nodes, avg_deg, n_classes, kind).
TABLE_III_SCALED = {
    "Flickr":        (4096,  22.2, 7,  "rmat"),    # 89k nodes
    "ogbn-proteins": (2048, 100.0, 2,  "uniform"), # 133k, deg 1194 (capped)
    "ogbn-arxiv":    (4096,  15.8, 40, "rmat"),    # 169k
    "Reddit":        (2048, 100.0, 41, "rmat"),    # 233k, deg 986 (capped)
    "Yelp":          (8192,  38.9, 10, "rmat"),    # 717k
    "ogbn-products": (16384, 51.5, 47, "rmat"),    # 2.45M, deg 103 (capped)
}


def table_ii_matrix(name: str, seed: int = 0, n_override: int | None = None,
                    device="cuda") -> CSR:
    """The Table II stand-in ``name`` (``n_override`` sets its rows)."""
    n, deg, kind = TABLE_II_SCALED[name]
    if n_override:
        n = n_override
    gen = rmat_graph if kind == "rmat" else uniform_graph
    return gen(n, deg, seed=seed, device=device)
