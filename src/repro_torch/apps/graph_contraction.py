"""Graph Contraction (paper Algorithm 7): C = S · G · Sᵀ via two SpGEMMs.

S is m×n with S[label[v], v] = 1: left-multiplying merges rows that share
a label, right-multiplying by Sᵀ merges columns; merged edge weights add.
Counterpart of ``repro.apps.graph_contraction``; both products run on the
device ``g`` lives on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import executor
from repro_torch.core.spgemm import spgemm
from repro_torch.sparse.formats import CSR, csr_from_coo
from repro_torch.sparse.ops import csr_transpose


def label_matrix(labels: np.ndarray, n: int | None = None,
                 m: int | None = None, device="cuda") -> CSR:
    """S = sparse(labels, 1:n, 1, m, n) (Algorithm 7 line 3)."""
    labels = np.asarray(labels)
    n = n if n is not None else len(labels)
    m = m if m is not None else int(labels.max()) + 1
    return csr_from_coo(labels, np.arange(n), np.ones(n, np.float32), (m, n),
                        device=device)


def graph_contraction(g: CSR, labels: np.ndarray, method: str = "sort",
                      gather: str = "auto", schedule: str = "grouped",
                      mesh=None, pipeline: str = "two_wave",
                      sizing: str = "auto"):
    """Returns (C, infos): the contracted adjacency and each SpGEMM's
    counters.

    ``method``/``gather``/``schedule``/``sizing`` select the executor's
    engine (``"auto"``: one per Table-I bin), B-row gather, Table-I
    scheduling and output sizing (the paper's ablation axes);
    ``sizing="auto"`` is planned (zero host syncs in the pipeline) for
    ``"fused_hash"``.  ``pipeline`` picks the two-wave or the legacy
    (per-chunk read) sync structure; ``mesh`` runs both products through
    the sharded executor (``g`` on its merge device).
    """
    method = executor.resolve_engine(method)
    s = label_matrix(labels, n=g.n_rows, device=g.device)
    st = csr_transpose(s)
    r1 = spgemm(s, g, engine=method, gather=gather, schedule=schedule,
                mesh=mesh, pipeline=pipeline, sizing=sizing)
    r2 = spgemm(r1.c, st, engine=method, gather=gather, schedule=schedule,
                mesh=mesh, pipeline=pipeline, sizing=sizing)
    return r2.c, [r1.info, r2.info]
