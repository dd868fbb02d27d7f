"""The paper's hash-based multi-phase SpGEMM, single device.

Phases: Algorithm 1 IP counting + Table-I grouping (``grouping``), then
allocation and accumulation per group-chunk (``phases``, dispatched by
``executor``).  ``spgemm.spgemm`` is the public entry point;
``spgemm_bsr`` is the block-CSR x dense product of the sparse-activation
path.
"""
