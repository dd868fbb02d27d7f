"""PyTorch/CUDA port of the SpGEMM reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro``'s layout (``sparse/``, ``core/``, ``kernels/``,
``apps/``, ``configs/``, ``models/``, ``serve/``, ``launch/``) so each module
has a counterpart by the same name.  Tensors live on an explicit device:
format constructors and model inits default to ``"cuda"``, and
``core.spgemm.spgemm`` runs on the device its operands live on.  On a CUDA
tensor seven hand-written CUDA kernels (``kernels/csrc``) serve three
paths: the SpGEMM path (the AIA row gather and the Algorithm-4 hash
accumulate), the sparse-activation path behind ``kernels.ops`` (the ranged
AIA gather, BSR x dense, and the TopK down-projection per token and per
tile) and the LM path (the fused flash attention of the full-sequence
forward).  On a CPU tensor each runs its plain PyTorch version, which the
tests hold against the JAX package.
"""
