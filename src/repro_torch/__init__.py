"""PyTorch/CUDA port of the SpGEMM reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro``'s layout (``sparse/``, ``core/``, ``kernels/``,
``apps/``) so each module has a counterpart by the same name.  Tensors live
on an explicit device: format constructors default to ``"cuda"``, and
``core.spgemm.spgemm`` runs on the device its operands live on.  On a CUDA
tensor six hand-written CUDA kernels (``kernels/csrc``) serve two paths:
the SpGEMM path (the AIA row gather and the Algorithm-4 hash accumulate)
and the sparse-activation path behind ``kernels.ops`` (the ranged AIA
gather, BSR x dense, and the TopK down-projection per token and per tile).
On a CPU tensor each runs its plain PyTorch version, which the tests hold
against the JAX package.
"""
