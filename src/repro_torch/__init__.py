"""PyTorch/CUDA port of the SpGEMM reproduction (``repro``) for one NVIDIA H100.

The package mirrors ``repro``'s layout (``sparse/``, ``core/``, ``kernels/``,
``apps/``) so each module has a counterpart by the same name.  Tensors live
on an explicit device: format constructors default to ``"cuda"``, and
``core.spgemm.spgemm`` runs on the device its operands live on.  On a CUDA
tensor the AIA row gather and the Algorithm-4 hash accumulate launch
hand-written CUDA kernels (``kernels/csrc``); on a CPU tensor they run their
plain PyTorch versions, which the tests hold against the JAX package.
"""
