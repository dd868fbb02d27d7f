"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``aia_gather`` — the AIA indirect gather: rows, ``out[i] = x[idx[i]]``
  (replaces the Pallas ``repro.kernels.aia_gather.gather_rows``), and
  ranges of R rows, the paper's Fig. 2 (replaces ``aia_ranged_gather``).
* ``hash_accum`` — Algorithm 4's linear-probing accumulate, one table per
  row (replaces the Pallas ``repro.kernels.hash_accum.hash_accumulate``).
* ``spgemm_bsr`` — block-CSR x dense, accumulated per block-row (replaces
  the Pallas ``repro.kernels.spgemm_bsr.bsr_spmm``).
* ``topk_spmm`` — the paper's Eq. (1) ``TopK(h) @ W2``, per token and per
  token tile (replaces the Pallas ``repro.kernels.topk_spmm.topk_spmm`` and
  ``block_topk_spmm``).
* ``flash_attention`` — fused online-softmax attention on ``(BH, S, D)``
  (replaces the Pallas ``repro.kernels.flash_attention.
  flash_attention_fused``), and the same kernel under the model attention's
  masks (window, query offset, key limit, Sq != Sk).

``ops`` holds the device dispatch, the launch counters and the public
entry points with the reference's signatures; ``_build`` builds the CUDA
sources under ``csrc/`` with ``nvcc`` at first use and loads them with
``ctypes``.
"""
