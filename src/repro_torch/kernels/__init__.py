"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

* ``aia_gather`` — the AIA indirect row gather ``out[i] = x[idx[i]]``
  (replaces the Pallas ``repro.kernels.aia_gather.gather_rows``).
* ``hash_accum`` — Algorithm 4's linear-probing accumulate, one table per
  row (replaces the Pallas ``repro.kernels.hash_accum.hash_accumulate``).

``ops`` holds the device dispatch and the launch counters; ``_build`` builds
the CUDA sources under ``csrc/`` with ``nvcc`` at first use and loads them
with ``ctypes``.
"""
