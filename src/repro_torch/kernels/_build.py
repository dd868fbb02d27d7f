"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together) and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
goes to ``build/repro_torch_kernels/<hash>/`` at the root of the checkout,
keyed on a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once.  A failed build raises with the compiler's
output; ``build.log`` beside the library keeps ``ptxas``'s register and
shared-memory report and each source's compile seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _B = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F = ctypes.c_float
# C entry points and their arguments (pointers and the stream as void*;
# ``_B`` is a dtype code, ``ops.DTYPE_CODES``: 0 float32, 1 bfloat16,
# 2 float16, 3 float64; or a flag).
SIGNATURES = {
    # idx, n_idx, n_x_rows, x0, out0, row_bytes0, pitch_bytes0, x1, out1,
    # row_bytes1, pitch_bytes1 (NULL, NULL, 0, 0 for one plane), unit
    # bytes, stream
    "repro_gather_planes": [_P, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _B,
                            _P],
    # keys, vals, masks (scratch), cols, out_vals, cnt, rows, ip_cap,
    # table_cap, dtype code, stream (the table in shared memory up to
    # kSmemTableBytes, else in cols and out_vals)
    "repro_hash_accumulate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _B, _P],
    # x, idx, out, n_blocks, rows a range (1: a contiguous x's range as one
    # row), row_bytes, pitch_bytes, n_idx, unit bytes, v16 (1: the 16-byte
    # copy, 0: the row gather's copy in units), stream
    "repro_aia_ranged_gather": [_P, _P, _P, _I, _I, _I, _I, _I, _B, _B, _P],
    # rowptr, colidx, a_blocks, b, out, n_brows, n_bcols, bs, d,
    # max_blocks_per_row, bcap, dtype code, stream (float32 or float16;
    # bfloat16 for the wgmma kernel)
    "repro_bsr_spmm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _B, _P],
    "repro_bsr_spmm_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _B,
                             _P],
    # vals, idx, w2, out, n, k, d, d_ff, dtype code, stream (the "l2"
    # route)
    "repro_topk_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _B, _P],
    # vals, idx, w2, pairs (scratch), out, n, k, d, d_ff, bf16 (0: float32),
    # stream (the "smem" route)
    "repro_topk_spmm_smem": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _B, _P],
    # h_kept, bidx, w2, out, n_tiles, kb, tile, block, d, n_blocks, dtype
    # code, stream (the CUDA cores); the wgmma kernel (bfloat16 and
    # float16) has pair_ptr, pairs and the workspace (and its elements)
    # as scratch after w2
    "repro_block_topk_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _B,
                              _P],
    "repro_block_topk_spmm_wgmma": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                                    _I, _I, _I, _I, _B, _P],
    # q, k, v, o, lse (NULL: not written), bh, sq, sk, d, dv, causal,
    # q_offset, window, kv_len, scale, p_bf16, dtype code, stream: the
    # CUDA-core kernel (any type) and the tensor-core builds (bfloat16 and
    # float16 up to 256 columns, and both types past it)
    **{name: [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _B, _I, _I, _I, _F, _B,
              _B, _P]
       for name in ("repro_flash_attention", "repro_flash_attention_wgmma",
                    "repro_flash_attention_wgmma_f16",
                    "repro_flash_attention_wgmma_wide")},
    # the same with the scratch of q, k and v's bf16 terms and its
    # elements after lse: the float32 tensor-core build
    "repro_flash_attention_wgmma_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _B, _I, _I, _I, _F, _B,
                                        _B, _P],
    # v, o, lse (NULL: none), bh, sq, sk, dv, a, b, den, p_bf16, dtype
    # code, fwd (0: the backward's keyless dV into o), stream: the queries
    # without a key
    "repro_flash_keyless": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _B, _B,
                            _B, _P],
    # q, k, v, o, lse, do, dq, dk, dv, delta (scratch), keyless dV (NULL:
    # none), bh, sq, sk, d, dv, causal, q_offset, window, kv_len, scale,
    # p_bf16, dtype code, stream: the CUDA-core kernel and the tensor-core
    # builds, as the forward's
    **{name: [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
              _B, _I, _I, _I, _F, _B, _B, _P]
       for name in ("repro_flash_attention_bwd",
                    "repro_flash_attention_bwd_wgmma",
                    "repro_flash_attention_bwd_wgmma_f16",
                    "repro_flash_attention_bwd_wgmma_wide")},
    # ids, vals, order (NULL: none), out, work (scratch; NULL for one
    # column), n, n_out, width, skip, batch, dtype code, stream
    "repro_segment_sum": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _B, _P],
}

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile and link the kernels if needed; return the library's path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    outs = [out_dir / f"{src.stem}.{tag}.log" for src in sources]
    t0 = time.perf_counter()
    procs = []
    for src, obj, out in zip(sources, objs, outs):
        with open(out, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)], stdout=f,
                stderr=subprocess.STDOUT))
    # each source's wall from the common start: the slowest sets the build's
    secs = [None] * len(procs)
    while None in secs:
        for i, proc in enumerate(procs):
            if secs[i] is None and proc.poll() is not None:
                secs[i] = time.perf_counter() - t0
        time.sleep(0.05)
    log, failed = [], []
    for src, proc, out, sec in zip(sources, procs, outs, secs):
        log.append(f"$ nvcc {src.name} (exit {proc.returncode}, {sec:.1f} s)"
                   f"\n{out.read_text()}")
        out.unlink()
        if proc.returncode:
            failed.append(src.name)
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        log.append(f"$ nvcc -shared (exit {link.returncode})\n"
                   f"{link.stdout}{link.stderr}")
        if link.returncode:
            failed.append("link")
    text = "\n".join(log)
    if failed:
        raise RuntimeError(f"building the CUDA kernels failed ({failed}):\n"
                           f"{text}")
    (out_dir / "build.log").write_text(text)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def source_constants(source: str) -> dict:
    """The integer constants of ``csrc/<source>`` (each ``constexpr int
    kName = N;``), read from the source, so that no copy of them is kept
    in Python."""
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", (CSRC / source).read_text())}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
