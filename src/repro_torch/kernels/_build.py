"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process (all started together) and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
goes to ``build/repro_torch_kernels/<hash>/`` at the root of the checkout,
keyed on a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once.  A failed build raises with the compiler's
output; ``build.log`` beside the library keeps ``ptxas``'s register and
shared-memory report.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _B = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F = ctypes.c_float
# C entry points and their arguments (pointers and the stream as void*;
# ``_B`` is 1 for bfloat16 operands, 0 for float32, or a flag).
SIGNATURES = {
    # idx, n_idx, n_x_rows, x0, out0, row_bytes0, x1, out1, row_bytes1
    # (NULL, NULL, 0 for one plane), unit bytes, stream
    "repro_gather_planes": [_P, _I, _I, _P, _P, _I, _P, _P, _I, _B, _P],
    # keys, vals, masks (scratch), cols, out_vals, cnt, rows, ip_cap,
    # table_cap, stream (the table in shared memory up to kSmemTableBytes,
    # else in cols and out_vals)
    "repro_hash_accumulate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, idx, out, n_blocks, range_words, n_idx, v16 (1: the 16-byte
    # copy, 0: the word copy), stream
    "repro_aia_ranged_gather": [_P, _P, _P, _I, _I, _I, _B, _P],
    # rowptr, colidx, a_blocks, b, out, n_brows, n_bcols, bs, d,
    # max_blocks_per_row, bcap, stream (float32; bfloat16 for the wgmma
    # kernel)
    "repro_bsr_spmm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_bsr_spmm_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # vals, idx, w2, out, n, k, d, d_ff, bf16, stream (the "l2" route)
    "repro_topk_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _B, _P],
    # vals, idx, w2, pairs (scratch), out, n, k, d, d_ff, bf16, stream (the
    # "smem" route)
    "repro_topk_spmm_smem": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _B, _P],
    # h_kept, bidx, w2, out, n_tiles, kb, tile, block, d, n_blocks, stream
    # (float32; bfloat16 for the wgmma kernel, with pair_ptr and pairs
    # scratch after w2)
    "repro_block_topk_spmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_block_topk_spmm_wgmma": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _P],
    # q, k, v, o, bh, sq, sk, d, dv, causal, q_offset, window, kv_len,
    # scale, stream (float32; bfloat16 for the wgmma kernel)
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _B, _I,
                              _I, _I, _F, _P],
    "repro_flash_attention_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _B,
                                    _I, _I, _I, _F, _P],
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
    procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"$ nvcc {src.name} (exit {proc.returncode})\n{out}")
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
