#!/usr/bin/env python3
"""Time variants of K6's bf16 kernel on one CUDA card, in turns.

    python3 tools/k6_variants.py [--json PATH]

Run from the root of a checkout.  Each variant is
``src/repro_torch/kernels/csrc/block_topk_spmm_wgmma.cu`` with one change,
compiled by its own ``nvcc`` (all started together) into a shared library
under ``build/k6_variants/`` and called through ctypes on the FFN path's
K6 inputs (``chip_smoke.ffn_operands``: Phi-3-mini's FFN, 2,048 tokens,
tiles of 8, 8 of 64 blocks of 128 a tile).  The device time of each
variant's product kernel (``torch.profiler``, mean of 10 launches) is
printed beside ``ptxas``'s registers and spills, twice in the order
listed and then reversed:

* ``shipped``: the source as it is;
* ``store``: plain 16-byte stores in place of the float32 reductions
  (wrong sums: the cost of the epilogue's reductions against stores);
* ``no_epilogue``: no store at all (the staging and the products alone);
* ``unroll_1`` / ``unroll_full``: the depth loop of ``wgmma``s not
  unrolled, or unrolled in full (the source unrolls it by 4).

It prints the card's name and power limit first, and one JSON object
last.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SOURCE = CSRC / "block_topk_spmm_wgmma.cu"
RED = 'asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\\n"'
LOOP = "#pragma unroll 4\n    for (int kk = 0; kk < kp / 16; ++kk)"
VARIANTS = {
    "shipped": [],
    "store": [(RED, RED.replace("red.global.add.v4.f32",
                                "st.global.v4.f32"))],
    "no_epilogue": [(RED, "if (x != x && y != y) " + RED)],
    "unroll_1": [(LOOP, LOOP.replace("unroll 4", "unroll 1"))],
    "unroll_full": [(LOOP, LOOP.replace("unroll 4", "unroll"))],
}
ENTRY = "repro_block_topk_spmm_wgmma"


def build(out_dir: pathlib.Path) -> dict:
    """Compile every variant (one nvcc each, all at once); return its
    library path and ptxas's report of the product kernel."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: the source has changed")
            src = src.replace(old, new)
        src = src.replace(f"{ENTRY}(", f"{ENTRY}_{name}(")
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *FLAGS, "-shared", "-I", str(CSRC), str(path), "-o",
             str(out_dir / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        report = out.split("block_topk_wgmma_kernel")[-1]
        regs = re.search(r"Used (\d+) registers", report)
        spill = re.search(r"(\d+) bytes spill stores", report)
        built[name] = {"library": out_dir / f"lib{name}.so",
                       "registers": int(regs.group(1)) if regs else None,
                       "spill_stores": int(spill.group(1)) if spill else None}
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, topk_spmm
    from repro_torch.models.ffn import tile_block_select

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built = build(ROOT / "build" / "k6_variants")
    fc = cs.FFN
    _, _, w2, h = cs.ffn_operands(seed=0)
    h_kept, bidx = tile_block_select(h, fc["k"] // fc["block"], fc["block"],
                                     fc["tile"])
    n_tiles, kb, tile, block = h_kept.shape
    d, n_blocks = w2.shape[1], w2.shape[0] // block
    want = topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2, block)
    pair_ptr = torch.empty(n_blocks + 1, dtype=torch.int32, device="cuda")
    pairs = torch.empty(n_tiles * kb, dtype=torch.int32, device="cuda")
    calls = {}
    for name, b in built.items():
        fn = getattr(ctypes.CDLL(str(b["library"])), f"{ENTRY}_{name}")
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int

        def call(fn=fn):
            out = torch.zeros((n_tiles * tile, d), dtype=torch.float32,
                              device="cuda")
            rc = fn(h_kept.data_ptr(), bidx.data_ptr(), w2.data_ptr(),
                    pair_ptr.data_ptr(), pairs.data_ptr(), out.data_ptr(),
                    n_tiles, kb, tile, block, d, n_blocks,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: error {rc}")
            return out
        calls[name] = call
    times = {name: [] for name in calls}
    for name in list(calls) + list(reversed(list(calls))):
        calls[name]()
        _, _, top = cs.profile(lambda: [calls[name]() for _ in range(10)])
        kernel = [t / n for k, t, n in top if "block_topk_wgmma" in k]
        times[name].append(kernel[0] if kernel else None)
    results = {name: {"kernel_device_ms": times[name],
                      "rel_err": cs.rel_err(calls[name](), want),
                      "registers": built[name]["registers"],
                      "spill_stores": built[name]["spill_stores"]}
               for name in calls}
    record = {"nvidia_smi": smi, "shape": list(h_kept.shape),
              "variants": results}
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
