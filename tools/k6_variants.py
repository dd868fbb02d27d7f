#!/usr/bin/env python3
"""Time variants of K6's tensor-core kernel on one CUDA card, in turns.

    python3 tools/k6_variants.py [--parent DIR] [--json PATH]

Run from the root of a checkout.  Each variant is
``src/repro_torch/kernels/csrc/block_topk_spmm_wgmma.cu`` with one change,
compiled by its own ``nvcc`` (all started together) into a shared library
under ``build/k6_variants/`` and called through ctypes on the FFN path's
K6 inputs (``chip_smoke.ffn_operands``: Phi-3-mini's FFN, 2,048 tokens,
tiles of 8, 8 of 64 blocks of 128 a tile, bf16), then in float16 and at
blocks of 512 lanes (bf16, 2 of 16 blocks a tile):

* ``shipped``: the source as it is (the products into a workspace slot
  each, then the slots added in (t, panel) order);
* ``panel_128``: depth panels of 128 lanes in place of 256 (more slots,
  less shared memory a block);
* ``unroll_1`` / ``unroll_full``: the depth loop of ``wgmma``s not
  unrolled, or unrolled in full (the source unrolls it by 4);
* ``parent`` (with ``--parent DIR``): DIR's ``block_topk_spmm_wgmma.cu``,
  an older source whose entry point takes no workspace and no dtype
  (h, bidx, w2, pair_ptr, pairs, out, n_tiles, kb, tile, block, d,
  n_blocks, stream), bf16 at blocks up to 256, adding its products into y
  with float32 reductions; timed at the first shape only.

Each (shape, variant) is timed by CUDA events around 20 back-to-back calls
(every launch of a call), and by ``torch.profiler`` (each kernel's mean
over 10 calls), in the order listed and then reversed; each is checked
against the plain version (within 1e-5 of the largest |value|) and, but
the parent, bit for bit on a repeat.  ``ptxas``'s registers and spills of
each build's product kernel are printed beside them.  It prints the card's
name and power limit first and one JSON object last, and exits non-zero
without a CUDA device.
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
LOOP = "#pragma unroll 4\n    for (int kk = 0; kk < kp / 16; ++kk)"
PANEL = "constexpr int kPanelLanes = 256;"
VARIANTS = {
    "shipped": [],
    "panel_128": [(PANEL, PANEL.replace("256", "128"))],
    "unroll_1": [(LOOP, LOOP.replace("unroll 4", "unroll 1"))],
    "unroll_full": [(LOOP, LOOP.replace("unroll 4", "unroll"))],
}
ENTRY = "repro_block_topk_spmm_wgmma"
_P, _I = ctypes.c_void_p, ctypes.c_longlong
PARENT_ARGS = [_P] * 6 + [_I] * 6 + [_P]
# (name, block, dtype): the FFN path's K6 call, then float16 and 512 lanes
SHAPES = (("ffn_bf16", 128, "bfloat16"), ("ffn_float16", 128, "float16"),
          ("block512_bf16", 512, "bfloat16"))


def build(out_dir: pathlib.Path, parent) -> dict:
    """Compile every variant (one nvcc each, all at once); return its
    library path and ptxas's report of the product kernel."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name}: the source has changed")
            src = src.replace(old, new)
        sources[name] = src
    if parent:
        sources["parent"] = (pathlib.Path(parent)
                             / "block_topk_spmm_wgmma.cu").read_text()
    procs = {}
    for name, src in sources.items():
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
    parser.add_argument("--parent", help="a directory holding an older "
                        "block_topk_spmm_wgmma.cu (no workspace, bf16)")
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, topk_spmm
    from repro_torch.models.ffn import tile_block_select

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built = build(ROOT / "build" / "k6_variants", args.parent)
    fc = cs.FFN
    _, _, w2_base, h_base = cs.ffn_operands(seed=0)
    record = {"nvidia_smi": smi, "shapes": {}}
    for shape, block, dt in SHAPES:
        dtype = getattr(torch, dt)
        w2, h = w2_base.to(dtype), h_base.to(dtype)
        h_kept, bidx = tile_block_select(h, fc["k"] // block, block,
                                         fc["tile"])
        n_tiles, kb, tile, _ = h_kept.shape
        d, n_blocks = w2.shape[1], w2.shape[0] // block
        want = topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2, block)
        pair_ptr = torch.empty(2 * n_blocks + 1, dtype=torch.int32,
                               device="cuda")
        pairs = torch.empty(n_tiles * kb, dtype=torch.int32, device="cuda")
        calls = {}
        for name, b in built.items():
            if name == "parent" and shape != SHAPES[0][0]:
                continue
            fn = getattr(ctypes.CDLL(str(b["library"])), f"{ENTRY}_{name}")
            fn.argtypes = (PARENT_ARGS if name == "parent"
                           else _build.SIGNATURES[ENTRY])
            fn.restype = ctypes.c_int
            panels = -(-block // (128 if name == "panel_128" else 256))
            n_ws = n_tiles * kb * panels * tile * (-(-d // 128) * 128)

            def call(fn=fn, name=name, n_ws=n_ws):
                out = torch.empty((n_tiles * tile, d), dtype=torch.float32,
                                  device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                if name == "parent":
                    rc = fn(h_kept.data_ptr(), bidx.data_ptr(),
                            w2.data_ptr(), pair_ptr.data_ptr(),
                            pairs.data_ptr(), out.data_ptr(), n_tiles, kb,
                            tile, block, d, n_blocks, stream)
                else:
                    ws = torch.empty(n_ws, dtype=torch.float32,
                                     device="cuda")
                    rc = fn(h_kept.data_ptr(), bidx.data_ptr(),
                            w2.data_ptr(), pair_ptr.data_ptr(),
                            pairs.data_ptr(), ws.data_ptr(), n_ws,
                            out.data_ptr(), n_tiles, kb, tile, block, d,
                            n_blocks, ops.DTYPE_CODES[dtype], stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed: error {rc}")
                return out
            calls[name] = call
        times = {name: {"loop_ms": [], "kernels_device_ms": []}
                 for name in calls}
        for name in list(calls) + list(reversed(list(calls))):
            times[name]["loop_ms"].append(cs.loop_ms(calls[name], reps=20))
            _, _, top = cs.profile(lambda: [calls[name]()
                                            for _ in range(10)], top_n=8)
            times[name]["kernels_device_ms"].append(
                {k: t / n for k, t, n in top})
        results = {}
        for name, call in calls.items():
            got = call()
            results[name] = {
                **times[name], "rel_err": cs.rel_err(got, want),
                "repeat_bit_identical": (None if name == "parent"
                                         else bool(torch.equal(got, call()))),
                "registers": built[name]["registers"],
                "spill_stores": built[name]["spill_stores"]}
            print(shape, name, json.dumps(results[name]), flush=True)
        record["shapes"][shape] = {"h_kept": list(h_kept.shape),
                                   "variants": results}
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
