#!/usr/bin/env python3
"""Time variants of K5's ``"smem"`` kernel on one CUDA card, in turns.

    python3 tools/k5_variants.py [--json PATH]

Run from the root of a checkout.  Each variant is
``src/repro_torch/kernels/csrc/topk_spmm_smem.cu`` with its constants
changed, compiled by its own ``nvcc`` (all started together) into a shared
library under ``build/k5_variants/`` and called through ctypes on the FFN
path's K5 inputs (``chip_smoke.ffn_operands``: Phi-3-mini's FFN, 2,048
tokens, the TopK k = 1,024 of d_ff 8,192, bf16).  Every variant's output
must equal ``topk_spmm_plain``'s bit for bit.  The device time of each
variant's launches (``torch.profiler``: the pre-pass and the product
kernel, mean of 10 calls) is printed beside ``ptxas``'s registers and
spills, twice in the order listed and then reversed:

* ``source``: the source as it is (four buffers of 16 KB, 256 consumer
  threads a block);
* ``chunk_24``: two buffers of 48 KB (24 steps of t a chunk);
* ``threads_512``: 512 consumer threads (tokens) a block in place of 256
  (16 warps; 8 steps of t a chunk);
* ``conflict_free``: each lane of a quarter-warp reading a row on its own
  banks (the low 3 bits of the row id replaced by the lane's): the cost of
  the bank conflicts;
* ``no_math``: the shared loads kept and the products and sums replaced by
  one xor a step: the cost of the arithmetic;
* ``no_staging``: W2's slice not staged: its cost.

The last three compute wrong sums on purpose and are not held.  It also
times the ``"l2"`` route (``csrc/topk_spmm.cu``) on the same inputs in the
same turns.

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
SOURCE = CSRC / "topk_spmm_smem.cu"
ENTRY = "repro_topk_spmm_smem"


def constant(name: str, value: int) -> tuple:
    """An edit of the source setting ``constexpr int <name>`` to ``value``."""
    return (re.compile(rf"constexpr int {name} = \d+;"),
            f"constexpr int {name} = {value};")


def text(old: str, new: str) -> tuple:
    """An edit of the source replacing every ``old`` with ``new``."""
    return re.compile(re.escape(old)), new


VARIANTS = {
    "source": [],
    "chunk_24": [constant("kStages", 2), constant("kStageBytes", 49152)],
    "threads_512": [constant("kThreads", 512)],
    "conflict_free": [
        text("rows[pair_id(p)]",
             "rows[(pair_id(p) & ~7u) | (threadIdx.x & 7u)]")],
    "no_math": [text("accumulate(acc, p, rows[pair_id(p)]);",
                     "{ const uint4 w = rows[pair_id(p)]; acc[0] = "
                     "__uint_as_float(__float_as_uint(acc[0]) ^ w.x ^ w.y "
                     "^ w.z ^ w.w); }")],
    "no_staging": [text("for (int r = threadIdx.x; r < d_ff; r += kThreads)"
                        "\n        hopper::cp_async_16",
                        "for (int r = threadIdx.x; r < 0; r += kThreads)"
                        "\n        hopper::cp_async_16")],
}
# variants that compute a wrong sum on purpose, to time a part of the kernel
DIAGNOSTIC = {"conflict_free", "no_math", "no_staging"}


def build(out_dir: pathlib.Path) -> dict:
    """Compile every variant (one nvcc each, all at once); return its
    library path, its constants and ptxas's report of the product kernel."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs, consts = {}, {}
    for name, edits in VARIANTS.items():
        src = text
        for pattern, new in edits:
            src, hits = pattern.subn(new, src)
            if not hits:
                raise RuntimeError(f"variant {name}: the source has changed")
        consts[name] = {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", src)}
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
        report = out.split("topk_smem_kernelIt")[-1]
        regs = re.search(r"Used (\d+) registers", report)
        spill = re.search(r"(\d+) bytes spill stores", report)
        built[name] = {"library": out_dir / f"lib{name}.so",
                       "constants": consts[name],
                       "registers": int(regs.group(1)) if regs else None,
                       "spill_stores": int(spill.group(1)) if spill else None}
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, topk_spmm
    from repro_torch.sparse.topk import topk_rows

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built = build(ROOT / "build" / "k5_variants")
    _, _, w2, h = cs.ffn_operands(seed=0)
    tk = topk_rows(h, cs.FFN["k"])
    vals, idx = tk.values, tk.indices
    (n, k), (d_ff, d) = vals.shape, w2.shape
    want = topk_spmm.topk_spmm_plain(vals, idx, w2)
    calls = {}
    for name, b in built.items():
        lib = ctypes.CDLL(str(b["library"]))
        fn = getattr(lib, f"{ENTRY}_{name}")
        fn.argtypes = _build.SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        group = b["constants"]["kThreads"]
        pairs = torch.empty(-(-n // group) * group * k * 4, dtype=torch.uint8,
                            device="cuda")

        def call(fn=fn, pairs=pairs):
            out = torch.empty((n, d), dtype=torch.float32, device="cuda")
            rc = fn(vals.data_ptr(), idx.data_ptr(), w2.data_ptr(),
                    pairs.data_ptr(), out.data_ptr(), n, k, d, d_ff, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: error {rc}")
            return out
        calls[name] = call

    def l2_route():
        out = torch.empty((n, d), dtype=torch.float32, device="cuda")
        rc = _build.library().repro_topk_spmm(
            vals.data_ptr(), idx.data_ptr(), w2.data_ptr(), out.data_ptr(), n,
            k, d, d_ff, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: error {rc}")
        return out
    calls["l2_route"] = l2_route
    exact = {name: bool(torch.equal(call(), want))
             for name, call in calls.items()}
    times = {name: [] for name in calls}
    kernels = {}
    for name in list(calls) + list(reversed(list(calls))):
        calls[name]()
        _, dev, top = cs.profile(lambda: [calls[name]() for _ in range(10)])
        times[name].append(None if dev is None else dev / 10)
        kernels[name] = {kern: ms / c for kern, ms, c in top}
    results = {name: {"device_ms": times[name],
                      "kernels_ms": kernels[name],
                      "bit_exact": exact[name],
                      "registers": built.get(name, {}).get("registers"),
                      "spill_stores": built.get(name, {}).get("spill_stores")}
               for name in calls}
    record = {"nvidia_smi": smi, "shape": {"vals": [n, k], "w2": [d_ff, d]},
              "variants": results}
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    if not all(v for name, v in exact.items() if name not in DIAGNOSTIC):
        print(f"k5_variants: not bit-exact: {exact}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
