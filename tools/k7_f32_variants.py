#!/usr/bin/env python3
"""Time layouts of K7's float32 tensor-core forward on one CUDA card, in
turns, beside the CUDA-core kernel and SDPA.

    python3 tools/k7_f32_variants.py [--stages N ...] [--json PATH]

Run from the root of a checkout.  Each layout is
``src/repro_torch/kernels/csrc/flash_attention_wgmma_f32.cu`` with another
depth of its K/V panel ring (``kF32Stages`` = N; 2, 3 and 4 by default:
24 KB a stage, so at D 96 two stages let two blocks share an SM and three
or four keep one; at D 256 one block an SM throughout), each built by its
own ``nvcc`` (all started together, with ``flash_attention.cu``, the
float32 CUDA-core kernel) into ``build/k7_f32_variants/``, and called
through ctypes on the same float32 inputs, causal:

* ``phi3``: BH 64, S 4,096, D 96 (Phi-3-mini's prefill);
* ``d256``: BH 32, S 4,096, D 256;
* ``qk64_v128``: BH 32, S 4,096, qk 64 / v 128.

Each (shape, layout) is timed by CUDA events around back-to-back calls
(every launch of a call: the pass that splits q, k and v into their bf16
terms, then the attention kernel), in the order listed and then reversed;
the CUDA-core kernel and ``F.scaled_dot_product_attention`` (a yardstick
the port never calls) are timed the same way.  Every layout must give the
first one's bits (the ring's depth does not change the arithmetic) and
lie within chip_smoke.py's float32 gate of the CUDA-core kernel's output.
``ptxas``'s registers and spills of each build are printed.  It prints
the card's name and power limit first and one JSON object last, and exits
non-zero without a CUDA device.
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
OUT = ROOT / "build/k7_f32_variants"
ENTRY = "repro_flash_attention_wgmma_f32"
STAGES = "kF32Stages = 2;"
CUDA_CORES = "repro_flash_attention"
# (name, bh, s, d, dv)
SHAPES = (("phi3", 64, 4096, 96, 96), ("d256", 32, 4096, 256, 256),
          ("qk64_v128", 32, 4096, 64, 128))
HEADS = {"phi3": 32, "d256": 16, "qk64_v128": 16}


def build(stages) -> dict:
    """One nvcc a layout and one for the CUDA-core kernel, all at once:
    {name: (library, registers, spill stores of its attention kernel)}."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    text = (CSRC / "flash_attention_wgmma_f32.cu").read_text()
    if STAGES not in text:
        raise RuntimeError("flash_attention_wgmma_f32.cu: kF32Stages has "
                           "changed")
    jobs = {"cuda_cores": (CSRC / "flash_attention.cu", "flash_kernel")}
    for n in stages:
        path = OUT / f"stages{n}.cu"
        path.write_text(text.replace(STAGES, f"kF32Stages = {n};"))
        jobs[f"stages{n}"] = (path, "flash_f32_kernel")
    procs = {name: subprocess.Popen(
        [_nvcc(), *FLAGS, "-shared", "-I", str(CSRC), str(src), "-o",
         str(OUT / f"lib{name}.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (src, _) in jobs.items()}
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{out}")
        reports = [b for b in out.split("Compiling entry function '")[1:]
                   if jobs[name][1] in b.split("'", 1)[0]]
        regs = [int(m) for b in reports
                for m in re.findall(r"Used (\d+) registers", b)]
        spills = [int(m) for b in reports
                  for m in re.findall(r"(\d+) bytes spill stores", b)]
        built[name] = (OUT / f"lib{name}.so", max(regs, default=None),
                       max(spills, default=None))
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4])
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k7_f32_variants: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k7

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built = build(args.stages)
    fns = {}
    for name, (lib, _, _) in built.items():
        entry = CUDA_CORES if name == "cuda_cores" else ENTRY
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device="cuda").manual_seed(0)
    record = {"nvidia_smi": smi,
              "builds": {n: {"registers": r, "spill_stores": s}
                         for n, (_, r, s) in built.items()},
              "shapes": {}}
    for shape, bh, s, d, dv in SHAPES:
        q, k = (torch.randn((bh, s, d), generator=g, device="cuda")
                for _ in range(2))
        v = torch.randn((bh, s, dv), generator=g, device="cuda")
        n = k7.f32_scratch_elems(bh, s, s, d, dv)
        terms = torch.empty(n, dtype=torch.bfloat16, device="cuda")

        def call(name):
            out = torch.empty((bh, s, dv), device="cuda")
            extra = () if name == "cuda_cores" else (terms.data_ptr(), n)
            rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), None, *extra, bh, s, s, d, dv, 1,
                           0, 0, s, 1.0 / d ** 0.5, 0, 0,
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed: error {rc}")
            return out

        heads = HEADS[shape]
        q4, k4, v4 = (x.view(bh // heads, heads, s, x.shape[2])
                      for x in (q, k, v))
        calls = {name: (lambda name=name: call(name)) for name in fns}
        calls["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        reps = {"cuda_cores": 3}
        times = {name: [] for name in calls}
        for name in list(calls) + list(reversed(list(calls))):
            times[name].append(cs.loop_ms(calls[name],
                                          reps=reps.get(name, 10)))
        base = call("cuda_cores")
        first = call(f"stages{args.stages[0]}")
        rtol, atol = cs.FLASH_TOL["torch.float32"]
        rows = {}
        for name in calls:
            rows[name] = {"loop_ms": times[name]}
            if name.startswith("stages"):
                got = call(name)
                diff = (got.double() - base.double()).abs()
                rows[name]["same_bits_as_first"] = bool(torch.equal(got,
                                                                    first))
                rows[name]["within_gate_of_cuda_cores"] = bool(
                    (diff <= atol + rtol * base.double().abs()).all())
                rows[name]["max_abs_diff_cuda_cores"] = float(diff.max())
            print(shape, name, json.dumps(rows[name]), flush=True)
        record["shapes"][shape] = {"bh": bh, "s": s, "d": d, "dv": dv,
                                   "rows": rows}
        del q, k, v, q4, k4, v4, terms, base, first
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    bad = [(sh, n) for sh, r in record["shapes"].items()
           for n, row in r["rows"].items()
           if row.get("same_bits_as_first") is False
           or row.get("within_gate_of_cuda_cores") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
