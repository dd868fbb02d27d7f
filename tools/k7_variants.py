#!/usr/bin/env python3
"""Time builds of K7's flash-attention kernels against each other on one
CUDA card, in turns.

    python3 tools/k7_variants.py [--parent DIR] [--variant NAME=PATH ...]
                                 [--json PATH]

Run from the root of a checkout.  ``shipped`` is
``src/repro_torch/kernels/csrc/flash_attention_wgmma.cu`` (bf16) and
``flash_attention.cu`` (float32) as they are.  ``--parent DIR`` adds the
two files of an older checkout, whose C entry points take one length S
and no mask (q, k, v, o, bh, s, d, dv, causal, scale, stream), as K7 did
before its masked entry; ``--variant NAME=PATH`` adds another bf16 source
with the shipped entry point's arguments.  Each source is compiled by its
own ``nvcc`` (all started together) into ``build/k7_variants/``, with its
entry point renamed, and called through ctypes on the same inputs:

* ``phi3``: BH 64, S 4,096, D 96, causal (Phi-3-mini's prefill);
* ``mla``: BH 32, S 4,096, qk 192, v 128, causal (DeepSeek-V2-Lite's);
* ``whisper_encoder``: BH 40, S 1,500, D 64, no mask;
* ``zamba2_shared``: BH 32, S 8,192, D 64, causal, window 4,096 (the
  masked builds only);
* ``phi3_f32``: the ``phi3`` shape in float32 (the float32 sources).

Each (shape, build) is timed by CUDA events around 20 back-to-back
launches, in the order listed and then reversed, and checked against the
shipped build's output (bf16: within one bf16 step, 2**-7 relative;
float32: 1e-5).  ``ptxas``'s registers and spills of each build's kernels
are printed beside them.  It prints the card's name and power limit
first and one JSON object last, and exits non-zero without a CUDA device.
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
OUT = ROOT / "build/k7_variants"
_P, _I, _B, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
NEW = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _B, _I, _I, _I, _F, _P]
OLD = [_P, _P, _P, _P, _I, _I, _I, _I, _B, _F, _P]
# (name, bh, s, d, dv, causal, window, dtype)
SHAPES = (("phi3", 64, 4096, 96, 96, True, 0, "bf16"),
          ("mla", 32, 4096, 192, 128, True, 0, "bf16"),
          ("whisper_encoder", 40, 1500, 64, 64, False, 0, "bf16"),
          ("zamba2_shared", 32, 8192, 64, 64, True, 4096, "bf16"),
          ("phi3_f32", 64, 4096, 96, 96, True, 0, "f32"))


def sources(args) -> dict:
    """{build name: (source path, dtype, entry point, argument kind)}."""
    out = {"shipped": (CSRC / "flash_attention_wgmma.cu", "bf16",
                       "repro_flash_attention_wgmma", "new"),
           "shipped_f32": (CSRC / "flash_attention.cu", "f32",
                           "repro_flash_attention", "new")}
    if args.parent:
        d = pathlib.Path(args.parent)
        out["parent"] = (d / "flash_attention_wgmma.cu", "bf16",
                         "repro_flash_attention_wgmma", "old")
        out["parent_f32"] = (d / "flash_attention.cu", "f32",
                             "repro_flash_attention", "old")
    for item in args.variant:
        name, path = item.split("=", 1)
        out[name] = (pathlib.Path(path), "bf16",
                     "repro_flash_attention_wgmma", "new")
    return out


def build(srcs: dict) -> dict:
    """Compile every source (one nvcc each, all at once); return its
    loaded entry point and ptxas's report by kernel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (path, _, entry, _) in srcs.items():
        src = path.read_text().replace(f"{entry}(", f"{entry}_{name}(")
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *FLAGS, "-shared", "-I", str(CSRC), str(cu), "-o",
             str(OUT / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} failed to build:\n{out}")
        _, _, entry, kind = srcs[name]
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{name}.so")),
                     f"{entry}_{name}")
        fn.argtypes, fn.restype = (NEW if kind == "new" else OLD), _B
        report = {}
        for block in out.split("Compiling entry function '")[1:]:
            kernel = re.search(r"flash_\w*?kernelI(?:Li\d+E)+",
                               block.split("'", 1)[0])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            report[kernel.group(0) if kernel else "?"] = (
                int(regs.group(1)) if regs else None,
                int(spill.group(1)) if spill else 0)
        built[name] = (fn, kind, report)
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a directory holding an older "
                        "flash_attention_wgmma.cu and flash_attention.cu")
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH of another bf16 source")
    parser.add_argument("--json", help="also write the result to PATH")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k7_variants: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    srcs = sources(args)
    built = build(srcs)
    for name, (_, _, report) in built.items():
        print(json.dumps({"ptxas": name, "kernels": report}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi, "ms": {}, "max_abs_err": {}, "ptxas": {
        name: report for name, (_, _, report) in built.items()}}
    for shape, bh, s, d, dv, causal, window, dt in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k = (torch.randn((bh, s, d), generator=g, device="cuda")
                .to(dtype) for _ in range(2))
        v = torch.randn((bh, s, dv), generator=g, device="cuda").to(dtype)
        names = [n for n in built if srcs[n][1] == dt
                 and (built[n][1] == "new" or window == 0)]
        outs = {n: torch.empty((bh, s, dv), dtype=dtype, device="cuda")
                for n in names}
        scale = 1.0 / d ** 0.5

        def call(n):
            fn, kind, _ = built[n]
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    outs[n].data_ptr())
            if kind == "new":
                rc = fn(*ptrs, bh, s, s, d, dv, int(causal), 0, window, s,
                        scale, stream)
            else:
                rc = fn(*ptrs, bh, s, d, dv, int(causal), scale, stream)
            if rc:
                raise RuntimeError(f"{n} at {shape}: error {rc}")

        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                call(n)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call(n)
                end.record()
                torch.cuda.synchronize()
                times[n].append(start.elapsed_time(end) / 20)
        ref = outs[names[0]].double()
        rtol, atol = (2 ** -7, 1e-6) if dt == "bf16" else (1e-5, 1e-5)
        errs = {}
        for n in names:
            diff = (outs[n].double() - ref).abs()
            if not bool((diff <= atol + rtol * ref.abs()).all()):
                raise AssertionError(f"{n} at {shape} differs from "
                                     f"{names[0]} by {float(diff.max())}")
            errs[n] = float(diff.max())
        result["ms"][shape] = times
        result["max_abs_err"][shape] = errs
        print(json.dumps({"shape": shape, "ms": times}), flush=True)
        del q, k, v, outs
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result["ms"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
