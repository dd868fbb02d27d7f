#!/usr/bin/env python3
"""Time builds of K7's backward kernels against each other on one CUDA
card, in turns.

    python3 tools/k7_bwd_variants.py [--variant NAME=PATH ...] [--json PATH]

Run from the root of a checkout.  ``shipped`` is
``src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu`` (bf16, the
tensor cores) as it is, ``cuda_cores`` is ``flash_attention_bwd.cu`` (the
CUDA cores) called with bf16 operands; ``--variant NAME=PATH`` adds another
source with the shipped entry point's arguments.  A build takes the heads up
to its source's ``kMaxD``, and MLA's qk 192 / v 128 where its source has a
build for ``kWideD`` / ``kWideDV`` (the CUDA-core kernel every head).  Each
source is
compiled by its own ``nvcc`` (all started together) into
``build/k7_bwd_variants/``, with its entry point renamed, and called through
ctypes on the same bf16 inputs (the forward's output and ``lse`` from the
repository's own K7 forward), causal:

* ``granite``: BH 64, S 2,048, D 64 (granite-3-2b's training shape);
* ``phi3``: BH 64, S 4,096, D 96;
* ``d128``: BH 32, S 4,096, D 128;
* ``mla``: BH 32, S 2,048, qk 192 / v 128 (DeepSeek-V2-Lite's training
  shape: 2 x 16 heads).

Each (shape, build) is timed by CUDA events around 10 back-to-back calls
(Delta pre-pass, dK/dV pass and dQ pass), in the order listed and then
reversed, and its dq, dk and dv are held against the plain backward with
``chip_smoke.py``'s gate (``FLASH_BWD_F32`` of the largest |gradient| plus
``FLASH_BWD_BF16_STEP`` of each value).  ``ptxas``'s registers and spills
of each build's kernels are printed beside them.  It prints the card's
name and power limit first and one JSON object last, and exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/k7_bwd_variants"
_P, _I, _B, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
    ctypes.c_float
# q, k, v, o, lse, do, dq, dk, dv, delta, bh, sq, sk, d, dv, causal,
# q_offset, window, kv_len, scale[, bf16], stream
WGMMA = [_P] * 10 + [_I] * 5 + [_B, _I, _I, _I, _F, _P]
CUDA_CORES = [_P] * 10 + [_I] * 5 + [_B, _I, _I, _I, _F, _B, _P]
# (name, bh, s, d, dv)
SHAPES = (("granite", 64, 2048, 64, 64), ("phi3", 64, 4096, 96, 96),
          ("d128", 32, 4096, 128, 128), ("mla", 32, 2048, 192, 128))


def takes(text: str, d: int, dv: int) -> bool:
    """Whether the tensor-core source ``text`` has a build for (d, dv)."""
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    return d <= consts["kMaxD"] or (
        d <= consts.get("kWideD", 0) and dv <= consts.get("kWideDV", 0))


def sources(args) -> dict:
    """{build name: (source path, entry point, argument kind)}."""
    out = {"shipped": (CSRC / "flash_attention_bwd_wgmma.cu",
                       "repro_flash_attention_bwd_wgmma", "wgmma"),
           "cuda_cores": (CSRC / "flash_attention_bwd.cu",
                          "repro_flash_attention_bwd", "cuda_cores")}
    for item in args.variant:
        name, path = item.split("=", 1)
        out[name] = (pathlib.Path(path), "repro_flash_attention_bwd_wgmma",
                     "wgmma")
    return out


def build(srcs: dict) -> dict:
    """Compile every source (one nvcc each, all at once); return its loaded
    entry point, its source text and ptxas's report by kernel."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (path, entry, _) in srcs.items():
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
        path, entry, kind = srcs[name]
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{name}.so")),
                     f"{entry}_{name}")
        fn.argtypes, fn.restype = (WGMMA if kind == "wgmma"
                                   else CUDA_CORES), _B
        report = {}
        for block in out.split("Compiling entry function '")[1:]:
            kernel = re.search(
                r"(?:dkdv|dq|delta)_kernel(?:I(?:Li\d+E|13__nv_bfloat16|f)+E)?",
                block.split("'", 1)[0])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            report[kernel.group(0) if kernel else "?"] = (
                int(regs.group(1)) if regs else None,
                int(spill.group(1)) if spill else 0)
        built[name] = (fn, kind, path.read_text(), report)
    return built


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH of another tensor-core source")
    parser.add_argument("--json", help="also write the result to PATH")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k7_bwd_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as k7

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    srcs = sources(args)
    built = build(srcs)
    for name, (_, _, _, report) in built.items():
        print(json.dumps({"ptxas": name, "kernels": report}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi, "ms": {}, "max_abs_err": {}, "ptxas": {
        name: report for name, (_, _, _, report) in built.items()}}
    for shape, bh, s, d, dv in SHAPES:
        q, k, v, do = (torch.randn((bh, s, w), generator=g, device="cuda")
                       .bfloat16() for w in (d, d, dv, dv))
        o, lse = k7._launch(q, k, v, True, 0, 0, s, with_lse=True)
        names = [n for n in built if built[n][1] == "cuda_cores"
                 or takes(built[n][2], d, dv)]
        grads = {n: [torch.empty_like(x) for x in (q, k, v)] for n in names}
        delta = torch.empty((bh, s), dtype=torch.float32, device="cuda")

        def call(n):
            fn, kind, _, _ = built[n]
            ptrs = [x.data_ptr() for x in (q, k, v, o, lse, do, *grads[n],
                                          delta)]
            flag = [1] if kind == "cuda_cores" else []
            rc = fn(*ptrs, bh, s, s, d, dv, 1, 0, 0, s, 1.0 / d ** 0.5,
                    *flag, stream)
            if rc:
                raise RuntimeError(f"{n} at {shape}: error {rc}")

        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                call(n)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(n)
                end.record()
                torch.cuda.synchronize()
                times[n].append(start.elapsed_time(end) / 10)
        want = k7.flash_attention_masked_bwd_plain(q, k, v, o, lse, do)
        top = max(float(w.double().abs().max()) for w in want)
        errs = {}
        for n in names:
            worst = 0.0
            for got, w in zip(grads[n], want):
                diff = (got.double() - w.double()).abs()
                gate = chip.FLASH_BWD_F32 * top \
                    + chip.FLASH_BWD_BF16_STEP * w.double().abs()
                if not bool((diff <= gate).all()):
                    raise AssertionError(f"{n} at {shape}: max |error| "
                                         f"{float(diff.max())} beyond the "
                                         f"gate")
                worst = max(worst, float(diff.max()))
            errs[n] = worst
        result["ms"][shape] = times
        result["max_abs_err"][shape] = errs
        print(json.dumps({"shape": shape, "ms": times}), flush=True)
        del q, k, v, do, o, lse, grads, want
        torch.cuda.empty_cache()
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps(result["ms"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
