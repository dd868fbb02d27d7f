"""What the ``p_dtype`` gate of ``chip_smoke.py`` can tell apart, on the CPU.

K7 under ``p_dtype=bfloat16`` rounds P to bf16 after each key tile's
running max.  ``chip_smoke.py`` holds the kernel against its plain version
run on the kernel's own tile (64 keys) and refuses a share of error
(sum |error| over sum |value|) past ``P_DTYPE_MEAN``.  This script prints
that share, against the plain version on 64-key tiles, for:

* ``flipped``: the same plain version on scores one float32 ulp apart (q
  scaled by 1 + 2**-22), which rounds a few probabilities the other way,
  as the kernel's exp2 and its order of sums do;
* ``three_terms``: no rounding of P (the tensor-core kernel's three-term
  build, or the backward without its flag);
* ``tile_128``: the plain version on 128-key tiles (rounding after other
  running maxima);
* ``dropped_tile``: one 64-key tile of every row left out.

Run: ``PYTHONPATH=src python tools/p_dtype_share.py [--bh 4 --s 1024 --d 64]``.
"""
import argparse
import json

import torch

from repro_torch.kernels import flash_attention as k7


def share(got, want) -> float:
    diff = (got.double() - want.double()).abs().sum()
    return float(diff / want.double().abs().sum())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bh", type=int, default=4)
    ap.add_argument("--s", type=int, default=1024)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.manual_seed(args.seed)
    q, k, v = (torch.randn(args.bh, args.s, args.d).bfloat16()
               for _ in range(3))
    bf16 = torch.bfloat16

    def plain(q, k, v, p_dtype=bf16, k_blk=64, **kw):
        return k7.flash_attention_masked_plain(q, k, v, True, p_dtype=p_dtype,
                                               k_blk=k_blk, **kw)

    want = plain(q, k, v)
    flipped = plain(q.float() * (1 + 2 ** -22), k.float(), v.float())
    # keys 64..127 left out of every row (a kernel that skips a tile), in a
    # dense causal softmax with P rounded to bf16
    sc = q.float() @ k.float().transpose(1, 2) / args.d ** 0.5
    pos = torch.arange(args.s)
    ok = (pos[None, :] <= pos[:, None]) & ((pos[None, :] < 64)
                                           | (pos[None, :] >= 128))
    p = torch.exp(torch.where(ok, sc, -1e30)
                  - torch.where(ok, sc, -1e30).amax(-1, keepdim=True))
    dropped = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    dropped = torch.where(pos[None, :, None] >= 64, dropped.bfloat16(), want)
    print(json.dumps({
        "shape": [args.bh, args.s, args.d],
        "flipped": share(flipped.bfloat16(), want),
        "three_terms": share(plain(q, k, v, p_dtype=None), want),
        "tile_128": share(plain(q, k, v, k_blk=128), want),
        "dropped_tile": share(dropped, want)}))


if __name__ == "__main__":
    main()
