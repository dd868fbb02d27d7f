"""FFNs: dense SwiGLU and the paper's TopK-SpGEMM FFN (Eq. 1–3).

Counterpart of ``repro.models.ffn`` (MoE is not ported yet: ROADMAP Queue A
item 12).  ``ffn_mode``:

* "dense"      — published architecture;
* "topk"       — Eq. (1): h is TopK-masked (``sparse.topk.topk_rows_st``,
                 with the Eq. (3) backward), then multiplied by W2 densely;
* "block_topk" — per tile of tokens, keep the ``k/block`` blocks of
                 ``block`` d_ff lanes with the most energy
                 (``tile_block_select``), gather only the selected W2
                 row-blocks and contract.

All three are plain PyTorch, as the reference writes them in jnp; the
sparse products have their own kernels behind ``kernels.ops``
(``topk_spmm``, ``block_topk_spmm``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.sparse.topk import topk_rows, topk_rows_st


class FFNParams(NamedTuple):
    w1: torch.Tensor  # gate (D, F)
    w3: torch.Tensor  # up   (D, F)
    w2: torch.Tensor  # down (F, D)


def ffn_init(generator, d_model, d_ff, dtype,
             layers: Optional[int] = None) -> FFNParams:
    """Weights for one layer, or stacked for ``layers`` layers."""
    return FFNParams(
        w1=dense_init(generator, d_model, d_ff, dtype, layers=layers),
        w3=dense_init(generator, d_model, d_ff, dtype, layers=layers),
        w2=dense_init(generator, d_ff, d_model, dtype, layers=layers),
    )


def _hidden(p: FFNParams, x):
    return F.silu(x @ p.w1) * (x @ p.w3)


def swiglu(p: FFNParams, x):
    return _hidden(p, x) @ p.w2


def topk_ffn(p: FFNParams, x, k: int):
    """Eq. (1): y = TopK(act(xW1)⊙(xW3)) @ W2 with Eq. (3) backward."""
    h = _hidden(p, x)
    b, s, f = h.shape
    hs = topk_rows_st(h.reshape(b * s, f), k).reshape(b, s, f)
    return hs @ p.w2


def tile_block_select(h: torch.Tensor, kb: int, block: int, tile: int):
    """``block_topk_ffn``'s selection on ``h`` (n, f): per tile of ``tile``
    tokens, the ``kb`` blocks of ``block`` lanes with the most float32
    energy (lower block first among equals, as ``lax.top_k``).  Returns
    h_kept (n_tiles, kb, tile, block) and bidx (n_tiles, kb) int32."""
    n, f = h.shape
    nb, nt = f // block, n // tile
    hb = h.reshape(nt, tile, nb, block)
    bidx = topk_rows(hb.float().square().sum((1, 3)), kb).indices
    tiles = torch.arange(nt, device=h.device)[:, None]
    h_kept = hb.permute(0, 2, 1, 3)[tiles, bidx.long()].contiguous()
    return h_kept, bidx.contiguous()


def block_topk_ffn(p: FFNParams, x, k: int, block: int = 128,
                   tile: int = 8):
    """Tile-shared block TopK + W2 block gather: the second product's
    operations drop from S·F·D to S·k·D."""
    h = _hidden(p, x)
    b, s, f = h.shape
    assert s % tile == 0, (s, tile)
    h_kept, bidx = tile_block_select(h.reshape(b * s, f), max(k // block, 1),
                                     block, tile)
    w2b = p.w2.reshape(f // block, block, p.w2.shape[1])
    w2_sel = w2b[bidx.long()]  # (nt, kb, block, D): the AIA ranged gather
    y = torch.einsum("nktb,nkbd->ntd", h_kept, w2_sel)
    return y.reshape(b, s, p.w2.shape[1])
