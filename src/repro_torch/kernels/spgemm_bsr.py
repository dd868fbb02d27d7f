"""Block-row Gustavson SpGEMM with a dense right-hand side (BSR x dense).

``C[i*bs:(i+1)*bs] = sum_j A_blocks[rowptr[i] + j] @ B[colidx[.]*bs : +bs]``
over ``j < min(max_blocks_per_row, row length)``, in float32 from float32
or bfloat16 operands.  As in the reference's grid of ``(n_brows,
max_blocks_per_row)`` steps, the blocks of a row past
``max_blocks_per_row`` are dropped, a slot past the last stored block reads
the last block, and an empty row gives zeros; block-column ids are clipped
to B's block rows.  The plain version takes the same steps in the same
order, one batched product per ``j``, so it and the kernels differ only in
the order of each block product's sums.

On CUDA the dtype chooses the kernel (``route``): bfloat16 blocks and ``b``
go to ``csrc/bsr_spmm_wgmma.cu``, the products on the tensor cores
(``wgmma`` on ``cp.async``-staged block tiles, float32 accumulators: bf16
products are exact in float32); float32 ones to ``csrc/bsr_spmm.cu``,
float32 on the CUDA cores (a TF32 ``wgmma`` would keep 10 mantissa bits).
Either is one launch per call.

Replaces ``repro.kernels.spgemm_bsr.bsr_spmm`` (the Pallas
``_accum_kernel``).  ``bsr_spmm_xla`` is the counterpart of the reference
wrapper's ``backend="xla"`` path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library

# the kernel each dtype goes to on CUDA: (C entry point, route)
KERNELS = {torch.bfloat16: ("repro_bsr_spmm_wgmma", "wgmma"),
           torch.float32: ("repro_bsr_spmm", "cuda_cores")}


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call with ``dtype`` blocks and ``b`` launches:
    ``"wgmma"`` (bfloat16, tensor cores) or ``"cuda_cores"`` (float32)."""
    return KERNELS[dtype][1]


def _check_shapes(rowptr, colidx, a_blocks, b):
    if a_blocks.dim() != 3 or a_blocks.shape[1] != a_blocks.shape[2] \
            or colidx.shape != a_blocks.shape[:1] or b.dim() != 2 \
            or rowptr.dim() != 1 or rowptr.shape[0] < 1:
        raise ValueError(
            f"expected rowptr (n_brows+1,), colidx (bcap,), a_blocks "
            f"(bcap, bs, bs) and b (n_bcols*bs, d); got {tuple(rowptr.shape)}, "
            f"{tuple(colidx.shape)}, {tuple(a_blocks.shape)}, "
            f"{tuple(b.shape)}")
    bs = a_blocks.shape[1]
    if bs == 0 or b.shape[0] % bs:
        raise ValueError(f"b has {b.shape[0]} rows, not a whole number of "
                         f"{bs}-row blocks")


def bsr_spmm_plain(rowptr, colidx, a_blocks, b, max_blocks_per_row: int):
    """The plain PyTorch version: for each ``j``, every block-row's
    ``j``-th block product (float32) added where the row has one."""
    _check_shapes(rowptr, colidx, a_blocks, b)
    n_brows = rowptr.shape[0] - 1
    bcap, bs, _ = a_blocks.shape
    d = b.shape[1]
    n_bcols = b.shape[0] // bs
    out = torch.zeros((n_brows, bs, d), dtype=torch.float32, device=b.device)
    if bcap == 0 or n_bcols == 0:
        return out.reshape(n_brows * bs, d)
    bb = b.reshape(n_bcols, bs, d)
    start, end = rowptr[:-1].long(), rowptr[1:].long()
    longest = int((end - start).max()) if n_brows else 0
    for j in range(min(max_blocks_per_row, longest)):
        p = start + j
        valid = p < end
        p = p.clamp(0, bcap - 1)
        c = colidx[p].clamp(0, n_bcols - 1).long()
        prod = torch.bmm(a_blocks[p].float(), bb[c].float())
        out += torch.where(valid[:, None, None], prod, 0.0)
    return out.reshape(n_brows * bs, d)


def bsr_spmm_xla(rowptr, colidx, a_blocks, b, max_blocks_per_row: int):
    """The reference wrapper's ``backend="xla"`` path: ``b`` times the BSR
    through ``core.spgemm_bsr`` (every block kept, the blocks' dtype out;
    ``max_blocks_per_row`` is not read, as in the reference)."""
    from repro_torch.core.spgemm_bsr import bsr_spgemm_dense_rhs
    from repro_torch.sparse.formats import BSR

    _check_shapes(rowptr, colidx, a_blocks, b)
    bs = a_blocks.shape[1]
    a = BSR(rowptr, colidx, a_blocks, ((rowptr.shape[0] - 1) * bs, b.shape[0]))
    return bsr_spgemm_dense_rhs(a, b)


def _bsr_spmm_cuda(rowptr, colidx, a_blocks, b, max_blocks_per_row: int):
    _check_shapes(rowptr, colidx, a_blocks, b)
    ops.expect(rowptr, torch.int32, 1, "rowptr")
    ops.expect(colidx, torch.int32, 1, "colidx")
    ops.expect_float(a_blocks, 3, "a_blocks")
    ops.expect(b, a_blocks.dtype, 2, "b")
    ops.same_device(("rowptr", rowptr), ("colidx", colidx),
                    ("a_blocks", a_blocks), ("b", b))
    n_brows = rowptr.shape[0] - 1
    bcap, bs, _ = a_blocks.shape
    d = b.shape[1]
    n_bcols = b.shape[0] // bs
    if bcap == 0 or n_bcols == 0 or max_blocks_per_row <= 0:
        return torch.zeros((n_brows * bs, d), dtype=torch.float32,
                           device=b.device)
    out = torch.empty((n_brows * bs, d), dtype=torch.float32, device=b.device)
    if out.numel() == 0:
        return out
    entry, path = KERNELS[b.dtype]
    with torch.cuda.device(b.device):
        rc = getattr(library(), entry)(
            rowptr.data_ptr(), colidx.data_ptr(), a_blocks.data_ptr(),
            b.data_ptr(), out.data_ptr(), n_brows, n_bcols, bs, d,
            max_blocks_per_row, bcap, torch.cuda.current_stream().cuda_stream)
    ops.check_launch("bsr_spmm", rc, path)
    return out


def bsr_spmm(rowptr, colidx, a_blocks, b, max_blocks_per_row: int):
    """BSR @ dense in float32: the plain version on the CPU, the dtype's
    kernel on CUDA (float32 or bfloat16 blocks and ``b`` of one dtype)."""
    return ops.dispatch(bsr_spmm_plain, _bsr_spmm_cuda, rowptr, colidx,
                        a_blocks, b, max_blocks_per_row)
