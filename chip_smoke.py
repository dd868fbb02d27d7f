#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with one CUDA card.  Float32
products run in full float32 (TF32 off).  It

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``,
   ``sm_90a``) and prints the build time and ``ptxas``'s report;
3. drives the sparse-activation path of ``kernels.ops`` at the FFN width
   of Phi-3-mini (``phi3_mini_3_8b``: d_model 3072, d_ff 8192, bf16; 2,048
   tokens, TopK k = d_ff/8 = 1,024, blocks of 128 lanes, tiles of 8 tokens;
   random weights from seed 0), with the launch counts set to 0 before and
   read after: ``topk_rows -> ops.topk_spmm`` (K5, on its ``"smem"``
   route: W2 column slices in shared memory), the per-tile block
   selection of ``block_topk_ffn`` -> ``ops.block_topk_spmm`` (K6) and
   ``ops.aia_ranged_gather`` of the selected W2 blocks (K3, 1.61 GB), and a
   3-of-24 block-pruned W1^T as a BSR (``bsr_from_dense``) times x^T through
   ``ops.bsr_spmm`` (K4); checks the results (finite, shaped, K5 against
   ``topk_rows_st(h, k) @ W2``, K6 against K3's blocks times h, K4 against
   the dense product, each within 1e-5 of the largest |value|), with K3 on
   its 16-byte route and K4 and K6 on their bf16 ``wgmma`` kernels
   (``FFN_ROUTES``); holds each kernel against its plain version (K3 and
   K5 bit-exact, K4 and K6 within 1e-5 of the largest |value|) on a sweep
   of the CPU tests' shapes in float32 and bf16, on both of K3's routes
   (``RANGED_ROUTES``), on K4's tile edges (``BSR_EDGES``), on K5's edges
   on both of its routes (``k5_edges``: d_ff at and past the shared-memory
   limit, ragged slices and chunks, few tokens, repeated and clipped ids)
   and on K6's edges (``K6_EDGES``: repeated, clipped and unpicked ids,
   tile 1, a block every tile picks, odd widths, blocks past one depth
   panel; in every dtype, each call the same bits on a repeat), then on
   the path's own inputs, where each call must add exactly one launch (K6
   the same bits on a repeat, and timed beside its CUDA-core kernel); and
   times kernel
   (CUDA events; device time of its own launches from ``torch.profiler``),
   plain version and one library call that computes the same function
   (``index_select``, ``torch.sparse_bsr_tensor @ b``,
   ``F.embedding_bag``, ``torch.bmm`` on pre-gathered blocks), with the
   dense bf16 ``torch.matmul`` of the whole down-projection beside them,
   and K3's to K6's routes and ``ptxas`` registers, spills and shared
   memory;
4. holds K7 (``ops.flash_attention_fused``) against its plain version on
   the 12 cases of ``tests/test_flash_kernel.py`` (float32 and bf16, causal
   and not), on the edges of the bf16 kernel's tiles (D 7, 36, 40, 96 and
   128 at S 64 and 192, causal and not, blocks of 64), the float32 kernel
   at the decode check's shape (32 heads, S 512, D 96), MLA's widths (qk
   192, v 128) at the CPU tests' shapes and at S 64 and 192 in both dtypes
   (``FLASH_MLA_CASES``) and the other (qk, v) kernels of the two-width
   sources (``FLASH_WIDTH_EDGES``), then at Phi-3-mini's prefill shape (BH
   64 = batch 2 x 32 heads, S 4,096, D 96, bf16, causal), one launch per
   call; float32 within 1e-5 + 1e-5 relative, bf16 within one bf16 step
   (2**-7 relative); and times it there (CUDA events; device time from
   ``torch.profiler``) beside its bound (operations), its plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   with its route (bf16: ``wgmma``), its rate, and ``ptxas``'s registers
   and spills and its shared memory; then holds and times the float32 route
   (the tensor cores: Q, K, V and P in three bf16 terms) at the same shape
   in float32, the same bits on a repeat, beside the CUDA-core kernel and
   SDPA on the same inputs; then holds and times the bf16
   route at DeepSeek-V2-Lite's prefill (BH 32 = 2 x 16 heads, S 4,096, qk
   192, v 128, causal) the same way; holds K7's masked entry
   (``ops.flash_attention_masked``: windows, a query offset, a key limit,
   Sq != Sk, ragged S) on ``FLASH_MASK_CASES`` in both dtypes, one launch
   a call, and times it at the new families' shapes (``FLASH_TIMED``:
   Whisper's encoder and cross-attention, Zamba2's windowed shared block)
   beside its bound over the pairs the mask lets through, its plain
   version and ``F.scaled_dot_product_attention`` with the same mask;
5. drives the LM path of Phi-3-mini (``phi3_mini_3_8b``) at full width and
   depth (32 layers, bf16, random weights from seed 0), each part with the
   launch counts from 0: ``models.transformer.train_loss`` forward-only on
   2 x 4,096 tokens (the loss within [-1, +2] of ln(vocab), 32 K7 launches);
   a ``serve.ServeEngine`` answering 4 requests of 4-6 prompt tokens x 8
   new tokens; then, in float32 at 4 layers, ``decode_step`` fed a 512-token
   prompt token by token against the prefill forward's last-position
   logits (within 1e-4 of the largest |logit|);
5b. drives DeepSeek-V2-Lite (``deepseek_v2_lite_16b``: 27 layers, MLA,
   64 routed experts top-6 + 2 shared, a dense first layer; bf16, random
   weights from seed 0, drawn a MoE layer at a time) the same way
   (``DS``): the prefill (27 K7 launches on the ``wgmma`` route at qk 192
   / v 128; the top kernels show the MoE dispatch and expert products),
   the server on MLA's absorbed decode (one step profiled), and the
   float32 decode check at the prefix layer + 3 MoE layers with
   ``capacity_factor`` = n_experts / top_k, so that the prefill drops no
   token; a token that a router near-tie (within ``NEAR_TIE``) sends to
   other experts in decode than in the prefill is named, and decode is
   then held against the prefill routed to decode's experts;
5c. drives the remaining serving families the same way
   (``families_phase``), each at full width and depth in bf16 from seed 0:
   Zamba2-1.2B (``ZAMBA``: 38 Mamba2 layers with their plain SSD, the
   shared block after every 6 through K7 with its 4,096-token window; the
   prefill on 1 x 8,192 tokens, 6 K7 launches), RWKV6-1.6B (``RWKV``: 24
   layers, the plain chunked WKV; 2 x 4,096 tokens, no K7 launch) and
   Whisper-large-v3 (``WHISPER``: 2 x 448 decoder tokens over 2 x 1,500
   stub frames from the seed, 96 K7 launches: the encoder's unmasked, the
   decoder's causal and cross), each with its server (4 requests x 8 new
   tokens; Whisper's on zero cross caches) and a float32 decode check at
   reduced depth (Zamba2 12 layers with 2 shared applications, RWKV6 4,
   Whisper 4 + 4 with its cross caches filled from the encoder's output;
   512, 512 and 448 prompt tokens); then InternVL2-76B's vision stub
   (``INTERNVL``: full width on 2 of 80 layers, 1 x 4,096 tokens with 256
   patch embeddings, 2 K7 launches), the prefill only;
5d. trains on the card (``train_phase``; sizes in ``TRAIN``): holds K7's
   backward (through the autograd ``Function`` of
   ``ops.flash_attention_masked``: one forward and one
   ``flash_attention_bwd`` count a call, on the route ``bwd_route``
   names: bf16 and float16 with D and Dv <= 256 on
   ``csrc/flash_bwd_wgmma.cuh``, the tensor cores; float32 and wider heads
   on ``csrc/flash_attention_bwd.cu``, the CUDA cores) against its plain
   version on ``FLASH_BWD_CASES`` in both dtypes (dq, dk, dv; float32
   within 1e-5 of the call's largest |gradient|, bf16 one bf16 step more;
   the plain backward takes the plain forward's ``lse``) and the forward's
   output and ``lse`` against the plain forward's (``lse`` within 1e-5 of
   max(1, its largest |value|)), one case on the tensor cores twice bit
   for bit, and float16 / bf16 calls whose dS passes 65,504 or sits below
   2^-14 (``FLASH_BWD_DS_RANGE``), each twice bit for bit; times K7's
   forward with ``lse`` and its backward at
   granite-3-2b's training shape (BH 64, S 2,048, D 64, bf16, causal) and
   at Phi-3's head (BH 64, S 4,096, D 96), the CUDA-core kernel on the
   same bf16 inputs in turns, beside their bounds (10 D FLOP a pair, and
   the tensor-core kernel's own 26 D), the plain backward and
   ``F.scaled_dot_product_attention``'s forward + backward; holds the
   loss and every gradient of granite at full width on 2 layers in
   float32 (1 x 1,024 tokens) on the card against the CPU's plain path
   (within 1e-4 of each leaf's largest |gradient|); runs granite at full
   width and depth (40 layers, bf16, float32 AdamW moments) through
   ``train.make_train_step`` on ``data.TokenPipeline`` batches of 2 x
   2,048 tokens: a warm-up step, 5 timed steps with the counts from 0 (40
   K7 forward and 40 backward launches a step, every backward on the
   tensor cores), one profiled step, every
   loss and grad norm finite, the peak memory; runs ``train.Trainer`` at
   full width on 2 layers for 6 steps with a checkpoint every 3 into a
   temporary directory and a RuntimeError injected at step 4: it restores
   step_3 and replays step 3 bit for bit, ends bit for bit a clean run,
   and its final checkpoint restores bit for bit (each write timed); and
   runs ``python -m repro_torch.launch.train --arch granite-3-2b --smoke
   --steps 3`` on the card;
5e. runs the distributed LM substrate on the card (``dist_phase``; sizes
   in ``DIST``): an NCCL process group of world size 1 (NCCL refuses two
   ranks on one card) and a (1, 1) ``("data", "model")`` DeviceMesh; one
   granite-3-2b AdamW step at full width and depth (40 layers, 2 x 2,048
   tokens) with the parameters placed by ``param_specs`` (the production
   layout, model 16: every split dim of the mesh has size 1, so each
   DTensor shares the plain state's memory), the moments by
   ``zero1_state_specs`` and the batch on ``data``, from the state the
   plain step starts from, held to the plain step on the loss, the grad
   norm and every new leaf's float64 sum (``DIST["rel"]``), with 40 K7
   forward and 40 backward launches on ``wgmma`` through ``local_map``,
   timed (first and profiled second call) with the peak memory;
   DeepSeek-V2-Lite at full width (the dense prefix layer and 3 MoE
   layers, capacity n_experts / top_k, so no token drops) with
   ``moe.impl="shard_map"``: ``forward_hidden`` bit for bit the
   ``moe_ffn`` path; ``optim.compressed_psum`` over NCCL on a tensor of
   granite's largest gradient leaf's shape, bit for bit the plain
   quantise, sum and dequantise, timed; ``launch.pipeline.pipeline_apply``
   on a ``pipe`` dim of 1 with 4 microbatches through one full-width
   granite block, bit for bit the block applied to each; and
   ``python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
   decode_32k`` and ``train_4k`` on both production meshes, in two
   subprocesses started right after the build (a fake process group
   cannot share a process with the NCCL one; at a lower priority, on one
   thread, so they run on the host beside the card's phases), each record
   with ``flops_per_device > 0`` and CUDA never initialised; every
   record's key and time since the start also go to stderr;
6. holds K1 and K2 against their plain PyTorch versions on the card, at
   the shapes the SpGEMM path gives them, for exact equality, and times both
   (CUDA events around the call, and the kernels' own device time from
   ``torch.profiler``): K1 (the AIA row gather) on the first chunk of
   every Table-I group of RoadTX and p2p-Gnutella04, both ELL planes in
   one launch, and timed on the RoadTX group-0 chunk beside
   ``torch.index_select`` and two one-plane calls (with the host's cost a
   call over back-to-back calls), then on every copy unit (``K1_EDGES``);
   K2 (Algorithm 4's hash accumulate) on the same chunks, each on the
   route its table size chooses (groups 0-2: ``"smem"``, group 3:
   ``"global"``) and held bit for bit, a stream wider than 16,384 slots on
   its products packed to the front (the same tables), and timed beside
   one PyTorch call that sums duplicate keys the same way (the chunk's
   products as a COO tensor, ``coalesce()``); each kernel's bound counts
   the bytes this run's data needs (distinct source rows, real products);
6b. holds the sorted segment sum (``kernels.segment_sum``,
   ``csrc/segment_sum.cu``: each output's terms added in the reference's
   order, no atomics) bit for bit against its plain version run on the
   CPU, on calls recorded at their sites: the sort engine on RoadTX's
   group-0 chunk and p2p-Gnutella04's group-2 chunk (976 x 131,793
   slots), ``csr_spmm`` on ogbn-arxiv's Â forward and X's gradient (the
   stable-sort route), the MoE gathers' backward at DeepSeek-V2-Lite's
   training shape (``MOE_GATHER``), ``csr_column_sums`` on Economics with
   its self loops; times each (CUDA events, device time) beside its bound
   (bytes)
   and its plain version on the card (``index_add_``, with atomics), the
   site's call before this kernel, ``scatter_add_``,
   ``torch.segment_reduce`` and ``index_put_(accumulate=True)``, with
   whether each gives the kernel's bits; then on ``SEGSUM_EDGES`` (one
   column, wide rows packed several to a warp and past one warp, runs past
   the kernel's batch of loads and past ``kLongRun`` on the block route,
   bf16, a batch, the permuted route, skipped segments, float64, no
   entry), each twice, bit for bit; and holds the dense conversions that
   add repeated entries (``TopKRows.to_dense``, ``bsr_to_dense``,
   ``csr_to_dense``, ``ell_to_dense``, each through the segment sum) on
   the card against the CPU, short and long runs of repeats, bit for
   bit;
6c. drives the calls the port once refused (``refused_calls_phase``, and
   ``new_routes_phase`` right after K7's phase, while the profiler still
   reads device time): the RoadTX and p2p-Gnutella04 self-products with
   bf16 values on the three lanes (p2p bit for bit the CPU port's bf16
   product, RoadTX with its float32 structure); the segment sum and K2 in
   bf16 and float16 at 6b's shapes, bit for bit their plain versions on
   the CPU, bf16 timed; K7 on the seven calls it once refused
   (``K7_REFUSED``) in three dtypes, forward and backward (the 16-bit
   calls on the tensor cores, their backward twice bit for bit, each
   timed beside the CUDA-core kernel on the same inputs), at D 256 and
   320 and qk 64 / v 128 (``K7_WIDE``), in float16 and with ``p_dtype``
   at Phi-3-mini's prefill shape, its backward at D 256
   (``K7_BWD_SLABS``) and with ``p_dtype``, in float16 and in float32 at
   granite's training shape, and its keyless pass, each beside its bound,
   SDPA and (the tensor-core routes) the CUDA-core kernel, every K7_WIDE
   call the same bits on a repeat; K3-K6 in float16
   at the FFN shape, K3's ``"u16"``, ``"bytes"`` and strided copies and
   K6 at wider blocks (``K6_WIDE``), each K6 call on the tensor cores the
   same bits on a repeat and timed beside the CUDA-core kernel; then
   ``refusals_phase``: every call the port once refused, made once on the
   card, each launching its kernel and matching its plain version, the
   calls that raise printed as ``refused: [...]`` (the phase fails unless
   the list is empty); Phi-3-mini's prefill (5) runs again with
   ``attn_p_dtype="bfloat16"``, 32 K7 launches on ``wgmma_p1``;
7. runs the self-products of RoadTX (1,393,383 rows) and p2p-Gnutella04
   (10,876 rows), seed 0, through ``spgemm(a, a)`` (sort engine, AIA
   gather, measured sizing), ``spgemm(a, a, engine="fused_hash")`` (AIA
   gather, planned sizing: both kernels, no host sync in the pipeline) and
   ``engine="hash", gather="xla"``; checks each product against
   ``scipy.sparse`` (structure exact, values within rtol 1e-4 / atol 1e-6:
   float32 sums in another order than scipy's float64), the hash path
   bit-identical to hash/xla, each call run a second time bit for bit,
   the default lane on p2p-Gnutella04 bit for bit the CPU port's product,
   zero pipeline syncs on the planned call and the kernels' launch counts
   (one K1 launch a chunk, one segment sum a chunk on the default lane);
   profiles one more
   run of each call (device time, busy share, top kernels); and times
   ``torch.sparse.mm`` (cuSPARSE) on the same CSR as a yardstick the port
   never calls;
8. serves SpGEMM requests through ``serve.SpGEMMService`` at paper size
   (``serve_phase``): 48 requests from 4 tenants, A·B with B the pattern's
   matrix (RoadTX, p2p-Gnutella04, Economics, drawn by Zipf 1.2
   popularity) and A its structure with fresh values, tenants 0-1 on the
   default lane and 2-3 on ``fused_hash``, ``max_batch`` 8 (cut where a
   batch's reckoned memory passes 60 GB), one flush at the end; every
   dispatch recorded with its launch and sync counts from 0: one K1 launch
   a chunk, K2 batch x chunks on ``fused_hash`` and none on the default
   lane, one segment sum a chunk on the default lane, no pipeline sync on
   the planned lane, the OperandCache's hits as its lead tenants predict;
   every request against its solo ``spgemm`` with the same knobs
   (structure exact, values bit for bit on both lanes), one
   per (pattern, lane) against scipy's float64 product; requests/s,
   p50/p99 latency, dispatches and coalescing ratio; the first batched
   dispatch of each (pattern, lane) profiled beside the same members as a
   loop of ``spgemm``; ``engine="auto"`` on the RoadTX and p2p
   self-products until the autotune cache converges (against scipy; a
   converged call measures nothing; a forced all-``fused_hash``
   assignment pays no pipeline sync); ``dispatch_fail`` armed once on a
   batched dispatch, every member replayed bit for bit;
8b. runs the sharded executor (``mesh_phase``; sizes in ``MESH``) on
   logical shards of the one card, each call with its launch and sync
   counts from 0: the RoadTX and p2p-Gnutella04 self-products under
   ``make_spgemm_mesh()``, ``[cuda:0] * 2`` and ``[cuda:0] * 4`` on the
   default lane (bit for bit ``mesh=None``, values within rtol 1e-4 /
   atol 1e-6 of scipy, one pipeline sync) and ``fused_hash`` (bit for
   bit ``mesh=None``, no sync), K1 and K2 once a chunk of the mesh's
   partition; on p2p ``operands`` auto, footprint and replicate, bit for
   bit each; wall, device and busy (one profiled call), peak, B rows and
   bytes placed; ``spgemm_batched`` p2p x 4 and ``spgemm_streamed`` p2p in
   6 tiles under 4 shards, bit for bit; ``csr_hadamard_power``'s count of
   entries off the correctly rounded float64 power at r 1.5, 2, 3, 0.5;
   one gcn/topk ``train_gnn`` step on ogbn-arxiv under 4 shards, step 1
   within 1e-4 of float64; MCL on Economics under 4 shards, each expansion
   bit for bit the ``mesh=None`` product of its inputs and each iterate
   bit for bit that iteration finished from it.  The
   copy between cards is the identity on one card and is not measured;
9. runs the paper's three applications at paper size, each lane with the
   launch counts and the pipeline's sync count from 0: graph contraction
   ``S·G·Sᵀ`` (``apps.graph_contraction``, labels n/64 from seed 0) on
   RoadTX, Economics and Protein on the default lane and ``fused_hash``,
   against scipy's float64 product (structure exact, values within rtol
   1e-4 / atol 1e-6, the total weight kept), beside cuSPARSE's two
   products; Markov clustering (``apps.mcl``, bench_mcl's parameters, 2
   iterations) on Economics on both lanes, every expansion and iterate
   recorded inside ``mcl`` and held, iteration by iteration, against a
   float64 step on the card (``torch.sparse.mm``, cuSPARSE) from the
   port's previous iterate (the first from the same input, itself held
   against scipy's): the expansion's structure equal to the pattern
   product with explicit zeros kept, values within rtol 1e-4 / atol 1e-6,
   every prune decision the reference's unless within 1e-4 (relative) of
   theta or of its column's k-th value (those counted), nonzero columns
   summing to 1, the clusters the reference's partition, a second run bit
   for bit the first; beside cuSPARSE's expansions; MCL on Economics cut
   to ``MCL_CPU_ROWS`` rows on the default lane, bit for bit the CPU
   port's run; full-batch GNN training (``apps.train_gnn``) on ogbn-arxiv
   (169,343 nodes, R-MAT, 64 features, 40 classes, TopK 16, 2 layers, 5
   steps) for GCN, GIN and SAGE in both modes: step 1's logits within 1e-4
   of the largest |logit| of a float64 numpy forward (rows fed by a TopK
   near-tie counted and left out), its gradients within 1e-4 of a float64
   CPU autograd run of the port's plain path, every loss finite, one K1
   launch per aggregation, and gcn/topk trained a second time, whether
   its losses and parameters are the first run's bits (a finding, with
   the accumulating kernels of one profiled step); and K1 on
   ``csr_spmm``'s one-plane shape (Â's
   ids, 256-byte rows of X) bit for bit, on a transposed X through
   ``csr_spmm``'s take too, timed beside ``index_select`` and its bound;
   one aggregation beside cuSPARSE SpMM;
10. trains a GNN on bulk-sampled subgraphs of ogbn-arxiv at paper size
    (``minibatch_phase``; sizes in ``MB``): ``apps.sampling.bulk_sample``
    on the first 4 batches of ``train_gnn_minibatch``'s order (1,024
    vertices, fanout 10, 2 layers, the per-batch seed) on the default lane
    and ``fused_hash``, the default lane held layer by layer against a
    numpy/scipy re-run of the reference's sampler from the port's previous
    frontier (frontiers equal, each adjacency ``A[rows][:, cols]`` bit for
    bit) and ``fused_hash`` bit for bit against the default lane; 4
    DropEdge reweightings (keep 0.9, seed 0) through ``spgemm_batched``,
    each member bit for bit against scipy, their mean within 1e-6, one K1
    launch a chunk; ``gnn_forward_minibatch`` for gcn, gin and sage (topk)
    on one sampled chain against a float64 numpy forward and its step-1
    gradients against a float64 CPU autograd run, within 1e-4; then
    ``train_gnn_minibatch`` (sage, ``fused_hash``, fanout 10, 2 epochs, at
    batches of 32,768, a cut the time limit forces) with every loss finite
    and every SpGEMM of epoch 2 a ``PlanCache`` hit, the ms a step split
    into host sampling, the six SpGEMMs and forward + backward + AdamW, the
    launches a step and one step profiled;
11. runs the out-of-core lane and its resilience layer (``stream_phase``;
    sizes in ``STREAM``): ``spgemm_streamed`` of the p2p-Gnutella04
    self-product in 6 tiles at prefetch 1, 2 and 3 on both lanes (bit
    for bit the monolithic product; both against scipy; 6 tiles, the
    reference's overlap count), one profiled call's
    side-stream copies and the ms of them that overlap a kernel; a device
    budget of half the monolithic estimate (``on_budget="error"`` raises
    before any allocation, ``"stream"`` degrades bit for bit with the
    derived ``tile_rows``); each fault point (``capacity_undersize`` on
    the planned and the batched lane, ``gather_fail``, ``stage_tile_fail``)
    armed once, firing once and recovering bit for bit, and a clean
    planned call after them with no pipeline sync; RoadTX in 6 tiles of
    2^18 rows bit for bit the monolithic product; MCL on Economics (2
    iterations, ``fused_hash``) under a 1 GiB budget with
    ``on_budget="stream"``, each expansion held bit for bit against a
    monolithic ``spgemm`` of its iterate, each estimate beside the real
    peak;
12. prints the kernels' JSON line (K1–K7, K7's backward, the segment sum
    and K7's keyless pass as records of their own; each new route of 6c
    under its kernel's ``new_routes``), then ``{"ok": true, "device": ...}``
    last, and the whole script's time on a line before them.

Every check raises on failure, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.  ``--json``
writes every number it printed to PATH as well.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings
from typing import Any, NamedTuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
MATRICES = {"RoadTX": 1_393_383, "p2p-Gnutella04": 10_876}
K2_MAX_STREAM = 16_384  # the lockstep plain version is too slow beyond this
RTOL, ATOL = 1e-4, 1e-6
# Peak dense rates of one H100 SXM by operand type (NVIDIA's data sheet):
# bf16 on the tensor cores, float32 on the CUDA cores.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
              "torch.float32": 67e12}
# Phi-3-mini's FFN (src/repro/configs/phi3_mini_3_8b.py, bf16 per
# configs/base.py): 2,048 tokens = batch 8 x seq 256 (launch/train.py:4),
# k = d_ff // 8 (launch/train.py:44), blocks of 128 lanes
# (configs/base.py:57), tiles of 8 tokens (models/ffn.py:62); the BSR keeps
# 3 of 24 block-columns per block-row, the same eighth.
FFN = {"d_model": 3072, "d_ff": 8192, "tokens": 2048, "k": 1024,
       "block": 128, "tile": 8, "bsr_keep": 3}
FFN_REL = 1e-5  # float32 sums in another order, bf16 products exact


_T0 = time.perf_counter()


def emit(record: dict, log: list) -> None:
    """Print a record on stdout (and keep it); its key and the seconds
    since the script started go to stderr."""
    log.append(record)
    print(json.dumps(record), flush=True)
    print(f"[{time.perf_counter() - _T0:8.1f} s] {', '.join(record)}",
          file=sys.stderr, flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_activities(prof) -> list:
    """(name, device µs) of every kernel, copy and fill in the profiler's
    raw results: the events on the device that are no range of
    ``record_function``.  No event tree is built: for a call of many
    thousand launches, building it takes several times as long as the
    call."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)()]


def profile(fn, top_n: int = 6):
    """(host ms, device ms, the ``top_n`` [(kernel, device ms, calls)] by
    time) of one call of ``fn``, from ``torch.profiler``; device ms is None
    when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for name, us in device_activities(prof):
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += us
        tot[1] += 1
    device_us = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][0],
                 reverse=True)[:top_n]
    return host_ms, (device_us / 1e3 if device_us else None), \
        [(name[:80], t / 1e3, n) for name, (t, n) in top]


def _trace_events(prof) -> list:
    """The events of the profiler's chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text()).get("traceEvents", [])


def device_ms(fn, reps: int = 10):
    """Device time per call of ``fn``'s kernels, from ``torch.profiler``
    (None when the profiler recorded none)."""
    fn()
    _, dev, _ = profile(lambda: [fn() for _ in range(reps)])
    return None if dev is None else dev / reps


def loop_ms(fn, reps: int = 20) -> float:
    """CUDA-event time of ``reps`` back-to-back calls of ``fn``, per call
    (after one warm-up call): the device's time per call where it is busy
    throughout, with no profiler involved."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 6: K1 and K2 against their plain versions, at the SpGEMM path's shapes
# ---------------------------------------------------------------------------

def chunk_operands(a):
    """The plan's first chunk of every Table-I group, with B's ELL."""
    import torch

    from repro_torch.core import executor as ex
    from repro_torch.core.grouping import group_rows
    from repro_torch.sparse.formats import csr_to_ell

    plan = group_rows(a, a)
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    row_nnz = np.diff(indptr)
    kb_cap = int(row_nnz.max())
    ell = csr_to_ell(a, kb_cap)
    items = ex.partition_plan(plan, row_nnz, 4096)
    _, rows = ex._chunk_rows(items, [a.device])
    firsts = {}
    for item, r in zip(items, rows):
        firsts.setdefault(item.group, (item, r))
    torch.cuda.synchronize()
    return ell, firsts


def kernel_phase(mats, log):
    from repro_torch.core import phases
    from repro_torch.kernels import aia_gather, hash_accum

    k1 = k2 = None
    chunks = []
    for name, a in mats.items():
        ell, firsts = chunk_operands(a)
        for g, (item, rows) in sorted(firsts.items()):
            cols_a, vals_a = phases.gather_group_rows(
                a.indptr, a.indices, a.data, rows, item.a_cap)
            flat = cols_a.reshape(-1)
            main = name == "RoadTX" and g == 0
            rec = gather_check(name, g, ell, flat, aia_gather, log,
                               timed=main)
            if main:
                k1 = rec
            keys, vals = phases.enumerate_products(cols_a, vals_a,
                                                   ell.indices, ell.data)
            rec = hash_check(name, g, keys, vals, item.table_cap, hash_accum,
                             log)
            chunks.append({k: rec[k] for k in (
                "matrix", "group", "rows", "ip_cap", "table_cap", "route",
                "compared", "device_ms", "bound_ms", "library_ms",
                "library_device_ms")})
            if main:
                k2 = rec
    check(k1 is not None and k2 is not None, "RoadTX group 0 chunk missing")
    k2["chunks"] = chunks
    k1_edges(log)
    return k1, k2


def routed_call(name, fn, expect=None):
    """``fn()``, which must launch kernel ``name`` once (on route ``expect``
    where given); returns its result and the route the launch was counted
    under."""
    from repro_torch.kernels import ops

    before, routes = ops.launch_counts()[name], ops.route_counts()
    got = fn()
    taken = [k.split("/", 1)[1] for k, c in ops.route_counts().items()
             if k.startswith(f"{name}/") and c != routes.get(k, 0)]
    check(ops.launch_counts()[name] == before + 1 and len(taken) == 1,
          f"{name}: one call launched {ops.launch_counts()[name] - before} "
          f"times on routes {taken}")
    check(expect is None or taken[0] == expect,
          f"{name}: took its {taken[0]} route, not {expect}")
    return got, taken[0]


def gather_check(name, g, ell, flat, aia_gather, log, timed=False):
    """Hold K1 against its plain version on one chunk's id stream, both
    ELL planes in one launch (the executor's call); with ``timed``, also
    time it beside the plain version, ``index_select`` and two one-plane
    calls."""
    import torch

    planes = (ell.indices, ell.data)
    got, route = routed_call("gather_rows",
                             lambda: aia_gather.gather_planes(planes, flat))
    want = aia_gather.gather_planes_plain(planes, flat)
    torch.cuda.synchronize()
    for gp, wp in zip(got, want):
        check(torch.equal(gp, wp), f"K1 differs from its plain version "
                                   f"({name} group {g})")
    n_x, kb = ell.indices.shape
    safe = flat.clamp(0, n_x - 1).long()
    n = flat.shape[0]
    rec = {"matrix": name, "group": g, "n_idx": n, "row_words": kb,
           "route": route,
           "max_abs_err": max(float((gp.double() - wp.double()).abs().max())
                              for gp, wp in zip(got, want))}
    if not timed:
        emit({"k1_check": rec}, log)
        return rec
    # Per plane, each distinct (clipped) source row read once and every
    # output row written once; the ids read once.
    distinct = int(torch.unique(safe).numel())
    rec["distinct_rows"] = distinct

    def kernel():
        return aia_gather.gather_planes(planes, flat)

    def one_plane_pair():
        return [aia_gather.gather_rows(x, flat) for x in planes]

    def plain():
        return aia_gather.gather_planes_plain(planes, flat)

    def library():
        return [torch.index_select(x, 0, safe) for x in planes]

    def host_ms(fn, calls=200):
        """Wall time a call over back-to-back calls: the host's cost where
        the device keeps up."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / calls

    rec.update({
        "ms": time_ms(kernel, reps=20),
        "host_ms": host_ms(kernel),
        "device_ms": device_ms(kernel),
        "one_plane_pair_ms": time_ms(one_plane_pair, reps=20),
        "one_plane_pair_host_ms": host_ms(one_plane_pair),
        "one_plane_pair_device_ms": device_ms(one_plane_pair),
        "plain_ms": time_ms(plain, reps=20),
        "plain_device_ms": device_ms(plain),
        "library_ms": time_ms(library, reps=20),
        "library_host_ms": host_ms(library),
        "library_device_ms": device_ms(library),
        "bound_ms": bound_ms(2 * (distinct + n) * kb * 4 + n * 4),
    })
    emit({"k1_chunk": rec}, log)
    return rec


# K1's copy units (aia_gather.gather_unit): (planes as (dtype, width), rows
# of x, ids, the planes' element offset into their allocations, the unit).
# 16-byte rows; RoadTX's and p2p-Gnutella04's ELL rows (56 and 2,364
# bytes; the latter one row a tile, 5,000 ids past the grid's cap); 16-byte
# rows in 4-byte aligned views; an odd-width bf16 plane beside an int32
# one, and alone; int8 rows of 3 bytes; int8 planes 1 byte off alignment;
# a bf16 plane of 16 bytes; int8 rows of 3,001 bytes (past a tile's units).
K1_EDGES = (
    ((("int32", 4), ("float32", 4)), 40, 300, 0, "v16"),
    ((("int32", 14), ("float32", 14)), 40, 300, 0, "v8"),
    ((("int32", 591), ("float32", 591)), 40, 5000, 0, "words"),
    ((("int32", 4), ("float32", 4)), 40, 300, 1, "words"),
    ((("int32", 3), ("bfloat16", 7)), 40, 300, 0, "u16"),
    ((("bfloat16", 7),), 40, 300, 0, "u16"),
    ((("int8", 3),), 40, 300, 0, "bytes"),
    ((("int8", 16), ("int8", 16)), 40, 300, 1, "bytes"),
    ((("bfloat16", 8),), 40, 300, 0, "v16"),
    ((("int8", 3001),), 40, 30, 0, "bytes"),
)


def k1_edges(log):
    """K1 on every copy unit (``K1_EDGES``), ids clipped at both ends, each
    call one launch on its unit and equal to the plain version; an empty
    stream launches nothing."""
    import torch

    from repro_torch.kernels import aia_gather, ops

    g = torch.Generator(device="cuda").manual_seed(2)
    for planes_spec, n_x, n_idx, off, unit in K1_EDGES:
        planes = []
        for dt, width in planes_spec:
            flat = torch.randint(-100, 100, (n_x * width + off,), generator=g,
                                 device="cuda").to(getattr(torch, dt))
            planes.append(flat[off:].view(n_x, width))
        idx = torch.randint(-3, n_x + 3, (n_idx,), generator=g, device="cuda",
                            dtype=torch.int32)
        case = f"K1 edge {planes_spec} off {off}"
        got, _ = routed_call(
            "gather_rows", lambda: aia_gather.gather_planes(planes, idx), unit)
        want = aia_gather.gather_planes_plain(planes, idx)
        check(all(torch.equal(a, b) for a, b in zip(got, want)), case)
    before = ops.launch_counts()["gather_rows"]
    empty = aia_gather.gather_planes(planes, idx[:0])
    check(ops.launch_counts()["gather_rows"] == before
          and all(e.shape == (0, p.shape[1]) for e, p in zip(empty, planes)),
          "K1: an empty stream")
    emit({"k1_edges": {"cases": len(K1_EDGES) + 1, "ok": True}}, log)


def packed_stream(keys, vals):
    """Each row's products moved to the front of its stream in stream order
    (a stable pack), cut to the longest row's count.  Algorithm 4 skips
    padding, so the packed stream gives the same tables."""
    import torch

    valid = keys >= 0
    width = int(valid.sum(1).max()) if keys.numel() else 0
    order = torch.argsort((~valid).to(torch.int8), dim=1,
                          stable=True)[:, :width]
    return keys.gather(1, order), vals.gather(1, order)


def hash_check(name, g, keys, vals, table_cap, hash_accum, log):
    """Hold K2 bit for bit against the plain version on one chunk, then
    time it.  A chunk whose stream is wider than ``K2_MAX_STREAM`` slots
    (the plain version's reach) is held on its packed stream
    (``"packed"``); a packed stream still too wide, on its rows of at most
    ``K2_MAX_STREAM`` products (``"rows"``).  The chunk must take the route
    its table size chooses: shared memory for Table-I groups 0-2, global
    memory for group 3."""
    import torch

    from repro_torch.kernels import ops

    r, ip_cap = keys.shape
    route = hash_accum.route(table_cap)
    check(route == ("global" if g == 3 else "smem"),
          f"K2 {name} group {g}: {table_cap}-slot tables take {route}")
    rec = {"matrix": name, "group": g, "rows": r, "ip_cap": ip_cap,
           "table_cap": table_cap, "route": route}
    before = ops.route_counts().get(f"hash_accumulate/{route}", 0)
    got = hash_accum.hash_accumulate(keys, vals, table_cap)
    check(ops.route_counts().get(f"hash_accumulate/{route}", 0) == before + 1,
          f"K2 {name} group {g}: the call did not take the {route} route")
    held_k, held_v, rows = keys, vals, slice(None)
    rec["compared"] = "full"
    if ip_cap > K2_MAX_STREAM:
        held_k, held_v = packed_stream(keys, vals)
        rec["compared"], rec["packed_width"] = "packed", held_k.shape[1]
        if held_k.shape[1] > K2_MAX_STREAM:
            rows = ((held_k >= 0).sum(1) <= K2_MAX_STREAM).nonzero()[:, 0]
            held_k = held_k[rows, :K2_MAX_STREAM].contiguous()
            held_v = held_v[rows, :K2_MAX_STREAM].contiguous()
            rec["compared"], rec["rows_held"] = "rows", int(rows.numel())
    t0 = time.perf_counter()
    want = hash_accum.hash_accumulate_plain(held_k, held_v, table_cap)
    torch.cuda.synchronize()
    rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
    for part, gp, wp in zip(("cols", "vals", "cnt"), got, want):
        check(torch.equal(gp[rows], wp), f"K2 {part} differ from the plain "
                                         f"version ({name} group {g})")
    rec["max_abs_err"] = float((got[1][rows] - want[1]).abs().max())

    def kernel():
        return hash_accum.hash_accumulate(keys, vals, table_cap)

    rec["ms"] = time_ms(kernel, reps=10)
    # device time per call (the window-mask and insert kernels), and each
    # kernel's own share
    kernel()
    _, dev, top = profile(lambda: [kernel() for _ in range(10)])
    rec["device_ms"] = None if dev is None else dev / 10
    rec["device_kernels"] = [(k, ms / 10) for k, ms, _ in top]
    # One PyTorch call that sums duplicate (row, column) keys as K2 does:
    # the chunk's products as a COO tensor, coalesced (its indices and
    # values gathered outside the clock).
    prow, pslot = (keys >= 0).nonzero(as_tuple=True)
    coo_idx = torch.stack([prow, keys[prow, pslot].long()])
    coo_val = vals[prow, pslot]
    coo_size = (r, int(keys.max()) + 1)

    def library():
        return torch.sparse_coo_tensor(coo_idx, coo_val, coo_size).coalesce()

    check(library()._nnz() == int(got[2].long().sum()),
          f"K2 {name} group {g}: coalesce found another number of keys")
    rec["library_call"] = "torch.sparse_coo_tensor(keys, vals).coalesce()"
    rec["library_ms"] = time_ms(library, reps=10)
    rec["library_device_ms"] = device_ms(library, reps=5)
    del coo_idx, coo_val
    # Every key read once, a value only where its key is a product (the
    # kernel skips the value of a padding key), the tables and the counts
    # written once.
    products = int((keys >= 0).sum())
    rec["products"] = products
    rec["bound_ms"] = bound_ms(r * ip_cap * 4 + products * 4
                               + r * table_cap * 8 + r * 4)
    emit({"k2_chunk": rec}, log)
    return rec


# ---------------------------------------------------------------------------
# Phase 6b: the sorted segment sum at the main paths' shapes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_sums(*modules):
    """Inside the block, each call of ``segment_sum`` through the global of
    one of ``modules`` is recorded as (ids, values, n_out, order, skip) and
    passed on."""
    from repro_torch.kernels import segment_sum as ss

    calls, real = [], ss.segment_sum

    def rec(ids, values, n_out, order=None, skip=0):
        calls.append((ids, values.detach(), n_out, order, skip))
        return real(ids, values, n_out, order, skip)

    saved = [(m, m.segment_sum) for m in modules]
    for m, _ in saved:
        m.segment_sum = rec
    try:
        yield calls
    finally:
        for m, fn in saved:
            m.segment_sum = fn


def segment_sum_check(what, call, log) -> dict:
    """Hold the kernel bit for bit against its plain version run on the CPU
    on one recorded call's inputs (one launch), then time it beside its
    plain version on the card (``index_add_``, with atomics), the call the
    site made before (``index_add_`` in stream order for a permuted
    route), ``scatter_add_`` (one column), ``torch.segment_reduce`` and
    ``index_put_(accumulate=True)`` on the values in run order, each with
    whether its bits are the kernel's."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss

    ids, values, n_out, order, skip = call
    values = values.contiguous()

    def kernel():
        return ss.segment_sum(ids, values, n_out, order, skip)

    before = ops.launch_counts()["segment_sum"]
    got = kernel()
    torch.cuda.synchronize()
    check(ops.launch_counts()["segment_sum"] == before + 1,
          f"segment_sum {what}: one call launched "
          f"{ops.launch_counts()['segment_sum'] - before} times")
    t0 = time.perf_counter()
    want = ss.segment_sum_plain(ids.cpu(), values.cpu(), n_out,
                                None if order is None else order.cpu(), skip)
    plain_cpu_s = time.perf_counter() - t0
    got_h = got.cpu()
    check(torch.equal(got_h, want), f"segment_sum {what}: differs from its "
          f"plain version on the CPU ({int((got_h != want).sum())} values)")
    del want
    ordered = values if order is None else values.index_select(-2, order)
    width = values.shape[-1]
    lengths = torch.bincount(ids, minlength=n_out)

    def plain():
        return ss.segment_sum_plain(ids, values, n_out, order, skip)

    def kept(out):  # the library calls sum the skipped segments too
        if skip:
            out[..., skip - 1::skip, :] = 0
        return out

    calls = {"plain": plain,
             "segment_reduce": lambda: kept(torch.segment_reduce(
                 ordered, "sum", lengths=lengths, axis=0)),
             "index_put": lambda: kept(torch.zeros_like(got).index_put_(
                 (ids,), ordered, accumulate=True))}
    if order is not None:  # the site's call before: stream order
        stream_ids = torch.empty_like(ids).index_copy_(0, order, ids)
        calls["before"] = lambda: torch.zeros_like(got).index_add_(
            0, stream_ids, values)
        calls["route"] = lambda: ss.index_sum_sorted(stream_ids, values,
                                                     n_out)
    if width == 1:  # the sort engine's call before this kernel
        calls["scatter_add"] = lambda: kept(torch.zeros_like(got[:, 0])
                                            .scatter_add_(0, ids,
                                                          ordered[:, 0])
                                            [:, None])
    # every id read once; the order entry and the values of an entry only
    # where its segment is summed (the sort engine's overflow segments and
    # the padding past n_out are not read); every output written once
    summed = ids < n_out
    if skip:
        summed &= ids % skip != skip - 1
    n_kept = int(summed.sum())
    nbytes = ids.numel() * 8 + (0 if order is None else n_kept * 8) \
        + (n_kept * values.numel() // max(ids.numel(), 1) + got.numel()) \
        * values.element_size()
    rec = {"shape": what, "n": ids.numel(), "n_out": n_out, "width": width,
           "dtype": str(values.dtype), "order": order is not None,
           "skip": skip, "summed": n_kept,
           "max_abs_err": 0.0, "plain_cpu_s": plain_cpu_s,
           "bytes": nbytes, "bound_ms": bound_ms(nbytes),
           "ms": time_ms(kernel, reps=10), "device_ms": device_ms(kernel, 5),
           "loop_ms": loop_ms(kernel, reps=10)}
    for label, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        rec[f"{label}_equal"] = bool(torch.equal(out, got))
        rec[f"{label}_ms"] = time_ms(fn, reps=10)
        rec[f"{label}_device_ms"] = device_ms(fn, 5)
        del out
    rec["library_call"] = "torch.segment_reduce(values, 'sum', lengths)"
    rec["library_ms"] = rec["segment_reduce_ms"]
    emit({"segment_sum_shape": rec}, log)
    del got, got_h, ordered
    torch.cuda.empty_cache()
    return rec


# (width, value sets, order, dtype, entries, segments, skip): one column,
# wide rows on several segments a warp, a lane a row and past one warp,
# runs shorter and longer than the kernel's batches of loads, a batch, the
# permuted route, skipped segments, float64, one segment, no entry; then
# runs of ~4,000 past kLongRun on the block route: bf16 through the
# permutation, float32 with a batch and skipped segments, and 2,048 bf16
# columns (tiles of 4 rows) through the permutation.
SEGSUM_EDGES = (
    (1, 1, False, "float32", 5000, 700, 0),
    (1, 3, True, "float32", 5000, 700, 0),
    (1, 1, True, "float64", 5000, 1, 0),
    (1, 1, False, "float32", 20000, 9, 0),
    (1, 2, False, "float32", 20000, 700, 7),
    (3, 1, False, "float32", 3000, 90, 0),
    (64, 2, True, "float32", 3000, 90, 0),
    (96, 1, True, "float32", 3000, 7, 3),
    (130, 1, False, "float64", 2000, 9, 0),
    (1, 1, False, "float32", 0, 40, 0),
    (64, 1, True, "float32", 0, 40, 0),
    (64, 1, True, "bfloat16", 20000, 9, 0),
    (64, 2, False, "float32", 20000, 9, 3),
    (2048, 1, True, "bfloat16", 6000, 6, 0),
)


def segment_sum_edges(log):
    """The kernel on SEGSUM_EDGES (values of mixed magnitude, ids with
    empty segments), each call one launch and bit for bit its plain version
    on the CPU."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss

    rng = np.random.default_rng(3)
    for width, batch, ordered, dt, n, n_out, skip in SEGSUM_EDGES:
        case = (width, batch, ordered, dt, n, n_out, skip)
        shape = (batch, n, width) if batch > 1 else (n, width)
        vals = np.where(rng.random(shape) < 0.3,
                        np.where(rng.random(shape) < 0.5, -1e8, 1e8),
                        rng.random(shape) + 0.5)
        ids = np.sort(rng.integers(0, n_out, n) // 2 * 2 % n_out)
        order = rng.permutation(n) if ordered else None
        host = (torch.from_numpy(ids),
                torch.from_numpy(vals).to(getattr(torch, dt)),
                None if order is None else torch.from_numpy(order))
        dev = tuple(None if h is None else h.cuda() for h in host)
        before = ops.launch_counts()["segment_sum"]
        got = ss.segment_sum(dev[0], dev[1], n_out, dev[2], skip).cpu()
        check(ops.launch_counts()["segment_sum"] == before + 1,
              f"segment_sum edge {case}: launches")
        want = ss.segment_sum_plain(host[0], host[1], n_out, host[2], skip)
        check(torch.equal(got, want), f"segment_sum edge {case} differs")
        again = ss.segment_sum(dev[0], dev[1], n_out, dev[2], skip).cpu()
        check(torch.equal(got, again), f"segment_sum edge {case}: a repeat "
                                       f"differs")
    emit({"segment_sum_edges": {"cases": len(SEGSUM_EDGES), "ok": True,
                                "long_run": ss.long_run()}}, log)


def formats_check(log) -> dict:
    """The dense conversions that add repeated entries, on the card against
    the CPU on the same inputs (float32 of mixed magnitude):
    ``TopKRows.to_dense``, ``bsr_to_dense``, ``csr_to_dense`` and
    ``ell_to_dense`` (each through the segment sum), each with short runs
    of repeats (2,000 rows, up to ~10 a slot) and long ones (4 rows,
    ~30,000 a slot); each must equal the CPU's bits."""
    import torch

    from repro_torch.sparse import formats as f

    rng = np.random.default_rng(7)

    def vals(*shape):
        big = rng.random(shape) < 0.3
        return torch.from_numpy(np.where(
            big, np.where(rng.random(shape) < 0.5, -1e8, 1e8),
            rng.random(shape) + 0.5).astype(np.float32))

    def ints(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    def to(x, dev):
        return dataclasses.replace(x, **{
            fl.name: getattr(x, fl.name).to(dev)
            for fl in dataclasses.fields(x)
            if isinstance(getattr(x, fl.name), torch.Tensor)})

    rec = {}
    for runs, n, reps, cols in (("short", 2000, 24, 3), ("long", 4, 60000, 2)):
        bs, nb = 8, n * reps // 64
        cases = (
            ("TopKRows.to_dense", f.TopKRows(vals(n, reps),
                                             ints(0, cols, n, reps),
                                             (n, 64)),
             lambda y: y.to_dense()),
            ("bsr_to_dense", f.BSR(
                torch.tensor([0, nb], dtype=torch.int32), ints(0, cols, nb),
                vals(nb, bs, bs), (bs, cols * bs)), f.bsr_to_dense),
            ("csr_to_dense", f.CSR(
                torch.arange(0, n * reps + 1, reps, dtype=torch.int32),
                ints(0, cols, n * reps), vals(n * reps), (n, 64)),
             f.csr_to_dense),
            ("ell_to_dense", f.ELL(ints(-1, cols, n, reps), vals(n, reps),
                                   (n, 64)), f.ell_to_dense))
        for label, x, fn in cases:
            want = fn(x)
            got = fn(to(x, "cuda")).cpu()
            off = int((got != want).sum())
            check(off == 0, f"{label} ({runs} runs): {off} values differ "
                            f"from the CPU's")
            rec[f"{label}/{runs}"] = {"equal_to_cpu": True, "values_off": 0}
    emit({"formats_on_card": rec}, log)
    return rec


# the MoE dispatch gather's backward at DeepSeek-V2-Lite's training shape
# (2 x 2,048 tokens, top-6 of 64 routed experts, d_model 2,048, bf16): the
# tokens of the expert-sorted (token, pick) stream, and a cotangent
MOE_GATHER = {"tokens": 4096, "k": 6, "experts": 64, "d": 2048}


def moe_gather_operands():
    """(t_sorted, ct) on the card from seed 0: each pair's token in the
    stable expert sort of random picks, and a bf16 (pairs, d) cotangent."""
    import torch

    m = MOE_GATHER
    rng = np.random.default_rng(0)
    flat_e = torch.from_numpy(rng.integers(0, m["experts"],
                                           m["tokens"] * m["k"])).cuda()
    t_sorted = torch.argsort(flat_e, stable=True) // m["k"]
    ct = torch.from_numpy(rng.standard_normal(
        (m["tokens"] * m["k"], m["d"])).astype(np.float32)).cuda().bfloat16()
    return t_sorted, ct


def moe_gather_check(log) -> dict:
    """The MoE dispatch gather ``xt[t_sorted]`` through ``take_rows`` at
    MOE_GATHER: its backward on the card (the sort and the segment sum,
    one launch) bit for bit the CPU port's (the reference's order of adds,
    each rounded to bf16), and the same on a repeat; timed beside PyTorch's
    indexing backward (``indexing_backward_kernel``), which it replaces."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sparse.ops import take_rows

    t_sorted, ct = moe_gather_operands()
    x = torch.zeros((MOE_GATHER["tokens"], MOE_GATHER["d"]),
                    dtype=torch.bfloat16, device="cuda", requires_grad=True)

    def grad():
        return torch.autograd.grad(take_rows(x, t_sorted), x, ct)[0]

    before = ops.launch_counts()["segment_sum"]
    got = grad()
    torch.cuda.synchronize()
    check(ops.launch_counts()["segment_sum"] == before + 1,
          "the MoE gather's backward: segment sum launches")
    xc = x.detach().cpu().requires_grad_()
    want = torch.autograd.grad(take_rows(xc, t_sorted.cpu()), xc,
                               ct.cpu())[0]
    check(torch.equal(got.cpu(), want), "the MoE gather's backward differs "
          "from the CPU port's")
    check(torch.equal(grad(), got), "the MoE gather's backward: a repeat "
                                    "differs")

    def indexing():
        return torch.autograd.grad(x[t_sorted], x, ct)[0]

    rec = {"shape": dict(MOE_GATHER), "bit_identical_to_cpu": True,
           "ms": time_ms(grad, reps=10), "loop_ms": loop_ms(grad, reps=10),
           "indexing_backward_ms": time_ms(indexing, reps=10),
           "indexing_backward_loop_ms": loop_ms(indexing, reps=10),
           "indexing_backward_equal": bool(torch.equal(indexing(), got))}
    emit({"moe_gather_backward": rec}, log)
    del x, got, want
    torch.cuda.empty_cache()
    return rec


def segment_sum_phase(mats, log) -> dict:
    """The sorted segment sum at the main paths' shapes, each call recorded
    at its site and held bit for bit against the plain version on the CPU:
    the sort engine on RoadTX's group-0 chunk and p2p-Gnutella04's group-2
    chunk (976 x 131,793 slots), ``csr_spmm`` on ogbn-arxiv's Â (GNN)
    forward and X's gradient, ``csr_column_sums`` on Economics with its
    self loops (MCL's input); then the dense conversions
    (``formats_check``)."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps import markov_clustering as mc
    from repro_torch.apps.graphs import rmat_graph, table_ii_matrix
    from repro_torch.core import phases
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse import ops as sparse_ops

    t0 = time.perf_counter()
    recs = {}
    for name, group in (("RoadTX", 0), ("p2p-Gnutella04", 2)):
        a = mats[name]
        ell, firsts = chunk_operands(a)
        item, rows = firsts[group]
        cols_a, vals_a = phases.gather_group_rows(
            a.indptr, a.indices, a.data, rows, item.a_cap)
        keys, vals = phases.enumerate_products(cols_a, vals_a, ell.indices,
                                               ell.data)
        out_cap = int(phases.allocate_sort(keys).max())
        with recorded_sums(phases) as calls:
            phases.sort_unique(keys, vals, out_cap)
        check(len(calls) == 1, f"sort_unique made {len(calls)} segment sums")
        recs[f"sort_unique/{name}/group {group}"] = segment_sum_check(
            f"sort_unique {name} group {group} ({keys.shape[0]} x "
            f"{keys.shape[1]} slots, out_cap {out_cap})", calls[0], log)
        del ell, firsts, cols_a, vals_a, keys, vals, calls
        torch.cuda.empty_cache()
    g = rmat_graph(GNN["nodes"], GNN["avg_deg"], seed=0, device="cuda")
    a = gnn.normalize_adjacency(g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (GNN["nodes"], GNN["d"])).astype(np.float32)).cuda().requires_grad_()
    ct = torch.from_numpy(rng.standard_normal(
        (GNN["nodes"], GNN["d"])).astype(np.float32)).cuda()
    with recorded_sums(sparse_ops, ss) as calls:
        sparse_ops.csr_spmm(a, x, gather="aia").backward(ct)
    check(len(calls) == 2 and calls[1][3] is not None,
          f"csr_spmm and its backward made {len(calls)} segment sums")
    recs["csr_spmm/ogbn-arxiv"] = segment_sum_check(
        f"csr_spmm ogbn-arxiv forward ({int(a.nnz)} slots x {GNN['d']})",
        calls[0], log)
    recs["csr_spmm/ogbn-arxiv/dX"] = segment_sum_check(
        "csr_spmm ogbn-arxiv X's gradient (stable-sort order)", calls[1],
        log)
    del g, a, x, ct, calls
    torch.cuda.empty_cache()
    ids, ct = moe_gather_operands()
    with recorded_sums(ss) as calls:
        ss.index_sum(ids, ct, MOE_GATHER["tokens"])
    check(len(calls) == 1, f"index_sum made {len(calls)} segment sums")
    recs["moe_backward/deepseek"] = segment_sum_check(
        f"the MoE gathers' backward, DeepSeek-V2-Lite's training shape "
        f"({ids.numel()} pairs x {MOE_GATHER['d']} bf16, runs of "
        f"{MOE_GATHER['k']})", calls[0], log)
    del ids, ct, calls
    torch.cuda.empty_cache()
    name, n = MCL_MATRIX
    g = mc.add_self_loops(table_ii_matrix(name, seed=0, n_override=n,
                                          device="cuda"))
    with recorded_sums(ss) as calls:
        sparse_ops.csr_column_sums(g)
    check(len(calls) == 1, f"csr_column_sums made {len(calls)} sums")
    recs[f"csr_column_sums/{name}"] = segment_sum_check(
        f"csr_column_sums {name} with self loops ({int(g.nnz)} slots)",
        calls[0], log)
    del g, calls
    torch.cuda.empty_cache()
    segment_sum_edges(log)
    fmt = formats_check(log)
    emit({"segment_sum_phase_s": time.perf_counter() - t0}, log)
    return {"shapes": recs, "formats": fmt}


# ---------------------------------------------------------------------------
# Phase 7: the SpGEMM path end to end
# ---------------------------------------------------------------------------

SPGEMM_KERNELS = ("gather_rows", "hash_accumulate")
CPU_PRODUCT = ("p2p-Gnutella04",)  # default lane held against the CPU port
SEGSUM_HEAD = "sort_unique/p2p-Gnutella04/group 2"  # the kernels line's shape
CALLS = (
    ("default", {}, {"gather_rows", "segment_sum"}, 1),
    ("fused_hash", {"engine": "fused_hash"},
     {"gather_rows", "hash_accumulate"}, 0),
    ("hash_xla", {"engine": "hash", "gather": "xla"}, {"hash_accumulate"}, 1),
)


def scipy_product(a):
    import scipy.sparse as sp

    n = a.n_rows
    host = sp.csr_matrix((a.data.cpu().numpy().astype(np.float64),
                          a.indices.cpu().numpy(), a.indptr.cpu().numpy()),
                         shape=(n, n))
    c = (host @ host).tocsr()
    c.sort_indices()
    return c


def check_against_scipy(name, label, c, nnz, want):
    indptr = c.indptr.cpu().numpy()
    check(nnz == want.nnz, f"{name}/{label}: nnz {nnz} != scipy {want.nnz}")
    check(np.array_equal(indptr, want.indptr), f"{name}/{label}: indptr")
    check(np.array_equal(c.indices[:nnz].cpu().numpy(), want.indices),
          f"{name}/{label}: indices")
    got = c.data[:nnz].cpu().numpy().astype(np.float64)
    check(np.allclose(got, want.data, rtol=RTOL, atol=ATOL),
          f"{name}/{label}: values beyond rtol {RTOL} atol {ATOL}")
    return float(np.abs(got - want.data).max(initial=0.0))


def run_call(a, kwargs, count_syncs=False):
    import torch

    from repro_torch.core import executor
    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    executor.clear_program_cache()
    before = ops.launch_counts()
    routes_before = ops.route_counts()
    syncs = None
    t0 = time.perf_counter()
    if count_syncs:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = spgemm(a, a, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message).lower()]
    else:
        res = spgemm(a, a, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    routes = {k: n - routes_before.get(k, 0)
              for k, n in ops.route_counts().items()
              if n != routes_before.get(k, 0)}
    return res, ms, {k: after[k] - before[k] for k in after}, routes, \
        executor.cache_stats()["host_sync_count"], syncs


def cusparse_ms(a):
    import torch

    nnz = int(a.nnz)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        t = torch.sparse_csr_tensor(a.indptr, a.indices[:nnz], a.data[:nnz],
                                    size=a.shape, check_invariants=False)
        return (time_ms(lambda: torch.sparse.mm(t, t), reps=3),
                device_ms(lambda: torch.sparse.mm(t, t), reps=3))


def end_to_end_phase(mats, log):
    import torch

    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()  # the main path's count starts here
    per_call = {}
    for name, a in mats.items():
        want = scipy_product(a)
        results = {}
        for label, kwargs, kernels, syncs_expected in CALLS:
            planned = label == "fused_hash"
            res, cold_ms, launches, routes, syncs, debug_syncs = run_call(
                a, kwargs, count_syncs=planned)
            nnz = res.info["nnz_c"]
            err = check_against_scipy(name, label, res.c, nnz, want)
            check(syncs == syncs_expected,
                  f"{name}/{label}: host_sync_count {syncs}, expected "
                  f"{syncs_expected}")
            for k, n in launches.items():
                check((n > 0) == (k in kernels),
                      f"{name}/{label}: {k} launched {n} times")
            again, ms, _, _, _, _ = run_call(a, kwargs)
            # every lane adds in a fixed order: a second run, bit for bit
            check(same_csr(again.c, res.c),
                  f"{name}/{label}: a second run differs")
            del again
            results[label] = res
            per_call[f"{name}/{label}"] = launches
            rec = {"matrix": name, "call": label, "rows": a.n_rows,
                   "nnz_a": res.info["nnz_a"], "nnz_c": nnz,
                   "intermediate_products": res.info["intermediate_products"],
                   "group_sizes": res.info["group_sizes"],
                   "ms": ms, "cold_ms": cold_ms, "host_sync_count": syncs,
                   "launches": launches, "route_launches": routes,
                   "max_abs_err_vs_scipy": err,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if planned:
                rec["sync_debug_warnings"] = len(debug_syncs)
                rec["sync_debug_sites"] = debug_syncs
            host_ms, dev_ms, top = profile(lambda: spgemm(a, a, **kwargs))
            rec["profiled"] = {"host_ms": host_ms, "device_ms": dev_ms,
                               "device_busy_share": None if dev_ms is None
                               else dev_ms / host_ms, "top_kernels": top}
            emit({"e2e": rec}, log)
        fu, hx = results["fused_hash"].c, results["hash_xla"].c
        nnz = results["hash_xla"].info["nnz_c"]
        check(torch.equal(fu.indptr, hx.indptr)
              and torch.equal(fu.indices[:nnz], hx.indices[:nnz])
              and torch.equal(fu.data[:nnz], hx.data[:nnz]),
              f"{name}: fused_hash/aia is not bit-identical to hash/xla")
        if name in CPU_PRODUCT:
            # the CPU port's product (the plain versions, index_add_ in
            # index order): the default lane's bits, as the reference's
            t0 = time.perf_counter()
            cpu = spgemm(on_cpu(a), on_cpu(a)).c
            cpu_s = time.perf_counter() - t0
            check(same_csr(cpu, on_cpu(results["default"].c)),
                  f"{name}/default: differs from the CPU port's product")
            emit({"e2e_vs_cpu_port": {"matrix": name, "lane": "default",
                                      "bit_identical": True,
                                      "cpu_s": cpu_s}}, log)
            del cpu
        ms, dev_ms = cusparse_ms(a)
        emit({"cusparse": {"matrix": name, "ms": ms, "device_ms": dev_ms}},
             log)
    totals = ops.launch_counts()
    for k in (*SPGEMM_KERNELS, "segment_sum"):
        check(totals[k] > 0, f"kernel {k} was never launched on the main path")
    return totals, per_call


def on_cpu(c):
    """A port CSR's tensors copied to the host."""
    return dataclasses.replace(c, indptr=c.indptr.cpu(),
                               indices=c.indices.cpu(), data=c.data.cpu())


# ---------------------------------------------------------------------------
# Phase 8: SpGEMM serving on the Table-II patterns
# ---------------------------------------------------------------------------

# repro.launch.serve's run_spgemm traffic on Table-II patterns: a request is
# A·B with B the pattern's matrix (one B for the pattern's requests, so the
# tenants' OperandCaches hit) and A that structure with fresh values from
# np.random.default_rng(seed); patterns by Zipf 1.2 popularity in this
# order, tenant i % 4, flushed at the end.
SERVE = {"patterns": {"RoadTX": 1_393_383, "p2p-Gnutella04": 10_876,
                      "Economics": 206_500},
         "requests": 48, "tenants": 4, "zipf": 1.2, "max_batch": 8,
         "seed": 0, "memory_limit_gb": 60.0}
# tenants 0-1 on the default lane (sort, AIA, measured), 2-3 on fused_hash
# (planned): the knob signature splits their groups
SERVE_KNOBS = ({}, {}, {"engine": "fused_hash"}, {"engine": "fused_hash"})
AUTO_MATRICES = ("RoadTX", "p2p-Gnutella04")


def lane_of(knobs) -> str:
    return "fused_hash" if knobs.get("engine") == "fused_hash" else "default"


def reckoned_batch_gb(a, batch: int):
    """Reckoned peak GB of a batched sort-lane product on ``a``'s pattern
    (the larger lane): wave 1 holds every chunk's keys and ``batch`` value
    streams, and the largest chunk's sort adds its keys, int64 order and
    targets, masks and ranks, and each member's gathered values.  Also
    returns the pattern's chunks and B's ELL width."""
    from repro_torch.core import executor as ex
    from repro_torch.core.grouping import group_rows

    row_nnz = np.diff(a.indptr.cpu().numpy().astype(np.int64))
    kb = int(row_nnz.max())
    items = ex.partition_plan(group_rows(a, a), row_nnz, 4096)
    slots = [ex._pad_rows(len(i.rows)) * i.a_cap * kb for i in items]
    return ((sum(slots) * (4 + 4 * batch) + max(slots) * (26 + 8 * batch))
            / 1e9, len(items), kb)


def fresh_values(b, rng):
    """A CSR on ``b``'s structure tensors with fresh float32 values."""
    import torch

    from repro_torch.sparse.formats import CSR

    nnz = int(b.nnz)
    data = torch.zeros(b.capacity, dtype=torch.float32, device=b.device)
    data[:nnz] = torch.from_numpy(
        rng.standard_normal(nnz).astype(np.float32)).to(b.device)
    return CSR(b.indptr, b.indices, data, b.shape)


@contextlib.contextmanager
def recorded_dispatches(records, patterns):
    """Record every call the service makes to ``spgemm`` and
    ``spgemm_batched``: pattern, members, knobs, wall ms, and the launches,
    routes and pipeline syncs it made."""
    import torch

    from repro_torch.core import executor
    from repro_torch.kernels import ops
    from repro_torch.serve import spgemm_service as svc_mod

    def wrap(kind, fn):
        def call(a, b, **kw):
            a0 = a[0] if isinstance(a, list) else a
            name = next(n for n, m in patterns.items()
                        if a0.indptr is m.indptr)
            l0, r0 = ops.launch_counts(), ops.route_counts()
            s0 = executor.cache_stats()["host_sync_count"]
            t0 = time.perf_counter()
            out = fn(a, b, **kw)
            torch.cuda.synchronize()
            records.append({
                "kind": kind, "pattern": name, "lane": lane_of(kw),
                "operand_cache": id(kw.get("operand_cache")),
                "batch": len(a) if isinstance(a, list) else 1,
                "a": a, "b": b, "knobs": kw,
                "ms": (time.perf_counter() - t0) * 1e3,
                "launches": {k: n - l0[k]
                             for k, n in ops.launch_counts().items()},
                "routes": {k: n - r0.get(k, 0)
                           for k, n in ops.route_counts().items()
                           if n != r0.get(k, 0)},
                "syncs": executor.cache_stats()["host_sync_count"] - s0})
            return out
        return call

    orig = {k: getattr(svc_mod, k) for k in ("spgemm", "spgemm_batched")}
    for k, fn in orig.items():
        setattr(svc_mod, k, wrap(k, fn))
    try:
        yield
    finally:
        for k, fn in orig.items():
            setattr(svc_mod, k, fn)


def pair_product(a, b):
    """scipy's float64 A·B of two port CSRs, indices sorted."""
    c = (host_csr(a) @ host_csr(b)).tocsr()
    c.sort_indices()
    return c


LANE_KNOBS = ("engine", "gather", "schedule", "row_chunk", "pipeline",
              "sizing", "operands")


def serve_traffic(patterns, caps, log):
    """The service over SERVE's traffic, every dispatch recorded; returns
    (tickets as (request, ticket), records, stats, wall s, operand stats)."""
    import torch

    from repro_torch.core import executor
    from repro_torch.kernels import ops
    from repro_torch.serve import SpGEMMService

    names = list(patterns)
    rng = np.random.default_rng(SERVE["seed"])  # the patterns' draws
    values = np.random.default_rng(SERVE["seed"] + 1)  # A's fresh values
    ranks = np.arange(1, len(names) + 1, dtype=np.float64)
    popularity = ranks ** -SERVE["zipf"]
    popularity /= popularity.sum()
    # one service per batch cap (a pattern whose reckoned memory passes the
    # limit at max_batch gets a smaller cap); max_wait past the run, so
    # batches form by size and the final flush
    services = {cap: SpGEMMService(max_batch=cap, max_wait=3600.0)
                for cap in sorted(set(caps.values()))}
    records, tickets = [], []
    torch.cuda.synchronize()
    executor.clear_program_cache()
    ops.reset_launch_counts()  # the serving run's counts start here
    t0 = time.perf_counter()
    with recorded_dispatches(records, patterns):
        for i in range(SERVE["requests"]):
            name = names[int(rng.choice(len(names), p=popularity))]
            knobs = SERVE_KNOBS[i % SERVE["tenants"]]
            a = fresh_values(patterns[name], values)
            svc = services[caps[name]]
            tickets.append(((name, knobs, a),
                            svc.submit(f"tenant{i % SERVE['tenants']}", a,
                                       patterns[name], **knobs)))
        for svc in services.values():
            svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    opstats = {k: v for k, v in executor.cache_stats().items()
               if k in ("operand_hits", "operand_misses")}
    stats = [svc.stats() for svc in services.values()]
    return tickets, records, stats, wall, opstats


def check_dispatches(records, chunks):
    """Per dispatch: one K1 launch a chunk; on fused_hash K2 batch x chunks
    and no pipeline sync; on the default lane no K2, one segment sum a
    chunk and one sync."""
    for r in records:
        n = chunks[r["pattern"]]
        what = f"serve {r['pattern']}/{r['lane']} {r['kind']} x{r['batch']}"
        check(r["launches"]["gather_rows"] == n,
              f"{what}: {r['launches']['gather_rows']} K1 launches for "
              f"{n} chunks")
        fused = r["lane"] == "fused_hash"
        check(r["launches"]["hash_accumulate"]
              == (r["batch"] * n if fused else 0),
              f"{what}: {r['launches']['hash_accumulate']} K2 launches")
        # the sort engine sums a chunk's members in one launch
        check(r["launches"]["segment_sum"] == (0 if fused else n),
              f"{what}: {r['launches']['segment_sum']} segment sums")
        check(r["syncs"] == (0 if fused else 1),
              f"{what}: {r['syncs']} pipeline syncs")


def check_members(tickets, patterns, log):
    """Every request against its solo ``spgemm`` on the card with the same
    knobs (structure exact, values bit for bit on both lanes), and one
    request per (pattern, lane) against scipy's float64 product."""
    import torch

    from repro_torch.core.spgemm import spgemm

    worst = {}
    scipy_err = {}
    for (name, knobs, a), tk in tickets:
        check(tk.done and tk._error is None,
              f"serve {name}: a request did not complete ({tk._error!r})")
        res = tk.result()
        c, nnz = res.c, res.info["nnz_c"]
        solo = spgemm(a, patterns[name], **knobs)
        lane = lane_of(knobs)
        what = f"serve {name}/{lane} member of {tk.coalesced_with}"
        check(solo.info["nnz_c"] == nnz
              and torch.equal(c.indptr, solo.c.indptr)
              and torch.equal(c.indices[:nnz], solo.c.indices[:nnz]),
              f"{what}: structure differs from the solo product")
        got, want = c.data[:nnz], solo.c.data[:nnz]
        check(torch.equal(got, want), f"{what}: not bit-identical to the "
                                      f"solo product")
        key = f"{name}/{lane}"
        worst[key] = max(worst.get(key, 0.0),
                         float((got.double() - want.double()).abs().max()
                               if nnz else 0.0))
        if key not in scipy_err:
            scipy_err[key] = check_against_scipy(
                name, f"serve/{lane}", c, nnz,
                pair_product(a, patterns[name]))
        del res, solo
    return worst, scipy_err


def batched_vs_loop(records):
    """For the first batched dispatch of each (pattern, lane): the same
    members through one ``spgemm_batched`` and through a loop of
    ``spgemm``, each profiled (device ms, busy share) with its peak GB."""
    import torch

    from repro_torch.core.spgemm import spgemm, spgemm_batched

    out = {}
    for r in records:
        key = f"{r['pattern']}/{r['lane']}"
        if r["kind"] != "spgemm_batched" or key in out:
            continue
        kw = {k: r["knobs"][k] for k in LANE_KNOBS}
        calls = {
            "batched": lambda: spgemm_batched(r["a"], r["b"], **kw),
            "loop": lambda: [spgemm(a, b, **kw)
                             for a, b in zip(r["a"], r["b"])]}
        out[key] = {"batch": r["batch"]}
        for label, fn in calls.items():
            fn()  # warm
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() / 1e9
            rec = profiled(fn)
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["base_gb"] = base
            rec.pop("top_kernels")
            out[key][label] = rec
    return out


def serve_auto(patterns, log):
    """``engine="auto"`` on AUTO_MATRICES' self-products: rounds until the
    autotune cache converges, the result against scipy, a converged call
    that measures nothing, and an all-fused_hash forced assignment with no
    pipeline sync.  No particular assignment is asserted."""
    import dataclasses

    import torch

    from repro_torch.core import executor as ex
    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    out = {}
    for name in AUTO_MATRICES:
        a = patterns[name]
        tuner = ex.AutotuneCache()
        ex.clear_program_cache()
        ops.reset_launch_counts()
        rounds = []
        for _ in range(len(ex.available_engines())):
            t0 = time.perf_counter()
            res = spgemm(a, a, engine="auto", autotune=tuner)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) * 1e3)
        key = ex.autotune_key(a, a, res.plan)
        check(tuner.converged(key), f"auto {name}: not converged after "
                                    f"{len(rounds)} rounds")
        err = check_against_scipy(name, "auto", res.c, res.info["nnz_c"],
                                  scipy_product(a))
        hits, misses = tuner.hits, tuner.misses
        t0 = time.perf_counter()
        res = spgemm(a, a, engine="auto", autotune=tuner)
        torch.cuda.synchronize()
        converged_ms = (time.perf_counter() - t0) * 1e3
        check((tuner.hits, tuner.misses) == (hits + 1, misses),
              f"auto {name}: the converged call measured again")
        forced = dataclasses.replace(res.plan,
                                     group_engines=("fused_hash",) * 4)
        s0 = ex.cache_stats()["host_sync_count"]
        k2 = ops.launch_counts()["hash_accumulate"]
        fres = spgemm(a, a, engine="auto", plan=forced)
        syncs = ex.cache_stats()["host_sync_count"] - s0
        check(syncs == 0, f"auto {name}: forced fused_hash paid {syncs} "
                          f"pipeline syncs")
        check(ops.launch_counts()["hash_accumulate"] > k2,
              f"auto {name}: forced fused_hash launched no K2")
        check(fres.info["nnz_c"] == res.info["nnz_c"],
              f"auto {name}: forced fused_hash nnz differs")
        [summary] = tuner.summary()
        out[name] = {"assignment": summary["assignment"],
                     "group_sizes": summary["group_sizes"],
                     "timings_us": summary["timings_us"],
                     "round_ms": rounds, "converged_call_ms": converged_ms,
                     "measuring_ms": sum(rounds) - len(rounds) * converged_ms,
                     "max_abs_err_vs_scipy": err,
                     "autotune_hits": tuner.hits,
                     "autotune_misses": tuner.misses}
        emit({"serve_auto": {"matrix": name, **out[name]}}, log)
    return out


def serve_dispatch_fail(patterns, log):
    """``dispatch_fail`` armed once on a batched fused_hash dispatch of 4
    p2p-Gnutella04 requests: every member completes by replay, each
    bit-identical to its solo product."""
    import torch

    from repro_torch.core import executor, faults
    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops
    from repro_torch.serve import SpGEMMService

    b = patterns["p2p-Gnutella04"]
    rng = np.random.default_rng(SERVE["seed"] + 2)
    members = [fresh_values(b, rng) for _ in range(4)]
    svc = SpGEMMService(max_batch=4, max_wait=3600.0)
    executor.clear_program_cache()
    ops.reset_launch_counts()
    with faults.fault_injection("dispatch_fail", times=1) as fault:
        tickets = [svc.submit("t", a, b, engine="fused_hash")
                   for a in members]
    st = svc.stats()
    check(fault.triggers == 1 and st["batched_dispatches"] == 1
          and st["quarantined"] == 0 and st["requests_completed"] == 4,
          f"dispatch_fail: {fault.triggers} triggers, stats {st}")
    # the failed dispatch placed nothing; the first replay converts B into
    # the tenant's OperandCache and the other three are served from it
    opstats = executor.cache_stats()
    check((opstats["operand_hits"], opstats["operand_misses"]) == (3, 1),
          f"dispatch_fail: OperandCache {opstats}")
    launches = ops.launch_counts()
    for a, tk in zip(members, tickets):
        c = tk.result().c
        solo = spgemm(a, b, engine="fused_hash").c
        check(torch.equal(c.indptr, solo.indptr)
              and torch.equal(c.indices, solo.indices)
              and torch.equal(c.data, solo.data),
              "dispatch_fail: a replayed member differs from its solo run")
    rec = {"triggers": fault.triggers, "replayed": 4,
           "quarantined": st["quarantined"],
           "operand_hits": opstats["operand_hits"],
           "operand_misses": opstats["operand_misses"],
           "launches": launches}
    emit({"serve_dispatch_fail": rec}, log)
    return rec


def serve_phase(mats, log):
    """SpGEMM serving through ``SpGEMMService`` on RoadTX, p2p-Gnutella04
    and Economics at paper size; returns K1's, K2's and the segment sum's
    launches per pattern/lane."""
    import torch

    from repro_torch.apps.graphs import table_ii_matrix

    t_phase = time.perf_counter()
    patterns = {name: mats[name] if name in mats else table_ii_matrix(
        name, seed=0, n_override=n, device="cuda")
        for name, n in SERVE["patterns"].items()}
    caps, chunks, plan_rec = {}, {}, {}
    for name, a in patterns.items():
        cap = SERVE["max_batch"]
        gb, chunks[name], kb = reckoned_batch_gb(a, cap)
        while cap > 1 and reckoned_batch_gb(a, cap)[0] \
                > SERVE["memory_limit_gb"]:
            cap -= 1
        caps[name] = cap
        plan_rec[name] = {"rows": a.n_rows, "nnz": int(a.nnz),
                          "chunks": chunks[name], "kb": kb,
                          "reckoned_gb_at_max_batch": gb, "max_batch": cap,
                          "k1_row_bytes": {"index": 4 * kb,
                                           "folded_values": 4 * cap * kb}}
    emit({"serve_patterns": plan_rec}, log)

    tickets, records, stats, wall, opstats = serve_traffic(patterns, caps,
                                                           log)
    check_dispatches(records, chunks)
    # a dispatch runs on its lead tenant's OperandCache: it hits where that
    # cache served the pattern's B before
    seen, expect_hits = set(), 0
    for r in records:
        expect_hits += (r["operand_cache"], r["pattern"]) in seen
        seen.add((r["operand_cache"], r["pattern"]))
    check(opstats == {"operand_hits": expect_hits,
                      "operand_misses": len(records) - expect_hits},
          f"serve: OperandCache {opstats}, expected {expect_hits} hits")
    per_serve = {}
    for r in records:
        key = f"{r['pattern']}/{r['lane']}"
        tot = per_serve.setdefault(key, {"gather_rows": 0,
                                         "hash_accumulate": 0,
                                         "segment_sum": 0})
        for k in tot:
            tot[k] += r["launches"][k]
    folded = {}
    for r in records:
        if r["kind"] == "spgemm_batched":
            folded.setdefault(f"{r['pattern']}/x{r['batch']}", {
                "index_row_bytes": 4 * plan_rec[r["pattern"]]["kb"],
                "value_row_bytes": 4 * r["batch"]
                * plan_rec[r["pattern"]]["kb"],
                "routes": r["routes"]})
    lat = sorted(tk.latency_s for _, tk in tickets)
    st = stats[0] if len(stats) == 1 else stats
    rec = {"requests": len(tickets), "wall_s": wall,
           "requests_per_s": len(tickets) / wall,
           "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "dispatches": sum(s["dispatches"] for s in stats),
           "batched_dispatches": sum(s["batched_dispatches"] for s in stats),
           "singleton_dispatches": sum(s["singleton_dispatches"]
                                       for s in stats),
           "coalescing_ratio": len(tickets) / sum(s["dispatches"]
                                                  for s in stats),
           "operand_cache": opstats, "launches": per_serve,
           "k1_folded_rows": folded,
           "dispatch_log": [{k: r[k] for k in ("pattern", "lane", "kind",
                                              "batch", "ms", "syncs",
                                              "launches")}
                            for r in records],
           "service_stats": st}
    emit({"serve": rec}, log)
    worst, scipy_err = check_members(tickets, patterns, log)
    emit({"serve_members": {"max_abs_diff_vs_solo": worst,
                            "max_abs_err_vs_scipy": scipy_err}}, log)
    del tickets
    torch.cuda.empty_cache()
    emit({"serve_batched_vs_loop": batched_vs_loop(records)}, log)
    del records
    torch.cuda.empty_cache()
    serve_auto(patterns, log)
    serve_dispatch_fail(patterns, log)
    emit({"serve_phase_s": time.perf_counter() - t_phase}, log)
    return per_serve


# ---------------------------------------------------------------------------
# Phase 3: the sparse-activation path (K3-K6) at Phi-3-mini FFN width
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def ffn_operands(seed: int = 0):
    """x (tokens, d_model), W1 and W2, h = silu(x W1) * (x W3), all bf16,
    from a seeded generator on the card."""
    import torch
    import torch.nn.functional as F

    d, f, n = FFN["d_model"], FFN["d_ff"], FFN["tokens"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    x = rand(n, d)
    w1, w3 = rand(d, f, scale=d ** -0.5), rand(d, f, scale=d ** -0.5)
    w2 = rand(f, d, scale=f ** -0.5)
    h = F.silu(x @ w1) * (x @ w3)
    return x, w1, w2, h


def pruned_bsr(w, keep, block):
    """``w`` with all but its ``keep`` highest-energy blocks per block-row
    zeroed, as a BSR through ``bsr_from_dense``."""
    import torch

    from repro_torch.sparse.formats import bsr_from_dense
    from repro_torch.sparse.topk import topk_mask

    r, c = w.shape
    nbr, nbc = r // block, c // block
    energy = w.float().reshape(nbr, block, nbc, block).square().sum((1, 3))
    mask = topk_mask(energy, keep)
    dense_mask = mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    return bsr_from_dense(torch.where(dense_mask, w, 0), (block, block),
                          device=w.device)


def ffn_path(x, w1, w2, h):
    """The path a user of ``kernels.ops`` drives: K5 on the TopK rows of h,
    K6 and K3 on the per-tile block selection, K4 on the pruned W1^T."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.ffn import tile_block_select
    from repro_torch.sparse.topk import topk_rows

    k, block, tile = FFN["k"], FFN["block"], FFN["tile"]
    tk = topk_rows(h, k)
    y5 = ops.topk_spmm(tk.values, tk.indices, w2)
    h_kept, bidx = tile_block_select(h, k // block, block, tile)
    y6 = ops.block_topk_spmm(h_kept, bidx, w2, block)
    w2_sel = ops.aia_ranged_gather(w2, bidx.reshape(-1), block)
    bsr = pruned_bsr(w1.t().contiguous(), FFN["bsr_keep"], block)
    xt = x.t().contiguous()
    y4 = ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks, xt,
                      FFN["bsr_keep"])
    torch.cuda.synchronize()
    return {"tk": tk, "y5": y5, "h_kept": h_kept, "bidx": bidx, "y6": y6,
            "w2_sel": w2_sel, "bsr": bsr, "xt": xt, "y4": y4}


def check_ffn_outputs(out, h, w2):
    """The path's results, held against dense products on the same data."""
    import torch

    from repro_torch.core.spgemm_bsr import bsr_spgemm_dense_rhs
    from repro_torch.sparse.formats import bsr_to_dense
    from repro_torch.sparse.topk import topk_rows_st

    n, d, f = FFN["tokens"], FFN["d_model"], FFN["d_ff"]
    block, tile = FFN["block"], FFN["tile"]
    nt, kb = n // tile, FFN["k"] // block
    shapes = {"y5": (n, d), "y6": (n, d), "w2_sel": (nt * kb * block, d),
              "y4": (f, n)}
    for name, shape in shapes.items():
        t = out[name]
        check(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()), f"{name}: non-finite values")
    errs = {}
    # topk_ffn's last line, ffn.py:58-59: the masked h times W2, dense
    dense5 = topk_rows_st(h.float(), FFN["k"]) @ w2.float()
    errs["topk_spmm_vs_masked_dense"] = rel_err(out["y5"], dense5)
    del dense5
    # block_topk_ffn's einsum on K3's gathered W2 blocks
    hk = out["h_kept"].permute(0, 2, 1, 3).reshape(nt, tile, kb * block)
    y3 = torch.bmm(hk.float(),
                   out["w2_sel"].view(nt, kb * block, d).float())
    errs["block_topk_spmm_vs_ranged_gather_bmm"] = rel_err(
        out["y6"], y3.reshape(n, d))
    del y3
    bsr = out["bsr"]
    dense4 = bsr_to_dense(bsr).float() @ out["xt"].float()
    errs["bsr_spmm_vs_dense"] = rel_err(out["y4"], dense4)
    del dense4
    errs["bsr_spmm_vs_spgemm_bsr_bf16"] = rel_err(
        out["y4"], bsr_spgemm_dense_rhs(bsr, out["xt"]))
    for name, e in errs.items():
        # the bf16 XLA path rounds each block product and each partial sum
        # to bf16 (2**-9 each): 3 products and 2 sums stay under 2**-6
        limit = 2.0 ** -6 if name.endswith("bf16") else FFN_REL
        check(e <= limit, f"FFN path: {name} {e} > {limit}")
    return errs


def ffn_phase(log):
    """Drive the sparse-activation path with the counts from 0, check its
    results, then hold, time and bound each of its kernels."""
    import torch

    from repro_torch.kernels import ops

    x, w1, w2, h = ffn_operands(seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    out = ffn_path(x, w1, w2, h)
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    routes = ops.route_counts()
    for name in FFN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the FFN path")
    for name, path in FFN_ROUTES.items():
        check(routes.get(f"{name}/{path}", 0) == launches[name],
              f"FFN path: {name} did not take its {path} route ({routes})")
    errs = check_ffn_outputs(out, h, w2)
    ffn_shape_sweep(log)
    host_ms, dev_ms, top = profile(lambda: ffn_path(x, w1, w2, h))
    emit({"ffn_path": {**FFN, "ms": path_ms, "launches": launches,
                       "route_launches": routes, "checks_rel_err": errs,
                       "profiled": {"host_ms": host_ms, "device_ms": dev_ms,
                                    "device_busy_share": None if dev_ms is None
                                    else dev_ms / host_ms,
                                    "top_kernels": top}}}, log)
    recs = ffn_kernel_records(out, w2, launches, log)

    def dense():
        return torch.matmul(h, w2)

    emit({"dense_down_projection": {
        "shape": [FFN["tokens"], FFN["d_ff"], FFN["d_model"]],
        "dtype": "bfloat16", "ms": time_ms(dense, reps=20),
        "device_ms": device_ms(dense)}}, log)
    return recs


# K3's routes (aia_gather.ranged_route): (dtype, n_blocks, r, d, n_idx, x's
# element offset into its allocation, the route).  16-byte ranges go to the
# 16-byte copy: one vector, 64 vectors, two 16 KB chunks and a ragged 577
# vectors more (bf16 7 x 3,000), ten chunks and 10 vectors (float32 5 x
# 8,200); 12-byte ranges (bf16 1 x 6, float32 1 x 3) and a 16-byte range at
# an x 4 bytes past a 16-byte boundary take the word copy.
RANGED_ROUTES = (
    ("bfloat16", 8, 1, 8, 9, 0, "v16"), ("float32", 8, 2, 128, 7, 0, "v16"),
    ("bfloat16", 6, 7, 3000, 5, 0, "v16"), ("float32", 3, 5, 8200, 4, 0, "v16"),
    ("bfloat16", 8, 1, 6, 9, 0, "words"), ("float32", 8, 1, 3, 9, 0, "words"),
    ("float32", 8, 2, 128, 7, 1, "words"),
    # a bf16 range of odd R * d (3 x 7: 42 bytes) and an x 2 bytes past a
    # 4-byte boundary take the 2-byte copy
    ("bfloat16", 8, 3, 7, 9, 0, "u16"), ("bfloat16", 8, 1, 8, 9, 1, "u16"),
)
# K4's bf16 kernel (csrc/bsr_spmm_wgmma.cu): block sizes around its
# 128-row tiles and 64-deep stages at d 40, widths around its 128-column
# tiles at bs 128; bs 12 and d 7 take its element-wise staging (rows that
# are not whole 16-byte chunks), d 7 its scalar stores.  Held in both
# dtypes (float32 goes to the CUDA-core kernel).
BSR_EDGES = tuple((bs, 40) for bs in (8, 12, 16, 64, 128, 200, 256)) \
    + tuple((128, d) for d in (7, 200, 2050)) + ((8, 7),)
# K4's bf16 kernel is persistent (block k takes tiles k, k + grid, ...; a
# grid of 264 on an H100): (block-rows, bs, d) with several tiles a block,
# so that its load cursor crosses tiles, skips empty ones and refills ring
# slots during an epilogue; 40 x 17 column tiles with element-wise B
# staging (d 2,050), and 300 x 2 x 2 tiles with ragged rows, depth and
# columns (bs 200, d 200).  Both dtypes.
BSR_MULTITILE = ((40, 128, 2050), (300, 200, 200))


def bsr_edge_operands(bs, d, dt, randn):
    """Five block-rows over 4 block-columns, max_blocks_per_row 2: a row of
    3 blocks (the third dropped), an empty row, a row naming one column
    twice, a row with ids past both ends of B (clipped), and a row whose
    second slot lies past the last stored block (it reads the last)."""
    import torch

    nbc = 4
    rp = torch.tensor((0, 3, 3, 5, 7, 9), dtype=torch.int32, device="cuda")
    ci = torch.tensor((0, 2, 1, 1, 1, nbc + 3, -2, 3), dtype=torch.int32,
                      device="cuda")
    return rp, ci, randn(8, bs, bs, dtype=dt), randn(nbc * bs, d, dtype=dt), 2


def bsr_multitile_operands(n_brows, bs, d, dt, randn, randint):
    """``n_brows`` block-rows over 6 block-columns, max_blocks_per_row 3:
    row lengths cycle 0, 3, 1, 5, 0, 0, 2 (empty rows alone and in a run,
    rows past max_blocks_per_row), ids from -2 to 8 (clipped at both ends,
    repeats), and the last row's second slot past the last stored block
    (it reads the last).  Returns the operands and the row lengths."""
    import torch

    nbc = 6
    lens = [(0, 3, 1, 5, 0, 0, 2)[i % 7] for i in range(n_brows - 1)] + [2]
    rp = torch.tensor([0] + lens, dtype=torch.int32).cumsum(0).to(
        torch.int32).cuda()
    bcap = sum(lens) - 1
    return (rp, randint(nbc + 3, bcap, lo=-2),
            randn(bcap, bs, bs, dtype=dt), randn(nbc * bs, d, dtype=dt),
            3), lens


def ffn_shape_sweep(log):
    """K3-K6 against their plain versions on the card at the CPU tests'
    shapes (``tests/test_torch_ops.py``), float32 and bfloat16: ragged
    tiles, narrow and odd widths, a block-row past ``max_blocks_per_row``,
    an empty block-row, repeated and out-of-range ids; then K3 on both of
    its routes (``RANGED_ROUTES``) and K4 on its tile edges
    (``BSR_EDGES``), each call counted on the route it should take."""
    import torch

    from repro_torch.kernels import aia_gather, spgemm_bsr, topk_spmm

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def randint(hi, *shape, lo=0):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    cases = 0
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for nb, r, d, n in ((8, 1, 128, 16), (8, 2, 128, 5), (16, 4, 256, 32),
                            (4, 8, 8, 3)):
            x, idx = randn(nb * r, d, dtype=dt), randint(nb + 2, n, lo=-2)
            check(torch.equal(aia_gather.aia_ranged_gather(x, idx, r),
                              aia_gather.aia_ranged_gather_plain(x, idx, r)),
                  f"sweep: aia_ranged_gather {dt} {(nb, r, d, n)}")
            cases += 1
        bsr_cases = [((0, 3, 4, 7), (0, 2, 3, 1, 3, 0, 1), 8, 16, 4, 2),
                     ((0, 2, 2, 3), (0, 1, 1), 8, 16, 2, 2),
                     ((0, 2, 5, 6), (1, 0, 2, 3, 9), 16, 40, 10, 3),
                     ((0, 1), (1,), 8, 8, 2, 1), ((0, 4, 6), (0, 1, 2, 3, 1, 2),
                                                 128, 200, 4, 4)]
        for rowptr, colidx, bs, d, nbc, mbpr in bsr_cases:
            rp = torch.tensor(rowptr, dtype=torch.int32, device="cuda")
            ci = torch.tensor(colidx, dtype=torch.int32, device="cuda")
            a, b = randn(len(colidx), bs, bs, dtype=dt), randn(nbc * bs, d,
                                                                dtype=dt)
            e = rel_err(spgemm_bsr.bsr_spmm(rp, ci, a, b, mbpr),
                        spgemm_bsr.bsr_spmm_plain(rp, ci, a, b, mbpr))
            check(e <= FFN_REL, f"sweep: bsr_spmm {dt} bs {bs} d {d}: {e}")
            cases += 1
        for bs, d in BSR_EDGES:
            args = bsr_edge_operands(bs, d, dt, randn)
            got, _ = routed_call("bsr_spmm",
                                 lambda: spgemm_bsr.bsr_spmm(*args),
                                 spgemm_bsr.route(dt))
            want = spgemm_bsr.bsr_spmm_plain(*args)
            check(bool(torch.isfinite(got).all())
                  and float(got[bs:2 * bs].abs().max()) == 0.0,
                  f"sweep: bsr_spmm {dt} bs {bs} d {d}: the empty row")
            e = rel_err(got, want)
            check(e <= FFN_REL, f"sweep: bsr_spmm {dt} bs {bs} d {d}: {e}")
            cases += 1
        for n_brows, bs, d in BSR_MULTITILE:
            args, lens = bsr_multitile_operands(n_brows, bs, d, dt, randn,
                                                randint)
            case = f"sweep: bsr_spmm {dt} {n_brows} rows bs {bs} d {d}"
            got, _ = routed_call("bsr_spmm",
                                 lambda: spgemm_bsr.bsr_spmm(*args),
                                 spgemm_bsr.route(dt))
            want = spgemm_bsr.bsr_spmm_plain(*args)
            empty = torch.tensor(lens, device="cuda") == 0
            check(bool(torch.isfinite(got).all()) and float(
                got.view(n_brows, bs, d)[empty].abs().max()) == 0.0,
                f"{case}: the empty rows")
            e = rel_err(got, want)
            check(e <= FFN_REL, f"{case}: {e}")
            cases += 1
        for n, k, dff, d, ids in ((4, 2, 16, 8, "clipped"),
                                  (16, 4, 64, 128, "clipped"),
                                  (3, 8, 32, 16, "clipped"),
                                  (5, 300, 40, 1100, "clipped")) + k5_edges():
            v, w2 = randn(n, k, dtype=dt), randn(dff, d, dtype=dt)
            idx = randint(dff + 3, n, k, lo=-3)
            if ids == "repeat":  # every token names one row twice, or more
                idx[:, 1::3] = idx[:, :1]
            case = f"sweep: topk_spmm {dt} {(n, k, dff, d)} {ids}"
            got, _ = routed_call("topk_spmm",
                                 lambda: topk_spmm.topk_spmm(v, idx, w2),
                                 topk_spmm.topk_spmm_route(dff, dt))
            check(torch.equal(got, topk_spmm.topk_spmm_plain(v, idx, w2)),
                  case)
            cases += 1
        for nt, kb, tile, block, d, ids in K6_EDGES:
            h, w2 = randn(nt, kb, tile, block, dtype=dt), randn(
                (kb + 2) * block, d, dtype=dt)
            bidx = k6_ids(ids, nt, kb, randint)
            case = f"sweep: block_topk_spmm {dt} {(nt, kb, tile, block, d)} {ids}"
            got, _ = routed_call(
                "block_topk_spmm",
                lambda: topk_spmm.block_topk_spmm(h, bidx, w2, block),
                topk_spmm.route(dt))
            e = rel_err(got, topk_spmm.block_topk_spmm_plain(h, bidx, w2,
                                                             block))
            check(e <= FFN_REL, f"{case}: {e}")
            check(torch.equal(got, topk_spmm.block_topk_spmm(h, bidx, w2,
                                                             block)),
                  f"{case}: a repeat differs")
            cases += 1
    for dt, nb, r, d, n, off, path in RANGED_ROUTES:
        dt = getattr(torch, dt)
        x = randn(nb * r * d + off, dtype=dt)[off:].view(nb * r, d)
        idx = randint(nb + 2, n, lo=-2)
        case = f"sweep: aia_ranged_gather {dt} {(nb, r, d, n, off)}"
        check(aia_gather.ranged_route(r * d * x.element_size(),
                                      x.data_ptr()) == path,
              f"{case}: not the {path} route")
        got, _ = routed_call("aia_ranged_gather",
                             lambda: aia_gather.aia_ranged_gather(x, idx, r),
                             path)
        check(torch.equal(got, aia_gather.aia_ranged_gather_plain(x, idx, r)),
              case)
        cases += 1
    emit({"ffn_shape_sweep": {"cases": cases, "ok": True}}, log)


def k5_edges():
    """K5's edges, both dtypes: (n, k, d_ff, d, ids) with ids clipped at both
    ends ("clipped") or each token naming one row again and again
    ("repeat").  d_ff at the ``"smem"`` route's limit and one past it (the
    ``"l2"`` route); k not a multiple of a chunk's steps (16 bf16, 8
    float32) and a chunk of one step; fewer tokens than a warp; d of 7 and 1,100 (the
    last slice ragged, rows not whole 16-byte slices) and 3,075; 1,100
    tokens (five groups of 256, the last ragged) over 5 column slices in
    bf16."""
    from repro_torch.kernels import topk_spmm
    from repro_torch.kernels._build import source_constants

    c = source_constants("topk_spmm_smem.cu")
    limit = (c["kMaxSmem"] - topk_spmm.topk_spmm_smem_bytes(0)) \
        // c["kSliceBytes"]
    check(topk_spmm.topk_spmm_route(limit) == "smem"
          and topk_spmm.topk_spmm_route(limit + 1) == "l2",
          f"K5: d_ff {limit} is not the smem route's limit")
    return ((40, 20, limit, 24, "clipped"), (40, 20, limit + 1, 24, "repeat"),
            (3, 13, 64, 7, "repeat"), (31, 301, 96, 1100, "clipped"),
            (1100, 33, 500, 40, "repeat"), (600, 9, 128, 3075, "clipped"),
            (2, 1, 16, 16, "clipped"))


# K6 (block_topk_spmm), every dtype (bf16 and float16: the wgmma kernel of
# csrc/block_topk_spmm_wgmma.cu; float32: the CUDA-core kernel), each call
# the same bits on a repeat: (n_tiles,
# kb, tile, block, d, ids) over kb + 2 blocks of W2.  ids "clipped": random
# in [-1, kb + 4), clipped at both ends; "repeat": the same, with tile 0
# naming one block twice; "unpicked": ids below kb only, so two blocks go
# unpicked; "every": every tile picks block 1 (300 tiles x 8 rows, far past
# one 64-row chunk).  Blocks 8-128 (24 and 12: not a panel's width; 12:
# element-wise staging of h), tile 11 and tile 1, d 7 (element-wise W2
# staging, scalar atomics) and 2,050 (17 column slices, the last ragged).
K6_EDGES = (
    (2, 2, 8, 16, 32, "clipped"), (4, 3, 8, 128, 64, "clipped"),
    (1, 1, 8, 8, 8, "clipped"), (3, 2, 11, 24, 600, "clipped"),
    (5, 3, 8, 16, 40, "repeat"), (6, 4, 1, 16, 40, "clipped"),
    (4, 3, 5, 12, 33, "unpicked"), (300, 2, 8, 16, 64, "every"),
    (4, 3, 8, 128, 7, "clipped"), (4, 3, 8, 128, 2050, "repeat"),
    # past the wgmma kernel's depth panel of 256 lanes (two and eight
    # panels), and past the CUDA-core kernel's one panel of 1,536 lanes
    (3, 2, 8, 512, 64, "clipped"), (2, 2, 8, 2048, 40, "repeat"),
)


def k6_ids(kind, nt, kb, randint):
    """bidx (nt, kb) for a K6_EDGES case."""
    if kind == "unpicked":
        return randint(kb, nt, kb)
    bidx = randint(kb + 4, nt, kb, lo=-1)
    if kind == "repeat":
        bidx[0, 1] = bidx[0, 0]
    elif kind == "every":
        bidx[:, 0] = 1
    return bidx


FFN_KERNELS = ("aia_ranged_gather", "bsr_spmm", "topk_spmm",
               "block_topk_spmm")
# the route each routed kernel takes on the path: W2's ranges are whole
# 16-byte vectors; the BSR, h and W2 are bf16
FFN_ROUTES = {"aia_ranged_gather": "v16", "bsr_spmm": "wgmma",
              "topk_spmm": "smem", "block_topk_spmm": "wgmma"}
# kernel, its CUDA source, the TPU kernel it replaces
FFN_SOURCES = (
    ("aia_ranged_gather", "aia_gather.cu",
     "src/repro/kernels/aia_gather.py:47"),
    ("bsr_spmm", "bsr_spmm_wgmma.cu", "src/repro/kernels/spgemm_bsr.py:46"),
    ("topk_spmm", "topk_spmm_smem.cu", "src/repro/kernels/topk_spmm.py:40"),
    ("block_topk_spmm", "block_topk_spmm_wgmma.cu",
     "src/repro/kernels/topk_spmm.py:74"),
)
# the CUDA-core kernel of a routed kernel's float32 calls, and the kernel
# of K5's calls whose W2 slice does not fit shared memory
FLOAT32_SOURCES = {"bsr_spmm": "bsr_spmm.cu",
                   "block_topk_spmm": "topk_spmm.cu"}
L2_SOURCES = {"topk_spmm": "topk_spmm.cu"}


def bound(nbytes: int, flops: int, dtype) -> tuple:
    """(bound ms, what binds) for ``nbytes`` at the memory rate and
    ``flops`` at the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def hold(name, kernel, plain, exact):
    """One kernel call against its plain version on the same inputs: the
    call adds exactly one launch, and agrees (bit for bit where ``exact``,
    else within FFN_REL of the largest |value|)."""
    import torch

    from repro_torch.kernels import ops

    before = ops.launch_counts()[name]
    got = kernel()
    torch.cuda.synchronize()
    check(ops.launch_counts()[name] == before + 1,
          f"{name}: one call launched {ops.launch_counts()[name] - before}")
    want = plain()
    if torch.equal(got, want):
        return {"max_abs_err": 0.0, "rel_err": 0.0, "bit_exact": True}
    check(not exact, f"{name} differs from its plain version")
    rel = rel_err(got, want)
    check(rel <= FFN_REL, f"{name}: {rel} > {FFN_REL} of the plain version")
    return {"max_abs_err": float((got.double() - want.double()).abs().max()),
            "rel_err": rel, "bit_exact": False}


def library_call(calls):
    """Time the first of ``calls`` (label, fn) that PyTorch accepts; the
    labels of refused ones are kept with their errors."""
    refused = {}
    for label, fn in calls:
        try:
            fn()
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            refused[label] = str(exc).splitlines()[0][:200]
            continue
        return {"library_call": label, "library_ms": time_ms(fn, reps=10),
                "library_device_ms": device_ms(fn, reps=5),
                "library_refused": refused}
    return {"library_call": None, "library_ms": None,
            "library_refused": refused}


def launch_config(fn, kernel: str) -> dict:
    """How one call of ``fn`` launched the kernel whose name holds
    ``kernel``, as the profiler's trace records that launch: shared memory
    a block (static and dynamic), registers a thread, grid and block; {}
    when the trace holds no such launch."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    for ev in events:
        if ev.get("cat") == "kernel" and kernel in ev.get("name", ""):
            args = ev.get("args", {})
            return {"shared_memory_bytes": args.get("shared memory"),
                    "registers": args.get("registers per thread"),
                    "grid": args.get("grid"), "block": args.get("block")}
    return {}


def ffn_kernel_records(out, w2, launches, log):
    """Each kernel of the path held (called through its ``ops`` wrapper),
    timed and bounded on the path's own inputs; the bounds count what these
    inputs need (distinct W2 rows or blocks, the B block rows the BSR
    names, the blocks kept)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import aia_gather, ops, spgemm_bsr, topk_spmm

    n, d, f = FFN["tokens"], FFN["d_model"], FFN["d_ff"]
    block, tile, keep = FFN["block"], FFN["tile"], FFN["bsr_keep"]
    nt, kb = n // tile, FFN["k"] // block
    tk, h_kept, bidx, bsr, xt = (out[k] for k in
                                 ("tk", "h_kept", "bidx", "bsr", "xt"))
    vals, idx = tk.values, tk.indices
    flat = bidx.reshape(-1)
    el = w2.element_size()
    nnzb = int(bsr.nnzb)
    row_len = (bsr.indptr[1:] - bsr.indptr[:-1]).clamp(max=keep)
    used = int(row_len.sum())
    b_blocks = int(torch.unique(bsr.indices[:nnzb]).numel())
    w2_view = w2.view(f // block, block * d)
    hk_flat = h_kept.permute(0, 2, 1, 3).reshape(nt, tile, kb * block)
    sel_view = out["w2_sel"].view(nt, kb * block, d)
    with warnings.catch_warnings():  # "sparse BSR support is in beta"
        warnings.simplefilter("ignore")
        lib_bsr = {dt: (torch.sparse_bsr_tensor(
            bsr.indptr, bsr.indices[:nnzb], bsr.blocks[:nnzb].to(dt),
            size=bsr.shape, check_invariants=False), xt.to(dt))
            for dt in (torch.bfloat16, torch.float32)}

    specs = {
        "aia_ranged_gather": dict(
            kernel=lambda: ops.aia_ranged_gather(w2, flat, block),
            plain=lambda: aia_gather.aia_ranged_gather_plain(w2, flat, block),
            exact=True, reps=(10, 3), dtype=w2.dtype,
            nbytes=int(torch.unique(flat).numel()) * block * d * el
            + flat.numel() * (block * d * el + 4), flops=0,
            library=[("index_select on the (n_blocks, R*d) view",
                      lambda: torch.index_select(w2_view, 0, flat.long()))],
            shape={"x": list(w2.shape), "r": block, "n_idx": flat.numel(),
                   "out_gb": flat.numel() * block * d * el / 1e9},
            route=aia_gather.ranged_route(block * d * el, w2.data_ptr()),
            ptxas="ranged_gather_v16_kernel"),
        "bsr_spmm": dict(
            kernel=lambda: ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks,
                                        xt, keep),
            plain=lambda: spgemm_bsr.bsr_spmm_plain(bsr.indptr, bsr.indices,
                                                    bsr.blocks, xt, keep),
            exact=False, reps=(10, 3), dtype=bsr.blocks.dtype,
            nbytes=(bsr.n_brows + 1) * 4 + used * (4 + block * block * el)
            + b_blocks * block * n * el + f * n * 4,
            flops=2 * used * block * block * n,
            library=[(f"torch.sparse_bsr_tensor({dt}) @ b",
                      lambda dt=dt: lib_bsr[dt][0] @ lib_bsr[dt][1])
                     for dt in lib_bsr],
            shape={"a": list(bsr.shape), "block": block, "nnzb": nnzb,
                   "b": list(xt.shape)},
            route=spgemm_bsr.route(bsr.blocks.dtype),
            ptxas="bsr_spmm_wgmma_kernel"),
        "topk_spmm": dict(
            kernel=lambda: ops.topk_spmm(vals, idx, w2),
            plain=lambda: topk_spmm.topk_spmm_plain(vals, idx, w2),
            exact=True, reps=(10, 1), dtype=vals.dtype,
            nbytes=vals.numel() * (el + 4)
            + int(torch.unique(idx).numel()) * d * el + n * d * 4,
            flops=2 * vals.numel() * d,
            library=[("F.embedding_bag(mode='sum', per_sample_weights)",
                      lambda: F.embedding_bag(idx, w2,
                                              per_sample_weights=vals,
                                              mode="sum"))],
            shape={"vals": list(vals.shape), "w2": list(w2.shape)},
            route=topk_spmm.topk_spmm_route(f),
            ptxas="topk_smem_kernelIt",  # the bf16 instantiation
            trace="topk_smem_kernel<unsigned short"),
        "block_topk_spmm": dict(
            kernel=lambda: ops.block_topk_spmm(h_kept, bidx, w2, block),
            plain=lambda: topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2,
                                                          block),
            exact=False, reps=(10, 3), dtype=h_kept.dtype,
            nbytes=h_kept.numel() * el + bidx.numel() * 4
            + int(torch.unique(bidx).numel()) * block * d * el + n * d * 4,
            flops=2 * h_kept.numel() * d,
            library=[("torch.bmm on the pre-gathered blocks (gather "
                      "excluded)", lambda: torch.bmm(hk_flat, sel_view))],
            shape={"h_kept": list(h_kept.shape), "w2": list(w2.shape)},
            route=topk_spmm.route(h_kept.dtype),
            ptxas=("block_topk_wgmma_kernel", "nv_bfloat16"),
            trace="block_topk_wgmma_kernel"),
    }
    recs = {}
    for name, sp in specs.items():
        rec = {"name": name, "launches": launches[name], "shape": sp["shape"]}
        if "route" in sp:
            rec["route"] = sp["route"]
            rec["ptxas"] = ptxas_report(sp["ptxas"])
        rec.update(hold(name, sp["kernel"], sp["plain"], sp["exact"]))
        if name == "block_topk_spmm":  # a fixed order of sums
            first = sp["kernel"]()
            check(torch.equal(first, sp["kernel"]()),
                  "block_topk_spmm: a repeat differs")
            rec["repeat_bit_identical"] = True
            del first
            rec["cuda_cores_ms"] = time_ms(
                lambda: topk_spmm._block_topk_spmm_cuda(
                    h_kept, bidx, w2, block, path="cuda_cores"), reps=3)
        reps, plain_reps = sp["reps"]
        rec["ms"] = time_ms(sp["kernel"], reps=reps)
        # device time per call: every launch of the call (K6's 16-bit
        # route: the selection's inversion, the products into the
        # workspace and the ordered sum into y), and the largest kernel's
        # own mean
        _, dev, top = profile(lambda: [sp["kernel"]() for _ in range(5)])
        rec["device_ms"] = None if dev is None else dev / 5
        rec["kernel_device_ms"] = top[0][1] / top[0][2] if top else None
        rec["device_launches_recorded"] = top[0][2] if top else 0
        rec["device_kernels"] = [(k, ms / n) for k, ms, n in top]
        rec["plain_ms"] = time_ms(sp["plain"], reps=plain_reps, warmup=0)
        rec["plain_device_ms"] = device_ms(sp["plain"], reps=1)
        rec["bound_ms"], rec["bound_by"] = bound(sp["nbytes"], sp["flops"],
                                                 sp["dtype"])
        rec["bytes"], rec["flops"] = sp["nbytes"], sp["flops"]
        rec.update(library_call(sp["library"]))
        if "route" in sp:
            rec["launch"] = launch_config(sp["kernel"],
                                          sp.get("trace", sp["ptxas"]))
        if name in ("bsr_spmm", "block_topk_spmm"):
            rec["tflops"] = sp["flops"] / rec["device_ms"] / 1e9 \
                if rec["device_ms"] else None
        emit({"ffn_kernel": rec}, log)
        recs[name] = rec
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# Phase 4: K7 (flash attention) against its plain version, then timed
# ---------------------------------------------------------------------------

# tests/test_flash_kernel.py's shapes (bh, s, d, q_blk, k_blk), then
# Phi-3-mini's prefill: batch 2 x 32 heads, 4,096 tokens, head dim 96, bf16
FLASH_CASES = ((2, 64, 32, 16, 16), (1, 128, 64, 32, 64), (3, 32, 16, 32, 16))
# the bf16 kernel's edges: D = 7 (odd: element-wise staging, scalar
# stores), 36 (even, not a multiple of 8: element-wise staging, paired
# stores), 40 (one panel, padded), 96 (two panels, the second half used),
# 128; S = 64 (one kv tile, half a query block) and 192 (a partial query
# block); q_blk = k_blk = 64 for the divisibility contract
FLASH_EDGES = tuple((2, s, d, 64, 64) for d in (7, 36, 40, 96, 128)
                    for s in (64, 192))
# the float32 kernel at the decode check's shape (1 x 32 heads, a 512-token
# prompt, D 96)
FLASH_F32 = ((32, 512, 96, 128, 128),)
FLASH_PHI3 = (64, 4096, 96, 128, 128)
# MLA's widths (DeepSeek-V2-Lite: qk 128 + 64 rope lanes, v 128), as
# (bh, s, d, dv, q_blk, k_blk): the CPU tests' shapes, then S 64 and 192
# with blocks of 64; both dtypes, causal and not
FLASH_MLA_CASES = tuple((bh, s, 192, 128, qb, kb)
                        for bh, s, _, qb, kb in FLASH_CASES) \
    + ((2, 64, 192, 128, 64, 64), (2, 192, 192, 128, 64, 64))
# the other (qk, v) kernels of the two widths: (192, 192) and (160, 150)
# (the DQ-wide accumulator), (150, 100) (element-wise staging into the
# (160, 128) kernel), (136, 72) (16-byte staging, V zero-filled past 72),
# (128, 64) (the 128-wide kernel, V zero-filled)
FLASH_WIDTH_EDGES = tuple((2, s, d, dv, 64, 64)
                          for d, dv in ((192, 192), (160, 150), (150, 100),
                                        (136, 72), (128, 64))
                          for s in (64, 192))
# DeepSeek-V2-Lite's prefill: batch 2 x 16 heads, 4,096 tokens, bf16
FLASH_MLA = (32, 4096, 192, 128, 128, 128)
# (rtol, atol) against the plain version: float32 sums in another order;
# a bf16 output is rounded once, so a sum near a rounding boundary may round
# the other way, one bf16 step (2**-7 of the value)
FLASH_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (2 ** -7, 1e-6),
             "torch.float16": (2 ** -10, 1e-6)}
# K7's masked contract (ops.flash_attention_masked), as (bh, sq, sk, d,
# causal, window, q_offset, kv_len): windows of 1, 64, 100 and 4,096 at S
# 192 and 8,192, causal (window 1: each query's one key, its first tiles
# all masked); Whisper's unequal lengths without a mask (1, 7, 448 and
# 1,500 queries against 1,500 keys); a key limit below Sk, a query offset
# with Sq < Sk (causal, and with a window); ragged S of 1 and 1,500; a
# window at D 128
FLASH_MASK_CASES = tuple((2, s, s, 64, True, w, 0, None)
                         for w in (1, 64, 100, 4096) for s in (192, 8192)) \
    + tuple((2, sq, 1500, 64, False, 0, 0, None)
            for sq in (1, 7, 448, 1500)) \
    + ((2, 448, 1500, 64, True, 0, 1052, 1400),
       (2, 300, 1500, 64, False, 0, 0, 1000),
       (2, 448, 1500, 64, True, 256, 1052, None),
       (2, 1, 1, 64, True, 0, 0, None), (2, 1500, 1500, 64, True, 0, 0, None),
       (2, 1500, 1500, 128, True, 100, 0, None))
# the masked calls of the new families' prefills, timed: (name, bh, sq, sk,
# d, causal, window, heads): Whisper's encoder (2 x 20 heads over 1,500
# frames, no mask) and cross-attention (448 decoder queries against them),
# Zamba2's shared block (1 x 32 heads, 8,192 tokens, window 4,096)
FLASH_TIMED = (("whisper_encoder", 40, 1500, 1500, 64, False, 0, 20),
               ("whisper_cross", 40, 448, 1500, 64, False, 0, 20),
               ("zamba2_shared", 32, 8192, 8192, 64, True, 4096, 32))


def flash_check(got, want, case) -> float:
    """``got`` within FLASH_TOL of ``want``, of its dtype and shape; the
    max |error|."""
    rtol, atol = FLASH_TOL[str(want.dtype)]
    diff = (got.double() - want.double()).abs()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"flash_attention_fused {case}: {got.dtype} {tuple(got.shape)}")
    check(bool((diff <= atol + rtol * want.double().abs()).all()),
          f"flash_attention_fused {case}: max |error| {float(diff.max())} "
          f"beyond rtol {rtol} atol {atol} of its plain version")
    return float(diff.max())


def one_launch(fn):
    """``fn()``, checked to launch K7 exactly once."""
    import torch

    from repro_torch.kernels import ops

    before = ops.launch_counts()["flash_attention_fused"]
    out = fn()
    torch.cuda.synchronize()
    n = ops.launch_counts()["flash_attention_fused"] - before
    check(n == 1, f"flash_attention_fused: one call launched {n}")
    return out


def flash_hold(q, k, v, causal, q_blk, k_blk):
    """One K7 call through ``ops`` against its plain version on the same
    inputs: exactly one launch, and within FLASH_TOL; the max |error|."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    got = one_launch(lambda: ops.flash_attention_fused(q, k, v, causal,
                                                       q_blk, k_blk))
    want = k7.flash_attention_fused_plain(q, k, v, causal, q_blk, k_blk)
    return flash_check(got, want, (str(q.dtype), causal, tuple(q.shape),
                                   tuple(v.shape), q_blk, k_blk))


def flash_hold_masked(q, k, v, causal, window, q_offset, kv_len):
    """One masked K7 call against its plain version, as ``flash_hold``."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    args = (causal, window, q_offset, kv_len)
    got = one_launch(lambda: ops.flash_attention_masked(q, k, v, *args))
    want = k7.flash_attention_masked_plain(q, k, v, *args)
    return flash_check(got, want, (str(q.dtype), tuple(q.shape),
                                   tuple(k.shape), *args))


def valid_pairs(sq, sk, causal, window, q_offset=0, kv_len=None) -> int:
    """The (query, key) pairs a masked call's mask lets through, per head:
    query i sees the keys [lo(i), hi(i))."""
    kvl = sk if kv_len is None else min(kv_len, sk)
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(kvl, pos + 1) if causal else np.full(sq, kvl)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum())


def flash_timed(q, k, v, heads: int, qb: int, kb: int) -> dict:
    """K7 held and timed on causal bf16 (BH, S, D) q, k and (BH, S, Dv) v
    beside its bound (operations), its plain version and
    ``scaled_dot_product_attention`` on (BH / heads, heads, S, .)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    bh, s, d = q.shape
    dv = v.shape[2]
    rec = {"name": "flash_attention_fused", "route": k7.route(q.dtype),
           "shape": {"bh": bh, "s": s, "d": d, "dv": dv,
                     "dtype": "bfloat16", "causal": True},
           "max_abs_err": flash_hold(q, k, v, True, qb, kb)}

    def kernel():
        return ops.flash_attention_fused(q, k, v, True)

    def plain():
        return k7.flash_attention_fused_plain(q, k, v, True)

    q4, k4, v4 = (x.view(bh // heads, heads, s, x.shape[2])
                  for x in (q, k, v))
    rec["ms"] = time_ms(kernel, reps=10)
    _, _, top = profile(lambda: [kernel() for _ in range(5)])
    rec["device_ms"] = top[0][1] / top[0][2] if top else None
    rec["device_launches_recorded"] = top[0][2] if top else 0
    rec["plain_ms"] = time_ms(plain, reps=3)
    rec["plain_device_ms"] = device_ms(plain, reps=1)
    # what this causal call needs: Q.K^T (D wide) and P.V (Dv wide) over the
    # s(s+1)/2 pairs on and below the diagonal (2 FLOP per multiply-add);
    # q, k, v read once and o written once
    pairs = bh * s * (s + 1) // 2
    rec["flops"] = 2 * pairs * (d + dv)
    rec["bytes"] = bh * s * (2 * d + 2 * dv) * q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             q.dtype)
    rec["tflops"] = rec["flops"] / rec["device_ms"] / 1e9 \
        if rec["device_ms"] else None
    # what the tensor cores do: Q.K^T once, P.V once for each bf16 term of P
    consts = k7.wgmma_constants()
    rec["tensor_flops"] = 2 * pairs * (d + consts["kPTerms"] * dv)
    rec["tensor_bound_ms"] = bound(0, rec["tensor_flops"], q.dtype)[0]
    rec["ptxas"] = ptxas_report(
        "flash_wgmma_kernelI13__nv_bfloat16Li{}ELi{}ELi{}E".format(
            *k7.wgmma_widths(d, dv), consts["kPTerms"]))
    rec["launch"] = launch_config(kernel, "flash_wgmma_kernel")
    rec.update(library_call([(
        f"F.scaled_dot_product_attention(is_causal=True) on "
        f"({bh // heads}, {heads}, s, d|dv)",
        lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                               is_causal=True))]))
    return rec


def flash_timed_masked(name, bh, sq, sk, d, causal, window, heads,
                       rand) -> dict:
    """Masked K7 held and timed on bf16 (BH, Sq, D) q and (BH, Sk, D) k and
    v beside its bound (operations over the pairs the mask lets through),
    its plain version and ``scaled_dot_product_attention`` with the same
    mask on (BH / heads, heads, S, D)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    q = rand((bh, sq, d), torch.bfloat16, 1)[0]
    k, v = rand((bh, sk, d), torch.bfloat16, 2)
    rec = {"name": name, "route": k7.route(q.dtype),
           "shape": {"bh": bh, "sq": sq, "sk": sk, "d": d, "dv": d,
                     "dtype": "bfloat16", "causal": causal,
                     "window": window},
           "max_abs_err": flash_hold_masked(q, k, v, causal, window, 0,
                                            None)}

    def kernel():
        return ops.flash_attention_masked(q, k, v, causal, window)

    def plain():
        return k7.flash_attention_masked_plain(q, k, v, causal, window)

    rec["ms"] = time_ms(kernel, reps=10)
    _, _, top = profile(lambda: [kernel() for _ in range(5)])
    rec["device_ms"] = top[0][1] / top[0][2] if top else None
    rec["plain_ms"] = time_ms(plain, reps=3)
    # Q.K^T and P.V over the pairs the mask lets through; q, k, v read
    # once and o written once
    pairs = bh * valid_pairs(sq, sk, causal, window)
    rec["pairs"] = pairs
    rec["flops"] = 4 * pairs * d
    rec["bytes"] = bh * (2 * sq * d + 2 * sk * d) * q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             q.dtype)
    if window:  # the same call without its window
        rec["bound_ms_unwindowed"] = bound(
            rec["bytes"], 4 * bh * valid_pairs(sq, sk, causal, 0) * d,
            q.dtype)[0]
    rec["tflops"] = rec["flops"] / rec["device_ms"] / 1e9 \
        if rec["device_ms"] else None
    q4 = q.view(bh // heads, heads, sq, d)
    k4, v4 = (x.view(bh // heads, heads, sk, d) for x in (k, v))
    mask = None
    if causal or window:
        qpos = torch.arange(sq, device="cuda")[:, None]
        kpos = torch.arange(sk, device="cuda")[None, :]
        mask = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        if window:
            mask = mask & (kpos > qpos - window)
    rec.update(library_call([(
        f"F.scaled_dot_product_attention on ({bh // heads}, {heads}, s, d)"
        + (", a boolean mask" if mask is not None else ""),
        lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                               attn_mask=mask))]))
    return rec


def flash_phase(log):
    """Hold K7 against its plain version on the 12 cases of the reference's
    kernel test, the bf16 kernel's tile edges, MLA's widths (qk 192, v 128)
    and the other widths of the two-width kernels, and its masked contract
    on ``FLASH_MASK_CASES`` in both dtypes; then time it at the Phi-3 and
    DeepSeek-V2-Lite prefill shapes and at the masked shapes of
    ``FLASH_TIMED`` beside its bound, its plain version and
    ``scaled_dot_product_attention``; then hold and time the float32 route
    at the Phi-3 shape beside the CUDA-core kernel and SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype, n=3):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(n)]

    errs = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for causal in (True, False):
            cases = FLASH_CASES + (FLASH_EDGES if dt == torch.bfloat16
                                   else FLASH_F32)
            for bh, s, d, qb, kb in cases:
                errs[f"{dt}/{causal}/{bh}x{s}x{d}"] = flash_hold(
                    *rand((bh, s, d), dt), causal, qb, kb)
            for bh, s, d, dv, qb, kb in FLASH_MLA_CASES + FLASH_WIDTH_EDGES:
                q, k = rand((bh, s, d), dt, 2)
                errs[f"{dt}/{causal}/{bh}x{s}x{d}/v{dv}"] = flash_hold(
                    q, k, rand((bh, s, dv), dt, 1)[0], causal, qb, kb)
    emit({"flash_cases": {"cases": len(errs), "max_abs_err": errs}}, log)
    masked = {}
    for dt in (torch.float32, torch.bfloat16):
        for bh, sq, sk, d, causal, window, off, kvl in FLASH_MASK_CASES:
            q = rand((bh, sq, d), dt, 1)[0]
            k, v = rand((bh, sk, d), dt, 2)
            masked[f"{dt}/{bh}x{sq}x{sk}x{d}/causal={causal}/window="
                   f"{window}/q_offset={off}/kv_len={kvl}"] = \
                flash_hold_masked(q, k, v, causal, window, off, kvl)
    del q, k, v
    emit({"flash_mask_cases": {"cases": len(masked),
                               "max_abs_err": masked}}, log)

    bh, s, d, qb, kb = FLASH_PHI3
    q, k, v = rand((bh, s, d), torch.bfloat16)
    rec = flash_timed(q, k, v, 32, qb, kb)
    emit({"flash_kernel": rec}, log)

    # the float32 route at the same shape (the tensor cores: Q, K, V and P
    # in three bf16 terms), beside the CUDA-core kernel and SDPA on the
    # same inputs
    q, k, v = (x.float() for x in (q, k, v))

    def kernel():
        return ops.flash_attention_fused(q, k, v, True)

    f32 = {"route": k7.route(q.dtype, d, d),
           "shape": {"bh": bh, "s": s, "d": d, "dv": d, "dtype": "float32",
                     "causal": True},
           "max_abs_err": flash_hold(q, k, v, True, qb, kb),
           "ms": time_ms(kernel, reps=3)}
    first = kernel()
    check(torch.equal(first, kernel()),
          "flash_attention_fused float32: a repeat differs")
    f32["repeat_bit_identical"] = True
    del first
    # every launch of the call: the pass that splits q, k and v into their
    # terms, and the attention kernel
    _, dev, top = profile(lambda: [kernel() for _ in range(3)])
    f32["device_ms"] = None if dev is None else dev / 3
    f32["device_kernels"] = [(name, ms / n) for name, ms, n in top]
    f32["cuda_cores_ms"] = time_ms(lambda: k7._launch(
        q, k, v, True, 0, 0, s, path="cuda_cores"), reps=2)
    pairs = bh * s * (s + 1) // 2
    f32["flops"] = 4 * pairs * d
    f32["bytes"] = 4 * bh * s * d * q.element_size()
    f32["bound_ms"], f32["bound_by"] = bound(f32["bytes"], f32["flops"],
                                             q.dtype)
    # what the tensor cores do: the term products i + j < kF32Terms
    terms = k7.f32_constants()["kF32Terms"]
    f32["tensor_flops"] = terms * (terms + 1) // 2 * f32["flops"]
    f32["tensor_bound_ms"] = bound(0, f32["tensor_flops"],
                                   torch.bfloat16)[0]
    f32["ptxas"] = ptxas_report(f"flash_f32_kernelILi{-(-d // 32) * 32}E")
    q4, k4, v4 = (x.view(bh // 32, 32, s, d) for x in (q, k, v))
    f32.update(library_call([(
        "F.scaled_dot_product_attention(is_causal=True) on "
        f"({bh // 32}, 32, s, d), float32",
        lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                               is_causal=True))]))
    emit({"flash_kernel_f32": f32}, log)
    del q, k, v, q4, k4, v4

    # MLA's prefill widths at DeepSeek-V2-Lite's prefill shape
    bh, s, d, dv, qb, kb = FLASH_MLA
    q, k = rand((bh, s, d), torch.bfloat16, 2)
    v = rand((bh, s, dv), torch.bfloat16, 1)[0]
    mla = flash_timed(q, k, v, 16, qb, kb)
    emit({"flash_kernel_mla": mla}, log)
    del q, k, v

    # the new families' masked shapes
    timed = {}
    for name, *shape in FLASH_TIMED:
        timed[name] = flash_timed_masked(name, *shape, rand)
        emit({f"flash_kernel_{name}": timed[name]}, log)
        torch.cuda.empty_cache()
    return rec, mla, {"cases": len(masked), "timed": timed, "float32": f32}


def ptxas_report(kernel) -> dict:
    """Registers, spills and static shared memory of the kernel whose
    mangled name holds ``kernel`` (a string, or a tuple of strings it holds
    all of), from ``ptxas -v`` in ``build.log``."""
    import re

    from repro_torch.kernels._build import build

    text = (build().parent / "build.log").read_text()
    blocks = text.split("Compiling entry function '")[1:]
    parts = (kernel,) if isinstance(kernel, str) else kernel
    for block in blocks:
        if all(part in block.split("'", 1)[0] for part in parts):
            nums = {k: int(v) for v, k in re.findall(
                r"(\d+) (bytes spill stores|bytes spill loads|registers|"
                r"bytes smem)", block)}
            return {"registers": nums.get("registers"),
                    "spill_stores": nums.get("bytes spill stores"),
                    "spill_loads": nums.get("bytes spill loads"),
                    "static_smem_bytes": nums.get("bytes smem", 0)}
    return {}


# ---------------------------------------------------------------------------
# Phase 5: the LM path at Phi-3-mini's full width and depth
# ---------------------------------------------------------------------------

# Phi-3-mini-4k: batch 2 x its 4,096-token context for the prefill forward;
# the decode check at full width, 4 layers, float32, on a 512-token prompt;
# the server: 4 requests of 4-6 prompt tokens x 8 new tokens
LM = {"arch": "phi3-mini-3.8b", "batch": 2, "seq": 4096,
      "p_dtype_prefill": True,
      "decode_layers": 4, "decode_prompt": 512,
      "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
# DeepSeek-V2-Lite (src/repro/configs/deepseek_v2_lite_16b.py: 27 layers,
# the first dense, MLA, 64 routed experts top-6 + 2 shared): the same
# prefill and server; the decode check at the prefix layer + 3 MoE layers
# in float32, at capacity_factor = n_experts / top_k so that the prefill
# drops no token (cap = T; a prefill that drops tokens differs from decode
# by design)
DS = {"arch": "deepseek-v2-lite-16b", "batch": 2, "seq": 4096,
      "decode_layers": 4, "decode_prompt": 512, "no_drop": True,
      "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
# Zamba2-1.2B (src/repro/configs/zamba2_1_2b.py: 38 Mamba2 layers, the
# shared attention + FFN block after every 6, window 4,096): a prefill of
# 1 x 8,192 tokens, so that the window masks (6 K7 launches); the decode
# check at 12 Mamba2 layers (2 shared applications)
ZAMBA = {"arch": "zamba2-1.2b", "batch": 1, "seq": 8192, "k7": 6,
         "decode_layers": 12, "decode_prompt": 512,
         "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
# RWKV6-1.6B (rwkv6_1_6b.py: 24 layers, attention-free): no K7 launch
RWKV = {"arch": "rwkv6-1.6b", "batch": 2, "seq": 4096, "k7": 0,
        "decode_layers": 4, "decode_prompt": 512,
        "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
# Whisper-large-v3 (whisper_large_v3.py: 32 encoder layers over 1,500 stub
# frames, 32 decoder layers with cross-attention): 2 x 448 decoder tokens
# (its text context) with 2 x 1,500 frames from the seed, 96 K7 launches;
# the decode check at 4 + 4 layers on a 448-token prompt, its cross caches
# filled from the encoder's output
WHISPER = {"arch": "whisper-large-v3", "batch": 2, "seq": 448, "k7": 96,
           "decode_layers": 4, "decode_prompt": 448,
           "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
# InternVL2-76B (internvl2_76b.py): its full width (d_model 8,192, 64 / 8
# heads, d_ff 28,672) cut to 2 of its 80 layers, a prefill of 1 x 4,096
# tokens with 256 stub patch embeddings; no server, no decode check
INTERNVL = {"arch": "internvl2-76b", "batch": 1, "seq": 4096, "k7": 2,
            "layers": 2, "serve": False, "decode": False,
            "reduced": {"layers": "2 of 80: the 80 layers' bf16 weights "
                        "take 141 GB, beyond one 80 GB card"}}
LM_LOSS_BAND = (-1.0, 2.0)  # around ln(vocab), for random weights
# decode logits against the prefill's last position, over the largest
# |logit|: float32 sums in other orders (GEMV against GEMM, the decode
# softmax against K7's online one) through 4 layers
DECODE_REL = 1e-4


def k7_per_forward(cfg, frames: bool) -> int:
    """K7 launches in one full-sequence forward of ``cfg``: one a layer's
    attention; Mamba2 stacks one a shared-block application, RWKV6 none;
    with ``frames``, Whisper's encoder layers and each decoder layer's
    cross-attention too."""
    from repro_torch.models.transformer import block_kind, n_shared_apps

    kind = block_kind(cfg)
    if kind == "M":
        return n_shared_apps(cfg)
    if kind == "R":
        return 0
    return cfg.n_layers + (cfg.encoder_layers + cfg.n_layers
                           if frames and cfg.encoder_layers else 0)


def stub_inputs(cfg, batch: int, rng) -> dict:
    """The config's stub inputs from ``rng``, float32 on the card: Whisper's
    frame embeddings (B, encoder_seq, D), InternVL2's patch embeddings
    (B, vision_patches, D)."""
    import torch

    out = {}
    if cfg.encoder_layers:
        out["frames"] = (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.frontend == "vision_stub":
        out["vision_embeds"] = (batch, cfg.vision_patches, cfg.d_model)
    return {k: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .cuda() for k, shape in out.items()}


def lm_prefill(cfg, params, log, spec=LM, key="lm_prefill"):
    """``train_loss`` forward-only at batch x seq (with the config's stub
    inputs) with the counts from 0: ``k7_per_forward`` K7 launches, on the
    dtype's route, and the loss inside its band."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import train_loss

    rng = np.random.default_rng(0)
    shape = (spec["batch"], spec["seq"])
    batch = {name: torch.from_numpy(rng.integers(0, cfg.vocab, shape)
                                    .astype(np.int32)).cuda()
             for name in ("tokens", "labels")}
    batch.update(stub_inputs(cfg, spec["batch"], rng))
    k7_want = k7_per_forward(cfg, "frames" in batch)
    check(spec.get("k7", k7_want) == k7_want,
          f"{key}: the spec's {spec.get('k7')} K7 launches, the config's "
          f"{k7_want}")

    def forward():
        with torch.no_grad():
            return train_loss(cfg, params, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    loss = float(forward())
    ms = (time.perf_counter() - t0) * 1e3
    launches, routes = ops.launch_counts(), ops.route_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lnv = float(np.log(cfg.vocab))
    check(np.isfinite(loss), f"{key}: loss {loss}")
    check(lnv + LM_LOSS_BAND[0] <= loss <= lnv + LM_LOSS_BAND[1],
          f"{key}: loss {loss} outside ln(vocab) {lnv} {LM_LOSS_BAND}")
    p_dtype = torch.bfloat16 if cfg.attn_p_dtype == "bfloat16" else None
    path = ("flash_attention_fused/"
            f"{k7.route(cfg.activation_dtype, p_dtype=p_dtype)}")
    check(launches["flash_attention_fused"] == k7_want
          and routes.get(path, 0) == k7_want,
          f"{key}: {launches['flash_attention_fused']} K7 launches "
          f"({routes}), {k7_want} wanted")
    host_ms, dev_ms, top = profile(forward, top_n=12)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": spec["batch"], "seq": spec["seq"],
           "stub_inputs": {k: list(batch[k].shape) for k in batch
                           if k not in ("tokens", "labels")},
           "reduced": spec.get("reduced"), "loss": loss,
           "ln_vocab": lnv, "ms": ms, "launches": launches,
           "routes": routes, "peak_mem_gb": peak_gb,
           "tokens_per_s": spec["batch"] * spec["seq"] / (ms / 1e3),
           "profiled": {"host_ms": host_ms, "device_ms": dev_ms,
                        "device_busy_share": None if dev_ms is None
                        else dev_ms / host_ms, "top_kernels": top}}
    emit({key: rec}, log)
    return rec


def lm_serve(cfg, params, log, spec=LM, key="lm_serve"):
    """The ServeEngine answers its requests at full depth, with the counts
    from 0 (decode attention is plain PyTorch, so no kernel launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(0)
    eng = ServeEngine(cfg, params, batch_slots=spec["slots"],
                      max_seq=spec["max_seq"])
    for i in range(spec["requests"]):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4 + i % 3),
                           max_new_tokens=spec["new_tokens"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    done = eng.run()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    check(len(done) == spec["requests"]
          and all(len(r.out_tokens) == spec["new_tokens"]
                  and all(0 <= tok < cfg.vocab for tok in r.out_tokens)
                  for r in done), f"{key}: a request went unanswered")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = eng.steps
    # one more step over the engine's cache, profiled
    host_ms, dev_ms, top = profile(
        lambda: eng._step(np.zeros((spec["slots"], 1), np.int32)), top_n=8)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(done), "steps": steps, "ms": ms,
           "ms_per_decode_step": ms / steps, "launches": launches,
           "peak_mem_gb": peak_gb,
           "profiled_step": {"host_ms": host_ms, "device_ms": dev_ms,
                             "device_busy_share": None if dev_ms is None
                             else dev_ms / host_ms, "top_kernels": top},
           "out_tokens": [r.out_tokens for r in done]}
    emit({key: rec}, log)
    return rec


# A router logit (~N(0, 1) here) of the decode and of the prefill differ
# by float32 sums in another order (~1e-6); a token whose experts differ
# between the two must have had a gap this small between them
NEAR_TIE = 1e-4


@contextlib.contextmanager
def routed(forced=None):
    """Patch ``ffn.moe_route`` inside the block to record each call's
    experts (T, k) and float32 logits; with ``forced`` (one (T, k) expert
    tensor a call, in call order) route each call's tokens to those
    experts instead, with the gates of the call's own logits."""
    import torch

    from repro_torch.models import ffn

    real, calls = ffn.moe_route, []

    def route(p, xt, cfg):
        logits, idx, gates = real(p, xt, cfg)
        if forced is not None:
            idx = forced[len(calls)].to(idx.device)
            gates = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
        calls.append((idx, logits))
        return logits, idx, gates

    ffn.moe_route = route
    try:
        yield calls
    finally:
        ffn.moe_route = real


def route_gaps(logits, chosen):
    """{token: gap} for each token whose ``chosen`` experts are not the top
    k of its ``logits``: the k-th largest logit minus the smallest logit
    among the chosen ones."""
    import torch

    k = chosen.shape[1]
    top = torch.topk(logits, k, dim=-1)
    differ = (top.indices.sort(1).values != chosen.sort(1).values).any(1)
    gaps = top.values[:, -1] - torch.gather(logits, 1, chosen).min(1).values
    return {int(t): float(gaps[t]) for t in torch.nonzero(differ)[:, 0]}


def lm_decode_check(base, log, spec=LM, key="lm_decode_vs_prefill"):
    """Float32 at full width, ``decode_layers`` layers: the logits of
    ``decode_step`` after the prompt fed token by token against the
    prefill forward's last position.

    With MoE, the experts each token took in decode are compared with the
    prefill's.  Where a router near-tie (within NEAR_TIE) went the other
    way, the two are different computations by design; the check then
    names the tokens and holds decode against a prefill routed to decode's
    experts, each of which must lie within NEAR_TIE of that prefill's own
    top k."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.attention import gqa_cross_kv
    from repro_torch.models.transformer import (decode_step, encode,
                                                forward_hidden,
                                                init_decode_cache,
                                                init_transformer, is_moe,
                                                layer_params, n_prefix)

    cfg = dataclasses.replace(base, n_layers=spec["decode_layers"],
                              dtype="float32")
    reduced = {"layers": f"{cfg.n_layers} of {base.n_layers}",
               "dtype": f"float32 for {base.dtype}",
               "prompt": f"{spec['decode_prompt']} tokens"}
    if base.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=spec["decode_layers"])
        reduced["encoder_layers"] = \
            f"{cfg.encoder_layers} of {base.encoder_layers}"
    if spec.get("no_drop"):
        moe = base.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k))
        reduced["capacity_factor"] = (
            f"{cfg.moe.capacity_factor} (n_experts / top_k: cap = T, no "
            f"token dropped) for {moe.capacity_factor}")
    params = init_transformer(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n = spec["decode_prompt"]
    n_moe = cfg.n_layers - n_prefix(cfg) if is_moe(cfg) else 0
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))
                            .astype(np.int32)).cuda()
    stubs = stub_inputs(cfg, 1, rng)

    def prefill_logits():
        h, _ = forward_hidden(cfg, params, toks, **stubs)
        return (h[:, -1] @ params["lm_head"]).double()

    with torch.no_grad():
        ops.reset_launch_counts()  # this path's count starts here
        with routed() as pre_calls:
            prefill = prefill_logits()
        launches = ops.launch_counts()
        cache = init_decode_cache(cfg, 1, n, device="cuda")
        if "frames" in stubs:  # what a Whisper decoder attends to
            enc = encode(cfg, params, stubs["frames"])
            for i in range(cfg.n_layers):
                k, v = gqa_cross_kv(layer_params(params, i)["cross"], enc,
                                    cfg.n_kv_heads, cfg.hd)
                cache["cross_k"][i].copy_(k)
                cache["cross_v"][i].copy_(v)
            del enc
        torch.cuda.synchronize()
        with routed() as dec_calls:
            t0 = time.perf_counter()
            for i in range(n):
                logits, cache = decode_step(cfg, params, cache,
                                            toks[:, i:i + 1])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    decoded = logits[:, 0].double()
    rel = rel_err(decoded, prefill)
    k7_want = k7_per_forward(cfg, "frames" in stubs)
    check(launches["flash_attention_fused"] == k7_want,
          f"{key}: {launches['flash_attention_fused']} K7 launches, "
          f"{k7_want} wanted")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "reduced": reduced, "prompt": n, "rel_err": rel,
           "tolerance": DECODE_REL,
           "max_abs_err": float((decoded - prefill).abs().max()),
           "same_argmax": bool(decoded.argmax() == prefill.argmax()),
           "prefill_launches": launches, "decode_ms": ms,
           "ms_per_decode_step": ms / n}
    held = rel
    if n_moe:
        # each MoE layer's experts, token by token, as decode chose them
        dec = [torch.cat([dec_calls[i * n_moe + layer][0]
                          for i in range(n)]) for layer in range(n_moe)]
        flips = {layer: route_gaps(pre_calls[layer][1], dec[layer])
                 for layer in range(n_moe)}
        rec["router_flips"] = {f"moe layer {layer}": gaps
                               for layer, gaps in flips.items() if gaps}
        if rec["router_flips"]:
            with torch.no_grad(), routed(forced=dec) as f_calls:
                forced = prefill_logits()
            ties = {layer: route_gaps(f_calls[layer][1], dec[layer])
                    for layer in range(n_moe)}
            rec["forced_route_gaps"] = {f"moe layer {layer}": gaps
                                        for layer, gaps in ties.items()
                                        if gaps}
            worst = max((g for gaps in ties.values() for g in gaps.values()),
                        default=0.0)
            check(worst <= NEAR_TIE,
                  f"{key}: decode's experts are {worst} from the top k of "
                  f"the prefill routed to them (> NEAR_TIE {NEAR_TIE})")
            held = rec["rel_err_routed_as_decode"] = rel_err(decoded, forced)
    check(held <= DECODE_REL,
          f"{key}: decode vs prefill logits {held} > {DECODE_REL} of the "
          f"largest |logit| ({rec.get('router_flips')})")
    emit({key: rec}, log)
    return rec


def lm_phase(log, spec=LM, prefix="lm"):
    """One LM at full width and depth (or the depth of ``spec["layers"]``)
    in bf16 with random weights from a seeded generator: the prefill
    forward, then the server; then the float32 decode-against-prefill check
    at reduced depth (the last two unless the spec turns them off)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_transformer

    cfg = get_config(spec["arch"])
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_transformer(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    emit({f"{prefix}_init": {"arch": cfg.name, "layers": cfg.n_layers,
                             "seconds": time.perf_counter() - t0,
                             "param_gb": (torch.cuda.memory_allocated()
                                          - before) / 1e9}}, log)
    prefill = lm_prefill(cfg, params, log, spec, f"{prefix}_prefill")
    if spec.get("p_dtype_prefill"):  # the config's attn_p_dtype knob set
        lm_prefill(dataclasses.replace(cfg, attn_p_dtype="bfloat16"), params,
                   log, spec, f"{prefix}_prefill_p_dtype")
    serve = lm_serve(cfg, params, log, spec, f"{prefix}_serve") \
        if spec.get("serve", True) else None
    del params
    torch.cuda.empty_cache()
    decode = lm_decode_check(cfg, log, spec, f"{prefix}_decode_vs_prefill") \
        if spec.get("decode", True) else None
    torch.cuda.empty_cache()
    return prefill, serve, decode


def deepseek_phase(log):
    """DeepSeek-V2-Lite at full width and depth: MLA's prefill through K7 at
    qk 192 / v 128, the capacity-routed MoE FFN and the dense prefix layer;
    the server on MLA's absorbed decode; the float32 decode check."""
    return lm_phase(log, DS, "deepseek")


def families_phase(log) -> dict:
    """The remaining serving families, each the way ``lm_phase`` drives
    Phi-3: Zamba2 (Mamba2's plain SSD, the shared block's windowed K7),
    RWKV6 (the plain WKV, no K7), Whisper (the encoder's unmasked K7 over
    1,500 frames, the decoder's causal and cross K7), then InternVL2's
    vision stub at full width on 2 layers; their prefill records by
    family."""
    out = {}
    for name, spec in (("zamba2", ZAMBA), ("rwkv6", RWKV),
                       ("whisper", WHISPER), ("internvl2", INTERNVL)):
        out[name] = lm_phase(log, spec, name)[0]
    return out


# ---------------------------------------------------------------------------
# Phase 5d: training on the card (K7's backward, the train step, the
# trainer, checkpoints, the launcher)
# ---------------------------------------------------------------------------

# K7's backward held against its plain version, as (bh, sq, sk, d, dv,
# causal, window, q_offset, kv_len): FLASH_MASK_CASES (windows, Sq != Sk, a
# key limit, a query offset, ragged S, D 64 and 128), then D 96 (causal, and
# with a key limit), MLA's widths (qk 192 / v 128: causal, windowed, a key
# limit, and a causal query offset with Sq < Sk) and a causal query offset
# with Sq < Sk at D 64
FLASH_BWD_CASES = tuple((bh, sq, sk, d, d, c, w, off, kvl)
                        for bh, sq, sk, d, c, w, off, kvl in FLASH_MASK_CASES) \
    + ((2, 192, 192, 96, 96, True, 0, 0, None),
       (2, 200, 200, 96, 96, False, 0, 0, 150),
       (2, 192, 192, 192, 128, True, 0, 0, None),
       (2, 256, 256, 192, 128, True, 64, 0, None),
       (2, 300, 300, 192, 128, False, 0, 0, 200),
       (2, 100, 356, 192, 128, True, 0, 256, None),
       (2, 64, 200, 64, 64, True, 0, 136, None))
# dq, dk and dv against the plain backward on the same (q, k, v, o, lse,
# do): float32 sums in another order, within 1e-5 of the largest |value| of
# the call's three gradients (not of each: where a query sees one key, dq
# and dk are sums of dS = P (dP - Delta) = 0 up to rounding, and their own
# largest |value| is that rounding); a bf16 gradient is that float32 result
# rounded once to bf16, so it may sit one bf16 step (2**-7 of the value)
# from the plain version's rounding, plus the float32 gate
FLASH_BWD_F32 = 1e-5
FLASH_BWD_BF16_STEP = 2 ** -7
# one rounding step of each 16-bit type, of the value
LOWP_STEP = {"torch.bfloat16": FLASH_BWD_BF16_STEP, "torch.float16": 2 ** -10}
# the forward's float32 row log-sum-exp against the plain forward's, in both
# dtypes: scores summed in another order and the kernels' exp2/log2 (the bf16
# kernel's scores are exact products of bf16 values, as the plain version's
# are), within 1e-5 of max(1, the call's largest |lse|)
FLASH_LSE_F32 = 1e-5
# granite-3-2b (src/repro/configs/granite_3_2b.py): 40 layers, d_model
# 2,048, 32 / 8 heads of 64, d_ff 8,192, vocab 49,155, bf16; the reference
# launcher's optimizer (launch/train.py:56: AdamW, linear_warmup_cosine
# (3e-4, 20, steps), clip 1.0); a TokenPipeline of 2 x 2,048 tokens
TRAIN = {"arch": "granite-3-2b", "batch": 2, "seq": 2048, "lr": 3e-4,
         "warmup": 20, "warm_steps": 1, "timed_steps": 5,
         "grad_layers": 2, "grad_seq": 1024, "grad_rel": 1e-4,
         "trainer_layers": 2, "trainer_steps": 6, "checkpoint_every": 3,
         "fail_at": 4}
# DeepSeek-V2-Lite (src/repro/configs/deepseek_v2_lite_16b.py: MLA's qk 192
# / v 128, 64 routed experts top-6 + 2 shared, the first layer dense) at
# full width on 4 of its 27 layers, the dense layer and 3 MoE layers: the
# 27 layers hold 15.7 B parameters, 157 GB of bf16 weights and float32
# AdamW moments, twice the card's 80 GB; the 4 hold 2.25 B.  TRAIN's
# optimizer, batch and steps; the float32 gradient check on 2 layers (the
# dense layer and 1 MoE layer), the CPU routed to the card's experts
DS_TRAIN = {"arch": "deepseek-v2-lite-16b", "layers": 4,
            "reduced": {"layers": "4 of 27: the 27 layers' bf16 weights and "
                                  "float32 AdamW moments take 157 GB"},
            **{k: TRAIN[k] for k in ("batch", "seq", "lr", "warmup",
                                     "warm_steps", "timed_steps",
                                     "grad_seq", "grad_rel")},
            "grad_layers": 2}


def flash_bwd_check(got, want, case, scale=None) -> float:
    """dq, dk, dv (or the first of them) within the backward's gate of the
    plain version's, its absolute part relative to ``scale`` (default the
    largest |value| of ``want``); the max |error|."""
    import torch

    worst = 0.0
    if scale is None:
        scale = max(float(w.double().abs().max()) for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"flash_attention_bwd {case} {name}: {g.dtype} "
              f"{tuple(g.shape)}")
        diff = (g.double() - w.double()).abs()
        gate = FLASH_BWD_F32 * scale
        if str(w.dtype) in LOWP_STEP:
            gate = gate + LOWP_STEP[str(w.dtype)] * w.double().abs()
        check(bool((diff <= gate).all()),
              f"flash_attention_bwd {case} {name}: max |error| "
              f"{float(diff.max())} beyond its gate")
        worst = max(worst, float(diff.max()))
    return worst


def flash_grad_call(q, k, v, do, causal, window, q_offset, kv_len):
    """One K7 forward and backward through ``ops`` under autograd: (dq, dk,
    dv), checked to add one launch of each, the backward's on the route
    ``bwd_route`` names."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before, routes = ops.launch_counts(), ops.route_counts()
    out = ops.flash_attention_masked(*leaves, causal, window, q_offset,
                                     kv_len)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for name in ("flash_attention_fused", "flash_attention_bwd"):
        check(after[name] == before[name] + 1,
              f"{name}: one gradient call launched "
              f"{after[name] - before[name]}")
    key = ("flash_attention_bwd/"
           f"{k7.bwd_route(q.dtype, q.shape[2], v.shape[2])}")
    check(ops.route_counts().get(key, 0) == routes.get(key, 0) + 1,
          f"{key}: the backward took another route "
          f"({ops.route_counts()})")
    return out.detach(), grads


# float16 backward calls whose dS leaves f16's normal range, (scales of q,
# k, v, do) on a causal (8, 128, 128, 64) call, as
# tests/test_torch_flash_bwd.py's DS_RANGE: a large V against small scores,
# |dS| past 65,504; a small dO and V, every |dS| below 2^-14, with large K
# so that dQ, the largest gradient, stays normal
FLASH_BWD_DS_RANGE = {"large_ds": (2 ** -3, 2 ** -5, 2 ** 12, 4.0),
                      "small_ds": (2 ** -10, 2 ** 10, 2 ** -6, 2 ** -12)}
FLASH_BWD_DS_SHAPE = (8, 128, 128, 64)


def flash_bwd_ds_range(errs, routes) -> dict:
    """The FLASH_BWD_DS_RANGE calls in float16 on the tensor cores (f16's dS
    carried at a power of two a head): each within the backward's gate of
    the plain backward, every gradient finite, the same bits on a repeat;
    and in bf16 on the same values.  Adds each case's error to ``errs``."""
    import torch

    from repro_torch.kernels import flash_attention as k7

    bh, s, _, d = FLASH_BWD_DS_SHAPE
    rec = {}
    for name, scales in FLASH_BWD_DS_RANGE.items():
        rng = np.random.default_rng(4)
        host = [torch.from_numpy((rng.standard_normal((bh, s, d)) * sc)
                                 .astype(np.float32)) for sc in scales]
        for dt in (torch.float16, torch.bfloat16):
            q, k, v, do = (x.to(dt).cuda() for x in host)
            out, got = flash_grad_call(q, k, v, do, True, 0, 0, None)
            _, lse_p = k7.flash_attention_masked_plain(q, k, v, True,
                                                       with_lse=True)
            want = k7.flash_attention_masked_bwd_plain(q, k, v, out, lse_p,
                                                       do, True)
            case = f"{dt}/{name}/{bh}x{s}x{d}/scales={scales}"
            check(all(bool(torch.isfinite(g).all()) for g in got),
                  f"flash_attention_bwd {case}: a gradient is not finite")
            errs[case] = flash_bwd_check(got, want, case)
            routes[case] = k7.bwd_route(dt, d, d)
            again = flash_grad_call(q, k, v, do, True, 0, 0, None)[1]
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_bwd {case}: a repeat differs")
            # dS = P (dP - Delta) of the plain backward, in float32
            sc = (q.float() @ k.float().transpose(1, 2)) / d ** 0.5
            ok = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
            p = torch.where(ok, torch.exp(sc - lse_p[..., None]), 0.0)
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            ds = (p * (do.float() @ v.float().transpose(1, 2) - delta)).abs()
            rec[case] = {"route": routes[case], "max_abs_err": errs[case],
                         "max_abs_ds": float(ds.max()),
                         "grad_max": [float(g.float().abs().max())
                                      for g in got]}
    large = [r for c, r in rec.items() if "large_ds" in c]
    small = [r for c, r in rec.items() if "small_ds" in c]
    check(all(r["max_abs_ds"] > 65504 for r in large)
          and all(0 < r["max_abs_ds"] < 2 ** -14 for r in small),
          f"flash_attention_bwd: the dS range cases miss their range {rec}")
    return rec


def flash_bwd_cases(log) -> dict:
    """K7's backward against its plain version on FLASH_BWD_CASES in both
    dtypes, each call one forward and one backward count, the backward on
    the route ``bwd_route`` names, with the forward's output and ``lse``
    against the plain forward's; the causal bf16 case at S 1,500 (the
    tensor cores) twice, bit for bit (no atomics); float16's dS past its
    range (``flash_bwd_ds_range``)."""
    import torch

    from repro_torch.kernels import flash_attention as k7

    g = torch.Generator(device="cuda").manual_seed(3)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    errs, lse_errs, routes, repeat = {}, {}, {}, None
    for dt in (torch.float32, torch.bfloat16):
        for bh, sq, sk, d, dv, causal, window, off, kvl in FLASH_BWD_CASES:
            q, k = rand((bh, sq, d), dt), rand((bh, sk, d), dt)
            v, do = rand((bh, sk, dv), dt), rand((bh, sq, dv), dt)
            args = (causal, window, off, kvl)
            out, got = flash_grad_call(q, k, v, do, *args)
            kvn = sk if kvl is None else min(kvl, sk)
            lse = k7._launch(q, k, v, causal, window, off, kvn,
                             with_lse=True)[1]
            case = (f"{dt}/{bh}x{sq}x{sk}x{d}/v{dv}/causal={causal}/window="
                    f"{window}/q_offset={off}/kv_len={kvl}")
            routes[case] = k7.bwd_route(dt, d, dv)
            o_p, lse_p = k7.flash_attention_masked_plain(q, k, v, *args,
                                                         with_lse=True)
            flash_check(out, o_p, f"{case} with lse")
            lse_errs[case] = float((lse - lse_p).abs().max())
            lse_gate = FLASH_LSE_F32 * max(1.0, float(lse_p.abs().max()))
            check(lse.dtype == torch.float32 and lse.shape == lse_p.shape
                  and lse_errs[case] <= lse_gate,
                  f"flash_attention_fused {case}: lse max |error| "
                  f"{lse_errs[case]} beyond {lse_gate}")
            # the plain backward from the plain forward's lse, so a wrong lse
            # shows in the gradients too; and from the kernel's output, held
            # above to the plain one: in bf16 the two outputs' roundings may
            # differ by a step, which Delta = sum(dO O) would carry into
            # every gradient of the row
            want = k7.flash_attention_masked_bwd_plain(q, k, v, out, lse_p,
                                                       do, *args)
            errs[case] = flash_bwd_check(got, want, case)
            if (repeat is None and dt == torch.bfloat16 and sq == sk == 1500
                    and causal and not window and routes[case] == "wgmma"):
                again = flash_grad_call(q, k, v, do, *args)[1]
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"flash_attention_bwd {case}: a repeat differs")
                repeat = case
    check(repeat is not None, "flash_attention_bwd: no repeat on wgmma")
    ds_range = flash_bwd_ds_range(errs, routes)
    rec = {"cases": len(errs), "max_abs_err": errs, "ds_range": ds_range,
           "lse_max_abs_err": lse_errs, "routes": routes,
           "gate": {"float32": f"{FLASH_BWD_F32} of the largest |value| "
                               f"of dq, dk, dv",
                    "bfloat16": f"{FLASH_BWD_BF16_STEP} of each |value| + "
                                f"{FLASH_BWD_F32} of the largest",
                    "lse": f"{FLASH_LSE_F32} of max(1, largest |lse|), both "
                           f"dtypes",
                    "out": "FLASH_TOL, the forward's"},
           "repeat_bit_identical": repeat}
    emit({"flash_bwd_cases": rec}, log)
    return rec


# K7's backward timed, causal: (name, bh, s, d, dv, heads): granite-3-2b's
# training shape (2 x 32 heads of 64 over 2,048 tokens), Phi-3's head (D 96)
# at 2 x 32 heads over 4,096, and DeepSeek-V2-Lite's (MLA's qk 192 / v 128,
# 2 x 16 heads over 2,048: its training shape)
# the mangled name of the tensor-core kernels' bf16 template argument
BF16 = "13__nv_bfloat16"
FLASH_BWD_TIMED = (("granite", 2 * 32, TRAIN["seq"], 64, 64, 32),
                   ("d96", 64, 4096, 96, 96, 32),
                   ("mla", 2 * 16, TRAIN["seq"], 192, 128, 16))


def sdpa_backend(q, k, v) -> str:
    """The backend ``F.scaled_dot_product_attention(q, k, v,
    is_causal=True)`` dispatches to (``FLASH_ATTENTION``,
    ``EFFICIENT_ATTENTION``, ``CUDNN_ATTENTION`` or ``MATH``), as PyTorch's
    own selection reports it, without running the call."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True)).name


def flash_bwd_timed_shape(bh, s, d, dv, heads, seed) -> dict:
    """K7's forward (with ``lse``) and backward on causal bf16 q, k of
    (bh, s, d) and v of (bh, s, dv): the backward on its route and, in turns
    (CUDA cores, route, route, CUDA cores), the CUDA-core kernel on the
    same inputs, each against the plain backward; the bounds at the bf16
    tensor-core rate of the least work, 6 d + 4 dv FLOP a pair (S, dQ, dK
    over d; dP, dV over dv), and of the tensor-core kernel's own 16 d +
    10 dv; the forward and backward back to back beside
    ``F.scaled_dot_product_attention``'s, with the backend it takes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, s, w), generator=g, device="cuda")
                   .to(torch.bfloat16) for w in (d, d, dv, dv))

    def fwd():
        return k7._launch(q, k, v, True, 0, 0, s, with_lse=True)

    o, lse = fwd()
    route = k7.bwd_route(q.dtype, d, dv)
    check(route == "wgmma", f"flash_attention_bwd at ({d}, {dv}): route "
                            f"{route}")

    def bwd(path=route):
        return k7._launch_bwd(q, k, v, o, lse, do, True, 0, 0, s, route=path)

    def plain():
        return k7.flash_attention_masked_bwd_plain(q, k, v, o, lse, do)

    want = plain()
    pairs = bh * valid_pairs(s, s, True, 0)
    rec = {"name": "flash_attention_bwd", "route": route,
           "shape": {"bh": bh, "s": s, "d": d, "dv": dv, "dtype": "bfloat16",
                     "causal": True}, "pairs": pairs,
           "max_abs_err": flash_bwd_check(bwd(), want, f"{bh}x{s}x{d}/{dv}"),
           "cuda_cores_max_abs_err": flash_bwd_check(
               bwd("cuda_cores"), want, f"{bh}x{s}x{d}/{dv} cuda_cores")}
    # CUDA events around one call, and around back-to-back calls, in turns
    turns = []
    for path in ("cuda_cores", route, route, "cuda_cores"):
        turns.append({"route": path,
                      "ms": time_ms(lambda: bwd(path), reps=5),
                      "loop_ms": loop_ms(lambda: bwd(path), reps=10)})
    for key, path in (("", route), ("cuda_cores_", "cuda_cores")):
        mine = [t for t in turns if t["route"] == path]
        rec[f"{key}ms"] = statistics.mean(t["ms"] for t in mine)
        rec[f"{key}loop_ms"] = statistics.mean(t["loop_ms"] for t in mine)
    rec["turns"] = turns
    rec["fwd_ms"], rec["fwd_loop_ms"] = time_ms(fwd, reps=10), loop_ms(fwd)
    rec["plain_ms"] = time_ms(plain, reps=2)
    # forward 2 d + 2 dv FLOP a pair (Q.K^T, P.V), backward 6 d + 4 dv (S
    # again, dQ and dK over d; dP and dV over dv); each input read once,
    # each output written once (q, k, dq, dk of width d; v, o, do, dv of dv)
    esz = q.element_size()
    rec["fwd_flops"] = (2 * d + 2 * dv) * pairs
    rec["flops"] = (6 * d + 4 * dv) * pairs
    rec["fwd_bytes"] = bh * s * (2 * d + 2 * dv) * esz + bh * s * 4
    rec["bytes"] = bh * s * (4 * d + 4 * dv) * esz + bh * s * 4
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(
        rec["fwd_bytes"], rec["fwd_flops"], torch.bfloat16)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             torch.bfloat16)
    # the tensor-core kernel's own work: S and dP in both passes (4 d +
    # 4 dv), dV, dK and dQ with three-term A operands (6 dv + 12 d)
    rec["own_work_bound_ms"] = bound(0, (16 * d + 10 * dv) * pairs,
                                     torch.bfloat16)[0]
    rec["tflops"] = rec["flops"] / rec["loop_ms"] / 1e9

    def fwd_bwd():
        o2, lse2 = fwd()
        return k7._launch_bwd(q, k, v, o2, lse2, do, True, 0, 0, s)

    rec["fwd_bwd_loop_ms"] = loop_ms(fwd_bwd, reps=10)
    q4, k4, v4, do4 = (x.view(bh // heads, heads, s, x.shape[2]).detach()
                       .requires_grad_(x is not do) for x in (q, k, v, do))

    def sdpa():
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return torch.autograd.grad(out, (q4, k4, v4), do4)

    rec["sdpa_backend"] = sdpa_backend(q4, k4, v4)
    rec.update(library_call([(
        f"F.scaled_dot_product_attention(is_causal=True) forward + backward "
        f"on ({bh // heads}, {heads}, s, d|dv), backend "
        f"{rec['sdpa_backend']}", sdpa)]))
    if rec["library_ms"] is not None:
        rec["library_loop_ms"] = loop_ms(sdpa, reps=10)
    return rec


def flash_bwd_timed(log) -> dict:
    """K7's forward and backward timed on FLASH_BWD_TIMED: granite's
    record, with the D 96 shape's under ``"d96"`` and MLA's under
    ``"mla"``, and the kernels' ``ptxas`` registers and spills."""
    import torch

    recs = {}
    for seed, (name, *shape) in enumerate(FLASH_BWD_TIMED):
        recs[name] = flash_bwd_timed_shape(*shape, 4 + seed)
        torch.cuda.empty_cache()
    rec = recs.pop("granite")
    rec.update(recs)
    rec["ptxas"] = {name: ptxas_report(kernel) for name, kernel in (
        *((f"{pass_}_wgmma_{name}", f"{pass_}_kernelI{BF16}{tmpl}Lb0E")
          for name, tmpl in (("d32", "Li32ELi32ELi64E"),
                             ("d64", "Li64ELi64ELi64E"),
                             ("d96", "Li96ELi96ELi64E"),
                             ("d128", "Li128ELi128ELi64E"),
                             ("qk64_v128", "Li64ELi128ELi64E"))
          for pass_ in ("dkdv", "dq")),
        ("dkdv_wgmma_mla", f"dkdv_kernelI{BF16}Li192ELi128ELi32ELb0ELb0E"),
        ("dq_wgmma_mla", f"dq_kernelI{BF16}Li192ELi128ELi64ELb0E"),
        ("dkdv_wgmma_p_dtype_d64",
         f"dkdv_kernelI{BF16}Li64ELi64ELi64ELb0ELb1E"),
        ("dkdv_wgmma_split_d256",
         f"dkdv_kernelI{BF16}Li256ELi256ELi32ELb1ELb0E"),
        ("dq_wgmma_split_d256", f"dq_kernelI{BF16}Li256ELi256ELi32ELb0E"),
        ("dkdv_wgmma_f16_d64", "dkdv_kernelI6__halfLi64ELi64ELi64ELb0ELb0E"),
        ("delta_wgmma", ("flash_attention_bwd_wgmma_cu",
                         f"12delta_kernelI{BF16}E")),
        ("dkdv_bf16_d64", "dkdv_kernelI13__nv_bfloat16Li4ELi4EE"),
        ("dq_bf16_d64", "dq_kernelI13__nv_bfloat16Li4ELi4EE"),
        ("dkdv_f32_d64", "dkdv_kernelIfLi4ELi4EE"),
        ("dq_f32_d64", "dq_kernelIfLi4ELi4EE"),
        ("fwd_wgmma_d64", f"flash_wgmma_kernelI{BF16}Li64ELi64E"),
        ("fwd_wgmma_d96", f"flash_wgmma_kernelI{BF16}Li96ELi96E"),
        ("fwd_wgmma_f16_d96", "flash_wgmma_kernelI6__halfLi96ELi96E"),
        ("fwd_wgmma_d320", f"flash_wgmma_kernelI{BF16}Li320ELi160E"),
        ("fwd_wgmma_d384", f"flash_wgmma_kernelI{BF16}Li384ELi128E"),
        ("fwd_f32_d96", "flash_kernelILi6E"))}
    emit({"flash_bwd_kernel": rec}, log)
    return rec


def grad_path_check(log, spec=TRAIN, key="train_grad_path") -> dict:
    """``spec``'s model at full width on ``grad_layers`` layers in float32:
    the loss and every gradient on the card (K7's float32 forward and
    backward) against the CPU's plain versions from the same parameters,
    each leaf within ``grad_rel`` of its largest |gradient|.  A MoE layer
    routes on the CPU to the experts the card chose (``routed``): a router
    near-tie may go the other way on the other device, and then the two
    are different computations; each forced expert must lie within
    NEAR_TIE of the CPU's own top k, and the gaps are recorded."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(spec["arch"]),
                              n_layers=spec["grad_layers"], dtype="float32")
    params = transformer.init_transformer(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 1, spec["grad_seq"])) \
        .astype(np.int32)

    def loss_and_grads(flat, device, forced=None):
        live = {k: p.detach().to(device).requires_grad_()
                for k, p in flat.items()}
        batch = {"tokens": torch.from_numpy(toks[0]).to(device),
                 "labels": torch.from_numpy(toks[1]).to(device)}
        with routed(forced) as calls:
            loss = transformer.train_loss(
                cfg, transformer.tree_params(cfg, live), batch)
        keys = list(live)
        grads = torch.autograd.grad(loss, [live[k] for k in keys])
        return float(loss.detach()), dict(zip(keys, grads)), \
            [(idx, logits.detach()) for idx, logits in calls]

    flat = transformer.flat_params(params)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads, calls = loss_and_grads(flat, "cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches["flash_attention_fused"] == cfg.n_layers
          and launches["flash_attention_bwd"] == cfg.n_layers,
          f"{key}: K7 launches {launches}")
    forced = [idx.cpu() for idx, _ in calls] or None
    t0 = time.perf_counter()
    cpu_loss, cpu_grads, cpu_calls = loss_and_grads(flat, "cpu", forced)
    cpu_s = time.perf_counter() - t0
    gaps = {f"moe layer {i}": route_gaps(logits, forced[i])
            for i, (_, logits) in enumerate(cpu_calls)}
    worst = max((g for gap in gaps.values() for g in gap.values()),
                default=0.0)
    check(worst <= NEAR_TIE,
          f"{key}: the card's experts are {worst} from the CPU's top k "
          f"(> NEAR_TIE {NEAR_TIE})")
    rels = {}
    for name, want in cpu_grads.items():
        got = grads[name].cpu().double()
        scale = float(want.double().abs().max())
        rels[name] = float((got - want.double()).abs().max()) / max(scale,
                                                                    1e-30)
        check(rels[name] <= spec["grad_rel"],
              f"{key} {name}: {rels[name]} of its largest |gradient|")
    check(abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss),
          f"{key}: loss {loss} on the card, {cpu_loss} on the CPU")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
           "tokens": spec["grad_seq"], "loss": loss, "cpu_loss": cpu_loss,
           "launches": launches, "leaves": len(rels),
           "max_rel_err": max(rels.values()), "rel_err_by_leaf": rels,
           "gate": f"{spec['grad_rel']} of each leaf's largest |gradient|",
           "card_s": card_s, "cpu_s": cpu_s}
    if calls:
        rec["moe_calls"] = len(calls)
        rec["cpu_route_gaps"] = {k: g for k, g in gaps.items() if g}
    emit({key: rec}, log)
    del params, grads
    torch.cuda.empty_cache()
    return rec


def batch_on_card(pipe, step: int) -> dict:
    import torch
    return {k: torch.from_numpy(v).cuda()
            for k, v in pipe.batch_at(step).items()}


def train_setup(spec) -> tuple:
    """(cfg, its optimizer, the steps it is scheduled for, ``make_train_step``'s
    step, the token pipeline) of ``spec``: its arch at ``spec["layers"]``
    layers where given, AdamW on the reference launcher's schedule over the
    warm-up, timed and profiled steps, ``batch`` x ``seq`` tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train import make_train_step

    cfg = get_config(spec["arch"])
    if "layers" in spec:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    n_steps = spec["warm_steps"] + spec["timed_steps"] + 1
    opt = adamw(linear_warmup_cosine(spec["lr"], spec["warmup"], n_steps))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=spec["seq"],
                         global_batch=spec["batch"], seed=0)
    return cfg, opt, n_steps, make_train_step(cfg, opt, 1, 1.0), pipe


def attn_widths(cfg) -> tuple:
    """K7's (qk, value) widths in ``cfg``'s attention: MLA's nope + rope and
    v_head_dim, else the head width twice."""
    if cfg.attention == "mla":
        m = cfg.mla
        return m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    return cfg.hd, cfg.hd


def step_product_flops(cfg, flat, tokens: int) -> float:
    """6 x tokens x the parameters, as 6 N D counts a step's products; a
    MoE stack's routed experts counted at the E x cap slot rows their
    grouped products run over, 6 x cap x their parameters (capacity
    padding included, top-k's unused experts excluded)."""
    from repro_torch.models.ffn import moe_capacity
    from repro_torch.models.transformer import is_moe

    if not is_moe(cfg):
        return 6 * cfg.n_params() * tokens
    experts = sum(flat[f"layers/ffn/{w}"].numel() for w in ("w1", "w3", "w2"))
    rest = sum(t.numel() for t in flat.values()) - experts
    return 6 * rest * tokens + 6 * moe_capacity(tokens, cfg.moe) * experts


# the segment sums of a MoE layer's backward: one a row gather through
# take_rows (models/ffn.py: the tokens, the gates, the expert outputs, the
# combine's parts)
MOE_SEGMENT_SUMS = 4


def moe_layers(cfg) -> int:
    """The MoE layers of ``cfg``'s stack (its dense prefix left out)."""
    from repro_torch.models.transformer import is_moe, n_prefix

    return cfg.n_layers - n_prefix(cfg) if is_moe(cfg) else 0


def train_steps(log, spec=TRAIN, key="train_steps") -> dict:
    """``spec``'s model at full width (granite at its full depth of 40
    layers; DeepSeek-V2-Lite at DS_TRAIN's 4), bf16 with float32 AdamW
    moments: one warm-up step, then ``timed_steps`` timed steps through
    ``make_train_step`` with the counts from 0 (one K7 forward and one
    backward launch a layer a step, every backward on the tensor cores),
    then one profiled step; every loss and grad norm finite; peak
    memory."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import flat_params
    from repro_torch.train import init_train_state

    cfg, opt, n_steps, step, pipe = train_setup(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), opt, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    n_params = sum(t.numel() for t in flat_params(state.params).values())
    flops = step_product_flops(cfg, flat_params(state.params),
                               spec["batch"] * spec["seq"])
    metrics, wall = [], []
    i = 0
    for _ in range(spec["warm_steps"]):
        state, m = step(state, batch_on_card(pipe, i))
        metrics.append({k: float(x) for k, x in m.items()})
        i += 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the training path's count starts here
    per_step = []
    for _ in range(spec["timed_steps"]):
        batch = batch_on_card(pipe, i)
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(x) for k, x in m.items()})
        after = ops.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
        i += 1
    launches, routes = ops.launch_counts(), ops.route_counts()
    # one K7 forward and backward a layer; a MoE layer's backward adds its
    # row gathers' segment sums
    want_step = {"flash_attention_fused": cfg.n_layers,
                 "flash_attention_bwd": cfg.n_layers}
    if moe_layers(cfg):
        want_step["segment_sum"] = MOE_SEGMENT_SUMS * moe_layers(cfg)
    for n in per_step:
        check(n == want_step, f"{key}: launches {n}, {want_step} wanted")
    check(routes.get("flash_attention_bwd/wgmma") == launches[
        "flash_attention_bwd"], f"{key}: backward routes {routes}")
    for m in metrics:
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"{key}: {m}")
    batch = batch_on_card(pipe, i)
    box = {}

    def one():
        box["state"], box["m"] = step(state, batch)

    host_ms, dev_ms, events = profile(one, top_n=None)
    # PyTorch's indexing backward adds repeated rows in its own order; the
    # MoE's gathers go through take_rows and the segment sum instead
    indexing = [e for e in events if "indexing_backward_kernel" in e[0]]
    check(not indexing, f"{key}: PyTorch's indexing backward ran: "
                        f"{indexing}")
    segsum = [e for e in events if "segment_sum" in e[0]
              or "mark_runs" in e[0]]
    metrics.append({k: float(x) for k, x in box["m"].items()})
    del state
    state = box.pop("state")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = spec["batch"] * spec["seq"]

    def k7_device(*kernels):
        """K7's device ms in the profiled step, its launches of each of
        ``kernels`` (the start of a kernel's name, template arguments
        included), and its ms a call (None unless the profile holds all
        ``n_layers`` launches of each)."""
        ms = {k: sum(t for name, t, _ in events if f"::{k}" in name)
              for k in kernels}
        n = {k: sum(c for name, _, c in events if f"::{k}" in name)
             for k in kernels}
        whole = all(c == cfg.n_layers for c in n.values())
        return {"ms": sum(ms.values()), "launches": n,
                "ms_per_call": sum(ms.values()) / cfg.n_layers if whole
                else None}

    k7_fwd = k7_device("flash_wgmma_kernel<")
    # the tensor-core backward of the model's widths: its Delta pre-pass
    # (not a template) and its two passes
    d, dv = attn_widths(cfg)
    wq, wv, bt = k7.bwd_widths(d, dv)
    k7_bwd = k7_device("delta_kernel<",
                       f"dkdv_kernel<__nv_bfloat16, {wq}, {wv}, {bt},",
                       f"dq_kernel<__nv_bfloat16, {wq}, {wv},")
    # operations: the products (step_product_flops), and K7's forward (2 d
    # + 2 dv) and backward (6 d + 4 dv) over the causal pairs of every
    # layer's heads
    attn = cfg.n_layers * spec["batch"] * cfg.n_heads \
        * valid_pairs(spec["seq"], spec["seq"], True, 0) * (8 * d + 6 * dv)
    flops += attn
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": n_params, "config_n_params": cfg.n_params(),
           "reduced": spec.get("reduced"), "batch": spec["batch"],
           "seq": spec["seq"], "tokens_per_step": tokens,
           "optimizer": f"adamw(linear_warmup_cosine({spec['lr']}, "
                        f"{spec['warmup']}, {n_steps})), clip 1.0",
           "init_s": init_s, "state_gb": state_gb,
           "step_ms": wall, "median_step_ms": statistics.median(wall),
           "tokens_per_s": tokens / (statistics.median(wall) / 1e3),
           "launches": launches, "routes": routes,
           "launches_per_step": per_step[0],
           "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "peak_mem_gb": peak_gb, "flops_per_step": flops,
           "bound_ms": bound(0, flops, torch.bfloat16)[0],
           "profiled": {"host_ms": host_ms, "device_ms": dev_ms,
                        "device_busy_share": None if dev_ms is None
                        else dev_ms / host_ms, "k7_forward": k7_fwd,
                        "k7_backward": k7_bwd, "top_kernels": events[:12],
                        "segment_sum_ms": sum(t for _, t, _ in segsum),
                        "segment_sum_kernels": segsum,
                        "indexing_backward": indexing}}
    emit({key: rec}, log)
    del state, box
    torch.cuda.empty_cache()
    return rec


def train_repeat(log, spec=DS_TRAIN, key="deepseek_train_repeat") -> dict:
    """The first step from ``init_train_state`` seed 0, twice, each from a
    fresh init: the same bits in the loss, the grad norm and every
    parameter's and moment's float64 sum and |sum| (``leaf_sums``), so the
    whole step (the MoE's dispatch and combine and their backward
    included) is the same run to run."""
    import torch

    from repro_torch.train import init_train_state

    cfg, opt, _, step, pipe = train_setup(spec)
    runs = []
    for _ in range(2):
        state = init_train_state(cfg, torch.Generator(device="cuda")
                                 .manual_seed(0), opt, "cuda")
        state, m = step(state, batch_on_card(pipe, 0))
        runs.append(({k: float(x) for k, x in m.items()}, leaf_sums(state)))
        del state
        torch.cuda.empty_cache()
    (m1, s1), (m2, s2) = runs
    differ = sorted(k for k in s1 if s1[k] != s2[k])
    check(m1 == m2 and not differ,
          f"{key}: the first step twice differs: metrics {m1} / {m2}, "
          f"leaves {differ}")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "metrics": m1,
           "leaves": len(s1), "bit_identical": True}
    emit({key: rec}, log)
    return rec


def deepseek_train(log) -> dict:
    """DeepSeek-V2-Lite's training on the card at DS_TRAIN: the timed
    steps (MLA's K7 backward on the tensor cores at qk 192 / v 128, the
    MoE's dispatch and combine backward through the segment sum, no
    PyTorch indexing backward), the dispatch gather's backward at full
    shape bit for bit the CPU port's, the first step twice bit for bit,
    and the float32 gradients of the dense and one MoE layer against the
    CPU's."""
    out = {"steps": train_steps(log, DS_TRAIN, "deepseek_train_steps")}
    out["moe_gather"] = moe_gather_check(log)
    out["repeat"] = train_repeat(log, DS_TRAIN, "deepseek_train_repeat")
    out["grad_path"] = grad_path_check(log, DS_TRAIN,
                                       "deepseek_train_grad_path")
    return out


def differing_leaves(a, b) -> list:
    """The flattened positions where two trees' leaves differ."""
    import torch

    from repro_torch.checkpoint import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"trees of {len(la)} and {len(lb)} leaves")
    return [i for i, (x, y) in enumerate(zip(la, lb))
            if not torch.equal(x, y)]


def trainer_check(log) -> dict:
    """The trainer at full width on 2 layers: 6 steps with a checkpoint
    every 3 into a temporary directory, a RuntimeError injected at step 4;
    the trainer restores step_3 and replays step 3, bit for bit the first
    pass; its final state bit for bit a clean run's; the final checkpoint
    restored bit for bit the live state; each write timed."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.train import (Trainer, TrainerConfig, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=TRAIN["trainer_layers"])
    n = TRAIN["trainer_steps"]
    opt = adamw(linear_warmup_cosine(TRAIN["lr"], TRAIN["warmup"], n))
    state0 = init_train_state(cfg, torch.Generator(device="cuda")
                              .manual_seed(0), opt, "cuda")
    step = make_train_step(cfg, opt, 1, 1.0)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                         global_batch=TRAIN["batch"], seed=0)
    # determinism of one step: the same state and batch twice
    b0 = batch_on_card(pipe, 0)
    s1, m1 = step(state0, b0)
    s2, m2 = step(state0, b0)
    differ = differing_leaves(s1, s2)
    deterministic = not differ and all(torch.equal(m1[k], m2[k]) for k in m1)
    del s1, s2
    check(deterministic, f"trainer: one step twice differs at leaves "
                         f"{differ} (a PyTorch op on the path is not "
                         f"deterministic)")
    clean, clean_m = state0, []
    for i in range(n):
        clean, m = step(clean, batch_on_card(pipe, i))
        clean_m.append({k: float(x) for k, x in m.items()})
    writes = []
    real_save = ckpt_mod.save_checkpoint

    def timed_save(directory, at, tree):
        t0 = time.perf_counter()
        path = real_save(directory, at, tree)
        writes.append({"step": at, "seconds": time.perf_counter() - t0,
                       "bytes": sum(f.stat().st_size for f in
                                    pathlib.Path(path).iterdir())})
        return path

    killed = {"done": False}

    def inject(at):
        if at == TRAIN["fail_at"] and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("injected device failure")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    ckpt_mod.save_checkpoint = timed_save
    try:
        tr = Trainer(TrainerConfig(total_steps=n,
                                   checkpoint_every=TRAIN["checkpoint_every"],
                                   checkpoint_dir=tmp, max_restarts=1),
                     step, state0, pipe, failure_injector=inject)
        t0 = time.perf_counter()
        final = tr.run()
        run_s = time.perf_counter() - t0
        last = latest_step(tmp)
        check(last == n, f"trainer: latest checkpoint {last}")
        restored = restore_checkpoint(tmp, last, final)
        check(not differing_leaves(restored, final),
              "trainer: the final checkpoint differs from the live state")
    finally:
        ckpt_mod.save_checkpoint = real_save
        shutil.rmtree(tmp, ignore_errors=True)
    restart = TRAIN["checkpoint_every"]
    hist = [(m["loss"], m["grad_norm"]) for m in tr.history]
    check(tr.restarts == 1 and [f[0] for f in tr.failures]
          == [TRAIN["fail_at"]], f"trainer: failures {tr.failures}")
    # history: steps 0 .. fail_at - 1, then restart .. n - 1 again
    first = hist[:TRAIN["fail_at"]]
    replay = hist[TRAIN["fail_at"]:]
    check(replay[0] == first[restart],
          f"trainer: replayed step {restart} {replay[0]}, first pass "
          f"{first[restart]}")
    check(first + replay[TRAIN["fail_at"] - restart:]
          == [(m["loss"], m["grad_norm"]) for m in clean_m],
          "trainer: its metrics differ from the clean run's")
    differ = differing_leaves(final, clean)
    check(not differ, f"trainer: final state differs from the clean run's "
                      f"at leaves {differ}")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "steps": n,
           "checkpoint_every": TRAIN["checkpoint_every"],
           "failed_at": TRAIN["fail_at"], "restored_step": restart,
           "restarts": tr.restarts, "failures": tr.failures,
           "replay_bit_identical": True, "final_bit_identical": True,
           "checkpoint_restore_bit_identical": True,
           "one_step_deterministic": deterministic,
           "losses": [h[0] for h in hist], "run_s": run_s,
           "writes": writes}
    emit({"train_trainer": rec}, log)
    del state0, clean, final, restored, tr
    torch.cuda.empty_cache()
    return rec


def train_cli(log) -> dict:
    """``python -m repro_torch.launch.train --arch granite-3-2b --smoke
    --steps 3`` on the card's default device (its checkpoints into a
    temporary directory, deleted after)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "granite-3-2b", "--smoke", "--steps", "3", "--ckpt-dir", tmp]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        seconds = time.perf_counter() - t0
    check(run.returncode == 0 and "device=cuda" in run.stdout
          and "[train] done: loss" in run.stdout,
          f"launch.train: exit {run.returncode}\n{run.stdout}\n"
          f"{run.stderr[-2000:]}")
    rec = {"command": " ".join(cmd[1:-2]), "seconds": seconds,
           "stdout": run.stdout.strip().splitlines()}
    emit({"train_cli": rec}, log)
    return rec


def train_phase(log) -> dict:
    """Training on the card: K7's backward against its plain version and
    timed; the whole path's gradients against the CPU's; full-depth granite
    steps; the trainer with a checkpoint, an injected failure and its
    replay; the launcher; DeepSeek-V2-Lite's steps, repeat and
    gradients."""
    import torch

    t0 = time.perf_counter()
    out = {"cases": flash_bwd_cases(log), "timed": flash_bwd_timed(log)}
    torch.cuda.empty_cache()
    out["grad_path"] = grad_path_check(log)
    out["steps"] = train_steps(log)
    out["trainer"] = trainer_check(log)
    out["cli"] = train_cli(log)
    torch.cuda.empty_cache()
    out["deepseek"] = deepseek_train(log)
    emit({"train_phase_s": time.perf_counter() - t0}, log)
    return out


# ---------------------------------------------------------------------------
# Phase 8b: the distributed LM substrate on one card
# ---------------------------------------------------------------------------

# granite's step at TRAIN's shape; DeepSeek-V2-Lite at the depth of its
# float32 decode check (the dense prefix layer + 3 MoE layers); the int8
# all-reduce on granite's largest gradient leaf (lm_head / embed, 49,155 x
# 2,048 in bf16); one granite block as the pipeline's stage
DIST = {"arch": "granite-3-2b", "batch": TRAIN["batch"],
        "seq": TRAIN["seq"], "lr": TRAIN["lr"], "model_size": 16,
        "rel": 1e-5, "ds_layers": 4, "ds_batch": 2, "ds_seq": 1024,
        "psum_shape": (49155, 2048), "psum_reps": 10, "pipe_micro": 4,
        "pipe_seq": 1024, "dryrun_shapes": ("decode_32k", "train_4k"),
        "dryrun_timeout": 900}


def dryrun_start() -> dict:
    """``launch.dryrun`` of each of ``DIST["dryrun_shapes"]`` on both
    production meshes, each in a subprocess (its fake process group cannot
    share a process with NCCL's), at a lower priority and on one thread,
    so that it runs beside the card's phases without slowing their host
    work.  Returns ``{shape: (process, its JSON path)}``."""
    import tempfile

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for shape in DIST["dryrun_shapes"]:
        out = tmp / f"{shape}.json"
        procs[shape] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DIST["arch"], "--shape", shape, "--multi-pod", "--json",
             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(10)), out)
    return procs


def stop(procs: dict) -> None:
    """Kill the dry runs still running (after a failure elsewhere)."""
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def leaf_sums(state) -> dict:
    """Every parameter's and moment's float64 sum and |sum|, by path."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.transformer import flat_params

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    out = {}
    for name, tree in (("params", flat_params(state.params)),
                       ("mu", state.opt.mu), ("nu", state.opt.nu)):
        for k, t in tree.items():
            x = full(t).double()
            out[f"{name}/{k}"] = (float(x.sum()), float(x.abs().sum()))
            del x
    torch.cuda.empty_cache()
    return out


def dist_granite_step(mesh, log) -> dict:
    """One full-depth granite step placed on ``mesh`` against the plain
    step from the same state."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import (NamedSharding, P, distribute,
                                             make_shardings)
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim import adamw
    from repro_torch.optim.zero import zero1_state_specs
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import shard_train_state

    cfg = get_config(DIST["arch"])
    opt = adamw(DIST["lr"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), opt, "cuda")
    state_gb = torch.cuda.memory_allocated() / 1e9
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=DIST["seq"],
                         global_batch=DIST["batch"], seed=0)
    batch = batch_on_card(pipe, 0)
    step = make_train_step(cfg, opt, 1, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    want_sums = leaf_sums(new)
    del new, m
    torch.cuda.empty_cache()
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.reset_peak_memory_stats()
    specs = param_specs(cfg, state.params, model_size=DIST["model_size"])
    zspecs = zero1_state_specs(specs, state.params)
    placed = shard_train_state(cfg, state, mesh, specs, zspecs)
    placed_gb = torch.cuda.memory_allocated() / 1e9
    on_data = {k: distribute(v, NamedSharding(mesh, P("data", None)))
               for k, v in batch.items()}
    sstep = make_train_step(cfg, opt, 1, 1.0, sh=make_shardings(mesh))
    with use_mesh(mesh):
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # the sharded step's count starts here
        t0 = time.perf_counter()
        new, m = sstep(placed, on_data)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches, routes = ops.launch_counts(), ops.route_counts()
    got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    got_sums = leaf_sums(new)
    del new, m
    torch.cuda.empty_cache()
    n = cfg.n_layers
    check(launches["flash_attention_fused"] == n
          and launches["flash_attention_bwd"] == n,
          f"sharded step launches {launches}, {n} + {n} K7 wanted")
    check(routes.get("flash_attention_fused/wgmma") == n
          and routes.get("flash_attention_bwd/wgmma") == n,
          f"sharded step routes {routes}")
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    for k, r in rel.items():
        check(np.isfinite(got[k]) and r <= DIST["rel"],
              f"sharded step {k} {got[k]} vs {want[k]}: {r} > {DIST['rel']}")
    check(set(got_sums) == set(want_sums), "sharded step leaves")
    worst = max(abs(got_sums[k][0] - want_sums[k][0])
                / max(want_sums[k][1], 1e-30) for k in want_sums)
    check(worst <= DIST["rel"],
          f"sharded step leaf sums: {worst} of |sum| > {DIST['rel']}")
    box = {}

    def one():
        box["r"] = sstep(placed, on_data)

    with use_mesh(mesh):
        host_ms, dev_ms, events = profile(one, top_n=8)
    del box
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"arch": cfg.name, "layers": n, "dtype": cfg.dtype,
           "batch": DIST["batch"], "seq": DIST["seq"],
           "mesh": {"data": 1, "model": 1}, "world_size": 1,
           "placement": f"param_specs(model_size={DIST['model_size']}), "
                        f"zero1_state_specs, batch on data",
           "state_gb": state_gb, "placed_state_gb": placed_gb,
           "loss": got, "plain": want, "rel": rel,
           "leaf_sum_rel_worst": worst, "tolerance": DIST["rel"],
           "bit_for_bit": got == want and got_sums == want_sums,
           "launches": launches, "routes": routes,
           "plain_step_ms": plain_ms, "first_step_ms": first_ms,
           "step_host_ms": host_ms, "step_device_ms": dev_ms,
           "device_busy_share": None if dev_ms is None else dev_ms / host_ms,
           "peak_mem_gb": peak_gb, "plain_peak_mem_gb": plain_peak_gb,
           "top_kernels": events}
    emit({"dist_train_step": rec}, log)
    del placed, on_data, state
    torch.cuda.empty_cache()
    return rec


def dist_deepseek(mesh, log) -> dict:
    """DeepSeek-V2-Lite's forward with the expert-parallel MoE on ``mesh``
    against the plain ``moe_ffn`` path, bit for bit."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import (NamedSharding, P, distribute,
                                             make_shardings, tree_map)
    from repro_torch.models.transformer import (forward_hidden,
                                                init_transformer,
                                                param_specs)

    base = get_config(DS["arch"])
    moe = dataclasses.replace(base.moe, capacity_factor=base.moe.n_experts
                              / base.moe.top_k)
    cfg = dataclasses.replace(base, n_layers=DIST["ds_layers"], moe=moe)
    cfg_s = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, impl="shard_map"))
    params = init_transformer(cfg, torch.Generator(device="cuda")
                              .manual_seed(2), device="cuda")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (DIST["ds_batch"], DIST["ds_seq"]))
        .astype(np.int32)).cuda()
    specs = param_specs(cfg, params, model_size=DIST["model_size"])
    placed = tree_map(lambda x, sp: distribute(x, NamedSharding(mesh, sp)),
                      params, specs)
    with torch.no_grad():
        want, want_aux = forward_hidden(cfg, params, tokens)
        with use_mesh(mesh):
            ops.reset_launch_counts()
            got, got_aux = forward_hidden(
                cfg_s, placed, distribute(tokens, NamedSharding(
                    mesh, P("data", None))), make_shardings(mesh))
            launches, routes = ops.launch_counts(), ops.route_counts()
            got, got_aux = got.full_tensor(), got_aux.full_tensor()
    k7 = cfg.n_layers
    check(launches["flash_attention_fused"] == k7
          and routes.get("flash_attention_fused/wgmma") == k7,
          f"deepseek shard_map launches {launches} {routes}")
    check(torch.equal(got, want), "deepseek shard_map forward_hidden: "
          f"{float((got.float() - want.float()).abs().max())} off moe_ffn's")
    check(torch.equal(got_aux, want_aux), "deepseek shard_map aux")
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "reduced": {"layers": f"{cfg.n_layers} of {base.n_layers}",
                       "capacity_factor": f"{moe.capacity_factor} (no drop)"
                                          f" for {base.moe.capacity_factor}"},
           "tokens": list(tokens.shape), "moe_impl": "shard_map",
           "bit_for_bit": True, "launches": launches, "routes": routes}
    emit({"dist_deepseek_shard_map": rec}, log)
    del params, placed, want, got
    torch.cuda.empty_cache()
    return rec


def dist_psum(mesh, log) -> dict:
    """``compressed_psum`` over NCCL against the plain quantise, sum and
    dequantise, bit for bit, and timed beside it."""
    import torch

    from repro_torch.launch.mesh import use_mesh
    from repro_torch.optim import compressed_psum

    g = torch.Generator(device="cuda").manual_seed(4)
    x = (torch.randn(DIST["psum_shape"], generator=g, device="cuda")
         * 1e-3).to(torch.bfloat16)

    def plain():
        x32 = x.float()
        amax = x32.abs().max()
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(x32 / scale), -127, 127) \
            .to(torch.int32)
        return (q.float() * scale).to(x.dtype)

    with use_mesh(mesh):
        got = compressed_psum(x, "data")
        check(torch.equal(got, plain()), "compressed_psum off the plain "
              "quantise / sum / dequantise")
        psum_ms = time_ms(lambda: compressed_psum(x, "data"),
                          DIST["psum_reps"])
    plain_ms = time_ms(plain, DIST["psum_reps"])
    rec = {"shape": list(x.shape), "dtype": str(x.dtype), "world_size": 1,
           "bit_for_bit": True, "ms": psum_ms, "plain_ms": plain_ms,
           "bytes": x.numel() * x.element_size()}
    emit({"dist_compressed_psum": rec}, log)
    del x, got
    return rec


def dist_pipeline(log) -> dict:
    """``pipeline_apply`` over a pipe dim of 1 with one granite block as
    the stage, against the block applied to each microbatch."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.launch.sharding import tree_map
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(DIST["arch"]), n_layers=1)
    params = tf.init_transformer(cfg, torch.Generator(device="cuda")
                                 .manual_seed(3), device="cuda")
    lp = tf.layer_params(params, 0)
    stage_weights = tree_map(lambda a: a[None], lp)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((DIST["pipe_micro"], 1, DIST["pipe_seq"], cfg.d_model),
                    generator=g, device="cuda").to(cfg.activation_dtype)

    def stage_fn(w, h):
        return tf._attn_block(cfg, w, h)[0]

    mesh = make_test_mesh((1,), ("pipe",))
    with torch.no_grad():
        ops.reset_launch_counts()
        out = pipeline_apply(mesh, stage_weights, x, stage_fn,
                             DIST["pipe_micro"])
        launches = ops.launch_counts()
        seq = torch.stack([stage_fn(lp, x[i])
                           for i in range(DIST["pipe_micro"])])
    check(launches["flash_attention_fused"] == DIST["pipe_micro"],
          f"pipeline launches {launches}")
    check(torch.equal(out, seq), "pipeline_apply off sequential")
    rec = {"stages": 1, "microbatches": DIST["pipe_micro"],
           "microbatch": list(x.shape[1:]), "stage": "one granite block",
           "bit_for_bit": True, "launches": launches}
    emit({"dist_pipeline": rec}, log)
    del params, x, out, seq
    return rec


def dryrun_finish(procs: dict, log) -> dict:
    """Wait for the dry-run subprocesses; every record holds flops > 0 and
    the trace never initialised CUDA."""
    out = {}
    for shape, (proc, path) in procs.items():
        text, _ = proc.communicate(timeout=DIST["dryrun_timeout"])
        check(proc.returncode == 0,
              f"dryrun {shape}: exit {proc.returncode}\n{text[-3000:]}")
        recs = json.loads(path.read_text())
        check(len(recs) == 2, f"dryrun {shape}: {len(recs)} records")
        for r in recs:
            check(r["flops_per_device"] > 0 and not r["cuda_initialized"],
                  f"dryrun {shape} {r['mesh']}: {r['flops_per_device']} "
                  f"flops, cuda {r['cuda_initialized']}")
        out[shape] = [{k: r[k] for k in (
            "mesh", "trace_s", "flops_per_device",
            "bytes_accessed_per_device", "collective_bytes", "memory")}
            for r in recs]
    emit({"dist_dryrun": out}, log)
    return out


def dist_phase(log, procs=None) -> dict:
    """The distributed LM substrate on one card: an NCCL group of world
    size 1, a (1, 1) mesh; then the dry runs' results (``procs`` from
    ``dryrun_start``, which ``main`` calls at the script's start so that
    they run beside the earlier phases; started here when None)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    procs = dryrun_start() if procs is None else procs
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1))
        out = {"step": dist_granite_step(mesh, log),
               "deepseek": dist_deepseek(mesh, log),
               "psum": dist_psum(mesh, log),
               "pipeline": dist_pipeline(log)}
        before = torch.cuda.memory_allocated()
        out["dryrun"] = dryrun_finish(procs, log)
        check(torch.cuda.memory_allocated() == before,
              "the dry run changed the card's allocated memory")
    finally:
        dist.destroy_process_group()
        stop(procs)
    torch.cuda.empty_cache()
    emit({"dist_phase_s": time.perf_counter() - t0}, log)
    return out


# ---------------------------------------------------------------------------
# Phase 9: the paper's three applications at paper size
# ---------------------------------------------------------------------------

# Graph contraction on the reference bench's list (bench_graph_apps.py:31)
# less web-Google (its ELL width fits no card), WindTunnel and amazon0601;
# Table II's rows.
CONTRACTION = {"RoadTX": 1_393_383, "Economics": 206_500, "Protein": 36_417}
# (lane, app kwargs, kernels it must launch, pipeline syncs per SpGEMM)
APP_LANES = (
    ("default", {}, {"gather_rows"}, 1),
    ("fused_hash", {"method": "fused_hash"},
     {"gather_rows", "hash_accumulate"}, 0),
)
# bench_mcl's parameters (bench_graph_apps.py:58-66) on Economics at paper
# size (206,500 rows), with 2 iterations for its 3: the reference keeps
# every pruned entry in the structure, so iteration i multiplies a matrix
# with the structure of A^(2^(i-1)), and a third expansion would form
# about 6e11 products.
MCL_MATRIX = ("Economics", 206_500)
MCL_ARGS = {"e": 2, "r": 2.0, "theta": 1e-4, "k": 32, "tol": 0.0,
            "max_iters": 2}
NEAR = 1e-4  # a decision this close (relative) to its threshold is "near"
MCL_CPU_ROWS = 2_048  # MCL on the card against the CPU port, bit for bit
# ogbn-arxiv at paper size (Table III: 169,343 nodes, average degree 15.8,
# 40 classes, R-MAT as TABLE_III_SCALED has it) with bench_gnn.bench_one's
# settings: 64 input and hidden features, TopK 16, 2 layers, 5 steps.
GNN = {"dataset": "ogbn-arxiv", "nodes": 169_343, "avg_deg": 15.8,
       "n_classes": 40, "d": 64, "topk": 16, "n_layers": 2, "steps": 5}
GNN_REL = 1e-4  # logits and step-1 gradients, of the largest |value|
GNN_REPEAT = ("gcn", "topk")  # trained twice: are the bits the same?


def host_csr(c, dtype=np.float64):
    """A port CSR's occupied slots as a scipy CSR (explicit zeros kept)."""
    import scipy.sparse as sp

    indptr = c.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return sp.csr_matrix((c.data[:nnz].cpu().numpy().astype(dtype),
                          c.indices[:nnz].cpu().numpy(), indptr),
                         shape=c.shape)


def torch_csr(c):
    """A port CSR as a ``torch.sparse_csr_tensor`` (for cuSPARSE)."""
    import torch

    nnz = int(c.nnz)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(c.indptr, c.indices[:nnz],
                                       c.data[:nnz], size=c.shape,
                                       check_invariants=False)


def counted_call(fn):
    """``fn()`` with the launch counts and the pipeline's sync count from 0:
    (result, wall ms ending in a sync, launches, host syncs, peak GB)."""
    import torch

    from repro_torch.core import executor
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    executor.clear_program_cache()
    ops.reset_launch_counts()  # this lane's count starts here
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, ops.launch_counts(), \
        executor.cache_stats()["host_sync_count"], \
        torch.cuda.max_memory_allocated() / 1e9


def check_lane_kernels(what, launches, kernels):
    for k in SPGEMM_KERNELS:
        check((launches[k] > 0) == (k in kernels),
              f"{what}: {k} launched {launches[k]} times")


def profiled(fn) -> dict:
    host_ms, dev_ms, top = profile(fn)
    return {"host_ms": host_ms, "device_ms": dev_ms,
            "device_busy_share": None if dev_ms is None else dev_ms / host_ms,
            "top_kernels": top}


def contraction_phase(log):
    """Graph contraction S·G·Sᵀ on each CONTRACTION matrix, on both lanes,
    against scipy's float64 product; cuSPARSE's two products beside it."""
    import scipy.sparse as sp
    import torch

    from repro_torch.apps.graph_contraction import (graph_contraction,
                                                    label_matrix)
    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.sparse.ops import csr_transpose

    per_lane = {}
    for name, n in CONTRACTION.items():
        g = table_ii_matrix(name, seed=0, n_override=n, device="cuda")
        labels = np.random.default_rng(0).integers(0, n // 64, n)
        gh = host_csr(g)
        s = sp.csr_matrix((np.ones(n), (labels, np.arange(n))),
                          shape=(int(labels.max()) + 1, n))
        want = (s @ gh @ s.T).tocsr()
        want.sort_indices()
        total = float(gh.sum())
        for lane, kwargs, kernels, syncs_per in APP_LANES:
            def run():
                return graph_contraction(g, labels, **kwargs)

            (c, infos), cold_ms, launches, syncs, peak = counted_call(run)
            what = f"contraction {name}/{lane}"
            err = check_against_scipy(name, f"contraction/{lane}", c,
                                      int(c.nnz), want)
            kept = float(c.data[: int(c.nnz)].double().sum())
            check(abs(kept - total) <= RTOL * total,
                  f"{what}: total weight {kept} != {total}")
            check_lane_kernels(what, launches, kernels)
            check(syncs == 2 * syncs_per,
                  f"{what}: {syncs} pipeline syncs, expected {2 * syncs_per}")
            _, ms, _, _, _ = counted_call(run)
            per_lane[f"contraction/{name}/{lane}"] = launches
            emit({"contraction": {
                "matrix": name, "lane": lane, "rows": n,
                "labels": int(labels.max()) + 1, "nnz_g": gh.nnz,
                "nnz_c": int(c.nnz), "ms": ms, "cold_ms": cold_ms,
                "intermediate_products": [i["intermediate_products"]
                                          for i in infos],
                "group_sizes": [i["group_sizes"] for i in infos],
                "host_sync_count": syncs, "launches": launches,
                "peak_mem_gb": peak, "max_abs_err_vs_scipy": err,
                "total_weight": kept, "profiled": profiled(run)}}, log)
        st = label_matrix(labels, n=n, device="cuda")
        ts, tg, tst = torch_csr(st), torch_csr(g), torch_csr(csr_transpose(st))

        def cusparse():
            return torch.sparse.mm(torch.sparse.mm(ts, tg), tst)

        emit({"cusparse_contraction": {
            "matrix": name, "ms": time_ms(cusparse, reps=3),
            "device_ms": device_ms(cusparse, reps=3)}}, log)
        del g, st, ts, tg, tst
        torch.cuda.empty_cache()
    return per_lane


@contextlib.contextmanager
def recording_mcl():
    """Record, inside ``markov_clustering.mcl``, every expansion's product
    and every column-normalized iterate (the first is the normalized
    input), each with the host clock after a sync."""
    import torch

    from repro_torch.apps import markov_clustering as mc

    rec = {"expansions": [], "iterates": [], "t": [time.perf_counter()]}
    spgemm, normalize = mc.spgemm, mc.csr_column_normalize

    def spgemm_rec(*args, **kwargs):
        res = spgemm(*args, **kwargs)
        rec["expansions"].append(res.c)
        return res

    def normalize_rec(*args, **kwargs):
        out = normalize(*args, **kwargs)
        torch.cuda.synchronize()
        rec["t"].append(time.perf_counter())
        rec["iterates"].append(out)
        return out

    mc.spgemm, mc.csr_column_normalize = spgemm_rec, normalize_rec
    try:
        yield rec
    finally:
        mc.spgemm, mc.csr_column_normalize = spgemm, normalize


def column_normalized(c):
    """scipy CSR ``c`` with each column divided by its sum (as
    Algorithm 6's ColumnNormalize, an empty column stays empty)."""
    s = np.bincount(c.indices, weights=c.data, minlength=c.shape[1])
    inv = np.where(s > 1e-12, 1.0 / np.maximum(s, 1e-12), 0.0)
    out = c.copy()
    out.data = c.data * inv[c.indices]
    return out


class Csr(NamedTuple):
    """A CSR on one device for MCL's float64 checks: int32 ``indptr`` and
    ``indices`` (sorted in each row), ``data`` of any dtype."""
    indptr: Any
    indices: Any
    data: Any
    shape: tuple

    def same_structure(self, other) -> bool:
        import torch

        return torch.equal(self.indptr, other.indptr) \
            and torch.equal(self.indices, other.indices)


def card_csr(c, dtype) -> Csr:
    """A port CSR's occupied slots as a ``Csr`` on its device, the values
    in ``dtype`` (explicit zeros kept)."""
    nnz = int(c.indptr[-1])
    return Csr(c.indptr.int(), c.indices[:nnz].int(), c.data[:nnz].to(dtype),
               tuple(c.shape))


def row_ids(c: Csr):
    import torch

    return torch.repeat_interleave(
        torch.arange(c.shape[0], device=c.data.device),
        (c.indptr[1:] - c.indptr[:-1]).long())


def nonzero_part(c: Csr):
    """The entries of ``c`` whose value is not 0, and the mask of them
    over ``c``'s entries."""
    import torch

    mask = c.data != 0
    cm = torch.cat([mask.new_zeros(1, dtype=torch.int64),
                    torch.cumsum(mask, 0)])
    return Csr(cm[c.indptr.long()].int(), c.indices[mask], c.data[mask],
               c.shape), mask


def column_sums(c: Csr):
    import torch

    return torch.zeros(c.shape[1], dtype=c.data.dtype,
                       device=c.data.device).index_add_(
                           0, c.indices.long(), c.data)


def sparse_product(a: Csr, b: Csr) -> Csr:
    """``a @ b`` by ``torch.sparse.mm`` (cuSPARSE on the card), every
    product's entry kept, the columns sorted in each row."""
    import torch

    def tensor(c):
        return torch.sparse_csr_tensor(c.indptr, c.indices, c.data,
                                       size=c.shape, check_invariants=False)

    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        t = torch.sparse.mm(tensor(a), tensor(b))
    c = Csr(t.crow_indices().int(), t.col_indices().int(), t.values(),
            (a.shape[0], b.shape[1]))
    del t
    rows, cols = row_ids(c), c.indices.long()
    if bool(((cols[1:] > cols[:-1]) | (rows[1:] != rows[:-1])).all()):
        return c
    order = torch.argsort(rows * c.shape[1] + cols)
    return Csr(c.indptr, c.indices[order], c.data[order], c.shape)


def prune_reference(v: Csr, theta, k):
    """Algorithm 6's prune of float64 ``v`` (entries not 0): the kept
    mask over its entries, the mask of near decisions, and each column's
    k-th value.  A decision is near where its value lies within NEAR of
    theta, or within NEAR of its column's k-th value in a column whose
    (k+1)-th candidate lies within NEAR of the k-th (the cut between kept
    and dropped is then a near tie).  Within a column, entries rank by
    value descending, then by row, as the port ranks equal values by
    slot."""
    import torch

    vals, cols = v.data, v.indices.long()
    dev = vals.device
    ok = torch.nonzero(vals >= theta).squeeze(1)
    # one stable sort of col*2 + (1 - value) (values lie in (0, 1]): column,
    # then value descending, then CSR order (row); keys closer than ~6e-11
    # may misorder, far inside the NEAR band
    order = ok[torch.sort(cols[ok] * 2.0 + (1.0 - vals[ok]),
                          stable=True).indices]
    sc = cols[order]
    pos = torch.arange(len(order), device=dev)
    first = torch.ones(len(order), dtype=torch.bool, device=dev)
    first[1:] = sc[1:] != sc[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    kept = torch.zeros(len(vals), dtype=torch.bool, device=dev)
    kept[order[rank < k]] = True
    kth = torch.full((v.shape[1],), float("nan"), dtype=vals.dtype,
                     device=dev)
    kth[sc[rank == k - 1]] = vals[order[rank == k - 1]]
    next_ = torch.full_like(kth, float("nan"))
    next_[sc[rank == k]] = vals[order[rank == k]]
    tie = kth - next_ <= NEAR * kth  # False where a column has <= k
    near = ((vals - theta).abs() <= NEAR * theta) | (
        tie[cols] & (vals >= theta)
        & ((vals - kth[cols]).abs() <= NEAR * kth[cols]))
    return kept, near, kth


def pattern_product(x: Csr, cache) -> Csr:
    """The structure of ``x @ x`` (every product's entry, on a pattern of
    ones); ``cache`` keeps the last one, for another lane's ``x`` of the
    same structure."""
    import torch

    hit = cache.get("x")
    if hit is not None and hit.same_structure(x):
        return cache["p"]
    pattern = x._replace(data=torch.ones_like(x.data, dtype=torch.float32))
    p = sparse_product(pattern, pattern)
    cache.update(x=pattern, p=p)
    return p


def mcl_iteration_check(i, x, e_port, m_port, theta, k, r, cache):
    """Iteration ``i`` of Algorithm 6 in float64 with ``torch.sparse.mm``
    on the card, from the port's iterate ``x`` (a ``Csr`` with its
    explicit zeros), against the port's expansion ``e_port`` and iterate
    ``m_port`` (float64 ``Csr``s).

    The expansion's structure must equal the pattern product (explicit
    zeros kept) and its values the float64 product; every prune decision
    of the port must match the reference's unless it is near; columns with
    a differing decision are left out of the value check and counted."""
    import torch

    p = pattern_product(x, cache.setdefault(i, {}))
    check(e_port.same_structure(p),
          f"MCL iteration {i}: the expansion's structure is not the pattern "
          f"product")
    xn, _ = nonzero_part(x._replace(data=x.data.double()))
    v = sparse_product(xn, xn)
    del xn
    e_nz, e_mask = nonzero_part(e_port)
    check(e_nz.same_structure(v),
          f"MCL iteration {i}: the expansion's nonzero entries differ")
    check(torch.allclose(e_nz.data, v.data, rtol=RTOL, atol=ATOL),
          f"MCL iteration {i}: expansion values beyond rtol {RTOL} / atol "
          f"{ATOL}")
    check(m_port.same_structure(p),
          f"MCL iteration {i}: the iterate lost the expansion's structure")
    kept_ref, near, kth = prune_reference(v, theta, k)
    m_vals = m_port.data[e_mask]  # over v's entries
    check(not bool(m_port.data[~e_mask].any()),
          f"MCL iteration {i}: an entry zero after expansion came back")
    differ = (m_vals != 0) != kept_ref
    far = torch.nonzero(differ & ~near).squeeze(1)
    if len(far):
        f5 = far[:5]
        cols = v.indices[f5].long()
        print(json.dumps({"mcl_far_decisions": {
            "iteration": i, "count": len(far),
            "value": v.data[f5].tolist(),
            "port_value": e_nz.data[f5].tolist(),
            "kept_ref": kept_ref[f5].tolist(),
            "column": cols.tolist(), "kth": kth[cols].tolist()}}),
              flush=True)
    check(not len(far),
          f"MCL iteration {i}: {len(far)} prune decisions differ from the "
          f"reference away from their thresholds")
    want = v._replace(data=torch.where(kept_ref, v.data, 0.0) ** r)
    s = column_sums(want)
    inv = torch.where(s > 1e-12, 1.0 / s.clamp(min=1e-12), 0.0)
    want = want._replace(data=want.data * inv[want.indices.long()])
    tainted = torch.zeros(v.shape[1], dtype=torch.bool,
                          device=v.data.device)
    tainted[v.indices[differ].long()] = True
    cols_ok = ~tainted[v.indices.long()]
    got, ref = m_vals[cols_ok], want.data[cols_ok]
    check(torch.allclose(got, ref, rtol=RTOL, atol=ATOL),
          f"MCL iteration {i}: iterate values beyond rtol {RTOL} / atol "
          f"{ATOL}")
    sums = column_sums(m_port)
    check(bool(((sums[sums > 0] - 1.0).abs() <= 1e-5).all()),
          f"MCL iteration {i}: a nonzero column does not sum to 1")
    return {"iteration": i, "nnz_in": len(x.indices),
            "expansion_nnz": len(p.indices),
            "expansion_nonzero": len(v.indices),
            "kept": int((m_vals != 0).sum()),
            "near_decisions": int(near.sum()),
            "differing_decisions": int(differ.sum()),
            "columns_left_out": int(tainted.sum()),
            "max_abs_err": float((got - ref).abs().max())
            if len(got) else 0.0}, want


def same_partition(a, b) -> bool:
    pairs = np.unique(np.stack([a, b]), axis=1).shape[1]
    return pairs == len(np.unique(a)) == len(np.unique(b))


def weak_components(c: Csr, dtype=None):
    """Component labels of the support above 1e-6 of ``c``, the values and
    the cut compared in ``dtype`` (the port's: float32; by default
    ``c``'s)."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components

    dtype = dtype or c.data.dtype
    support, _ = nonzero_part(c._replace(data=(
        c.data.to(dtype) > torch.tensor(1e-6, dtype=dtype)).to(torch.int8)))
    host = sp.csr_matrix((support.data.cpu().numpy(),
                          support.indices.cpu().numpy(),
                          support.indptr.cpu().numpy()), shape=c.shape)
    return connected_components(host, directed=True, connection="weak")[1]


def mcl_phase(log):
    """Algorithm 6 on Economics at paper size, on both lanes: each
    iteration held against float64 products by ``torch.sparse.mm`` from
    the port's previous iterate (the first input against scipy's), the
    clusters against the reference's
    partition; per-iteration times and cuSPARSE's expansions beside
    them."""
    import scipy.sparse as sp
    import torch

    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.apps.markov_clustering import mcl

    name, n = MCL_MATRIX
    g = table_ii_matrix(name, seed=0, n_override=n, device="cuda")
    a0 = column_normalized((host_csr(g) + sp.identity(n, format="csr"))
                           .tocsr())
    a0.sort_indices()
    args = MCL_ARGS
    per_lane, patterns = {}, {}
    cusparse_in = None
    for lane, kwargs, kernels, syncs_per in APP_LANES:
        with recording_mcl() as rec:
            res, cold_ms, launches, syncs, peak = counted_call(
                lambda: mcl(g, **args, **kwargs))
        what = f"MCL {name}/{lane}"
        check_lane_kernels(what, launches, kernels)
        check(res.n_iterations == MCL_ARGS["max_iters"]
              and len(res.spgemm_info) == MCL_ARGS["max_iters"],
              f"{what}: {res.n_iterations} iterations")
        check(syncs == syncs_per * MCL_ARGS["max_iters"],
              f"{what}: {syncs} pipeline syncs")
        x = host_csr(rec["iterates"][0])
        check(np.array_equal(x.indptr, a0.indptr)
              and np.array_equal(x.indices, a0.indices)
              and np.allclose(x.data, a0.data, rtol=RTOL, atol=ATOL),
              f"{what}: the normalized input differs from scipy's")
        x = card_csr(rec["iterates"][0], torch.float32)
        iters = []
        for i in range(1, MCL_ARGS["max_iters"] + 1):
            e_port = card_csr(rec["expansions"][i - 1], torch.float64)
            m_port = card_csr(rec["iterates"][i], torch.float64)
            t0 = time.perf_counter()
            rec_i, want = mcl_iteration_check(i, x, e_port, m_port,
                                              args["theta"], args["k"],
                                              args["r"], patterns)
            rec_i["check_s"] = time.perf_counter() - t0
            rec_i["ms"] = (rec["t"][i + 1] - rec["t"][i]) * 1e3
            iters.append(rec_i)
            x = m_port
        if cusparse_in is None:
            cusparse_in = [rec["iterates"][0], rec["iterates"][1]]
        ref_clusters = weak_components(want)
        check(same_partition(res.clusters,
                             weak_components(m_port, torch.float32)),
              f"{what}: clusters are not the components of the port's "
              f"iterate")
        near_support = int(((want.data - 1e-6).abs() <= NEAR * 1e-6).sum())
        same = same_partition(res.clusters, ref_clusters)
        check(same or near_support or iters[-1]["columns_left_out"],
              f"{what}: the clusters differ from the reference's partition")
        del rec, x, e_port, m_port, want
        torch.cuda.empty_cache()
        again, ms, _, _, _ = counted_call(lambda: mcl(g, **args, **kwargs))
        # every sum adds in a fixed order: a second run, bit for bit
        check(same_csr(again.matrix, res.matrix)
              and np.array_equal(again.clusters, res.clusters),
              f"{what}: a second run differs")
        del again
        per_lane[f"mcl/{name}/{lane}"] = launches
        emit({"mcl": {
            "matrix": name, "lane": lane, "rows": n, "args": MCL_ARGS,
            "reduced": {"max_iters": "2 of bench_mcl's 3: the reference "
                        "keeps pruned entries, so a third expansion forms "
                        "~6e11 products"},
            "ms": ms, "recorded_ms": cold_ms, "iterations": iters,
            "second_run_bit_identical": True,
            "intermediate_products": [i["intermediate_products"]
                                      for i in res.spgemm_info],
            "nnz_c": [i["nnz_c"] for i in res.spgemm_info],
            "plan_cache_hits": res.plan_cache_hits,
            "clusters": int(len(np.unique(res.clusters))),
            "same_partition_as_reference": bool(same),
            "support_near_1e-6": near_support,
            "host_sync_count": syncs, "launches": launches,
            "peak_mem_gb": peak,
            "profiled": profiled(lambda: mcl(g, **args, **kwargs))}}, log)
        torch.cuda.empty_cache()
    exp = []
    for i, a in enumerate(cusparse_in, 1):
        t = torch_csr(a)
        exp.append({"iteration": i, "nnz_in": int(a.nnz),
                    "ms": time_ms(lambda: torch.sparse.mm(t, t), reps=1),
                    "device_ms": device_ms(lambda: torch.sparse.mm(t, t),
                                           reps=1),
                    "loop_ms": loop_ms(lambda: torch.sparse.mm(t, t),
                                       reps=3)})
        del t
        torch.cuda.empty_cache()
    emit({"cusparse_mcl_expansions": {"matrix": name, "expansions": exp}},
         log)
    mcl_cpu_check(log)
    return per_lane


def mcl_cpu_check(log):
    """MCL (MCL_ARGS) on Economics cut to MCL_CPU_ROWS rows on the default
    lane, on the card and on the CPU (the port's plain versions): the same
    matrix and clusters, bit for bit."""
    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.apps.markov_clustering import mcl

    name = MCL_MATRIX[0]
    g = table_ii_matrix(name, seed=0, n_override=MCL_CPU_ROWS, device="cpu")
    t0 = time.perf_counter()
    cpu = mcl(g, **MCL_ARGS)
    cpu_s = time.perf_counter() - t0
    card, ms, launches, _, _ = counted_call(
        lambda: mcl(dataclasses.replace(
            g, indptr=g.indptr.cuda(), indices=g.indices.cuda(),
            data=g.data.cuda()), **MCL_ARGS))
    check(same_csr(on_cpu(card.matrix), cpu.matrix)
          and np.array_equal(card.clusters, cpu.clusters),
          f"MCL {name} at {MCL_CPU_ROWS} rows: the card's run differs from "
          f"the CPU port's")
    check(launches["segment_sum"] > 0, f"MCL on the card: launches {launches}")
    emit({"mcl_vs_cpu_port": {"matrix": name, "rows": MCL_CPU_ROWS,
                              "lane": "default", "args": MCL_ARGS,
                              "nnz": int(cpu.matrix.nnz), "ms": ms,
                              "cpu_s": cpu_s, "launches": launches,
                              "bit_identical": True}}, log)


def gnn_reference_forward(cfg, params, a, x):
    """Float64 numpy/scipy forward of ``gnn_forward``: logits, and the
    rows whose k-th and (k+1)-th largest |value| lie within 1e-5
    (relative) at a TopK layer, where float32 may pick another entry."""
    h, near = x, np.zeros(x.shape[0], bool)
    for layer in range(cfg.n_layers):
        k = min(cfg.topk, h.shape[1])
        hs = h
        if cfg.sparse_mode == "topk" and layer > 0:
            order = np.argsort(-np.abs(h), axis=1, kind="stable")
            hs = np.zeros_like(h)
            rows = np.arange(h.shape[0])[:, None]
            hs[rows, order[:, :k]] = h[rows, order[:, :k]]
            mag = np.take_along_axis(np.abs(h), order, 1)
            near |= (mag[:, k - 1] > 0) & \
                (mag[:, k - 1] - mag[:, k] <= 1e-5 * mag[:, k - 1])
        agg = a @ hs
        w = params[f"w{layer}"]
        if cfg.arch == "gcn":
            h = agg @ w
        elif cfg.arch == "gin":
            h = ((1.0 + params[f"eps{layer}"]) * h + agg) @ w
        else:
            h = h @ params[f"w_self{layer}"] + agg @ w
        if layer < cfg.n_layers - 1:
            h = np.maximum(h, 0)
    return h, near


def k1_spmm_shape(a, x, log):
    """K1 on ``csr_spmm``'s one-plane shape (the ids of Â, rows of X), bit
    for bit against its plain version, on a contiguous X and, through
    ``csr_spmm``'s take, a transposed one; timed beside ``index_select``
    and its bound."""
    import torch

    from repro_torch.kernels import aia_gather
    from repro_torch.sparse.ops import _TakeRows

    idx = a.indices
    got, route = routed_call("gather_rows",
                             lambda: aia_gather.gather_rows(x, idx))
    want = aia_gather.gather_rows_plain(x, idx)
    check(torch.equal(got, want), "K1 on csr_spmm's shape differs")
    xt = x.T.contiguous().T  # the same values, column-major
    check(not xt.is_contiguous(), "the transposed case is contiguous")
    try:
        aia_gather.gather_rows(xt, idx)
        refused = False
    except ValueError:
        refused = True
    check(refused, "K1's wrapper took a strided x")
    got_t, _ = routed_call("gather_rows",
                           lambda: _TakeRows.apply(xt, idx, "aia"))
    check(torch.equal(got_t, aia_gather.gather_rows_plain(xt, idx)),
          "K1 through csr_spmm's take differs on a transposed X")
    # a column slice of a wider X: rows a pitch apart, gathered in place
    wide = torch.cat([x, -x], 1)
    xs = wide[:, :x.shape[1]]
    check(xs.stride(1) == 1 and not xs.is_contiguous(),
          "the column slice is contiguous")

    def sliced():
        return aia_gather.gather_rows(xs, idx)

    got_s, route_s = routed_call("gather_rows", sliced)
    check(torch.equal(got_s, want), "K1 on a column slice of X differs")
    got_s, _ = routed_call("gather_rows",
                           lambda: _TakeRows.apply(xs, idx, "aia"))
    check(torch.equal(got_s, want),
          "K1 through csr_spmm's take differs on a column slice of X")
    del got_s
    safe = idx.clamp(0, x.shape[0] - 1).long()
    n = idx.shape[0]
    row_bytes = x.shape[1] * x.element_size()
    distinct = int(torch.unique(safe).numel())

    def kernel():
        return aia_gather.gather_rows(x, idx)

    def plain():
        return aia_gather.gather_rows_plain(x, idx)

    def library():
        return torch.index_select(x, 0, safe)

    rec = {"rows": x.shape[0], "n_idx": n, "row_bytes": row_bytes,
           "distinct_rows": distinct, "route": route,
           "transposed_held": True, "max_abs_err": 0.0,
           "ms": time_ms(kernel, reps=20), "device_ms": device_ms(kernel),
           "loop_ms": loop_ms(kernel),
           "plain_ms": time_ms(plain, reps=20),
           "plain_device_ms": device_ms(plain), "plain_loop_ms": loop_ms(plain),
           "library_ms": time_ms(library, reps=20),
           "library_device_ms": device_ms(library),
           "library_loop_ms": loop_ms(library),
           "bound_ms": bound_ms((distinct + n) * row_bytes + n * 4)}
    rec["column_slice"] = {
        "pitch_bytes": xs.stride(0) * x.element_size(), "route": route_s,
        "max_abs_err": 0.0, "ms": time_ms(sliced, reps=20),
        "device_ms": device_ms(sliced), "loop_ms": loop_ms(sliced),
        "plain_ms": time_ms(lambda: aia_gather.gather_rows_plain(xs, idx),
                            reps=5),
        "library_ms": time_ms(lambda: torch.index_select(xs, 0, safe),
                              reps=20),
        "bound_ms": rec["bound_ms"]}
    del wide, xs
    emit({"k1_csr_spmm": rec}, log)
    return rec


def gnn_inputs() -> dict:
    """ogbn-arxiv at paper size (GNN) from seed 0: the graph, Â, X and the
    labels on the card and on the host, Â = D^-1/2 (G + I) D^-1/2 in
    float64 from G by scipy (D: entries per row, independently of the
    port), and the port's Â in float64 on the CPU."""
    import scipy.sparse as sp
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps.graphs import rmat_graph
    from repro_torch.sparse.formats import CSR

    n = GNN["nodes"]
    g = rmat_graph(n, GNN["avg_deg"], seed=0, device="cuda")
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((n, GNN["d"])).astype(np.float32)
    labels_np = rng.integers(0, GNN["n_classes"], n)
    a = gnn.normalize_adjacency(g)
    ai = (host_csr(g) + sp.identity(n, format="csr")).tocsr()
    dinv = 1.0 / np.sqrt(np.maximum(np.diff(ai.indptr), 1.0))
    return {"g": g, "a": a, "x": torch.from_numpy(x_np).cuda(),
            "labels": torch.from_numpy(labels_np).cuda(), "x_np": x_np,
            "labels_np": labels_np,
            "a64": sp.diags(dinv) @ ai @ sp.diags(dinv),
            "a_cpu": CSR(a.indptr.cpu(), a.indices.cpu(),
                         a.data.cpu().double(), a.shape)}


def gnn_step1_check(what, cfg, params, d, mesh=None) -> dict:
    """Step 1 of ``cfg`` on ``d`` (``gnn_inputs``), under ``mesh``: its
    logits against a float64 numpy forward (rows that a near TopK tie
    reaches left out) and its gradients against a float64 CPU autograd run
    of the port's plain path, each within GNN_REL of the largest |value|."""
    import torch

    from repro_torch.apps import gnn

    a, x, n = d["a"], d["x"], d["a"].n_rows
    p64 = {k: v.cpu().double().numpy() for k, v in params.items()}
    want, near = gnn_reference_forward(cfg, p64, d["a64"],
                                       d["x_np"].astype(np.float64))
    with torch.no_grad():
        got = gnn.gnn_forward(cfg, params, a, x, mesh=mesh).double().cpu()
    affected = (d["a64"] @ near.astype(np.float64)) > 0
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want)[~affected].max()
    check(err <= GNN_REL * scale,
          f"{what}: logits {err} beyond {GNN_REL} of {scale}")
    # step 1's gradients: float32 on the card, float64 on the CPU
    mask = torch.ones(n, device=a.device)
    live = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = gnn._loss_fn(cfg, live, a, x, d["labels"], mask, mesh=mesh)
    g32 = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    live64 = {k: torch.from_numpy(v).requires_grad_()
              for k, v in p64.items()}
    loss64 = gnn._loss_fn(cfg, live64, d["a_cpu"],
                          torch.from_numpy(d["x_np"]).double(),
                          torch.from_numpy(d["labels_np"]),
                          torch.ones(n, dtype=torch.float64))
    g64 = dict(zip(live64, torch.autograd.grad(
        loss64, list(live64.values()))))
    grad_err = {}
    for k in g32:
        ref = g64[k].numpy()
        e = float(np.abs(g32[k].double().cpu().numpy() - ref).max())
        grad_err[k] = e / max(np.abs(ref).max(), 1e-300)
        check(grad_err[k] <= GNN_REL,
              f"{what}: step-1 gradient of {k} {grad_err[k]} beyond "
              f"{GNN_REL}")
    return {"logits_err": float(err), "logits_scale": float(scale),
            "rows_near_topk_tie": int(near.sum()),
            "logit_rows_left_out": int(affected.sum()),
            "grad_rel_err": grad_err, "loss_step1": float(loss64.detach())}


def gnn_repeat(cfg, d, trained, hist) -> dict:
    """A finding, not a gate: ``train_gnn`` run again from the same seed,
    and whether its losses and trained parameters are the first run's bit
    for bit; with the kernels of one profiled step that accumulate (their
    names), where an order of adds could still move."""
    import torch

    from repro_torch.apps import gnn

    again, hist2 = gnn.train_gnn(cfg, d["a"], d["x"], d["labels"],
                                 n_steps=GNN["steps"], seed=0)
    _, _, top = profile(lambda: gnn.train_gnn(cfg, d["a"], d["x"],
                                              d["labels"], n_steps=1,
                                              seed=0), top_n=60)
    words = ("scatter", "index", "atomic", "reduce", "segment", "put")
    return {"losses_bit_identical": list(hist) == list(hist2),
            "params_bit_identical": all(torch.equal(trained[k], again[k])
                                        for k in trained),
            "param_sums": {k: [float(trained[k].double().sum()),
                               float(again[k].double().sum())]
                           for k in trained},
            "accumulating_kernels": sorted({name for name, _, _ in top
                                            if any(w in name.lower()
                                                   for w in words)})}


def gnn_phase(log):
    """Full-batch GNN training on ogbn-arxiv at paper size, 3 archs x 2
    modes: step 1 held by ``gnn_step1_check``, then ``train_gnn`` with one
    K1 launch per aggregation; cuSPARSE SpMM beside one aggregation."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.sparse.ops import csr_spmm

    n = GNN["nodes"]
    d = gnn_inputs()
    g, a, x, labels = d["g"], d["a"], d["x"], d["labels"]
    k1 = k1_spmm_shape(a, x, log)
    per_lane = {}
    for arch in ("gcn", "gin", "sage"):
        for mode in ("topk", "dense"):
            cfg = gnn.GNNConfig(arch=arch, d_in=GNN["d"], d_hidden=GNN["d"],
                                n_classes=GNN["n_classes"], topk=GNN["topk"],
                                sparse_mode=mode, n_layers=GNN["n_layers"])
            what = f"GNN {arch}/{mode}"
            params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                                  device="cuda")
            step1 = gnn_step1_check(what, cfg, params, d)
            (trained, hist), ms, launches, _, peak = counted_call(
                lambda: gnn.train_gnn(cfg, a, x, labels,
                                      n_steps=GNN["steps"], seed=0))
            check(all(np.isfinite(hist)), f"{what}: loss {hist}")
            if (arch, mode) == GNN_REPEAT:
                step1["repeat"] = gnn_repeat(cfg, d, trained, hist)
            check(launches["gather_rows"] == GNN["steps"] * cfg.n_layers
                  and launches["hash_accumulate"] == 0,
                  f"{what}: launches {launches}, expected one K1 launch per "
                  f"aggregation")
            per_lane[f"gnn/{arch}/{mode}"] = launches
            emit({"gnn": {
                "dataset": GNN["dataset"], "arch": arch, "mode": mode,
                "nodes": n, "edges": int(g.nnz), "nnz_a_hat": int(a.nnz),
                "steps": GNN["steps"], "loss": hist,
                "ms": ms, "ms_per_step": ms / GNN["steps"],
                "launches": launches, "peak_mem_gb": peak, **step1,
                "profiled_2_steps": profiled(
                    lambda: gnn.train_gnn(cfg, a, x, labels, n_steps=2,
                                          seed=0))}}, log)
            torch.cuda.empty_cache()

    def aggregation():
        return csr_spmm(a, x, gather="aia")

    ta = torch_csr(a)

    def cusparse():
        return torch.sparse.mm(ta, x)

    emit({"gnn_aggregation": {
        "nodes": n, "nnz_a_hat": int(a.nnz), "d": GNN["d"],
        "ms": time_ms(aggregation, reps=10),
        "device_ms": device_ms(aggregation),
        "loop_ms": loop_ms(aggregation),
        "cusparse_ms": time_ms(cusparse, reps=10),
        "cusparse_device_ms": device_ms(cusparse),
        "cusparse_loop_ms": loop_ms(cusparse)}}, log)
    return per_lane, k1


def apps_phase(log):
    """The three applications, each lane with its launch counts from 0;
    MCL last, since the profiler reads later kernels low after its
    traces."""
    per_lane = contraction_phase(log)
    gnn_lanes, k1 = gnn_phase(log)
    per_lane.update(gnn_lanes)
    per_lane.update(mcl_phase(log))
    return per_lane, k1


# ---------------------------------------------------------------------------
# Phase 10: mini-batch GNN training on bulk-sampled subgraphs
# ---------------------------------------------------------------------------

DEVICE = "cuda"  # the device of the mini-batch and stream phases
# ogbn-arxiv as GNN has it.  Sampling: the first 4 vertex batches of
# train_gnn_minibatch's order at 1,024 vertices, fanout 10 (GraphSAGE's
# per-layer fanout), each with its per-batch seed; the ensemble: 4 DropEdge
# reweightings keeping an edge with probability 0.9; training: sage on
# fused_hash, 2 epochs, at batches of 32,768 (a cut forced by the time
# limit: each step draws every frontier row on the host).
MB = {"batch": 1024, "fanout": 10, "sample_batches": 4, "members": 4,
      "keep": 0.9, "train_batch": 32_768, "epochs": 2}
MB_LANES = (("default", {}), ("fused_hash", {"engine": "fused_hash"}))
MB_KERNELS = {"default": {"gather_rows"},
              "fused_hash": {"gather_rows", "hash_accumulate"}}
ENSEMBLE_REL = 1e-6  # the ensemble mean, as tests/test_torch_sampling.py


def sync() -> None:
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def same_csr(x, y) -> bool:
    """Two port CSRs with the same shape, indptr and occupied slots, bit
    for bit."""
    import torch

    if x.shape != y.shape or not torch.equal(x.indptr, y.indptr):
        return False
    nnz = int(x.nnz)
    return torch.equal(x.indices[:nnz], y.indices[:nnz]) and \
        torch.equal(x.data[:nnz], y.data[:nnz])


def numpy_layer(a_host, q, fanout, rng):
    """One layer of the reference's sampler (``src/repro/apps/sampling.py``
    :51-78) in numpy/scipy from frontier ``q``: P = A[q] in float32, row
    sums by ``np.add.at`` in slot order, the per-row draws from ``rng``;
    returns the next frontier."""
    p = a_host[q]
    rid = np.repeat(np.arange(len(q)), np.diff(p.indptr))
    rowsum = np.zeros(len(q), np.float32)
    np.add.at(rowsum, rid, p.data)
    inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0) \
        .astype(np.float32)
    data = p.data * inv[rid]
    picks = set()
    for i in range(len(q)):
        lo, hi = p.indptr[i], p.indptr[i + 1]
        cols, w = p.indices[lo:hi], np.maximum(data[lo:hi], 0)
        if len(cols) == 0 or w.sum() <= 0:
            continue
        chosen = rng.choice(cols, size=min(fanout, len(cols)), replace=False,
                            p=w / w.sum())
        picks.update(int(c) for c in chosen)
    return np.unique(np.concatenate([q, np.asarray(sorted(picks), np.int64)]))


def check_chain(what, a_host, seed, adjs, frontiers):
    """Hold a sampled chain layer by layer against ``numpy_layer`` from the
    port's own previous frontier (one generator across the layers, as the
    reference) and each adjacency against ``A[rows][:, cols]``, exactly."""
    rng = np.random.default_rng(seed)
    for layer, adj in enumerate(adjs):
        q, q_next = frontiers[layer], frontiers[layer + 1]
        check(np.array_equal(q, np.unique(q)) and np.isin(q, q_next).all(),
              f"{what}: frontier {layer} is not sorted inside the next")
        check(np.array_equal(q_next, numpy_layer(a_host, q, MB["fanout"],
                                                 rng)),
              f"{what}: frontier {layer + 1} differs from the reference's")
        want = a_host[q][:, q_next].tocsr()
        want.sort_indices()
        got = host_csr(adj, np.float32)
        check(got.shape == want.shape
              and np.array_equal(got.indptr, want.indptr)
              and np.array_equal(got.indices, want.indices)
              and np.array_equal(got.data, want.data),
              f"{what}: A^{layer} is not A[rows][:, cols] bit for bit")


def sample_chains(a, a_host, batches, log):
    """(a) ``bulk_sample`` on both lanes: the default lane against the
    numpy re-run, ``fused_hash`` bit for bit against the default lane (so
    against the re-run too)."""
    from repro_torch.apps import sampling

    chains, per_lane = {}, {}
    kb_cap = int(np.diff(a_host.indptr).max())
    for lane, kw in MB_LANES:
        recs, total = [], {}
        for bi, batch in enumerate(batches):
            (adjs, frontiers), ms, launches, syncs, peak = counted_call(
                lambda: sampling.bulk_sample(
                    a, batch, fanout=MB["fanout"], n_layers=GNN["n_layers"],
                    seed=bi, **kw))
            what = f"bulk_sample {lane} batch {bi}"
            check_lane_kernels(what, launches, MB_KERNELS[lane])
            if lane == "default":
                t0 = time.perf_counter()
                check_chain(what, a_host, bi, adjs, frontiers)
                check_s = time.perf_counter() - t0
                chains[bi] = (adjs, frontiers)
            else:
                check_s = None
                ref_adjs, ref_frontiers = chains[bi]
                check(all(np.array_equal(f, r) for f, r in
                          zip(frontiers, ref_frontiers))
                      and all(same_csr(x, y) for x, y in zip(adjs, ref_adjs)),
                      f"{what}: the chain differs from the default lane's")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            recs.append({"batch": bi, "seed": bi,
                         "frontiers": [len(f) for f in frontiers],
                         "adj_nnz": [int(x.nnz) for x in adjs],
                         "ms": ms, "launches": launches,
                         "host_sync_count": syncs, "peak_mem_gb": peak,
                         "numpy_check_s": check_s})
        per_lane[f"minibatch_sample/{lane}"] = total
        emit({"minibatch_sample": {
            "dataset": GNN["dataset"], "lane": lane, "batch": MB["batch"],
            "fanout": MB["fanout"], "kb_cap": kb_cap,
            "held": "numpy re-run" if lane == "default"
                    else "bit for bit the default lane",
            "batches": recs}}, log)
    return chains, per_lane


def ensemble_check(a, a_host, batch, log):
    """(b) W DropEdge reweightings of A through ``spgemm_batched``: every
    member bit for bit against scipy's product, the mean within
    ENSEMBLE_REL of the float64 mean, K1 one launch a chunk (the folded
    plane), K2 once a member a chunk; then ``bulk_sample`` on them."""
    import scipy.sparse as sp
    import torch

    from repro_torch.apps import sampling
    from repro_torch.core import executor
    from repro_torch.core.grouping import group_rows

    nnz = int(a.nnz)
    rng = np.random.default_rng(0)
    base = a_host.data.astype(np.float32)
    ws = (base * (rng.random((MB["members"], nnz)) < MB["keep"])
          / np.float32(MB["keep"])).astype(np.float32)
    q = sampling.selection_matrix(batch, a.n_rows, DEVICE)
    members = sampling._weighted_members(a, ws)
    items = executor.partition_plan(group_rows(q, a),
                                    np.diff(q.indptr.cpu().numpy()), 4096)
    res, ms, launches, syncs, peak = counted_call(
        lambda: sampling.spgemm_batched(q, members, engine="fused_hash"))
    check(launches["gather_rows"] == len(items)
          and launches["hash_accumulate"] == MB["members"] * len(items),
          f"ensemble: launches {launches} for {len(items)} chunks")
    got = []
    for i, c in enumerate(res.cs):
        want = sp.csr_matrix((ws[i], a_host.indices, a_host.indptr),
                             shape=a_host.shape)[batch]
        h = host_csr(c, np.float32)
        check(np.array_equal(h.indptr, want.indptr)
              and np.array_equal(h.indices, want.indices)
              and np.array_equal(h.data, want.data),
              f"ensemble member {i} differs from scipy's product")
        got.append(h.data.astype(np.float64))
    mean = sampling._ensemble_mean(res.cs)
    m = mean.data[:int(mean.nnz)].cpu().numpy().astype(np.float64)
    want_mean = np.mean(got, axis=0)
    err = float((np.abs(m - want_mean) / np.maximum(np.abs(want_mean),
                                                    1e-300)).max())
    check(err <= ENSEMBLE_REL, f"ensemble mean {err} beyond {ENSEMBLE_REL}")
    # The reference's sampler draws min(fanout, row nnz) columns whatever
    # their weights, so a row whose mean weight is 0 on too many of its
    # edges (every member dropped them) makes numpy's choice raise there;
    # the port keeps that behaviour (ROADMAP Queue C).
    try:
        (adjs, frontiers), s_ms, _, _, s_peak = counted_call(
            lambda: sampling.bulk_sample(a, batch, fanout=MB["fanout"],
                                         n_layers=GNN["n_layers"], seed=0,
                                         weight_sets=ws))
        chain = {"frontiers": [len(f) for f in frontiers], "ms": s_ms,
                 "peak_mem_gb": s_peak}
        for layer, adj in enumerate(adjs):
            want = a_host[frontiers[layer]][:, frontiers[layer + 1]].tocsr()
            want.sort_indices()
            h = host_csr(adj, np.float32)
            check(np.array_equal(h.indptr, want.indptr)
                  and np.array_equal(h.data, want.data),
                  f"ensemble chain: A^{layer} is not a submatrix of A")
    except ValueError as exc:
        check("non-zero entries in p" in str(exc), f"ensemble chain: {exc}")
        chain = {"raised": str(exc)}
    del res, mean
    torch.cuda.empty_cache()
    emit({"minibatch_ensemble": {
        "members": MB["members"], "keep": MB["keep"], "rows": len(batch),
        "chunks": len(items), "launches": launches, "ms": ms,
        "host_sync_count": syncs, "peak_mem_gb": peak,
        "mean_rel_err": err, "tolerance": ENSEMBLE_REL,
        "bulk_sample": chain}}, log)


def minibatch_reference_forward(cfg, params, adjs, frontiers, x):
    """Float64 numpy forward of ``gnn_forward_minibatch`` over a chain
    (host CSRs in float64): the logits and the output rows that a TopK
    near-tie (k-th and (k+1)-th |value| within 1e-5 relative) can reach."""
    n_layers = cfg.n_layers
    h = x[frontiers[n_layers]]
    near = np.zeros(h.shape[0], bool)
    for layer in range(n_layers):
        t = n_layers - 1 - layer
        rows, cols = frontiers[t], frontiers[t + 1]
        k = min(cfg.topk, h.shape[1])
        hs = h
        if cfg.sparse_mode == "topk" and layer > 0:
            order = np.argsort(-np.abs(h), axis=1, kind="stable")
            hs = np.zeros_like(h)
            r = np.arange(h.shape[0])[:, None]
            hs[r, order[:, :k]] = h[r, order[:, :k]]
            mag = np.take_along_axis(np.abs(h), order, 1)
            near |= (mag[:, k - 1] > 0) & \
                (mag[:, k - 1] - mag[:, k] <= 1e-5 * mag[:, k - 1])
        agg = adjs[t] @ hs
        self_idx = np.searchsorted(cols, rows)
        h_self = h[self_idx]
        near = ((adjs[t] @ near.astype(np.float64)) > 0) | near[self_idx]
        w = params[f"w{layer}"]
        if cfg.arch == "gcn":
            h = agg @ w
        elif cfg.arch == "gin":
            h = ((1.0 + params[f"eps{layer}"]) * h_self + agg) @ w
        else:
            h = h_self @ params[f"w_self{layer}"] + agg @ w
        if layer < n_layers - 1:
            h = np.maximum(h, 0)
    return h, near


def minibatch_loss(cfg, params, adjs, frontiers, x, y):
    import torch

    from repro_torch.apps import gnn

    logits = gnn.gnn_forward_minibatch(cfg, params, adjs, frontiers, x)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))


def forward_check(chain, x_np, labels_np, log):
    """(c) ``gnn_forward_minibatch`` for gcn, gin and sage (topk) on one
    sampled chain: logits against a float64 numpy forward, step-1
    gradients against a float64 CPU autograd run of the port's plain
    path, each within GNN_REL of the largest |value|."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.sparse.formats import CSR

    adjs, frontiers = chain
    adj64 = [host_csr(t) for t in adjs]
    adj_cpu = [CSR(t.indptr.cpu(), t.indices.cpu(), t.data.cpu().double(),
                   t.shape) for t in adjs]
    x = torch.from_numpy(x_np).to(DEVICE)
    y = torch.from_numpy(labels_np[frontiers[0]]).long()
    out = {}
    for arch in ("gcn", "gin", "sage"):
        cfg = gnn.GNNConfig(arch=arch, d_in=GNN["d"], d_hidden=GNN["d"],
                            n_classes=GNN["n_classes"], topk=GNN["topk"],
                            sparse_mode="topk", n_layers=GNN["n_layers"])
        what = f"minibatch GNN {arch}"
        params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                              device=DEVICE)
        p64 = {k: v.cpu().double().numpy() for k, v in params.items()}
        want, near = minibatch_reference_forward(cfg, p64, adj64, frontiers,
                                                 x_np.astype(np.float64))
        with torch.no_grad():
            got = gnn.gnn_forward_minibatch(cfg, params, adjs, frontiers,
                                            x).double().cpu().numpy()
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want)[~near].max(initial=0.0))
        check(err <= GNN_REL * scale,
              f"{what}: logits {err} beyond {GNN_REL} of {scale}")
        live = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = minibatch_loss(cfg, live, adjs, frontiers, x, y.to(DEVICE))
        g32 = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        live64 = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in p64.items()}
        loss64 = minibatch_loss(cfg, live64, adj_cpu, frontiers,
                                torch.from_numpy(x_np).double(), y)
        g64 = dict(zip(live64, torch.autograd.grad(loss64,
                                                   list(live64.values()))))
        grad_err = {}
        for k in g32:
            ref = g64[k].numpy()
            e = float(np.abs(g32[k].double().cpu().numpy() - ref).max())
            grad_err[k] = e / max(float(np.abs(ref).max()), 1e-300)
            check(grad_err[k] <= GNN_REL,
                  f"{what}: step-1 gradient of {k} {grad_err[k]} beyond "
                  f"{GNN_REL}")
        out[arch] = {"logits_err": err, "logits_scale": scale,
                     "logit_rows_left_out": int(near.sum()),
                     "loss_step1": float(loss64.detach()),
                     "grad_rel_err": grad_err}
    emit({"minibatch_forward": {"frontiers": [len(f) for f in frontiers],
                                "tolerance": GNN_REL, "archs": out}}, log)


@contextlib.contextmanager
def timed_sampling():
    """Time, inside ``apps.sampling``, every ``bulk_sample`` call (with the
    plan-cache counters at its start), the host steps ``norm_rows`` and
    ``sample_rows``, and every ``spgemm``/``spgemm_batched`` (a sync
    before and after each)."""
    from repro_torch.apps import sampling
    from repro_torch.core import executor

    rec = {k: [] for k in ("bulk_sample", "norm_rows", "sample_rows",
                           "spgemm", "plan_stats")}
    saved = {k: getattr(sampling, k) for k in (
        "bulk_sample", "norm_rows", "sample_rows", "spgemm",
        "spgemm_batched")}

    def timed(name, fn):
        def call(*args, **kwargs):
            if name == "bulk_sample":
                st = executor.cache_stats()
                rec["plan_stats"].append((st["plan_hits"],
                                          st["plan_misses"]))
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            rec[name].append(time.perf_counter() - t0)
            return out
        return call

    for name, fn in saved.items():
        setattr(sampling, name,
                timed("spgemm" if name == "spgemm_batched" else name, fn))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(sampling, name, fn)


def one_step(cfg, a, x, labels_np, batch, seed, params, opt, opt_state):
    """One step of ``train_gnn_minibatch`` (its sampling, forward, loss,
    gradients, clipping and AdamW), for the profiler."""
    import torch

    from repro_torch.apps import sampling
    from repro_torch.optim import apply_updates, clip_by_global_norm

    adjs, frontiers = sampling.bulk_sample(
        a, batch, fanout=MB["fanout"], n_layers=cfg.n_layers, seed=seed,
        engine="fused_hash", gather=cfg.gather)
    y = torch.from_numpy(labels_np[frontiers[0]]).long().to(DEVICE)
    live = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = minibatch_loss(cfg, live, adjs, frontiers, x, y)
    keys = sorted(live)
    grads = dict(zip(keys, torch.autograd.grad(loss,
                                               [live[k] for k in keys])))
    grads, _ = clip_by_global_norm(grads, 1.0)
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), float(loss.detach())


def train_check(a, x_np, labels_np, log):
    """(d) ``train_gnn_minibatch`` itself (sage, fused_hash): every loss
    finite, every SpGEMM of epoch 2 a PlanCache hit; ms a step split into
    host sampling, the six SpGEMMs and forward + backward + AdamW, the
    kernels' launches a step, and one step profiled."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.core import executor
    from repro_torch.optim import adamw

    cfg = gnn.GNNConfig(arch="sage", d_in=GNN["d"], d_hidden=GNN["d"],
                        n_classes=GNN["n_classes"], topk=GNN["topk"],
                        sparse_mode="topk", n_layers=GNN["n_layers"])
    n = a.n_rows
    x = torch.from_numpy(x_np).to(DEVICE)
    n_batches = -(-n // MB["train_batch"])
    steps = MB["epochs"] * n_batches
    with timed_sampling() as rec:
        (params, hist, stats), ms, launches, syncs, peak = counted_call(
            lambda: gnn.train_gnn_minibatch(
                cfg, a, x, labels_np, batch_size=MB["train_batch"],
                n_epochs=MB["epochs"], fanout=MB["fanout"], seed=0,
                engine="fused_hash"))
    check(len(hist) == steps and all(np.isfinite(hist)),
          f"train_gnn_minibatch: losses {hist}")
    hits0, misses0 = rec["plan_stats"][n_batches]
    end = executor.cache_stats()
    sgemm_per_step = 3 * cfg.n_layers
    check(end["plan_misses"] == misses0
          and end["plan_hits"] - hits0 == sgemm_per_step * n_batches,
          f"epoch 2: {end['plan_misses'] - misses0} PlanCache misses, "
          f"{end['plan_hits'] - hits0} hits")
    check(stats["plan_cache_misses"] == end["plan_misses"]
          and stats["plan_cache_hits"] == end["plan_hits"],
          f"stats {stats} vs executor {end}")
    check(len(rec["spgemm"]) == sgemm_per_step * steps,
          f"{len(rec['spgemm'])} SpGEMMs in {steps} steps")
    sample_s = sum(rec["bulk_sample"])
    host_s = sum(rec["norm_rows"]) + sum(rec["sample_rows"])
    spgemm_s = sum(rec["spgemm"])
    split = {"step": ms / steps,
             "host_sampling": host_s * 1e3 / steps,
             "norm_rows": sum(rec["norm_rows"]) * 1e3 / steps,
             "sample_rows": sum(rec["sample_rows"]) * 1e3 / steps,
             "six_spgemms": spgemm_s * 1e3 / steps,
             "sampling_other": (sample_s - host_s - spgemm_s) * 1e3 / steps,
             "forward_backward_adamw": (ms / 1e3 - sample_s) * 1e3 / steps}
    opt = adamw(1e-2, weight_decay=0.0)
    order = np.random.default_rng(0).permutation(n)
    batch0 = np.sort(order[:MB["train_batch"]])
    prof = profiled(lambda: one_step(cfg, a, x, labels_np, batch0, 0,
                                     params, opt, opt.init(params)))
    per_step = {k: v / steps for k, v in launches.items()}
    emit({"minibatch_train": {
        "dataset": GNN["dataset"], "arch": "sage", "engine": "fused_hash",
        "batch_size": MB["train_batch"], "batches_an_epoch": n_batches,
        "epochs": MB["epochs"], "fanout": MB["fanout"],
        "reduced": {"batch_size": f"{MB['train_batch']}: a cut for the "
                    "script's time limit (the host's draws cost about the "
                    "same a step, so fewer steps an epoch)"},
        "loss": hist, "ms": ms, "ms_a_step": split,
        "plan_cache": stats, "epoch2_plan_hits": end["plan_hits"] - hits0,
        "launches": launches, "launches_a_step": per_step,
        "host_sync_count": syncs, "peak_mem_gb": peak,
        "profiled_step": prof}}, log)
    return per_step


def minibatch_phase(log):
    """Mini-batch GNN training on ogbn-arxiv at paper size: (a) sampling
    held bit for bit on both lanes, (b) the weight ensemble, (c) forward
    and gradients on a sampled chain, (d) ``train_gnn_minibatch``."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps.graphs import rmat_graph
    from repro_torch.core import executor

    t0 = time.perf_counter()
    emit({"minibatch_phase_resident_gb":
          torch.cuda.memory_allocated() / 1e9}, log)
    n = GNN["nodes"]
    g = rmat_graph(n, GNN["avg_deg"], seed=0, device=DEVICE)
    a = gnn.normalize_adjacency(g)
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((n, GNN["d"])).astype(np.float32)
    labels_np = rng.integers(0, GNN["n_classes"], n)
    a_host = host_csr(a, np.float32)
    order = np.random.default_rng(0).permutation(n)
    batches = [np.sort(order[i * MB["batch"]:(i + 1) * MB["batch"]])
               for i in range(MB["sample_batches"])]
    chains, per_lane = sample_chains(a, a_host, batches, log)
    ensemble_check(a, a_host, batches[0], log)
    forward_check(chains[0], x_np, labels_np, log)
    del chains
    torch.cuda.empty_cache()
    per_step = train_check(a, x_np, labels_np, log)
    executor.clear_program_cache()  # drops Â's 13.6 GB ELL from the cache
    torch.cuda.empty_cache()
    emit({"minibatch_phase_s": time.perf_counter() - t0}, log)
    return per_lane, per_step


# ---------------------------------------------------------------------------
# Phase 11: the out-of-core streamed lane and its resilience layer
# ---------------------------------------------------------------------------

# p2p-Gnutella04 in 6 tiles of 2,048 rows (the last ragged) at prefetch
# 1-3; RoadTX in 6 tiles of 2^18 rows; a budget of half p2p's estimate;
# MCL on Economics under 1 GiB.
STREAM = {"matrix": ("p2p-Gnutella04", 10_876), "tile_rows": 2048,
          "prefetch": (1, 2, 3), "roadtx": ("RoadTX", 1_393_383),
          "roadtx_tile_rows": 1 << 18, "mcl_budget": 1 << 30}


def stream_overlap(trace_events) -> dict:
    """From a profiler trace: the host-to-device copies on streams other
    than the compute stream (the one with the most kernel time), their
    total ms, and the ms of them that overlap a kernel on the compute
    stream."""
    kernels, copies = {}, []
    for ev in trace_events:
        args = ev.get("args", {})
        if ev.get("cat") == "kernel":
            kernels.setdefault(args.get("stream"), []).append(
                (ev["ts"], ev["ts"] + ev["dur"]))
        elif ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            copies.append((args.get("stream"), ev["ts"],
                           ev["ts"] + ev["dur"]))
    check(kernels and copies, "the profiler traced no kernel or no copy")
    compute = max(kernels, key=lambda s: sum(e - b for b, e in kernels[s]))
    spans = []
    for b, e in sorted(kernels[compute]):
        if spans and b <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([b, e])
    side = [(b, e) for s, b, e in copies if s != compute]
    overlap = sum(max(0.0, min(e, se) - max(b, sb))
                  for b, e in side for sb, se in spans)
    return {"compute_stream": compute,
            "side_copies": len(side),
            "side_copy_ms": sum(e - b for b, e in side) / 1e3,
            "side_copy_overlap_ms": overlap / 1e3,
            "compute_stream_copies": len(copies) - len(side)}


def traced(fn) -> list:
    """The chrome-trace events of one profiled call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _trace_events(prof)


def stream_p2p(a, log):
    """(a) ``spgemm_streamed`` of the p2p self-product at prefetch 1-3 on
    both lanes against the monolithic call (bit for bit) and scipy."""
    from repro_torch.core import executor
    from repro_torch.core.spgemm import spgemm, spgemm_streamed

    name = STREAM["matrix"][0]
    want = scipy_product(a)
    n_tiles = len(executor.tile_ranges(a.n_rows, STREAM["tile_rows"]))
    monos, per_stream = {}, {}
    for lane, kw in MB_LANES:
        mono, mono_ms, mono_launches, _, mono_peak = counted_call(
            lambda: spgemm(a, a, **kw))
        monos[lane] = (mono, mono_ms, mono_peak)
        recs = []
        for prefetch in STREAM["prefetch"]:
            res, ms, launches, syncs, peak = counted_call(
                lambda: spgemm_streamed(a, a, tile_rows=STREAM["tile_rows"],
                                        prefetch=prefetch, **kw))
            st = executor.cache_stats()
            what = f"streamed {name}/{lane}/prefetch {prefetch}"
            check_lane_kernels(what, launches, MB_KERNELS[lane])
            check(st["tiles_streamed"] == n_tiles == res.info["n_tiles"],
                  f"{what}: {st['tiles_streamed']} tiles")
            check(st["prefetch_overlap_hits"]
                  == (0 if prefetch == 1 else n_tiles - 1),
                  f"{what}: {st['prefetch_overlap_hits']} overlap hits")
            nnz = int(res.info["nnz_c"])
            check(same_csr(res.c, mono.c),
                  f"{what}: not the monolithic product bit for bit")
            err = check_against_scipy(name, f"streamed/{lane}", res.c, nnz,
                                      want)
            if prefetch == 2:
                per_stream[f"stream/{name}/{lane}"] = launches
            recs.append({"prefetch": prefetch, "ms": ms,
                         "launches": launches, "host_sync_count": syncs,
                         "peak_mem_gb": peak,
                         "tile_bytes_h2d": st["tile_bytes_h2d"],
                         "prefetch_overlap_hits":
                             st["prefetch_overlap_hits"],
                         "max_abs_err_vs_scipy": err})
        emit({"stream_p2p": {
            "matrix": name, "rows": a.n_rows, "lane": lane,
            "tile_rows": STREAM["tile_rows"], "n_tiles": n_tiles,
            "monolithic_ms": mono_ms, "monolithic_peak_gb": mono_peak,
            "monolithic_launches": mono_launches, "calls": recs}}, log)
    overlap = stream_overlap(traced(lambda: spgemm_streamed(
        a, a, tile_rows=STREAM["tile_rows"], prefetch=2,
        engine="fused_hash")))
    check(overlap["side_copies"] > 0, "no tile copy on the side stream")
    emit({"stream_overlap": {"matrix": name, "lane": "fused_hash",
                             "prefetch": 2, **overlap}}, log)
    return monos, per_stream


def stream_roadtx(log):
    """(a) RoadTX on ``fused_hash`` in 6 tiles, bit for bit the
    monolithic product, wall and peak beside it."""
    import torch

    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.core.spgemm import spgemm, spgemm_streamed

    name, n = STREAM["roadtx"]
    road = table_ii_matrix(name, seed=0, n_override=n, device=DEVICE)
    mono, mono_ms, _, _, mono_peak = counted_call(
        lambda: spgemm(road, road, engine="fused_hash"))
    res, ms, launches, syncs, peak = counted_call(
        lambda: spgemm_streamed(road, road,
                                tile_rows=STREAM["roadtx_tile_rows"],
                                engine="fused_hash"))
    check(res.info["n_tiles"] == 6 and same_csr(res.c, mono.c),
          f"streamed {name}: {res.info['n_tiles']} tiles, not the "
          "monolithic product bit for bit")
    emit({"stream_roadtx": {
        "matrix": name, "rows": n, "lane": "fused_hash",
        "tile_rows": STREAM["roadtx_tile_rows"],
        "n_tiles": res.info["n_tiles"], "ms": ms, "peak_mem_gb": peak,
        "launches": launches, "monolithic_ms": mono_ms,
        "monolithic_peak_gb": mono_peak,
        "max_tile_ip": res.info["max_tile_ip"],
        "intermediate_products": res.info["intermediate_products"]}}, log)
    del road, mono, res
    torch.cuda.empty_cache()


def budget_check(a, mono, log):
    """(b) a budget of half p2p's estimate: ``on_budget="error"`` raises
    before any allocation, ``"stream"`` degrades bit for bit."""
    import torch

    from repro_torch.core import executor
    from repro_torch.core.grouping import group_rows
    from repro_torch.core.spgemm import spgemm

    mono_c, _, mono_peak = mono
    plan = group_rows(a, a)
    est = executor.estimated_device_bytes(plan, 4)
    budget = est // 2
    executor.set_device_budget(budget)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        try:
            spgemm(a, a, engine="fused_hash", plan=plan, on_budget="error")
            raised = False
        except executor.DeviceBudgetExceeded:
            raised = True
        check(raised, "on_budget='error' did not raise")
        check(torch.cuda.memory_allocated() == before
              and torch.cuda.max_memory_allocated() == before,
              "the refused call allocated device memory")
        res, ms, launches, syncs, peak = counted_call(
            lambda: spgemm(a, a, engine="fused_hash", on_budget="stream"))
        st = executor.cache_stats()
        tile_rows = executor.derive_degradation_tile_rows(plan, a.n_rows, 4)
    finally:
        executor.set_device_budget(None)
    check(res.info.get("degraded_to_stream") == 1
          and res.info["tile_rows"] == tile_rows
          and st["budget_degradations"] == 1,
          f"degradation: info {res.info}, stats {st}")
    check(same_csr(res.c, mono_c.c), "the degraded product differs")
    emit({"stream_budget": {
        "matrix": STREAM["matrix"][0], "lane": "fused_hash",
        "budget_bytes": budget, "monolithic_estimate_bytes": est,
        "monolithic_peak_gb": mono_peak, "tile_rows": tile_rows,
        "n_tiles": res.info["n_tiles"],
        "tile_estimate_bytes": res.info["max_tile_ip"] * 8,
        "degraded_peak_gb": peak, "degraded_ms": ms,
        "launches": launches, "budget_degradations":
            st["budget_degradations"]}}, log)


def stream_mcl(log):
    """(c) MCL on Economics under a 1 GiB budget with
    ``on_budget="stream"``: each expansion recorded inside ``mcl`` and
    held bit for bit against a monolithic ``spgemm`` of its iterate."""
    import torch

    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.apps.markov_clustering import mcl
    from repro_torch.core import executor
    from repro_torch.core.spgemm import spgemm

    from repro_torch.apps import markov_clustering as mc

    name, n = MCL_MATRIX
    g = table_ii_matrix(name, seed=0, n_override=n, device=DEVICE)
    peaks = []
    executor.set_device_budget(STREAM["mcl_budget"])
    try:
        with recording_mcl() as rec:
            recorded = mc.spgemm

            def expansion(*args, **kwargs):  # each expansion's own peak
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                out = recorded(*args, **kwargs)
                torch.cuda.synchronize()
                peaks.append((resident / 1e9,
                              torch.cuda.max_memory_allocated() / 1e9))
                return out

            mc.spgemm = expansion
            try:
                res, ms, launches, syncs, peak = counted_call(
                    lambda: mcl(g, **MCL_ARGS, method="fused_hash",
                                on_budget="stream"))
            finally:
                mc.spgemm = recorded
        st = executor.cache_stats()
    finally:
        executor.set_device_budget(None)
    iters = []
    for i, info in enumerate(res.spgemm_info):
        x = rec["iterates"][i]
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        mono = spgemm(x, x, engine="fused_hash")
        torch.cuda.synchronize()
        mono_ms = (time.perf_counter() - t0) * 1e3
        check(same_csr(rec["expansions"][i], mono.c),
              f"MCL {name} iteration {i + 1}: the expansion differs from "
              "the monolithic product")
        iters.append({"iteration": i + 1,
                      "intermediate_products": info["intermediate_products"],
                      "estimate_bytes": info["intermediate_products"] * 8,
                      "degraded": bool(info.get("degraded_to_stream")),
                      "n_tiles": info.get("n_tiles", 1),
                      "tile_rows": info.get("tile_rows"),
                      "nnz_c": info["nnz_c"],
                      "resident_gb": peaks[i][0],
                      "peak_gb": peaks[i][1],
                      "monolithic_ms": mono_ms,
                      "monolithic_resident_gb": resident,
                      "monolithic_peak_gb":
                          torch.cuda.max_memory_allocated() / 1e9})
        del mono
        torch.cuda.empty_cache()
    check(st["budget_degradations"] == sum(i["degraded"] for i in iters)
          and st["budget_degradations"] >= 1,
          f"MCL {name}: {st['budget_degradations']} degradations")
    emit({"stream_mcl": {
        "matrix": name, "rows": n, "args": MCL_ARGS, "lane": "fused_hash",
        "budget_bytes": STREAM["mcl_budget"], "ms": ms, "peak_mem_gb": peak,
        "launches": launches, "budget_degradations":
            st["budget_degradations"], "tiles_streamed":
            st["tiles_streamed"], "iterations": iters}}, log)
    del rec, res
    torch.cuda.empty_cache()


def fault_check(a, mono, log):
    """(d) each fault point armed once on the p2p ``fused_hash`` product:
    it fires once, the result is the clean one bit for bit, a retried call
    counts one retry; then a clean planned call pays no pipeline sync."""
    from repro_torch.core import executor, faults
    from repro_torch.core.spgemm import spgemm, spgemm_batched
    from repro_torch.core.spgemm import spgemm_streamed

    clean = mono[0].c
    rng = np.random.default_rng(1)
    members = [fresh_values(a, rng) for _ in range(4)]
    clean_batch = spgemm_batched(members, a, engine="fused_hash").cs
    clean_stream = spgemm_streamed(a, a, tile_rows=STREAM["tile_rows"],
                                   engine="fused_hash").c
    calls = (
        ("capacity_undersize", "planned",
         lambda: [spgemm(a, a, engine="fused_hash").c], [clean], 1),
        ("capacity_undersize", "batched x4",
         lambda: spgemm_batched(members, a, engine="fused_hash").cs,
         clean_batch, 1),
        ("gather_fail", "planned",
         lambda: [spgemm(a, a, engine="fused_hash").c], [clean], 0),
        ("stage_tile_fail", "streamed",
         lambda: [spgemm_streamed(a, a, tile_rows=STREAM["tile_rows"],
                                  engine="fused_hash").c], [clean_stream], 0),
    )
    recs = []
    for point, lane, fn, want, retries in calls:
        with faults.fault_injection(point) as fault:
            got, ms, launches, syncs, _ = counted_call(fn)
        st = executor.cache_stats()
        what = f"fault {point} on the {lane} lane"
        check(fault.triggers == 1, f"{what}: fired {fault.triggers} times")
        check(st["capacity_retries"] == retries,
              f"{what}: {st['capacity_retries']} capacity retries")
        check(all(same_csr(x, y) for x, y in zip(got, want)),
              f"{what}: not the clean result bit for bit")
        recs.append({"point": point, "lane": lane, "triggers":
                     fault.triggers, "capacity_retries":
                     st["capacity_retries"], "ms": ms, "launches": launches,
                     "host_sync_count": syncs})
    _, ms, _, syncs, _ = counted_call(lambda: spgemm(a, a,
                                                     engine="fused_hash"))
    check(syncs == 0 and executor.cache_stats()["capacity_retries"] == 0,
          f"the clean planned call after the faults paid {syncs} syncs")
    emit({"stream_faults": {"matrix": STREAM["matrix"][0], "calls": recs,
                            "clean_after": {"ms": ms,
                                            "host_sync_count": syncs}}},
         log)


def stream_phase(log):
    """The out-of-core lane and its resilience layer: (a) the streamed
    p2p and RoadTX self-products, (b) the device budget, (c) MCL under a
    budget, (d) the three fault points."""
    from repro_torch.apps.graphs import table_ii_matrix

    import torch

    t0 = time.perf_counter()
    emit({"stream_phase_resident_gb": torch.cuda.memory_allocated() / 1e9},
         log)
    name, n = STREAM["matrix"]
    a = table_ii_matrix(name, seed=0, n_override=n, device=DEVICE)
    monos, per_stream = stream_p2p(a, log)
    budget_check(a, monos["fused_hash"], log)
    fault_check(a, monos["fused_hash"], log)
    del monos
    stream_roadtx(log)
    stream_mcl(log)
    emit({"stream_phase_s": time.perf_counter() - t0}, log)
    return per_stream


# ---------------------------------------------------------------------------
# Phase 12: the sharded executor on logical shards of the one card
# ---------------------------------------------------------------------------

# The meshes: make_spgemm_mesh() (every visible card, here the one) and
# logical shards of cuda:0.  Logical shards run every line a mesh of cards
# runs but the copy between cards, which stays unmeasured here.
MESH = {"shards": (None, 2, 4), "batch": 4, "stream_tiles": 6,
        "pow_r": (1.5, 2.0, 3.0, 0.5), "pow_n": 1 << 20}
MESH_LANES = (("default", {}, 1), ("fused_hash", {"engine": "fused_hash"}, 0))


def mesh_of(shards):
    """(mesh, label): ``make_spgemm_mesh()`` for None, else ``shards``
    logical shards of cuda:0."""
    import torch

    from repro_torch.launch.mesh import make_spgemm_mesh

    if shards is None:
        return make_spgemm_mesh(), "make_spgemm_mesh()"
    return [torch.device("cuda", 0)] * shards, f"[cuda:0] * {shards}"


def mesh_chunks(a, n_shards: int) -> int:
    """The chunks ``a``'s self-product is cut into on ``n_shards`` shards
    (a group's chunk shrinks to ceil(rows / n_shards))."""
    from repro_torch.core import executor as ex
    from repro_torch.core.grouping import group_rows

    row_nnz = np.diff(a.indptr.cpu().numpy().astype(np.int64))
    return len(ex.partition_plan(group_rows(a, a), row_nnz, 4096,
                                 n_shards=n_shards))


def operand_counters() -> dict:
    from repro_torch.core import executor

    st = executor.cache_stats()
    return {k: st[k] for k in ("operand_bytes_placed",
                               "operand_rows_footprint",
                               "operand_rows_total")}


def mesh_products(mats, log):
    """The Table-II self-products under each mesh on both lanes, bit for
    bit the ``mesh=None`` product (the default lane's values also within
    RTOL/ATOL of scipy), with
    the pipeline's syncs and K1/K2 launches per chunk; on p2p the three
    ``operands`` placements, bit for bit."""
    from repro_torch.core.spgemm import spgemm

    per_call = {}
    for name, a in mats.items():
        want = scipy_product(a)
        base = {lane: spgemm(a, a, **kw).c for lane, kw, _ in MESH_LANES}
        for shards in MESH["shards"]:
            mesh, label = mesh_of(shards)
            chunks = mesh_chunks(a, len(mesh))
            placements = ("auto", "footprint", "replicate") \
                if name == "p2p-Gnutella04" else ("auto",)
            for lane, kw, syncs_expected in MESH_LANES:
                for placement in placements if lane == "fused_hash" \
                        else ("auto",):
                    what = f"mesh {name}/{label}/{lane}/{placement}"
                    res, ms, launches, syncs, peak = counted_call(
                        lambda: spgemm(a, a, mesh=mesh, operands=placement,
                                       **kw))
                    placed = operand_counters()
                    c, nnz = res.c, res.info["nnz_c"]
                    check(syncs == syncs_expected,
                          f"{what}: host_sync_count {syncs}")
                    check(launches["gather_rows"] == chunks,
                          f"{what}: {launches['gather_rows']} K1 launches "
                          f"for {chunks} chunks")
                    check(launches["hash_accumulate"] ==
                          (chunks if lane == "fused_hash" else 0),
                          f"{what}: {launches['hash_accumulate']} K2 "
                          f"launches for {chunks} chunks")
                    check(same_csr(c, base[lane]),
                          f"{what}: not bit-identical to mesh=None")
                    err = 0.0 if lane == "fused_hash" else \
                        check_against_scipy(name, what, c, nnz, want)
                    per_call[f"{name}/{label}/{lane}/{placement}"] = launches
                    emit({"mesh_spgemm": {
                        "matrix": name, "mesh": label, "shards": len(mesh),
                        "lane": lane, "operands": placement,
                        "nnz_c": nnz, "chunks": chunks, "ms": ms,
                        "host_sync_count": syncs, "launches": launches,
                        "peak_mem_gb": peak,
                        "bit_identical_to_mesh_none": True,
                        "max_abs_err_vs_scipy": err,
                        "operand_rows_share":
                            placed["operand_rows_footprint"]
                            / max(placed["operand_rows_total"], 1),
                        **placed,
                        "profiled": profiled(lambda: spgemm(
                            a, a, mesh=mesh, operands=placement, **kw))}},
                        log)
                    del res, c
        del base
    return per_call


def mesh_batched_and_streamed(a, log):
    """p2p x MESH["batch"] through ``spgemm_batched`` on ``fused_hash``
    under [cuda:0] * 4, each member against its solo ``mesh=None``
    product; p2p in MESH["stream_tiles"] tiles under the same mesh against
    the monolithic product; both bit for bit."""
    from repro_torch.core.spgemm import spgemm, spgemm_batched, \
        spgemm_streamed

    mesh, label = mesh_of(4)
    chunks = mesh_chunks(a, 4)
    rng = np.random.default_rng(1)
    members = [fresh_values(a, rng) for _ in range(MESH["batch"])]
    res, ms, launches, syncs, peak = counted_call(
        lambda: spgemm_batched(members, members, engine="fused_hash",
                               mesh=mesh))
    check(syncs == 0, f"mesh batched: host_sync_count {syncs}")
    check(launches["gather_rows"] == chunks
          and launches["hash_accumulate"] == MESH["batch"] * chunks,
          f"mesh batched: launches {launches} for {chunks} chunks")
    for i, (m, c) in enumerate(zip(members, res.cs)):
        check(same_csr(c, spgemm(m, m, engine="fused_hash").c),
              f"mesh batched: member {i} differs from its solo product")
    per_call = {f"batched/{label}": launches}
    emit({"mesh_batched": {"matrix": "p2p-Gnutella04", "mesh": label,
                           "batch": MESH["batch"], "chunks": chunks,
                           "ms": ms, "launches": launches,
                           "host_sync_count": syncs, "peak_mem_gb": peak,
                           "bit_identical_to_solo": True}}, log)
    del res, members
    mono = spgemm(a, a, engine="fused_hash").c
    tile_rows = -(-a.n_rows // MESH["stream_tiles"])
    res, ms, launches, syncs, peak = counted_call(
        lambda: spgemm_streamed(a, a, tile_rows=tile_rows,
                                engine="fused_hash", mesh=mesh))
    check(res.info["n_tiles"] == MESH["stream_tiles"]
          and res.info["n_shards"] == 4, f"mesh streamed: {res.info}")
    check(same_csr(res.c, mono), "mesh streamed: not bit-identical to the "
          "monolithic product")
    check(launches["gather_rows"] > 0 and launches["hash_accumulate"] > 0,
          f"mesh streamed: launches {launches}")
    per_call[f"streamed/{label}"] = launches
    emit({"mesh_streamed": {"matrix": "p2p-Gnutella04", "mesh": label,
                            "tiles": MESH["stream_tiles"],
                            "tile_rows": tile_rows, "ms": ms,
                            "launches": launches, "peak_mem_gb": peak,
                            "bit_identical_to_monolithic": True}}, log)
    return per_call


def mesh_pow(log):
    """``csr_hadamard_power`` on the card at MESH["pow_r"]: entries that
    differ from numpy's float64 power rounded once to float32 (0 expected;
    the count is written down either way)."""
    import torch

    from repro_torch.sparse.formats import CSR
    from repro_torch.sparse.ops import csr_hadamard_power

    n = MESH["pow_n"]
    x = (np.random.default_rng(2).random(n) * 4).astype(np.float32)
    a = CSR(torch.tensor([0, n], dtype=torch.int32, device="cuda"),
            torch.zeros(n, dtype=torch.int32, device="cuda"),
            torch.from_numpy(x).cuda(), (1, 1))
    counts = {}
    for r in MESH["pow_r"]:
        got = csr_hadamard_power(a, r).data.cpu().numpy()
        want = np.power(x.astype(np.float64), r).astype(np.float32)
        counts[str(r)] = int((got != want).sum())
    emit({"mesh_pow": {"values": n, "differ_from_float64_rounded_once":
                       counts}}, log)


def mesh_gnn(log):
    """One ``train_gnn`` step of gcn/topk on ogbn-arxiv under [cuda:0] * 4:
    step 1's logits and gradients within GNN_REL of float64
    (``gnn_step1_check``), then the step with K1 once a shard an
    aggregation."""
    import torch

    from repro_torch.apps import gnn

    mesh, label = mesh_of(4)
    d = gnn_inputs()
    cfg = gnn.GNNConfig(arch="gcn", d_in=GNN["d"], d_hidden=GNN["d"],
                        n_classes=GNN["n_classes"], topk=GNN["topk"],
                        sparse_mode="topk", n_layers=GNN["n_layers"])
    params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0),
                          device="cuda")
    step1 = gnn_step1_check(f"mesh GNN {label}", cfg, params, d, mesh=mesh)
    (_, hist), ms, launches, _, peak = counted_call(
        lambda: gnn.train_gnn(cfg, d["a"], d["x"], d["labels"], n_steps=1,
                              seed=0, mesh=mesh))
    check(all(np.isfinite(hist)), f"mesh GNN: loss {hist}")
    check(launches["gather_rows"] == 4 * cfg.n_layers
          and launches["hash_accumulate"] == 0,
          f"mesh GNN: launches {launches}, expected one K1 launch a shard "
          f"an aggregation")
    emit({"mesh_gnn": {"dataset": GNN["dataset"], "arch": "gcn",
                       "mode": "topk", "mesh": label, "loss": hist,
                       "ms": ms, "launches": launches, "peak_mem_gb": peak,
                       **step1}}, log)
    return {f"gnn/{label}": launches}


def mesh_mcl(log):
    """MCL (MCL_ARGS) on Economics on ``fused_hash`` under [cuda:0] * 4,
    operands "auto".  The mesh reaches only the expansions, so inside the
    run each expansion is held bit for bit against the ``mesh=None``
    product of its own inputs, and the iteration is finished from that
    product (prune, inflation, normalisation) as ``mcl`` does: each
    iterate of the run is that one bit for bit (the column sums add in
    slot order on the card too).  The checks' time (the iterates' host
    copies too) and launches are left out of the run's."""
    import torch

    from repro_torch.apps import markov_clustering as mc
    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.kernels import ops

    mesh, label = mesh_of(4)
    name, n = MCL_MATRIX
    g = table_ii_matrix(name, seed=0, n_override=n, device="cuda")
    args = MCL_ARGS
    real_spgemm, real_normalize = mc.spgemm, mc.csr_column_normalize
    iterates, wanted = [], []
    check_s = [0.0]

    def spgemm_checked(b, a, **kwargs):
        res = real_spgemm(b, a, **kwargs)
        t0 = time.perf_counter()
        counts = ops.launch_counts()
        plain = real_spgemm(b, a, **dict(kwargs, mesh=None))
        check(same_csr(res.c, plain.c), f"mesh MCL {label}: expansion "
              f"{len(wanted) + 1} differs from mesh=None")
        inflated = mc.csr_hadamard_power(
            mc.csr_prune_columns(plain.c, args["theta"], args["k"]),
            args["r"])
        wanted.append(host_csr(real_normalize(inflated)))
        del plain, inflated
        ops.LAUNCHES.update(counts)
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t0
        return res

    def normalize_rec(*a, **kw):
        out = real_normalize(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iterates.append(host_csr(out))
        check_s[0] += time.perf_counter() - t0
        return out

    mc.spgemm, mc.csr_column_normalize = spgemm_checked, normalize_rec
    try:
        res, ms, launches, syncs, peak = counted_call(
            lambda: mc.mcl(g, mesh=mesh, method="fused_hash", **args))
    finally:
        mc.spgemm, mc.csr_column_normalize = real_spgemm, real_normalize
    check(res.n_iterations == args["max_iters"] == len(wanted),
          f"mesh MCL: {res.n_iterations} iterations")
    check(syncs == 0, f"mesh MCL: host_sync_count {syncs}")
    check(launches["gather_rows"] > 0 and launches["hash_accumulate"] > 0,
          f"mesh MCL: launches {launches}")
    errs = []
    for i, (x, y) in enumerate(zip(iterates[1:], wanted), 1):
        check(np.array_equal(x.indptr, y.indptr)
              and np.array_equal(x.indices, y.indices),
              f"mesh MCL: iterate {i}'s structure differs")
        err = float(np.abs(x.data - y.data).max(initial=0.0))
        scale = float(np.abs(y.data).max(initial=0.0))
        check(np.array_equal(x.data, y.data),
              f"mesh MCL: iterate {i} differs by {err} (scale {scale})")
        errs.append({"iterate": i, "max_abs_diff": err, "scale": scale,
                     "nnz": int(x.nnz)})
    emit({"mesh_mcl": {"matrix": name, "rows": n, "mesh": label,
                       "args": args, "lane": "fused_hash",
                       "operands": "auto",
                       "ms_less_checks": ms - check_s[0] * 1e3,
                       "check_s": check_s[0], "launches": launches,
                       "host_sync_count": syncs, "peak_mem_gb": peak,
                       "expansions_bit_identical": True,
                       "iterates_vs_mesh_none": errs,
                       "clusters": int(len(np.unique(res.clusters)))}}, log)
    return {f"mcl/{name}/{label}": launches}


def mesh_phase(mats, log):
    """The sharded executor on the card: the Table-II products under three
    meshes, the batched and streamed lanes, ``csr_hadamard_power``, one
    GNN step and MCL, each with its launch counts from 0."""
    import torch

    t0 = time.perf_counter()
    per_call = mesh_products(mats, log)
    per_call.update(mesh_batched_and_streamed(mats["p2p-Gnutella04"], log))
    mesh_pow(log)
    torch.cuda.empty_cache()
    per_call.update(mesh_gnn(log))
    torch.cuda.empty_cache()
    per_call.update(mesh_mcl(log))
    torch.cuda.empty_cache()
    emit({"mesh_phase_s": time.perf_counter() - t0}, log)
    return per_call


# ---------------------------------------------------------------------------
# Phase 12: the calls the port once refused on the card
# ---------------------------------------------------------------------------

LOWP_DTYPES = ("bfloat16", "float16")
# the bf16 self-products held bit for bit against the CPU port's (every
# lane); RoadTX's bf16 products against its float32 structure
LOWP_CPU_PRODUCT = ("p2p-Gnutella04",)
# the calls K7 once refused (tests/test_torch_flash.py's REFUSED), as
# (sq, sk, d, dv, window, q_offset, kv_len, p_dtype, causal), at BH 2
K7_REFUSED = {
    "p_dtype": (16, 16, 8, 8, 0, 0, None, "bfloat16", True),
    "d_past_192": (16, 16, 200, 200, 0, 0, None, None, True),
    "dv_past_d": (16, 16, 8, 16, 0, 0, None, None, True),
    "first_query_sees_nothing": (16, 16, 8, 8, 0, -1, None, None, True),
    "no_keys": (16, 16, 8, 8, 0, 0, 0, None, False),
    "window_past_the_keys": (8, 32, 8, 8, 4, 40, None, None, False),
    "last_query_past_the_window": (64, 64, 8, 8, 4, 0, 20, None, True),
}
# K7's new widths timed, as (name, bh, s, d, dv, dtypes): D 256 (the
# tensor cores' <256, 256> build; float32 on the float32 tensor-core
# build), D 320 (the wide build <320, 160>, two value slabs, in both 16-bit
# types; float32 in slabs on the CUDA cores), qk 64 / v 128 (the <128, 128>
# build; float32 on its own build), causal; each held, the same bits on a
# repeat, and timed beside the CUDA-core kernel and SDPA
K7_WIDE = (("d256", 32, 4096, 256, 256, ("bfloat16", "float32")),
           ("d320", 32, 4096, 320, 320, ("bfloat16", "float16", "float32")),
           ("qk64_v128", 32, 4096, 64, 128, ("bfloat16", "float32")))
# the p_dtype gate.  The plain version runs the kernels' own key tile
# (k7_tile: kBK, 64 keys in both forward kernels), so the running max, and
# so each bf16 rounding of P, falls at the same points.  A probability near
# a rounding boundary may still round the other way (expf against the
# kernel's exp2, scores summed in another order): such a flip moves one
# output by up to 2**-7 of its key's weight times |v|.  So each element
# within FLASH_TOL plus P_DTYPE_GATE of the largest |value| (a few flips of
# heavy keys), and all of them within P_DTYPE_MEAN: sum |error| <=
# P_DTYPE_MEAN * sum |value|.  Without the rounding (three P terms, or the
# backward without its flag) every output moves by some 2**-9 of the
# spread of its terms, and a dropped key tile by far more: the mean gate
# refuses both, and p_dtype_control checks that it refuses the former on
# the same inputs.  dQ and dK see no rounded P (dS takes float32 P), so
# they keep the backward's own gate.
P_DTYPE_GATE = 2 ** -8
P_DTYPE_MEAN = 2 ** -12
# float16 at the attention shape (Phi-3-mini's prefill) and p_dtype at
# granite-3-2b's training shape (2 x 32 heads, S 2,048, D 64)
K7_F16 = (64, 4096, 96)
K7_P_DTYPE_TRAIN = (64, 2048, 64, 32)
# K6 at wider blocks, timed at the FFN path's shape: (block, dtype); bf16
# at 512 lanes on the tensor cores (two depth panels of 256), float32 at
# 2,048 on the CUDA cores
K6_WIDE = ((512, "bfloat16"), (2048, "float32"))


def lowp_data(a, dtype):
    """A port CSR with its values cast to ``dtype``."""
    return dataclasses.replace(a, data=a.data.to(dtype))


def lowp_products(mats, log) -> dict:
    """RoadTX and p2p-Gnutella04 at paper size with bf16 values, on the
    three lanes of ``CALLS``, each lane's kernels launched and every sum in
    bf16: p2p bit for bit the CPU port's bf16 product on every lane (the
    plain versions, each add rounded to bf16), RoadTX with the structure of
    its float32 product; a second run bit for bit."""
    import torch

    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()  # this path's count starts here
    per_call = {}
    for name, a in mats.items():
        a16 = lowp_data(a, torch.bfloat16)
        f32 = spgemm(a, a).c
        cpu, cpu_s = None, None
        if name in LOWP_CPU_PRODUCT:
            t0 = time.perf_counter()
            cpu = spgemm(on_cpu(a16), on_cpu(a16)).c
            cpu_s = time.perf_counter() - t0
        for label, kwargs, kernels, _ in CALLS:
            res, cold_ms, launches, routes, _, _ = run_call(a16, kwargs)
            c, nnz = res.c, res.info["nnz_c"]
            what = f"{name}/{label} bf16"
            check(c.data.dtype == torch.bfloat16, f"{what}: {c.data.dtype}")
            for k, n in launches.items():
                check((n > 0) == (k in kernels),
                      f"{what}: {k} launched {n} times")
            check(nnz == int(f32.nnz) and torch.equal(c.indptr, f32.indptr)
                  and torch.equal(c.indices[:nnz], f32.indices[:nnz]),
                  f"{what}: another structure than the float32 product's")
            check(bool(torch.isfinite(c.data[:nnz]).all()),
                  f"{what}: non-finite values")
            if cpu is not None:
                check(same_csr(cpu, on_cpu(c)),
                      f"{what}: differs from the CPU port's bf16 product")
            again, ms, _, _, _, _ = run_call(a16, kwargs)
            check(same_csr(again.c, c), f"{what}: a second run differs")
            del again
            host_ms, dev_ms, top = profile(lambda: spgemm(a16, a16, **kwargs))
            per_call[f"{name}/{label}"] = launches
            emit({"lowp_e2e": {
                "matrix": name, "call": label, "dtype": "bfloat16",
                "nnz_c": nnz, "ms": ms, "cold_ms": cold_ms,
                "launches": launches, "route_launches": routes,
                "bit_identical_to_cpu_port": cpu is not None,
                "cpu_s": cpu_s, "profiled": {
                    "host_ms": host_ms, "device_ms": dev_ms,
                    "device_busy_share": None if dev_ms is None
                    else dev_ms / host_ms, "top_kernels": top},
                "rel_err_vs_float32": rel_err(c.data[:nnz],
                                              f32.data[:nnz])}}, log)
            del res, c
        del a16, f32, cpu
        torch.cuda.empty_cache()
    return {"launches": ops.launch_counts(), "routes": ops.route_counts(),
            "per_call": per_call}


def lowp_segsum_hold(what, call, timed, log) -> dict:
    """One recorded low-precision segment sum: one launch, bit for bit its
    plain version on the CPU; ``timed`` adds the kernel's time beside its
    bound, its plain version on the card and ``torch.segment_reduce``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss

    ids, values, n_out, order, skip = call
    values = values.contiguous()

    def kernel():
        return ss.segment_sum(ids, values, n_out, order, skip)

    before = ops.launch_counts()["segment_sum"]
    got = kernel()
    torch.cuda.synchronize()
    check(ops.launch_counts()["segment_sum"] == before + 1,
          f"segment_sum {what}: launches")
    want = ss.segment_sum_plain(ids.cpu(), values.cpu(), n_out,
                                None if order is None else order.cpu(), skip)
    check(torch.equal(got.cpu(), want),
          f"segment_sum {what}: differs from its plain version on the CPU")
    rec = {"shape": what, "dtype": str(values.dtype), "n": ids.numel(),
           "n_out": n_out, "width": values.shape[-1], "max_abs_err": 0.0,
           "launches": ops.launch_counts()["segment_sum"] - before}
    if timed:
        summed = ids < n_out
        if skip:
            summed &= ids % skip != skip - 1
        n_kept = int(summed.sum())
        nbytes = ids.numel() * 8 + (0 if order is None else n_kept * 8) \
            + (n_kept * values.numel() // max(ids.numel(), 1) + got.numel()) \
            * values.element_size()
        ordered = values if order is None else values.index_select(-2, order)
        lengths = torch.bincount(ids, minlength=n_out)
        rec.update({"bytes": nbytes, "bound_ms": bound_ms(nbytes),
                    "bound_by": "bytes", "ms": time_ms(kernel, reps=5),
                    "device_ms": device_ms(kernel, 3),
                    "loop_ms": loop_ms(kernel, reps=5),
                    "plain_ms": time_ms(lambda: ss.segment_sum_plain(
                        ids, values, n_out, order, skip), reps=1)})
        rec.update(library_call([(
            "torch.segment_reduce(values, 'sum', lengths)",
            lambda: torch.segment_reduce(ordered, "sum", lengths=lengths,
                                         axis=0))]))
        del ordered, lengths
    emit({"lowp_segment_sum": rec}, log)
    del got, want
    return rec


def lowp_hash_hold(what, keys, vals, table_cap, timed, log) -> dict:
    """K2 on one chunk's stream with low-precision values: one launch on
    its table size's route, bit for bit its plain version (on the packed
    stream, as ``hash_check`` holds it); ``timed`` adds its time beside its
    bound and a COO ``coalesce()``."""
    import torch

    from repro_torch.kernels import hash_accum, ops

    route = hash_accum.route(table_cap)
    before = ops.launch_counts()["hash_accumulate"]
    got, _ = routed_call("hash_accumulate", lambda: hash_accum.hash_accumulate(
        keys, vals, table_cap), route)
    launches = ops.launch_counts()["hash_accumulate"] - before
    check(got[1].dtype == vals.dtype, f"K2 {what}: {got[1].dtype}")
    held_k, held_v, rows = keys, vals, slice(None)
    if keys.shape[1] > K2_MAX_STREAM:
        held_k, held_v = packed_stream(keys, vals)
        if held_k.shape[1] > K2_MAX_STREAM:
            rows = ((held_k >= 0).sum(1) <= K2_MAX_STREAM).nonzero()[:, 0]
            held_k = held_k[rows, :K2_MAX_STREAM].contiguous()
            held_v = held_v[rows, :K2_MAX_STREAM].contiguous()
    want = hash_accum.hash_accumulate_plain(held_k, held_v, table_cap)
    for part, gp, wp in zip(("cols", "vals", "cnt"), got, want):
        check(torch.equal(gp[rows], wp), f"K2 {what}: {part} differ")
    rec = {"shape": what, "dtype": str(vals.dtype), "rows": keys.shape[0],
           "ip_cap": keys.shape[1], "table_cap": table_cap, "route": route,
           "max_abs_err": 0.0, "launches": launches}
    if timed:
        def kernel():
            return hash_accum.hash_accumulate(keys, vals, table_cap)

        products = int((keys >= 0).sum())
        r = keys.shape[0]
        nbytes = r * keys.shape[1] * 4 + products * vals.element_size() \
            + r * table_cap * (4 + vals.element_size()) + r * 4
        prow, pslot = (keys >= 0).nonzero(as_tuple=True)
        coo_idx = torch.stack([prow, keys[prow, pslot].long()])
        coo_val = vals[prow, pslot]
        size = (r, int(keys.max()) + 1)
        rec.update({"products": products, "bytes": nbytes,
                    "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                    "ms": time_ms(kernel, reps=5),
                    "device_ms": device_ms(kernel, 3),
                    "loop_ms": loop_ms(kernel, reps=5)})
        rec.update(library_call([(
            "torch.sparse_coo_tensor(keys, vals).coalesce()",
            lambda: torch.sparse_coo_tensor(coo_idx, coo_val,
                                            size).coalesce())]))
        del coo_idx, coo_val
    emit({"lowp_hash_accumulate": rec}, log)
    return rec


def lowp_kernel_shapes(mats, log) -> dict:
    """The segment sum and K2 in bf16 and float16 at 6b's four shapes:
    the sort engine's chunks (RoadTX group 0, p2p-Gnutella04 group 2) with
    K2 on the same chunks, ``csr_spmm`` on ogbn-arxiv's Â with 64 columns
    (its forward and X's gradient; the path's bf16 run beside its float32
    one), and ``csr_column_sums`` on Economics with self loops.  bf16 calls
    are timed; float16 ones held only."""
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps import markov_clustering as mc
    from repro_torch.apps.graphs import rmat_graph, table_ii_matrix
    from repro_torch.core import phases
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse import ops as sparse_ops

    t0 = time.perf_counter()
    recs = {"segment_sum": {}, "hash_accumulate": {}}
    for name, group in (("RoadTX", 0), ("p2p-Gnutella04", 2)):
        a = mats[name]
        ell, firsts = chunk_operands(a)
        item, rows = firsts[group]
        cols_a, vals_a = phases.gather_group_rows(
            a.indptr, a.indices, a.data, rows, item.a_cap)
        keys, vals = phases.enumerate_products(cols_a, vals_a, ell.indices,
                                               ell.data)
        out_cap = int(phases.allocate_sort(keys).max())
        for dt in LOWP_DTYPES:
            dtype = getattr(torch, dt)
            _, lv = phases.enumerate_products(cols_a, vals_a.to(dtype),
                                              ell.indices, ell.data.to(dtype))
            timed = dt == "bfloat16"
            with recorded_sums(phases) as calls:
                phases.sort_unique(keys, lv, out_cap)
            key = f"sort_unique/{name}/group {group}/{dt}"
            recs["segment_sum"][key] = lowp_segsum_hold(key, calls[0], timed,
                                                        log)
            key = f"hash/{name}/group {group}/{dt}"
            recs["hash_accumulate"][key] = lowp_hash_hold(
                key, keys, lv, item.table_cap, timed, log)
            del lv, calls
        del ell, firsts, cols_a, vals_a, keys, vals
        torch.cuda.empty_cache()
    g = rmat_graph(GNN["nodes"], GNN["avg_deg"], seed=0, device="cuda")
    a32 = gnn.normalize_adjacency(g)
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal(
        (GNN["nodes"], GNN["d"])).astype(np.float32)).cuda()
    ct32 = torch.from_numpy(rng.standard_normal(
        (GNN["nodes"], GNN["d"])).astype(np.float32)).cuda()
    y32 = sparse_ops.csr_spmm(a32, x32, gather="aia")
    path = {}
    for dt in LOWP_DTYPES:
        dtype = getattr(torch, dt)
        a = lowp_data(a32, dtype)
        x = x32.to(dtype).requires_grad_()
        with recorded_sums(sparse_ops, ss) as calls:
            t1 = time.perf_counter()
            y = sparse_ops.csr_spmm(a, x, gather="aia")
            y.backward(ct32.to(dtype))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        check(len(calls) == 2, f"csr_spmm {dt}: {len(calls)} segment sums")
        check(y.dtype == dtype and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(x.grad).all()),
              f"csr_spmm {dt}: dtype or non-finite values")
        path[dt] = {"forward_backward_ms": ms,
                    "rel_err_vs_float32": rel_err(y.detach(), y32)}
        timed = dt == "bfloat16"
        for label, call in (("forward", calls[0]), ("dX", calls[1])):
            key = f"csr_spmm/ogbn-arxiv/{label}/{dt}"
            recs["segment_sum"][key] = lowp_segsum_hold(key, call, timed,
                                                        log)
        del a, x, y, calls
    emit({"lowp_csr_spmm": {"shape": [GNN["nodes"], GNN["d"]],
                            "nnz": int(a32.nnz), **path}}, log)
    del g, a32, x32, ct32, y32
    torch.cuda.empty_cache()
    name, n = MCL_MATRIX
    g = mc.add_self_loops(table_ii_matrix(name, seed=0, n_override=n,
                                          device="cuda"))
    for dt in LOWP_DTYPES:
        with recorded_sums(ss) as calls:
            sparse_ops.csr_column_sums(lowp_data(g, getattr(torch, dt)))
        key = f"csr_column_sums/{name}/{dt}"
        recs["segment_sum"][key] = lowp_segsum_hold(key, calls[0],
                                                    dt == "bfloat16", log)
        del calls
    del g
    torch.cuda.empty_cache()
    emit({"lowp_kernel_shapes_s": time.perf_counter() - t0}, log)
    return recs


def k7_tile(path: str) -> int:
    """The key tile of K7's forward kernel on route ``path``: the plain
    version's ``k_blk`` under ``p_dtype``, so that P is rounded after the
    same running maxima."""
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels._build import source_constants

    if path.startswith("wgmma"):
        return k7.wgmma_constants()["kBK"]
    return source_constants("flash_attention.cu")["kBK"]


def error_share(got, want) -> float:
    """sum |got - want| over sum |want|."""
    diff = (got.double() - want.double()).abs().sum()
    return float(diff / want.double().abs().sum().clamp_min(1e-300))


def k7_gate(got, want, vmax, p_dtype, case) -> float:
    """``got`` within FLASH_TOL of ``want`` plus, under ``p_dtype``,
    P_DTYPE_GATE of ``vmax`` (the largest value the rounding can move) and
    its errors together within P_DTYPE_MEAN of ``want``'s values."""
    rtol, atol = FLASH_TOL[str(want.dtype)]
    if p_dtype is not None:
        atol = atol + P_DTYPE_GATE * vmax
        share = error_share(got, want)
        check(share <= P_DTYPE_MEAN,
              f"K7 {case}: sum |error| {share} of sum |value|, beyond "
              f"P_DTYPE_MEAN {P_DTYPE_MEAN}")
    diff = (got.double() - want.double()).abs()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"K7 {case}: {got.dtype} {tuple(got.shape)}")
    check(bool((diff <= atol + rtol * want.double().abs()).all()),
          f"K7 {case}: max |error| {float(diff.max())} beyond its gate")
    return float(diff.max())


def p_dtype_control(got, want, case) -> float:
    """The share of ``got`` (a build without the rounding, on the inputs
    that ``want``, the plain version under ``p_dtype``, was given) past
    P_DTYPE_MEAN: the gate must refuse it."""
    share = error_share(got, want)
    check(share > P_DTYPE_MEAN,
          f"{case}: the build without the rounding meets the p_dtype gate "
          f"({share} <= {P_DTYPE_MEAN})")
    return share


def k7_call_hold(q, k, v, do, causal, window, q_offset, kv_len, p_dtype,
                 case, k_chunk=1024, control=False, timed=False) -> dict:
    """One K7 forward and backward through ``ops.flash_attention_masked``
    under autograd: each kernel launched once on the route ``route`` and
    ``bwd_route`` name (the forward none where no query has a key), the
    keyless pass once each way where some query has none; the output
    against the plain forward, the gradients against the plain backward on
    the kernel's own output and lse; a 16-bit call's gradients (the
    tensor cores) twice, bit for bit.  Under ``p_dtype`` the plain forward
    runs the kernel's key tile, and with ``control`` the builds without
    the rounding are held to the same plain versions (p_dtype_control).
    With ``timed``, each kernel is timed beside the CUDA-core kernel on the
    same inputs, its bound and SDPA (``k7_route_times``)."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    a, b = k7.keyless_rows(sq, sk, causal, window, q_offset, kv_len)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before, routes = ops.launch_counts(), ops.route_counts()
    out = ops.flash_attention_masked(*leaves, causal, window, q_offset,
                                     kv_len, p_dtype, k_chunk)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after, now = ops.launch_counts(), ops.route_counts()
    keyless = a > 0 or b < sq
    want = {"flash_attention_fused": int(a < b), "flash_attention_bwd": 1,
            "flash_attention_keyless": 2 * int(keyless)}
    for name, n in want.items():
        check(after[name] - before[name] == n,
              f"K7 {case}: {name} launched {after[name] - before[name]}, "
              f"{n} wanted")
    keys = [f"flash_attention_bwd/{k7.bwd_route(q.dtype, d, dv)}"]
    if a < b:
        keys.append("flash_attention_fused/"
                    f"{k7.route(q.dtype, d, dv, p_dtype)}")
    for key in keys:
        check(now.get(key, 0) == routes.get(key, 0) + 1,
              f"K7 {case}: not on {key} ({now})")
    fwd = k7.route(q.dtype, d, dv, p_dtype)
    o_p = k7.flash_attention_masked_plain(q, k, v, causal, window, q_offset,
                                          kv_len, p_dtype=p_dtype,
                                          k_chunk=k_chunk,
                                          k_blk=k7_tile(fwd))
    vmax = float(v.double().abs().max())
    rec = {"route": keys[-1], "keyless_rows": (a, sq - b),
           "max_abs_err": k7_gate(out.detach(), o_p, vmax, p_dtype, case)}
    kvl = k7._kv_limit(sk, kv_len)
    lse = k7._launch(q, k, v, causal, window, q_offset, kvl, True, p_dtype,
                     k_chunk)[1]
    want_g = k7.flash_attention_masked_bwd_plain(
        q, k, v, out.detach(), lse, do, causal, window, q_offset, kv_len,
        p_dtype, k_chunk)
    if p_dtype is None:
        rec["grad_max_abs_err"] = flash_bwd_check(grads, want_g, case)
    else:  # dq, dk: no rounded P; dv: the p_dtype gate
        gmax = max(float(w.double().abs().max()) for w in want_g)
        rec["grad_max_abs_err"] = max(
            flash_bwd_check(grads[:2], want_g[:2], case, gmax),
            k7_gate(grads[2], want_g[2], gmax, p_dtype, f"{case} dv"))
        rec["error_share"] = error_share(out.detach(), o_p)
        rec["dv_error_share"] = error_share(grads[2], want_g[2])
    if q.dtype in k7.TENSOR_CORE_DTYPES:  # a repeat, bit for bit
        again = torch.autograd.grad(ops.flash_attention_masked(
            *leaves, causal, window, q_offset, kv_len, p_dtype, k_chunk),
            leaves, do)
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"K7 {case}: a repeat of the backward differs")
        rec["repeat_bit_identical"] = True
    if control and p_dtype is not None:
        # the same routes without the rounding: the forward's full P terms,
        # the backward without its flag
        routes = ops.route_counts()
        three = k7._launch(q, k, v, causal, window, q_offset, kvl, False,
                           None, k_chunk)
        no_flag = k7._launch_bwd(q, k, v, out.detach(), lse, do, causal,
                                 window, q_offset, kv_len, None, k_chunk,
                                 route=k7.bwd_route(q.dtype, d, dv))[2]
        rec["control_routes"] = {
            key: n - routes.get(key, 0)
            for key, n in ops.route_counts().items()
            if key.startswith("flash_attention_") and n != routes.get(key, 0)}
        rec["control_error_share"] = p_dtype_control(
            three, o_p, f"K7 {case} without p_dtype")
        rec["control_dv_error_share"] = p_dtype_control(
            no_flag, want_g[2], f"K7 {case} backward without its flag")
    if timed:
        rec.update(k7_route_times(q, k, v, do, causal, window, q_offset,
                                  kv_len, p_dtype, k_chunk))
    return rec


# the kernels of K7's forward and backward calls (both routes, the keyless
# pass's included), by name
KEYLESS_TYPES = ("__nv_bfloat16", "__half", "float")
K7_FWD_KERNEL_NAMES = ("flash_wgmma_kernel", "flash_kernel",
                       "flash_slab_kernel", "flash_f32_kernel",
                       "split_kernel") \
    + tuple(f"keyless_kernel<{t}, true>" for t in KEYLESS_TYPES)
K7_BWD_KERNEL_NAMES = ("delta_kernel", "dkdv_kernel", "dkdv_slab_kernel",
                       "dq_kernel", "dq_slab_kernel") \
    + tuple(f"keyless_kernel<{t}, false>" for t in KEYLESS_TYPES)


def k7_route_times(q, k, v, do, causal, window, q_offset, kv_len, p_dtype,
                   k_chunk=1024) -> dict:
    """K7's forward (with lse) and backward on their routes, each beside
    the CUDA-core kernel on the same inputs (``cuda_cores_ms``,
    ``bwd_cuda_cores_ms``; CUDA events, and the profiler's device time
    under ``*device_ms``), its bound over the pairs the mask lets through
    (forward 2 (D + Dv) FLOP a pair, backward 2 (3 D + 2 Dv); each input
    read once, each output written once) and SDPA with the same boolean
    mask (forward; forward and backward)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7

    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    kvl = k7._kv_limit(sk, kv_len)
    args = (causal, window, q_offset)

    def fwd(path=None):
        return k7._launch(q, k, v, *args, kvl, True, p_dtype, k_chunk, path)

    o, lse = fwd()

    def bwd(route=None):
        return k7._launch_bwd(q, k, v, o, lse, do, *args, kv_len, p_dtype,
                              k_chunk, route)

    pairs = bh * valid_pairs(sq, sk, causal, window, q_offset, kv_len)
    esz = q.element_size()
    io_f = bh * (sq * d + sk * d + sk * dv + sq * dv) * esz + bh * sq * 4
    # at these sizes a call's host time (~0.1 ms) hides its kernels' few
    # microseconds: the routes are compared on device time (one profile a
    # route of 3 forwards and 3 backwards, the kernels split by name: the
    # keyless pass's included, other kernels under other_device_ms), CUDA
    # events kept beside
    rec = {}
    for key, fn in (("", fwd), ("cuda_cores_", lambda: fwd("cuda_cores")),
                    ("bwd_", bwd),
                    ("bwd_cuda_cores_", lambda: bwd("cuda_cores"))):
        rec[f"{key}ms"] = time_ms(fn, reps=3)
    for key, path in (("", None), ("cuda_cores_", "cuda_cores")):
        fwd(path), bwd(path)
        for _ in range(2):  # once more where the profiler recorded nothing
            _, dev, top = profile(lambda: [(fwd(path), bwd(path))
                                           for _ in range(3)], top_n=64)
            if dev:
                break
        split = {"fwd": 0.0, "bwd": 0.0, "other": 0.0}
        for name, ms, _ in top:
            part = ("bwd" if any(n in name for n in K7_BWD_KERNEL_NAMES)
                    else "fwd" if any(n in name for n in K7_FWD_KERNEL_NAMES)
                    else "other")
            split[part] += ms / 3
        rec[f"{key}device_ms"] = split["fwd"] if dev else None
        rec[f"bwd_{key}device_ms"] = split["bwd"] if dev else None
        rec[f"{key}other_device_ms"] = split["other"] if dev else None
    rec["bound_ms"], rec["bound_by"] = bound(
        io_f, 2 * pairs * (d + dv), q.dtype)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(
        2 * io_f, 2 * pairs * (3 * d + 2 * dv), q.dtype)
    # a forward and a backward call's kernels together, each route's
    totals = [None if rec[f"{key}device_ms"] is None else
              rec[f"{key}device_ms"] + rec[f"bwd_{key}device_ms"]
              + rec[f"{key}other_device_ms"] for key in ("", "cuda_cores_")]
    rec["faster_than_cuda_cores"] = None if None in totals \
        else totals[0] < totals[1]
    mask = k7._valid(sq, 0, sk, causal, window, q_offset, q.device)
    mask = mask & (torch.arange(sk, device=q.device) < kvl)[None, :]
    q4, k4, v4, do4 = (x.detach().view(1, bh, x.shape[1], x.shape[2])
                       .requires_grad_(x is not do) for x in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa(), (q4, k4, v4), do4)

    rec["library_call"] = ("F.scaled_dot_product_attention(attn_mask=the "
                           "call's boolean mask); forward + backward")
    try:
        rec["library_ms"] = time_ms(sdpa, reps=5)
        rec["bwd_library_ms"] = time_ms(sdpa_bwd, reps=5)
    except (RuntimeError, NotImplementedError) as exc:
        rec["library_ms"] = rec["bwd_library_ms"] = None
        rec["library_refused"] = str(exc).splitlines()[0][:200]
    return rec


def k7_refused_cases(log) -> dict:
    """K7_REFUSED in float32, bf16 and float16, forward and backward; the
    16-bit cases (the tensor cores) timed beside the CUDA-core kernel."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(12)
    recs = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for name, spec in K7_REFUSED.items():
            sq, sk, d, dv, window, off, kvl, pdt, causal = spec
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for shape in ((2, sq, d), (2, sk, d),
                                                 (2, sk, dv), (2, sq, dv)))
            case = f"{name}/{dt}"
            recs[case] = k7_call_hold(
                q, k, v, do, causal, window, off, kvl,
                None if pdt is None else getattr(torch, pdt), case,
                timed=dt != torch.float32)
    emit({"k7_refused_cases": recs}, log)
    return recs


def k7_timed(q, k, v, causal, p_dtype, heads, log, key) -> dict:
    """K7 through ``ops.flash_attention_masked`` on (BH, S, .) inputs, held
    against its plain version and timed beside its bound, its plain version
    and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    bh, s, d = q.shape
    dv = v.shape[2]
    path = k7.route(q.dtype, d, dv, p_dtype)

    def kernel():
        return ops.flash_attention_masked(q, k, v, causal, p_dtype=p_dtype)

    def plain():
        return k7.flash_attention_masked_plain(q, k, v, causal,
                                               p_dtype=p_dtype,
                                               k_blk=k7_tile(path))

    got, taken = routed_call("flash_attention_fused", kernel, path)
    vmax = float(v.double().abs().max())
    want = plain()
    rec = {"name": "flash_attention_fused", "route": taken,
           "shape": {"bh": bh, "s": s, "d": d, "dv": dv,
                     "dtype": str(q.dtype), "causal": causal,
                     "p_dtype": None if p_dtype is None else str(p_dtype)},
           "max_abs_err": k7_gate(got, want, vmax, p_dtype, key)}
    check(torch.equal(got, kernel()), f"K7 {key}: a repeat differs")
    rec["repeat_bit_identical"] = True
    if p_dtype is not None:  # and the build without the rounding
        rec["error_share"] = error_share(got, want)
        rec["control_error_share"] = p_dtype_control(
            k7._launch(q, k, v, causal, 0, 0, s, False, None), want,
            f"{key} without p_dtype")
    del got, want
    rec["ms"] = time_ms(kernel, reps=3)
    rec["device_ms"] = device_ms(kernel, reps=2)
    rec["plain_ms"] = time_ms(plain, reps=1)
    if path.startswith("wgmma"):  # the CUDA-core kernel on the same inputs
        rec["cuda_cores_ms"] = time_ms(lambda: k7._launch(
            q, k, v, causal, 0, 0, s, False, p_dtype, path="cuda_cores"),
            reps=2)
        rec["faster_than_cuda_cores"] = rec["ms"] < rec["cuda_cores_ms"]
    pairs = bh * valid_pairs(s, s, causal, 0)
    rec["flops"] = 2 * pairs * (d + dv)
    rec["bytes"] = bh * s * (2 * d + 2 * dv) * q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             q.dtype)
    if q.dtype == torch.float32 and path == "wgmma":
        # the tensor cores' own work: the term products i + j < kF32Terms
        # at the bf16 rate (each value slab's S where D passes its build)
        terms = k7.f32_constants()["kF32Terms"]
        rec["tensor_bound_ms"] = bound(
            0, terms * (terms + 1) // 2 * rec["flops"], torch.bfloat16)[0]
    q4, k4, v4 = (x.view(bh // heads, heads, s, x.shape[2])
                  for x in (q, k, v))
    rec.update(library_call([(
        f"F.scaled_dot_product_attention(is_causal={causal}) on "
        f"({bh // heads}, {heads}, s, d|dv)",
        lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                               is_causal=causal))]))
    emit({key: rec}, log)
    return rec


# the keyless pass timed: every query of (BH, S, D) bf16 without a key
# (kv_len 0), key chunk 1,024 (den = S)
K7_KEYLESS = (32, 4096, 128)


def k7_keyless_timed(rand, log) -> dict:
    """K7's keyless pass alone (kv_len 0: no attention launch) at
    K7_KEYLESS, against its plain version and the same bits on a repeat,
    beside its bound (v read once, o and lse written once) and
    ``torch.mean`` of v over the keys (the rows' values, not written out);
    the backward's dV sum likewise, beside ``v.float().sum(1)``."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    bh, s, d = K7_KEYLESS
    q, k, v = (rand(bh, s, d, dtype=torch.bfloat16) for _ in range(3))

    def kernel():
        return ops.flash_attention_masked(q, k, v, False, kv_len=0)

    before = ops.launch_counts()["flash_attention_fused"]
    got, taken = routed_call("flash_attention_keyless", kernel, "fwd")
    check(ops.launch_counts()["flash_attention_fused"] == before,
          "keyless: the attention kernel was launched")
    want = k7.flash_attention_masked_plain(q, k, v, False, kv_len=0)
    check(torch.equal(kernel(), got), "keyless: a repeat differs")
    rec = {"name": "flash_attention_keyless", "route": taken,
           "shape": {"bh": bh, "sq": s, "sk": s, "d": d, "dv": d,
                     "dtype": "bfloat16", "kv_len": 0},
           "max_abs_err": k7_gate(got, want, 1.0, None, "keyless"),
           "ms": time_ms(kernel, reps=5), "device_ms": device_ms(kernel, 3),
           "loop_ms": loop_ms(kernel, reps=20),
           "plain_ms": time_ms(lambda: k7.flash_attention_masked_plain(
               q, k, v, False, kv_len=0), reps=1)}
    nbytes = bh * s * d * 2 * v.element_size() + bh * s * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, bh * s * d,
                                             torch.bfloat16)
    rec.update(library_call([("torch.mean(v, 1) (the rows' values only)",
                              lambda: torch.mean(v, 1))]))
    rec["library_loop_ms"] = loop_ms(lambda: torch.mean(v, 1), reps=20)
    # the backward's keyless pass alone: the float32 dV every key gets
    g = torch.empty((bh, d), dtype=torch.float32, device="cuda")
    before = ops.launch_counts()["flash_attention_keyless"]

    def kernel_bwd():
        k7._keyless(v, g, None, s, s, s, None, 1024, False)

    kernel_bwd()
    torch.cuda.synchronize()
    check(ops.launch_counts()["flash_attention_keyless"] == before + 1,
          "keyless backward: launches")
    check(torch.allclose(g, v.float().sum(1) / s, rtol=1e-5, atol=1e-6),
          "keyless backward: differs from its plain sum")
    first = g.clone()
    kernel_bwd()
    check(torch.equal(g, first), "keyless backward: a repeat differs")
    rec["bwd"] = {"route": "bwd", "ms": time_ms(kernel_bwd, reps=5),
                  "device_ms": device_ms(kernel_bwd, 3),
                  "loop_ms": loop_ms(kernel_bwd, reps=20),
                  "library_loop_ms": loop_ms(lambda: v.float().sum(1),
                                             reps=20),
                  "bound_ms": bound_ms(v.numel() * v.element_size()
                                       + g.numel() * 4),
                  "library_ms": time_ms(lambda: v.float().sum(1), reps=5),
                  "library_call": "v.float().sum(1)"}
    emit({"k7_keyless": rec}, log)
    del q, k, v, got, want
    return rec


# the backward at D 256 timed: bf16 (BH 16, S 2,048, causal), the split
# build on the tensor cores, beside the CUDA-core slab kernel
K7_BWD_SLABS = (16, 2048, 256)


def k7_bwd_repeat(bwd, case) -> bool:
    """``bwd()`` twice, bit for bit (no atomics)."""
    import torch

    first = bwd()
    again = bwd()
    check(all(torch.equal(x, y) for x, y in zip(first, again)),
          f"{case}: a repeat of the backward differs")
    return True


def k7_bwd_timed(q, k, v, do, p_dtype, heads, log, key, control=False):
    """K7's causal backward on (BH, S, .) inputs, held with its forward
    against their plain versions (``k7_call_hold``), twice bit for bit,
    and timed beside the CUDA-core kernel on the same inputs, its bound
    (6 D + 4 Dv FLOP a pair) and SDPA's forward + backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7

    bh, s, d = q.shape
    dv = v.shape[2]
    rec = k7_call_hold(q, k, v, do, True, 0, 0, None, p_dtype, key,
                       control=control)
    o, lse = k7._launch(q, k, v, True, 0, 0, s, True, p_dtype)
    route = k7.bwd_route(q.dtype, d, dv)

    def bwd(route=None):
        return k7._launch_bwd(q, k, v, o, lse, do, True, 0, 0, s, p_dtype,
                              route=route)

    def fwd_bwd():
        o2, lse2 = k7._launch(q, k, v, True, 0, 0, s, True, p_dtype)
        return k7._launch_bwd(q, k, v, o2, lse2, do, True, 0, 0, s, p_dtype)

    pairs = bh * valid_pairs(s, s, True, 0)
    rec.update({"name": "flash_attention_bwd", "bwd_route": route,
                "shape": {"bh": bh, "s": s, "d": d, "dv": dv,
                          "dtype": str(q.dtype), "causal": True,
                          "p_dtype": None if p_dtype is None
                          else str(p_dtype)},
                "repeat_bit_identical": k7_bwd_repeat(bwd, key),
                "ms": time_ms(bwd, reps=3), "loop_ms": loop_ms(bwd, reps=5),
                "device_ms": device_ms(bwd, 1),
                "cuda_cores_ms": time_ms(lambda: bwd("cuda_cores"), reps=2),
                "fwd_bwd_loop_ms": loop_ms(fwd_bwd, reps=5),
                "plain_ms": time_ms(lambda: k7.flash_attention_masked_bwd_plain(
                    q, k, v, o, lse, do, True, p_dtype=p_dtype), reps=1),
                "flops": (6 * d + 4 * dv) * pairs,
                "bytes": bh * s * (4 * d + 4 * dv) * q.element_size()
                + bh * s * 4})
    rec["faster_than_cuda_cores"] = rec["ms"] < rec["cuda_cores_ms"]
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             q.dtype)
    q4, k4, v4, do4 = (x.view(bh // heads, heads, s, x.shape[2]).detach()
                       .requires_grad_(x is not do) for x in (q, k, v, do))

    def sdpa():
        out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        return torch.autograd.grad(out, (q4, k4, v4), do4)

    rec.update(library_call([(
        "F.scaled_dot_product_attention(is_causal=True) forward + backward "
        f"on ({bh // heads}, {heads}, s, d)", sdpa)]))
    emit({key: rec}, log)
    del o, lse
    return rec


def k7_new_shapes(log) -> dict:
    """K7 at its new widths (K7_WIDE), in float16 at Phi-3-mini's prefill
    shape, its backward at D 256 (K7_BWD_SLABS), with p_dtype and in
    float16 at granite-3-2b's training shape (K7_P_DTYPE_TRAIN), and the
    keyless pass."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    recs = {}
    for name, bh, s, d, dv, dtypes in K7_WIDE:
        for dt in dtypes:
            dtype = getattr(torch, dt)
            q, k = rand(bh, s, d, dtype=dtype), rand(bh, s, d, dtype=dtype)
            v = rand(bh, s, dv, dtype=dtype)
            key = f"k7_{name}_{dt}"
            recs[key] = k7_timed(q, k, v, True, None, 16, log, key)
            del q, k, v
            torch.cuda.empty_cache()
    bh, s, d = K7_F16
    q, k, v = (rand(bh, s, d, dtype=torch.float16) for _ in range(3))
    recs["k7_phi3_float16"] = k7_timed(q, k, v, True, None, 32, log,
                                       "k7_phi3_float16")
    q, k, v = (x.bfloat16() for x in (q, k, v))
    recs["k7_phi3_p_dtype"] = k7_timed(q, k, v, True, torch.bfloat16, 32,
                                       log, "k7_phi3_p_dtype")
    del q, k, v
    bh, s, d = K7_BWD_SLABS
    q, k, v, do = (rand(bh, s, d, dtype=torch.bfloat16) for _ in range(4))
    recs["k7_bwd_slabs"] = k7_bwd_timed(q, k, v, do, None, bh, log,
                                        "k7_bwd_slabs")
    del q, k, v, do
    recs["keyless"] = k7_keyless_timed(rand, log)
    # granite's training shape: with p_dtype (the forward on the one-term
    # build, the backward with its flag; both held beside the same builds
    # without the rounding), in float16, and in float32 (the forward on the
    # float32 tensor-core build, the backward on the CUDA cores)
    bh, s, d, heads = K7_P_DTYPE_TRAIN
    for key, dtype, pdt in (
            ("k7_bwd_p_dtype_train_shape", torch.bfloat16, torch.bfloat16),
            ("k7_bwd_float16_train_shape", torch.float16, None),
            ("k7_bwd_float32_train_shape", torch.float32, None)):
        q, k, v, do = (rand(bh, s, d, dtype=dtype) for _ in range(4))
        recs[key] = k7_bwd_timed(q, k, v, do, pdt, heads, log, key,
                                 control=pdt is not None)
        del q, k, v, do
        torch.cuda.empty_cache()
    return recs


def k6_bmm(h_kept, bidx, w2, block) -> list:
    """K6's library call, as on its own row: ``torch.bmm`` of each tile's
    kept lanes with its picked W2 blocks, gathered beforehand (the gather
    excluded from the time)."""
    import torch

    nt, kb = bidx.shape
    hk_flat = h_kept.permute(0, 2, 1, 3).reshape(nt, -1, kb * block)
    sel = w2.view(-1, block, w2.shape[1])[bidx.long()].reshape(
        nt, kb * block, w2.shape[1])
    return [("torch.bmm on the pre-gathered blocks (gather excluded)",
             lambda: torch.bmm(hk_flat, sel))]


def ffn_new_routes(log) -> dict:
    """K3-K6 in float16 at the FFN path's shape (K3's 16-byte copy, K4 and
    K5 on the CUDA cores, K6 on the tensor cores), and K6 at the blocks of
    K6_WIDE: each held against its plain version and timed beside its
    bound, its plain version and a library call; each K6 call on the
    tensor cores also the same bits on a repeat, and timed beside the
    CUDA-core kernel on the same inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import aia_gather, ops, spgemm_bsr, topk_spmm
    from repro_torch.models.ffn import tile_block_select
    from repro_torch.sparse.topk import topk_rows

    x, w1, w2, h = (t.half() for t in ffn_operands(seed=0))
    n, d, f = FFN["tokens"], FFN["d_model"], FFN["d_ff"]
    k, block, tile = FFN["k"], FFN["block"], FFN["tile"]
    el = 2
    recs = {}

    def row(name, kernel, plain, exact, nbytes, flops, dtype, library,
            shape, expect, cuda_cores=None):
        got, taken = routed_call(name, kernel, expect)
        if cuda_cores is not None:  # K6 on the tensor cores: a repeat
            check(torch.equal(got, kernel()), f"{name} {shape}: a repeat "
                  f"differs")
        want = plain()
        if exact:
            check(torch.equal(got, want), f"{name} {shape}: differs")
            err = 0.0
        else:
            err = rel_err(got, want)
            check(err <= FFN_REL, f"{name} {shape}: {err} > {FFN_REL}")
        rec = {"name": name, "route": taken, "shape": shape,
               "max_abs_err": float((got.double() - want.double()).abs()
                                    .max()) if not exact else 0.0,
               "rel_err": err, "ms": time_ms(kernel, reps=5),
               "device_ms": device_ms(kernel, reps=3),
               "plain_ms": time_ms(plain, reps=1)}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dtype)
        if cuda_cores is not None:
            rec["repeat_bit_identical"] = True
            rec["cuda_cores_ms"] = time_ms(cuda_cores, reps=3)
            rec["cuda_cores_device_ms"] = device_ms(cuda_cores, reps=2)
        rec.update(library_call(library))
        del got, want
        return rec

    tk = topk_rows(h, k)
    vals, idx = tk.values, tk.indices
    recs["topk_spmm/float16"] = row(
        "topk_spmm", lambda: ops.topk_spmm(vals, idx, w2),
        lambda: topk_spmm.topk_spmm_plain(vals, idx, w2), True,
        vals.numel() * (el + 4) + int(torch.unique(idx).numel()) * d * el
        + n * d * 4, 2 * vals.numel() * d, torch.float16,
        [("F.embedding_bag(mode='sum', per_sample_weights)",
          lambda: F.embedding_bag(idx, w2, per_sample_weights=vals,
                                  mode="sum"))],
        {"vals": list(vals.shape), "w2": list(w2.shape), "dtype": "float16"},
        "l2")
    h_kept, bidx = tile_block_select(h, k // block, block, tile)
    recs["block_topk_spmm/float16"] = row(
        "block_topk_spmm", lambda: ops.block_topk_spmm(h_kept, bidx, w2, block),
        lambda: topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2, block),
        False, h_kept.numel() * el + bidx.numel() * 4
        + int(torch.unique(bidx).numel()) * block * d * el + n * d * 4,
        2 * h_kept.numel() * d, torch.float16,
        k6_bmm(h_kept, bidx, w2, block),
        {"h_kept": list(h_kept.shape), "w2": list(w2.shape),
         "dtype": "float16"}, "wgmma",
        lambda: topk_spmm._block_topk_spmm_cuda(h_kept, bidx, w2, block,
                                                path="cuda_cores"))
    sel = bidx.reshape(-1)
    recs["aia_ranged_gather/float16"] = row(
        "aia_ranged_gather", lambda: ops.aia_ranged_gather(w2, sel, block),
        lambda: aia_gather.aia_ranged_gather_plain(w2, sel, block), True,
        2 * sel.numel() * block * d * el + sel.numel() * 4, 0, torch.float16,
        [("index_select of the blocks", lambda: w2.view(-1, block * d)
          .index_select(0, sel.long()))],
        {"w2": list(w2.shape), "ids": sel.numel(), "dtype": "float16"},
        "v16")
    # K3's other new routes on W2's ranges (bf16): an x 2 bytes off a word
    # ("u16"), W2's bytes 1 byte off ("bytes"), a column slice of a wider
    # W2 ("words": rows a pitch apart)
    w2b = w2.bfloat16()
    off = torch.empty(w2b.numel() + 1, dtype=torch.bfloat16,
                      device="cuda")[1:].view_as(w2b)
    off.copy_(w2b)
    raw = torch.empty(w2b.numel() * 2 + 1, dtype=torch.uint8,
                      device="cuda")[1:].view(f, 2 * d)
    raw.copy_(w2b.view(torch.uint8))
    wide = torch.zeros((f, d + 64), dtype=torch.bfloat16, device="cuda")
    wide[:, :d] = w2b
    for route, xr in (("u16", off), ("bytes", raw), ("words", wide[:, :d])):
        recs[f"aia_ranged_gather/{route}"] = row(
            "aia_ranged_gather",
            lambda xr=xr: ops.aia_ranged_gather(xr, sel, block),
            lambda xr=xr: aia_gather.aia_ranged_gather_plain(xr, sel, block),
            True, 2 * sel.numel() * block * xr.shape[1] * xr.element_size()
            + sel.numel() * 4, 0, torch.bfloat16,
            [("index_select of the ranges", lambda xr=xr: xr.reshape(
                -1, block * xr.shape[1]).index_select(0, sel.long()))],
            {"x": list(xr.shape), "stride": list(xr.stride()),
             "dtype": str(xr.dtype), "ids": sel.numel()}, route)
    del h_kept, bidx, sel, w2b, off, raw, wide
    bsr = pruned_bsr(w1.t().contiguous(), FFN["bsr_keep"], block)
    xt = x.t().contiguous()
    keep = FFN["bsr_keep"]
    used = int(bsr.indptr[-1])
    b_blocks = int(torch.unique(bsr.indices[:used]).numel())
    recs["bsr_spmm/float16"] = row(
        "bsr_spmm", lambda: ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks,
                                         xt, keep),
        lambda: spgemm_bsr.bsr_spmm_plain(bsr.indptr, bsr.indices,
                                          bsr.blocks, xt, keep), False,
        (bsr.n_brows + 1) * 4 + used * (4 + block * block * el)
        + b_blocks * block * n * el + f * n * 4,
        2 * used * block * block * n, torch.float16, [],
        {"a": list(bsr.shape), "block": block, "b": list(xt.shape),
         "dtype": "float16"}, "cuda_cores")
    del bsr, xt
    for wide, dt in K6_WIDE:
        dtype = getattr(torch, dt)
        hw, w2w = h.to(dtype), w2.to(dtype)
        h_kept, bidx = tile_block_select(hw, max(1, k // wide), wide, tile)
        esz = hw.element_size()
        recs[f"block_topk_spmm/block {wide}/{dt}"] = row(
            "block_topk_spmm",
            lambda: ops.block_topk_spmm(h_kept, bidx, w2w, wide),
            lambda: topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2w, wide),
            False, h_kept.numel() * esz + bidx.numel() * 4
            + int(torch.unique(bidx).numel()) * wide * d * esz + n * d * 4,
            2 * h_kept.numel() * d, dtype, k6_bmm(h_kept, bidx, w2w, wide),
            {"h_kept": list(h_kept.shape), "w2": list(w2w.shape),
             "block": wide, "dtype": dt}, topk_spmm.route(dtype),
            None if topk_spmm.route(dtype) == "cuda_cores" else
            lambda: topk_spmm._block_topk_spmm_cuda(h_kept, bidx, w2w, wide,
                                                    path="cuda_cores"))
        del hw, w2w, h_kept, bidx
        torch.cuda.empty_cache()
    for key, rec in recs.items():
        emit({"ffn_new_route": {"case": key, **rec}}, log)
    del x, w1, w2, h
    torch.cuda.empty_cache()
    return recs


def refusals_phase(log) -> dict:
    """Every call the port once refused on the card (listed in 6c of the
    module's docstring), made once: each must launch its kernel and match its plain version on the
    same inputs (on the CPU where the plain version is the CPU port's).
    The calls that raise are collected and printed (``refused: [...]``);
    the phase fails unless there are none."""
    import torch

    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import aia_gather, ops, spgemm_bsr, topk_spmm
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.models import attention
    from repro_torch.sparse import formats as fm
    from repro_torch.sparse import ops as sparse_ops

    g = torch.Generator(device="cuda").manual_seed(14)
    rng = np.random.default_rng(14)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def same(got, want, what):
        check(torch.equal(got.cpu(), want.cpu()), f"{what}: differs")

    def launched(name, fn):
        before = ops.launch_counts()[name]
        out = fn()
        torch.cuda.synchronize()
        check(ops.launch_counts()[name] > before, f"{name} not launched")
        return out

    dense = rng.standard_normal((96, 96)).astype(np.float32)
    dense = np.where(rng.random((96, 96)) < 0.15, dense, 0)
    x16 = torch.from_numpy(dense).bfloat16()
    calls = {}

    def spgemm_lanes():
        a = fm.csr_from_dense(x16.cuda(), device="cuda")
        check(a.data.dtype == torch.bfloat16, "csr_from_dense dtype")
        cpu = spgemm(on_cpu(a), on_cpu(a)).c
        for label, kwargs, kernels, _ in CALLS:
            c = spgemm(a, a, **kwargs).c
            check(same_csr(on_cpu(c), cpu), f"spgemm bf16 {label}")
        return "segment_sum, hash_accumulate"

    calls["spgemm bf16 (sort, fused_hash, hash-xla) and csr_from_dense"] = \
        spgemm_lanes

    def csr_prims():
        a = fm.csr_from_dense(x16, device="cuda")
        ac = on_cpu(a)
        xv = rand(96, dtype=torch.bfloat16)
        same(launched("segment_sum", lambda: sparse_ops.csr_spmv(a, xv)),
             sparse_ops.csr_spmv(ac, xv.cpu()), "csr_spmv bf16")
        wide = rand(96, 80, dtype=torch.bfloat16)
        xs = wide[:, 8:72]
        same(launched("gather_rows", lambda: sparse_ops.csr_spmm(
            a, xs, gather="aia")),
            sparse_ops.csr_spmm(ac, xs.cpu()), "csr_spmm bf16 column slice")
        same(launched("segment_sum", lambda: sparse_ops.csr_column_sums(a)),
             sparse_ops.csr_column_sums(ac), "csr_column_sums bf16")
        same(launched("segment_sum", lambda: fm.csr_to_dense(a)), x16,
             "csr_to_dense bf16 (_add_at)")
        return "segment_sum, gather_rows"

    calls["csr_spmv, csr_spmm (strided X), column sums, dense bf16"] = \
        csr_prims

    def k7_model():
        for name, spec in K7_REFUSED.items():
            sq, sk, d, dv, window, off, kvl, pdt, causal = spec
            q = rand(1, sq, 2, d, dtype=torch.bfloat16)
            k = rand(1, sk, 2, d, dtype=torch.bfloat16)
            v = rand(1, sk, 2, dv, dtype=torch.bfloat16)
            kw = dict(causal=causal, window=window, q_offset=off,
                      kv_valid_len=kvl,
                      p_dtype=None if pdt is None else torch.bfloat16)
            before = ops.launch_counts()
            got = attention.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            check(after["flash_attention_fused"]
                  + after["flash_attention_keyless"]
                  > before["flash_attention_fused"]
                  + before["flash_attention_keyless"],
                  f"attention {name}: no K7 launch")
            want = attention.flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
            k7_gate(got.cpu(), want, float(v.abs().max()), kw["p_dtype"],
                    f"attention {name}")
        return "flash_attention_fused, flash_attention_keyless"

    calls["K7: p_dtype, D > 192, Dv > D, queries without keys"] = k7_model

    def k1_k3():
        x = rand(300, 40)
        xs = rand(300, 64)[:, 8:48]
        idx = torch.from_numpy(rng.integers(-3, 303, 500).astype(np.int32)
                               ).cuda()
        same(launched("gather_rows", lambda: aia_gather.gather_rows(xs, idx)),
             aia_gather.gather_rows_plain(xs.cpu(), idx.cpu()),
             "K1 strided x")
        ridx = torch.from_numpy(rng.integers(-2, 102, 50).astype(np.int32)
                                ).cuda()
        for what, xr, r in (
                ("K3 strided x", xs, 3),
                ("K3 bf16 odd range", rand(300, 7, dtype=torch.bfloat16), 3),
                ("K3 x 2 bytes off", rand(301 * 8, dtype=torch.bfloat16)
                 [1:2401].view(300, 8), 3),
                ("K3 bytes", torch.randint(0, 255, (300, 5), generator=g,
                                           device="cuda",
                                           dtype=torch.uint8), 3)):
            same(launched("aia_ranged_gather",
                          lambda: aia_gather.aia_ranged_gather(xr, ridx, r)),
                 aia_gather.aia_ranged_gather_plain(xr.cpu(), ridx.cpu(), r),
                 what)
        del x
        return "gather_rows, aia_ranged_gather"

    calls["K1 and K3 on strided, odd and unaligned x"] = k1_k3

    def k6_caps():
        for block, nb, dt in ((264, 3, torch.bfloat16),
                              (8, 32_770, torch.bfloat16),
                              (2048, 3, torch.float32)):
            h = rand(2, 2, 8, block, dtype=dt)
            w2 = rand(nb * block, 24, dtype=dt)
            bidx = torch.from_numpy(rng.integers(-1, nb + 1, (2, 2))
                                    .astype(np.int32)).cuda()
            got = launched("block_topk_spmm",
                           lambda: ops.block_topk_spmm(h, bidx, w2, block))
            e = rel_err(got, topk_spmm.block_topk_spmm_plain(h, bidx, w2,
                                                             block))
            check(e <= FFN_REL, f"K6 block {block} x {nb} {dt}: {e}")
        return "block_topk_spmm"

    calls["K6 past its caps"] = k6_caps

    def f16_k4_k7():
        h = rand(4, 24, dtype=torch.float16)
        w2 = rand(40, 16, dtype=torch.float16)
        idx = torch.from_numpy(rng.integers(0, 40, (4, 24)).astype(np.int32)
                               ).cuda()
        same(launched("topk_spmm", lambda: ops.topk_spmm(h, idx, w2)),
             topk_spmm.topk_spmm_plain(h, idx, w2), "K5 float16")
        q, k, v = (rand(2, 64, 32, dtype=torch.float16) for _ in range(3))
        got = launched("flash_attention_fused",
                       lambda: ops.flash_attention_fused(q, k, v))
        k7_gate(got, ops.flash_attention_fused(q.cpu(), k.cpu(), v.cpu())
                .cuda(), 1.0, None, "K7 float16")
        rp = torch.tensor([0, 2, 3], dtype=torch.int32, device="cuda")
        ci = torch.tensor([0, 1, 1], dtype=torch.int32, device="cuda")
        blocks, b = rand(3, 8, 8, dtype=torch.float16), rand(16, 12,
                                                            dtype=torch.float16)
        got = launched("bsr_spmm", lambda: ops.bsr_spmm(rp, ci, blocks, b, 2))
        e = rel_err(got, spgemm_bsr.bsr_spmm_plain(rp, ci, blocks, b, 2))
        check(e <= FFN_REL, f"K4 float16: {e}")
        hk = rand(2, 2, 8, 16, dtype=torch.float16)
        w2b = rand(4 * 16, 24, dtype=torch.float16)
        bidx = torch.tensor([[0, 3], [2, 2]], dtype=torch.int32,
                            device="cuda")
        got = launched("block_topk_spmm",
                       lambda: ops.block_topk_spmm(hk, bidx, w2b, 16))
        e = rel_err(got, topk_spmm.block_topk_spmm_plain(hk, bidx, w2b, 16))
        check(e <= FFN_REL, f"K6 float16: {e}")
        return "topk_spmm, flash_attention_fused, bsr_spmm, block_topk_spmm"

    calls["K4-K7 in float16"] = f16_k4_k7

    def segsum_sets():
        ids = torch.tensor([0, 0, 2, 3], device="cuda")
        vals = rand(70_000, 4, 2)
        same(launched("segment_sum", lambda: ss.segment_sum(ids, vals, 4)),
             ss.segment_sum_plain(ids.cpu(), vals.cpu(), 4),
             "segment_sum 70,000 value sets")
        return "segment_sum"

    calls["segment sum past 65,535 value sets"] = segsum_sets

    refused, done = [], {}
    ops.reset_launch_counts()  # this phase's count starts here
    for what, fn in calls.items():
        try:
            done[what] = fn()
        except (ValueError, NotImplementedError, TypeError) as exc:
            refused.append(f"{what}: {type(exc).__name__}: {exc}"[:300])
    print(f"refused: {json.dumps(refused)}", flush=True)
    emit({"refusals": {"calls": done, "refused": refused}}, log)
    check(not refused, f"calls refused on the card: {refused}")
    return {"calls": list(done), "refused": refused,
            "launches": ops.launch_counts()}


ROUTE_KEYS = ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms", "library_call")


def route_row(rec, launches) -> dict:
    """A new route's entry in the kernels line: the launches counted
    around the call its row holds and times, and its measured numbers."""
    return {**{k: rec.get(k) for k in ROUTE_KEYS[1:]}, "launches": launches,
            "route": rec.get("route"), "shape": rec.get("shape")}


def add_new_routes(kernels, new, prefill_p) -> None:
    """6c's routes into the kernels line: each kernel's entry gains
    ``new_routes`` (launches, error, times, bound and library time of each
    new route), and the keyless pass gets an entry of its own."""
    by_name = {k["name"]: k for k in kernels}
    products, shapes = new["products"], new["shapes"]
    refusals = new["refusals"]["launches"]
    seg = by_name["segment_sum"]
    seg["new_routes"] = {key: route_row(rec, rec["launches"])
                         for key, rec in shapes["segment_sum"].items()
                         if "ms" in rec}
    seg["launches_per_bf16_spgemm"] = {
        c: n["segment_sum"] for c, n in products["per_call"].items()}
    by_name["aia_gather_rows"]["launches_per_bf16_spgemm"] = {
        c: n["gather_rows"] for c, n in products["per_call"].items()}
    k2 = by_name["hash_accumulate"]
    k2["new_routes"] = {key: route_row(rec, rec["launches"])
                        for key, rec in shapes["hash_accumulate"].items()
                        if "ms" in rec}
    k2["launches_per_bf16_spgemm"] = {
        c: n["hash_accumulate"] for c, n in products["per_call"].items()}
    for key, rec in new["ffn"].items():
        entry = by_name[rec["name"]]
        entry.setdefault("new_routes", {})[key] = route_row(rec, 1)
    k7 = by_name["flash_attention_fused"]
    k7["new_routes"] = {key: {**route_row(rec, 1),
                              "cuda_cores_ms": rec.get("cuda_cores_ms")}
                        for key, rec in new["k7"].items()
                        if rec["name"] == "flash_attention_fused"}
    k7["launches_per_phi3_p_dtype_prefill"] = \
        prefill_p["launches"]["flash_attention_fused"]
    k7["routes_per_phi3_p_dtype_prefill"] = prefill_p["routes"]
    k7["refused_cases"] = new["k7_cases"]
    k7["launches_per_refusals_phase"] = refusals["flash_attention_fused"]
    bwd = by_name["flash_attention_bwd"]
    bwd["new_routes"] = {
        name: {**route_row(rec, 1), "route": rec["bwd_route"],
               **{k: rec[k] for k in ("loop_ms", "fwd_bwd_loop_ms",
                                      "cuda_cores_ms")}}
        for name, rec in (
            ("p_dtype granite train shape",
             new["k7"]["k7_bwd_p_dtype_train_shape"]),
            ("float16 granite train shape",
             new["k7"]["k7_bwd_float16_train_shape"]),
            ("float32 granite train shape",
             new["k7"]["k7_bwd_float32_train_shape"]),
            ("D 256", new["k7"]["k7_bwd_slabs"]))}
    rec = new["k7"]["keyless"]
    kernels.append({
        "bwd": rec["bwd"],
        "name": "flash_attention_keyless", "route": "cuda",
        "path": rec["route"],
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "none: the rows the reference's chunked attention "
                    "(src/repro/models/attention.py:96-120) gives a query "
                    "without keys",
        "shape": rec["shape"],
        "launches": refusals["flash_attention_keyless"],
        **{k: rec.get(k) for k in ROUTE_KEYS[1:]}})


def new_routes_phase(log) -> dict:
    """K7's once-refused cases and new shapes and the FFN kernels' new
    routes, early in the script (the profiler reads no device time after
    the long SpGEMM traces)."""
    import torch

    t0 = time.perf_counter()
    out = {"k7_cases": k7_refused_cases(log), "k7": k7_new_shapes(log),
           "ffn": ffn_new_routes(log)}
    torch.cuda.empty_cache()
    emit({"new_routes_phase_s": time.perf_counter() - t0}, log)
    return out


def refused_calls_phase(mats, log) -> dict:
    """The low-precision products and kernel shapes, then the refusals."""
    import torch

    t0 = time.perf_counter()
    out = {"products": lowp_products(mats, log)}
    out["shapes"] = lowp_kernel_shapes(mats, log)
    torch.cuda.empty_cache()
    out["refusals"] = refusals_phase(log)
    emit({"refused_calls_phase_s": time.perf_counter() - t0}, log)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every record to this file")
    args = parser.parse_args(argv)

    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    log: list = []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (lib_path.parent / "build.log")
             .read_text().splitlines() if "ptxas info" in ln]
    emit({"build": {"seconds": build_s, "library": str(lib_path),
                    "ptxas": ptxas}}, log)
    dryruns = dryrun_start()  # CPU only, beside the card's phases
    try:
        return run_phases(args, log, smi, dryruns, t_script)
    finally:
        stop(dryruns)


def run_phases(args, log, smi, dryruns, t_script) -> int:
    """Every phase in order, then the kernels' line and the last line."""
    import torch

    from repro_torch.apps.graphs import table_ii_matrix

    # the sparse-activation path first, so its profiles do not follow the
    # SpGEMM calls' traces of many thousand launches
    ffn = ffn_phase(log)
    torch.cuda.empty_cache()
    # then K7 and the LM path, still ahead of the SpGEMM traces
    flash, flash_mla, flash_masked = flash_phase(log)
    torch.cuda.empty_cache()
    new_routes = new_routes_phase(log)
    prefill, _, _ = lm_phase(log)
    prefill_p = next(r["lm_prefill_p_dtype"] for r in log
                     if "lm_prefill_p_dtype" in r)
    ds_prefill, _, _ = deepseek_phase(log)
    families = families_phase(log)
    torch.cuda.empty_cache()
    train = train_phase(log)
    torch.cuda.empty_cache()
    dist_run = dist_phase(log, dryruns)
    torch.cuda.empty_cache()
    mats = {name: table_ii_matrix(name, seed=0, n_override=n, device="cuda")
            for name, n in MATRICES.items()}
    k1, k2 = kernel_phase(mats, log)
    segsum = segment_sum_phase(mats, log)
    refused = refused_calls_phase(mats, log)
    torch.cuda.empty_cache()
    totals, per_call = end_to_end_phase(mats, log)
    per_serve = serve_phase(mats, log)
    torch.cuda.empty_cache()
    per_mesh = mesh_phase(mats, log)
    del mats
    torch.cuda.empty_cache()
    per_app, k1_spmm = apps_phase(log)
    torch.cuda.empty_cache()
    per_sample, per_step = minibatch_phase(log)
    per_app.update(per_sample)
    torch.cuda.empty_cache()
    per_stream = stream_phase(log)

    ds_train = train["deepseek"]
    kernels = [
        {"name": "aia_gather_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aia_gather.cu",
         "replaces": "src/repro/kernels/aia_gather.py:75",
         "tpu_kernel": "src/repro/kernels/aia_gather.py:gather_rows",
         "shape": {"planes": 2, **{k: k1[k] for k in (
             "matrix", "group", "n_idx", "row_words")}},
         "launches": totals["gather_rows"],
         "launches_per_spgemm": {c: n["gather_rows"]
                                 for c, n in per_call.items()},
         "launches_per_app": {c: n["gather_rows"]
                              for c, n in per_app.items()},
         "launches_per_serve": {c: n["gather_rows"]
                                for c, n in per_serve.items()},
         "launches_per_minibatch_step": per_step["gather_rows"],
         "launches_per_stream": {c: n["gather_rows"]
                                 for c, n in per_stream.items()},
         "launches_per_mesh": {c: n["gather_rows"]
                               for c, n in per_mesh.items()},
         "csr_spmm_shape": k1_spmm,
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "kernel_ms": k1["ms"], "host_ms": k1["host_ms"],
         "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"],
         "library_device_ms": k1["library_device_ms"], "path": k1["route"]},
        {"name": "hash_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_accum.cu",
         "replaces": "src/repro/kernels/hash_accum.py:130",
         "tpu_kernel": "src/repro/kernels/hash_accum.py:hash_accumulate",
         "shape": {k: k2[k] for k in ("matrix", "group", "rows", "ip_cap",
                                      "table_cap")},
         "launches": totals["hash_accumulate"],
         "launches_per_spgemm": {c: n["hash_accumulate"]
                                 for c, n in per_call.items()},
         "launches_per_app": {c: n["hash_accumulate"]
                              for c, n in per_app.items()},
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "kernel_ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"],
         "library_device_ms": k2["library_device_ms"],
         "library_call": k2["library_call"],
         "launches_per_serve": {c: n["hash_accumulate"]
                                for c, n in per_serve.items()},
         "launches_per_minibatch_step": per_step["hash_accumulate"],
         "launches_per_stream": {c: n["hash_accumulate"]
                                 for c, n in per_stream.items()},
         "launches_per_mesh": {c: n["hash_accumulate"]
                               for c, n in per_mesh.items()},
         "path": k2["route"], "chunks": k2["chunks"]},
    ]
    head = segsum["shapes"][SEGSUM_HEAD]
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "none: the reference's sums are XLA's .at[].add "
                    "(src/repro/core/phases.py:356; src/repro/sparse/"
                    "ops.py:45, :83, :103, :133)",
        "shape": head["shape"],
        "launches": totals["segment_sum"],
        "launches_per_spgemm": {c: n["segment_sum"]
                                for c, n in per_call.items()},
        "launches_per_app": {c: n["segment_sum"]
                             for c, n in per_app.items()},
        "launches_per_serve": {c: n["segment_sum"]
                               for c, n in per_serve.items()},
        "launches_per_minibatch_step": per_step["segment_sum"],
        "launches_per_stream": {c: n["segment_sum"]
                                for c, n in per_stream.items()},
        "launches_per_mesh": {c: n["segment_sum"]
                              for c, n in per_mesh.items()},
        # the MoE gathers' backward, 4 a MoE layer
        "launches_per_deepseek_train_step":
            ds_train["steps"]["launches_per_step"].get("segment_sum", 0),
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "kernel_ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "library_call": head["library_call"],
        "shapes": {k: {f: r[f] for f in (
            "shape", "ms", "device_ms", "loop_ms", "plain_ms",
            "plain_device_ms", "plain_equal", "bound_ms", "library_ms",
            "segment_reduce_device_ms", "segment_reduce_equal",
            "index_put_ms", "index_put_device_ms", "index_put_equal")}
            for k, r in segsum["shapes"].items()},
        "formats_on_card": segsum["formats"]})
    for name, src, tpu in FFN_SOURCES:
        rec = ffn[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "tpu_kernel": f"{tpu.split(':')[0]}:{name}",
            "shape": rec["shape"], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "kernel_ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_call": rec["library_call"]})
        if "route" in rec:  # the CUDA kernel the path's call took
            kernels[-1].update(path=rec["route"], ptxas=rec["ptxas"],
                               launch=rec["launch"])
        if name in FLOAT32_SOURCES:
            kernels[-1]["float32_source"] = \
                f"src/repro_torch/kernels/csrc/{FLOAT32_SOURCES[name]}"
        if name in L2_SOURCES:
            kernels[-1]["l2_source"] = \
                f"src/repro_torch/kernels/csrc/{L2_SOURCES[name]}"
    kernels.append({
        "name": "flash_attention_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
        "built_by": [f"src/repro_torch/kernels/csrc/{name}" for name in (
            "flash_attention_wgmma.cu", "flash_attention_wgmma_f16.cu",
            "flash_attention_wgmma_wide.cu")],
        # float32 up to 256 columns: the tensor cores, three bf16 terms an
        # operand; float32 past them and under p_dtype: the CUDA cores
        "float32_wgmma_source":
            "src/repro_torch/kernels/csrc/flash_attention_wgmma_f32.cu",
        "float32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "float32": {k: flash_masked["float32"].get(k) for k in (
            "route", "shape", "max_abs_err", "ms", "device_ms",
            "cuda_cores_ms", "bound_ms", "bound_by", "tensor_bound_ms",
            "library_ms", "library_call", "repeat_bit_identical", "ptxas")},
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "tpu_kernel": "src/repro/kernels/flash_attention.py:"
                      "flash_attention_fused",
        "shape": flash["shape"],
        "launches": prefill["launches"]["flash_attention_fused"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "kernel_ms": flash["ms"], "device_ms": flash["device_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_call": flash["library_call"],
        # MLA's widths at DeepSeek-V2-Lite's prefill
        "mla": {k: flash_mla[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call",
            "ptxas")},
        "launches_per_deepseek_prefill":
            ds_prefill["launches"]["flash_attention_fused"],
        # the masked entry: FLASH_MASK_CASES in both dtypes, and the new
        # families' shapes timed
        "mask_cases": flash_masked["cases"],
        "masked": {name: {k: rec.get(k) for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_ms_unwindowed", "bound_by", "tflops",
            "library_ms", "library_call")}
            for name, rec in flash_masked["timed"].items()},
        **{f"launches_per_{name}_prefill":
           rec["launches"]["flash_attention_fused"]
           for name, rec in families.items()},
        # the training path: forward with lse and the backward kernel, a
        # full-depth granite step each
        "launches_per_train_step": {
            "forward": train["steps"]["launches_per_step"]
            ["flash_attention_fused"],
            "backward": train["steps"]["launches_per_step"]
            ["flash_attention_bwd"]},
        # the same step placed on a (1, 1) mesh, K7 through local_map; and
        # DeepSeek-V2-Lite's forward with the expert-parallel MoE
        "launches_per_sharded_train_step": {
            "forward": dist_run["step"]["launches"]["flash_attention_fused"],
            "backward": dist_run["step"]["launches"]["flash_attention_bwd"]},
        "launches_per_deepseek_shard_map_forward":
            dist_run["deepseek"]["launches"]["flash_attention_fused"],
        # DeepSeek-V2-Lite's train step at 4 layers: MLA's forward with lse
        "launches_per_deepseek_train_step":
            ds_train["steps"]["launches_per_step"]["flash_attention_fused"]})
    timed = train["timed"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "path": timed["route"],
        "source": "src/repro_torch/kernels/csrc/flash_bwd_wgmma.cuh",
        "built_by": [f"src/repro_torch/kernels/csrc/{name}" for name in (
            "flash_attention_bwd_wgmma.cu", "flash_attention_bwd_wgmma_f16.cu",
            "flash_attention_bwd_wgmma_wide.cu")],
        "cuda_cores_source":
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: the reference differentiates its chunked "
                    "attention with XLA (src/repro/models/attention.py:32)",
        "shape": timed["shape"],
        "launches": train["steps"]["launches"]["flash_attention_bwd"],
        "launches_per_sharded_train_step":
            dist_run["step"]["launches"]["flash_attention_bwd"],
        "routes": {k: n for k, n in train["steps"]["routes"].items()
                   if k.startswith("flash_attention_bwd/")},
        "cases": train["cases"]["cases"],
        "max_abs_err": timed["max_abs_err"], "ms": timed["ms"],
        # the profiled full-depth step's Delta, dK/dV and dQ kernels, over
        # its 40 calls
        "device_ms": train["steps"]["profiled"]["k7_backward"]
        ["ms_per_call"],
        "loop_ms": timed["loop_ms"], "plain_ms": timed["plain_ms"],
        "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
        "own_work_bound_ms": timed["own_work_bound_ms"],
        "library_ms": timed["library_ms"],
        "library_call": timed["library_call"],
        "library_loop_ms": timed.get("library_loop_ms"),
        # the CUDA-core kernel on the same bf16 inputs, in turns
        "cuda_cores_ms": timed["cuda_cores_ms"],
        "cuda_cores_loop_ms": timed["cuda_cores_loop_ms"],
        "forward_with_lse_ms": timed["fwd_ms"],
        "forward_with_lse_loop_ms": timed["fwd_loop_ms"],
        "forward_with_lse_device_ms": train["steps"]["profiled"]
        ["k7_forward"]["ms_per_call"],
        "forward_bound_ms": timed["fwd_bound_ms"],
        "forward_backward_loop_ms": timed["fwd_bwd_loop_ms"],
        "d96": {k: timed["d96"].get(k) for k in (
            "route", "shape", "max_abs_err", "ms", "loop_ms",
            "cuda_cores_ms", "cuda_cores_loop_ms", "plain_ms", "bound_ms",
            "own_work_bound_ms", "fwd_loop_ms", "fwd_bwd_loop_ms",
            "library_ms", "library_loop_ms", "library_call")},
        # MLA's qk 192 / v 128 at DeepSeek-V2-Lite's training shape, on the
        # tensor-core build with the 32-query dK/dV tile
        "mla": {k: timed["mla"].get(k) for k in (
            "route", "shape", "max_abs_err", "ms", "loop_ms",
            "cuda_cores_max_abs_err", "cuda_cores_ms", "cuda_cores_loop_ms",
            "plain_ms", "bound_ms", "bound_by", "own_work_bound_ms",
            "tflops", "fwd_ms", "fwd_loop_ms", "fwd_bound_ms",
            "fwd_bwd_loop_ms", "library_ms", "library_loop_ms",
            "library_call", "sdpa_backend")},
        # DeepSeek-V2-Lite's train step at 4 layers: one backward a layer,
        # on the route of MLA's build
        "deepseek_train_routes": {
            k: n for k, n in ds_train["steps"]["routes"].items()
            if k.startswith("flash_attention_bwd/")},
        "launches_per_deepseek_train_step":
            ds_train["steps"]["launches_per_step"]["flash_attention_bwd"],
        "deepseek_train_device_ms": ds_train["steps"]["profiled"]
        ["k7_backward"]["ms_per_call"],
        "ptxas": timed["ptxas"]})
    add_new_routes(kernels, {**refused, **new_routes}, prefill_p)
    emit({"script_s": time.perf_counter() - t_script}, log)
    emit({"kernels": kernels}, log)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(
            {"nvidia_smi": smi, "records": log}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
