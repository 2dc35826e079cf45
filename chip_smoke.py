#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (smmb_tpu_torch) on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which exits non-zero on failure:

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the path from the sources in the checkout,
   and count the HMMA, IMMA and HGMMA instructions in B1's SASS
   (``cuobjdump``): its bf16 and W2A8 modes run on ``mma.sync`` and its
   wide bf16 body on ``wgmma``, so all three must be there, the wide
   body's registers and spills (none) and any wgmma serialisation ptxas
   reports logged; and
   the HMMA in ``flash_attention.cu``'s SASS (B9's and B9p's bf16 body;
   as many as the first port's, ``B9_PARENT_HMMA``: the CUDA-core body has
   none) and in ``bcsr_spmm.cu``'s (B2's mma body), with the registers and
   spills ``ptxas -v`` gives their mma kernels, each CUDA-core flash
   instance (none may spill), each ``bcsr_spmm_mma`` instance,
   each instance of B1's f32 body ``packed_spmm_float``,
   ``flash_decode.cu``'s kernels (B4 and B8), B5's and B6's
   ``mlp_items_kernel`` and B3's and B7's ``qkv_items_kernel``;
3. each kernel against its plain PyTorch version on the card, in every
   mode, at the test shapes and the headline shapes, with and without bias
   and PReLU, and the launch counter rising once per call; B1's row
   identity: in bf16 and int8, rows of M = 2, 5, 16, 17, 64 and 256 calls
   bitwise the M = 1 calls, at 1024×8192 and 4096×4096, and the wide bf16
   body at two shapes ``tile_for`` routes to it (4097×2560×6912,
   8192×6912×2560): against plain, counted in ``launches_wide``, bitwise
   the 64×128 tile, its rows bitwise the M = 1 calls; C1's reading: B1's
   f32 headline call and the library's f32 product against f64 beside C1's
   limits (B1's RMS error at most 1.25× the library's, its largest at most
   2×), logged (C1 is a measured precision gap, ROADMAP queue B);
4. the main path at full width: the packed ternary MLP of
   ``python -m smmb_tpu_torch mlp`` (depth 4, dim 4096, batch 256, density
   1/10, bf16) with exactly one kernel launch per layer, and the MLP of
   ``__graft_entry__.entry()`` ((1024, 2048, 2048, 1024), batch 64, f32),
   each against the plain path;
5. times through ``bench/measure.py`` (CUDA events): per mode at the
   headline shape the kernel, its bound (f32 under ``"f32_ternary"``, f32 X
   times a ternary W), the plain version and one PyTorch
   library call on the same inputs, beside the recorded times of B1's
   earlier CUDA-core kernel; B1 at
   M = 1 on the headline's W and at the LM head's 1×1024×8192, each beside
   ``torch.matmul`` on the dense bf16 W, per call and on the device (the
   profiler); B1's device time in bf16 and
   int8 under each of its four tiles at the paths' shapes, every tile's
   output bitwise equal; B1 in bf16 at the LM prefill's projections and
   head at M = 16,384 (``B1_WIDE_SHAPES``) on the wide body and on the
   64×128 tile, bitwise equal, beside the bound and ``torch.matmul`` bf16
   on the dense W; B1's f32 body under each of its four tiles at
   those shapes, ``entry()``'s three layers, 32×1024×1024 and two ragged
   K, every tile's output bitwise ``packed_spmm_f32_chain``, device µs by
   tile beside ``torch.matmul`` f32 (TF32 off); its K order
   (``_b1_order_rows``: the chain, and rows bitwise the M = 1 calls, gated);
   the full-width MLP forward;
6. the fused LM kernels (B3 fused_norm_qkv, B5 fused_block_tail, B6
   fused_mlp) against their plain versions in f32 and bf16 compute at the
   shapes of the LM path (and B3 at a GQA width, N = 1536, and at M = 5),
   B5 at M = 9 (512/1536) and B5 and B6 at d = 2048, H = 8192 (more items
   than the card holds blocks), each call raising its launch count by one,
   with B5's and B6's grid and item count and B3's blocks;
7. row identity: row 0 of an M = 8 call equals the M = 1 call bitwise
   (B3, B5, B6), every row of B3 and B7 at M = 5, rows 0, 5, 31 of B6 at
   M = 32 and row 8 of B5 at M = 9; B5 and B6 (one cooperative launch
   each) bitwise equal at the occupancy grid and at forced grids of 1, 7
   and 33 blocks, a grid larger than the card holds refused; one kernel
   event a call in the profiler for B3, B7, B5 and B6; and logged probes
   of a B5, a B3 and a B7 call captured in a CUDA graph and replayed, each
   replay bitwise the eager call;
8. the LM main path: ``generate`` at the default configuration of
   ``python -m smmb_tpu_torch lm`` (4 layers, d_model 1024, 8 heads, d_ff
   4096, vocab 8192, batch 1, 32-token prompt, 64 greedy steps, bf16) with
   the launch counts of every kernel, its per-step logits (bf16 and f32)
   held against the plain path (the kernels' plain versions in their place)
   teacher-forced on its tokens, and µs/token from ``bench/lm_bench.py``;
9. times of B3, B5 and B6 at the path's shapes: kernel, plain version,
   bound, and ``torch.matmul`` on the pre-decoded dense bf16 weights; each
   kernel's device time alone and ``torch.matmul``'s (the profiler), beside
   the earlier kernels' recorded ``FUSED_PARENT_US``;
10. B4 (flash decode / chunk) against its plain version in f32 and bf16 at
    the LM path's shapes, the decode bench's, GQA, a window and B = 4, and
    at pos 8191 of S = 8192 (alone, under GQA 8/2 with a window of 1000
    whose edge lies inside a span, at B = 4, and at pos 7938, where the
    chunk straddles a span boundary), each call raising its launch count by
    one, with the blocks of each launch (at least 128 at pos 8191 alone); chunk
    row c equals the decode step at pos + c and row r of a B = 4 call the
    row served alone, bitwise;
11. B9 (flash prefill) against its plain version in f32 and bf16: the LM
    prefill, T = 512 causal, T = 200, GQA, a window, non-causal, hd = 64,
    256 and 512, with the body ``kernel_route`` picks at each (bf16 at hd
    64 and 128 on the tensor cores, the rest on CUDA cores);
12. the flash LM path: ``generate(use_flash=True)`` at the ``lm`` defaults
    with every kernel's launch count, its teacher-forced logits against the
    plain path, ``lm_prefill_chunked`` against ``lm_prefill``,
    ``block_extend`` (C = 4) bitwise per row against four decode steps,
    µs/token and the decode bench with and without flash, and the
    ``bench/trace.py --lm`` step with and without flash (B4's device time
    in it, and B5's and B3's device time and launches);
13. times of B4 and B9 at the path shapes and at one long shape each, B9
    in f32 (the CUDA-core body) at T = 32, 512 and 4096 causal and in bf16
    (the mma body) at T = 4096 causal and not (each B9 row past T = 32
    held against its plain version): kernel, plain version, bound, and
    ``scaled_dot_product_attention`` (f32 with TF32 off), beside the
    recorded times of B9's earlier CUDA-core bodies (``B9_CUDA_CORE_MS``,
    ``B9_PARENT_US``) and of B4's unsplit kernel at pos 8191; each row's
    and SDPA's device time alone (the profiler), B4's blocks;
14. B2 (BCSR block SpMM) against its plain version in f32 and bf16, with
    the route ``bcsr_route`` picks logged at each shape (the mma body for
    r % 64 == 0, the CUDA-core body for the 4- and 8-row blocks): the
    tests' 8×128 blocks (both ``x_resident`` values bitwise equal), 128×128
    blocks at M = 100, M = 140 with ``block_m`` = 64, 64×128 and 256×128
    blocks, the empty matrix (no launch, the activated bias), the
    showcase's largest case, the block-sparse shape and the showcase's M = 1,
    each call with blocks raising its launch count by one; at the two M = 256
    shapes rows of M = 2 ... 256 and every tile bitwise the M = 1 calls (f32
    and bf16), and f32 within absolute ``TOL_DENSE`` of ``ops.dense.gemm``;
15. the reference-benchmark path: ``run_showcase()`` over all five
    showcase cases (every row valid and timed, ``bcsr_kernel`` in each),
    one ``run_sweep`` slice (one case per density) and the capacity case
    64000×16384×4096 at 1/2 density through B1's stream, with the CSV rows
    as JSON lines (each ``bcsr_kernel`` row's ``max_err`` logged) and the
    peak device memory;
16. times of B2 at the showcase's largest case, the block-sparse shape and
    the showcase's M = 64 and M = 1, f32 and bf16: kernel, plain version,
    bound (f32 under ``"f32_ternary"``, the CUDA cores' f32 bound beside it),
    and ``torch.matmul`` on the dense W, per call and on the device alone
    (the profiler), beside the CUDA-core body's recorded ``BCSR_PARENT_MS``;
    and B2's device time under every tile of its mma body, each tile's
    output bitwise the wrapper's;
17. the int8 cache's kernels against their plain versions in f32 and bf16:
    B7 (norm + QKV with the int8 K/V epilogue) at the LM shape, at GQA
    (N = 1536), at hd 256 and 512 (a span's cluster of 8 blocks, one and two
    items a block) and at M = 5 and 8, its q bitwise
    B3's, its codes and scales bitwise the plain quantize of B3's f32 output
    (within 1 code of a bf16 output's), row 0 of M = 8 bitwise M = 1; B8
    (flash decode / chunk over the int8 cache) at the path shape, GQA, a
    window and B = 4, chunk rows (C = 4) bitwise the decode rows and batch
    rows the rows served alone, and within 2e-2 of B4 on the dequantized
    cache, also at phase 10's four shapes of S = 8192; each call raising its
    launch count by one;
18. the int8 LM path at the ``lm`` defaults: ``generate(kv_quant=True,
    use_flash=True)`` and ``generate(kv_quant=True)`` with every kernel's
    launch count, their teacher-forced logits against the same routing with
    plain versions, ``lm_prefill_chunked`` (B7, B8's chunk entry) against
    the plain routing, ``block_extend`` (C = 4) bitwise per row against
    four decode steps, µs/token of ``lm --kv-quant`` with and without
    ``--flash``, and the traced int8 decode step (B8's device time in it,
    and B5's and B7's device time and launches);
19. times of B7 and B8 at the path shapes and B8 at pos 8191: kernel, plain
    version, bound, ``torch.matmul`` on the dense Wqkv (B7, with both
    device times alone by the profiler) and
    ``scaled_dot_product_attention`` on the dequantized bf16 cache (B8); B8's
    blocks and device time alone and SDPA's, beside the unsplit kernel's
    recorded time at pos 8191;
20. B9p (``flash_attention(pipeline_p=True)``) against its plain version in
    f32 and bf16 at phase 11's causal shapes, with the body each takes,
    bitwise the serial kernel where both take the same body and tile,
    counted apart from B9, the non-causal call refused; and the LM prefill with B9p in B9's place, counted,
    bitwise the serial prefill's logits;
21. the serving controls at the ``lm`` defaults with the spec bench's draft:
    ``generate_speculative(use_flash=True)`` in bf16 (k = 4, 64 steps) with
    the random draft and with self-draft, counted, token for token
    ``generate(use_flash=True)``; batched speculative decoding (B = 4, f32)
    and a ragged ``generate`` (prompts of 5, 12 and 9 tokens, f32), each row
    token for token its own batch-1 ``generate`` up to a near tie;
    ``generate_beam`` (beam 1 is greedy, beam 4 sorted and distinct, its
    best beside beam 1's);
    ``fork_cache`` to 4 rows and a decode step against the plain routing;
22. times of B9p against the serial kernel, its plain version, its bound and
    ``scaled_dot_product_attention`` at the LM prefill, at T = 512 and 4096
    f32 and at T = 4096 bf16, each with the device times of both kernels
    and of SDPA (beside the earlier CUDA-core bodies' recorded times), and
    the three rows of ``python -m smmb_tpu_torch spec``;
23. the training surface at BASELINE config 5's widths (depth 4, dim 4096,
    batch 256, ~10% nnz): ``make_packed_linear`` (B1 forward on W, backward
    on the packed Wᵀ) in f32 and bf16, its y, dx and db of one backward
    held against autograd through the plain version, then Adam steps on
    the biases of the frozen 4-layer backbone, B1's launches counted per
    step, the loss falling; five ``make_train_step`` steps of the MLP's f32
    masters (one QAT product within 1e-5 of its f64 value, which TF32 would
    miss), the loss falling, and the trained masters
    served (``pack_mlp(quantize=True)``, B1 in f32) within
    max(1e-4, 2e-6·max|y|) of ``qat_forward``;
24. LM QAT at the ``lm`` CLI's widths (4 layers, d_model 1024, 8 heads,
    d_ff 4096, vocab 8192) on a batch of 8×256 tokens with
    ``accum_steps=2`` and ``attn_chunk=64``: three steps, the loss falling,
    the first step's loss within rtol 1e-5 of the ``accum_steps=1`` step's,
    one QAT product held against f64 as in 23;
    the trained masters packed and served by ``lm_forward`` on the kernels:
    every B1 call within 1e-4 of its plain version on its own input, each
    block and the head on the kernels within 2e-4 + 1.1e-4·max|·| of the
    same stage on the plain products at every position (both fed the plain
    path's input), and end to end the median position within that rule of
    ``qat_lm_forward`` (the kernel and the plain serving paths) and of each
    other (the worst positions logged: the random model is chaotic at
    near-tied positions, ROADMAP §C); a 16-step
    ``generate`` on them with phase 8's launch counts; then five
    ``make_draft_distill_step`` steps at the ``spec`` CLI's target and
    draft (the target's logits through B1, counted), the loss falling, the
    argmax agreement logged before and after. Each training step's time and
    peak device memory are logged beside the card's name and power limit.
    C1's reading on each of the served forward's 25 B1 calls (as in phase
    3, logged), and a second, well-conditioned LM (LeCun-scale masters, seed 26,
    trained as the first): its served f32 logits on the kernels within the
    rule 2e-4 + 1.1e-4·max|logit| of ``qat_lm_forward`` and of the plain
    serving path at every one of the 2×256 positions, its B1 calls read too;
25. the MoE LM at the ``lm`` widths with 8 experts, top-2: ``generate``
    (bf16, 32-token prompt, 64 steps) with and without flash, B1 launched
    2·E times a layer a call besides the projections and the head, B3, B5,
    B6 and B7 never, B4 and B9 only under flash; the teacher-forced f32
    logits: every B1 call within 1e-4 of its plain version on its own
    input, each block and the head on the kernels within its stage's rule
    of the plain products at every position (both fed the plain path's
    input), a position exempt only where its token was routed to other
    experts at a near tie of the plain gates (rank k against k+1 within
    1e-4 of the largest; counted), a route that differs at a wider gap
    failing; µs/token of ``lm --experts 8 --top-k 2``; three QAT steps at
    phase 24's batch, taken again by the port on CPU tensors: on unit-scale
    masters the first loss within 1e-3 of the CPU's (the later ones
    logged), on LeCun-scale ones the first step's loss and gradients within
    3e-5 of the CPU's (of max|g| for gradients) and the loss falling; the
    aux positive and ``aux_weight`` moving the loss;
26. LoRA on phase 8's LM, rank 8 on wq, wv, w_up and w_down: one
    ``make_lora_train_step`` step (the base's packed bytes unchanged),
    ``generate`` on the adapted model on B1 alone (B3, B5 and B6 never),
    and its served f32 logits held call by call and stage by stage;
27. the runtime: the native library (``runtime/native.py``) built, the
    headline W of phase 3's C1 reading packed, and its TCSC and 128×128
    BCSR built, natively, each byte-identical to the port's formats, B1 on
    the planes and B2 on the BCSR against their plain versions in f32 and
    bf16; a corpus of 2**26 tokens from the seed read back by
    ``TokenDataset`` (windows a second at seq 256, batch 8) and three LM
    QAT steps at the ``lm`` widths on its batches (phase 24's accumulation
    and ``attn_chunk``; finite losses, ms a step, peak memory); and
    ``bench/measure.py::measure_device`` (CUDA-graph replay) on the LM
    head's B1 call and on B3 at M = 1, each within [GRAPH_LO×, GRAPH_HI× +
    GRAPH_ADD_US] of the profiler's device time of the same call, beside
    ``measure``'s host-bound time;
28. the parallel layer (``smmb_tpu_torch.parallel``). NCCL refuses two
    ranks on one device, so a 2-rank gloo world on the one card
    (``run_world``; every collective staged through host memory by
    ``parallel/mesh.py``, counted and printed): at the headline in f32,
    bf16 and W2A8, column shards gathered bitwise the unsharded B1 call,
    row and ring-overlap shards against the same calls on the plain bodies
    (f32 1e-4, bf16 2^-7, int8 1e-6 of max(1, max|Y|)), 4 B1 launches a
    rank; ``sharded_bcsr_spmm`` at 256×1024×4096 against its plain bodies,
    one B2 launch a rank; ``mlp_forward_sharded`` at config 5 and
    ``block_forward_tp`` at 4096-d (with and without flash) within
    max(1e-4, 2e-5·max|ref|) of the single-rank calls; ``generate_tp`` at
    the ``lm`` widths on model = 2, plain, flash and int8 + flash, its
    launches a rank (B1 1113, B9 4, B4 or B8 256) and its teacher-forced
    logits within the LM rule of the single-rank path at every position on
    a LeCun-scale LM in f32 (bf16 and the unit-scale LM logged), with
    µs/token beside ``generate``'s and where a call's time goes; a 2-stage
    ``lm_forward_pp`` within the LM rule of ``lm_forward``; three DP steps
    against one rank on the whole batch (the first loss within 1e-5); a
    1-rank NCCL world (column bitwise, row 1e-4, a TP block, none staged);
    the latency of one small all_reduce, staged from the card and of host
    tensors;
    and ``python -m smmb_tpu_torch scaling --mesh 1x1,1x2`` (14 points,
    ``ep_moe`` among them), its 2-rank points labelled as sharing the card;
29. the parallel layer's second half, in phase 28's 2-rank gloo world:
    ``moe_forward_ep`` at scaling's ``ep_moe`` shape (8 experts of
    1024→4096→1024, 256 tokens; top-1 and top-2, f32 and bf16) bitwise the
    single-rank ``moe_forward``, 8 B1 launches and one all_reduce a rank;
    ``moe_block_forward_tp`` at the ``lm`` widths (8 experts, top-2) within
    max(1e-4, 5e-5·max|ref|) of ``moe_block_forward``; ``generate_tp`` on
    phase 25's MoE LM (LeCun-scale masters), plain, flash and int8 +
    flash: its launches a rank (B1 49 + 41 a step), every bf16 B1 call
    against its plain version, the f32 teacher-forced logits within the LM
    rule of the single-rank path at every position (router margins
    logged), µs/token beside ``generate``'s; ``lm_forward_sp`` on the
    LeCun-scale LM at T = 4096 within the LM rule of ``lm_forward``,
    ``ring_attention`` at T = 4096 within 2e-5 of the attention math, an SP
    MoE block at T = 512, the SP prefill's µs/token beside
    ``lm_forward``'s; ``lm_forward_pp`` on the MoE LM within the LM rule;
    LoRA under TP (rank 8, all six targets): ``lm_forward_tp`` and
    ``generate_tp``'s teacher-forced logits within the LM rule of the
    single-rank adapted path; the NCCL world's ``moe_forward_ep`` bitwise;
30. A5: ``bench/autotune.py::autotune_packed_spmm`` at the headline in bf16
    and int8 (each candidate tile's µs logged; the pick's output bitwise
    ``tile_for``'s, its ``measure_device`` time no more than
    ``A5_TILE_SPREAD`` over ``tile_for``'s, the median of ``A5_PAIRS``
    in-turn runs each; a second call
    answered from the cache, the timer disabled), the autotune CLI as a
    subprocess printing one JSON config, ``bench/trace.py::capture_trace``
    of a headline B1 call in ``annotate("b1")`` (the Chrome trace holds its
    kernel events and the ``b1`` ranges), and the four port-owned examples
    (``examples/torch_*.py`` but the sharded one), each ``main([])`` on the
    card returning 0 through B1, with its wall time.

31. B1g, the grouped experts, at Mellum2's routed layer (64 experts, top-8,
    2304 -> 896 -> 2304): every expert's rows bitwise B1's at 512 and 16,384
    tokens and on element loads; device µs against the per-expert B1 loop
    and a per-expert ``torch.matmul`` loop; ``moe_forward`` grouped against
    the slab path, bitwise, with both device times; a Mellum-shaped
    ``lm_prefill`` with no host synchronisation (``--moe-grouped``: this
    phase alone, after the build).

The line before the last is the card's name and power limit, the line
before that the per-kernel JSON summary, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 1 and
prints no result.

``python3 chip_smoke.py --fused-ab DIR`` instead holds B3, B7, B5, B6,
B1's f32 body and B9's and B9p's CUDA-core body of this checkout against
those of DIR, an earlier tree of the port: every output bitwise, and both
sides' device µs a call (``fused_ab``). It also
reads C1's same-token A/B of DIR's B1 f32 body against this one on the f32
paths of phases 8 and 18 over ``LM_AB_PAIRS`` (``c1_side``, ``c1_verdict``).
``python3 chip_smoke.py --c1-candidate DIR`` writes such a DIR: this
checkout's port with C1's candidate body (``C1_FOLD``, a compile-time
switch of ``packed_spmm.cu``).
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

T0 = time.time()
HERE = Path(__file__).resolve().parent
ALPHA = 0.2
# B1's times at the headline (M=256, K=N=4096, ~10% nnz) before its
# tensor-core redesign: the CUDA-core kernel, measured by this script on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md's B1 row), and its LM-head device
# time a decode step from bench/trace.py --lm (PERF.md section 5)
B1_CUDA_CORE_MS = {"f32": 0.380, "bf16": 0.3773, "int8": 0.273}
B1_CUDA_CORE_HEAD_DEVICE_MS = 0.065
# B9's and B9p's times at T=4096 bf16 causal (B=1, H=8, hd 128) before
# their tensor-core redesign: the CUDA-core body, measured by this script on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's B9 and B9p rows)
B9_CUDA_CORE_MS = {"serial": 6.506, "pipe": 8.105}
# the device µs a call of the first port's CUDA-core body (B9, and B9p under
# "B9p ...") in f32 at B=1, H=8, hd 128, causal, T = 32, 512 and 4096 (the
# shapes of phases 13 and 22) before its redesign: the median of that
# tree's four runs of ``--fused-ab`` on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md's B9 and B9p rows); logged beside this run's own device times
# the HMMA instructions in the SASS of the first port's flash_attention.cu,
# all in the mma body (scripts/torch_b9_core_probe.py on the same card)
B9_PARENT_HMMA = 384
B9_PARENT_US = {"lm prefill": 51.14, "T=512 f32": 321.59, "long f32": 6494.73,
                "B9p lm prefill": 54.89, "B9p T=512 f32": 381.88, "B9p long f32": 7870.56}
# B4's and B8's times at pos 8191 of S=8192 (B=1, H=KVH=8, hd 128, bf16)
# before the split of the cache across blocks: one block per (KV head,
# batch row), measured by this script on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md's B4 and B8 rows)
FLASH_DECODE_UNSPLIT_MS = {"B4": 0.912, "B8": 1.141}
FLASH_DECODE_DESIGN = ("cache split into S-fixed spans, grid (live spans, KVH, B); cp.async "
                       "ring in the storage type; last block combines in ascending span "
                       "order; CUDA cores")


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def _sass(lib) -> str:
    """The SASS of a built kernel library (cuobjdump beside nvcc)."""
    from pathlib import Path

    from smmb_tpu_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def _ptxas_kernels(text: str, pattern: str) -> list:
    """Registers and spills of the kernels whose mangled name matches
    ``pattern``, from ``nvcc -Xptxas -v`` output: ``[(groups, registers,
    spill stores, spill loads)]``."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = re.search(pattern, line)
        elif "spill stores" in line:
            spills = tuple(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line and name:
            out.append((name.groups(), int(re.search(r"Used (\d+) registers", line)[1]),
                        *spills))
            name = None
    return out


def _decode_types(mangled: str) -> str:
    """flash_decode_kernel's template arguments (q's type, the cache's, and
    whether the compute dtype is bf16) from their mangled form: f float, a
    int8, 13__nv_bfloat16 and its back-reference S<n>_ bf16, Lb0E/Lb1E the
    flag."""
    import re

    names = {"f": "f32", "a": "int8"}
    types, flag = mangled.split("Lb")
    q, cache = (names.get(t, "bf16") for t in re.findall(r"13__nv_bfloat16|S\d*_|f|a", types))
    return f"q {q}, cache {cache}, compute {'bf16' if flag.startswith('1') else 'f32'}"


def _kernel_us(trace: dict, name: str) -> float:
    """Device µs a call of the kernels whose name holds ``name`` in a
    bench/trace.py report."""
    return sum(r["us"] for r in trace["kernels"] if name in r["name"])


def _fused_step(trace: dict) -> dict:
    """B5's and B3's (or B7's) device µs and launches a decode step in a
    bench/trace.py report."""
    out = {}
    for key, name in (("b5", "mlp_items_kernel"), ("qkv", "qkv_items_kernel")):
        rows = [r for r in trace["kernels"] if name in r["name"]]
        out[f"trace_{key}_us"] = sum(r["us"] for r in rows)
        out[f"trace_{key}_launches"] = sum(r["launches"] for r in rows)
    return out


def _device_us(fn, n: int = 30) -> float:
    """Device µs per call of ``fn`` (every kernel it launches), by the
    profiler (bench/trace.py's kernel breakdown)."""
    from smmb_tpu_torch.bench.trace import kernel_breakdown

    return sum(r["us"] for r in kernel_breakdown(fn, n_calls=n))


def time_b1_tiles(torch, dev) -> None:
    """Phase 5: B1's device time (torch.profiler) in bf16 and int8 at the
    paths' shapes under every tile of the tensor-core kernel, through its C
    entry; every tile's output bitwise equal (one K walk for every tile).
    Logs the device µs under the tile ``tile_for`` picks."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels import _build
    from smmb_tpu_torch.kernels.packed_spmm import quantize_rows, tile_for
    from smmb_tpu_torch.utils import rng

    fn = _build.packed_spmm_lib().smmb_packed_spmm
    gen = rng.make_generator(7, dev)
    picked = {}
    for (m, k, n) in ((256, 4096, 4096), (1, 4096, 4096), (1, 1024, 8192),
                      (32, 1024, 3072), (5, 1024, 8192)):
        p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=10))
        x = rng.rand_dense(gen, (m, k))
        for mode, cdt in ((1, torch.bfloat16), (2, torch.int8)):
            xq, scale = (x.to(cdt), None) if mode == 1 else quantize_rows(x)
            outs, us = {}, {}
            for bm in (16, 64):
                for bn in (64, 128):
                    out = torch.empty((m, n), device=dev)

                    def call():
                        rc = fn(xq.data_ptr(), p.data.data_ptr(), None,
                                None if scale is None else scale.data_ptr(),
                                out.data_ptr(), m, k, n, p.data.shape[0], mode, 0,
                                bm, bn, 1, 0, 0.0, torch.cuda.current_stream().cuda_stream)
                        check(rc == 0, f"B1 launch at tile {bm}x{bn}: CUDA error {rc}")

                    call()
                    torch.cuda.synchronize()
                    outs[bm, bn] = out.clone()
                    us[bm, bn] = _device_us(call)
            first = outs[16, 64]
            check(all(torch.equal(first, o) for o in outs.values()),
                  f"B1 tiles disagree at {m}x{k}x{n} {cdt}")
            pick = tile_for(m, n, cdt)[:2]
            picked[m, k, n, cdt] = us[pick]
            print(json.dumps({"b1_device_us": [m, k, n], "mode": str(cdt).split(".")[1],
                              "tile_for": list(pick),
                              "by_tile": {f"{a}x{b}": v for (a, b), v in us.items()}}),
                  flush=True)
    log("B1 device times by tile, bitwise equal across tiles: " + ", ".join(
        f"{m}x{k}x{n} {str(c).split('.')[1]} {v:.2f} us" for (m, k, n, c), v in picked.items()))


# the LM prefill's B1 shapes at its longest request (4 prompts of 4096
# tokens; ternary-lm-2b): the fused QKV and the output projection, K and V,
# the MLP's up and down projections, and the head
B1_WIDE_SHAPES = ((16384, 2560, 2560), (16384, 2560, 640), (16384, 2560, 6912),
                  (16384, 6912, 2560), (16384, 2560, 128256))


def check_b1_wide(torch, dev, gen) -> None:
    """Phase 3: B1's wide bf16 body at shapes ``tile_for`` routes to it
    (ragged M, K of 13.5 groups): within 1e-5 of the plain version (f32 X
    and Y), counted in ``packed_spmm.launches_wide``, bitwise the same call
    on the 64x128 tile, and its rows bitwise the M = 1 calls."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import (
        WIDE_TILE,
        packed_spmm,
        packed_spmm_plain,
        tile_for,
    )
    from smmb_tpu_torch.utils import rng

    bf16 = torch.bfloat16
    for (m, k, n) in ((4097, 2560, 6912), (8192, 6912, 2560)):
        p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=2))
        b, x = rng.rand_dense(gen, (n,)), rng.rand_dense(gen, (m, k))
        check(tile_for(m, n, bf16)[:2] == WIDE_TILE, f"tile_for keeps {m}x{n} off the wide body")
        before = packed_spmm.launches_wide
        y = packed_spmm(x, p, b, ALPHA, compute_dtype=bf16)
        check(packed_spmm.launches_wide == before + 1, f"launches_wide at {m}x{k}x{n}")
        small = packed_spmm(x, p, b, ALPHA, compute_dtype=bf16, block_m=64, block_n=128)
        ref = packed_spmm_plain(x, p, b, ALPHA, compute_dtype=bf16)
        rows = (0, 1, 127, 128, m // 2, m - 1)
        ones = torch.cat([packed_spmm(x[r:r + 1], p, b, ALPHA, compute_dtype=bf16)
                          for r in rows])
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        check(err <= 1e-5 * max(1.0, float(ref.abs().max())),
              f"B1 wide body vs plain at {m}x{k}x{n}: err {err:.3e}")
        check(torch.equal(y, small), f"B1 wide body != the 64x128 tile at {m}x{k}x{n}")
        check(torch.equal(y[list(rows)], ones), f"B1 wide rows != M=1 calls at {m}x{k}x{n}")
        log(f"B1 wide body at {m}x{k}x{n}: err {err:.3e} vs plain, bitwise the 64x128 tile "
            f"and rows {rows} bitwise the M=1 calls")


def time_b1_wide(torch, dev, spec) -> list:
    """Phase 5: B1 in bf16 at the LM prefill's shapes (``B1_WIDE_SHAPES``):
    device µs (the profiler) on the tile ``tile_for`` picks (the wide body)
    and forced onto the 64x128 tile, bitwise equal, beside the bound at
    density 1/2 (``bench/roofline.py``) and ``torch.matmul`` bf16 on the
    dense W. Returns a JSON row a shape."""
    from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, tile_for
    from smmb_tpu_torch.utils import rng

    gen = rng.make_generator(27, dev)
    rows = []
    for (m, k, n) in B1_WIDE_SHAPES:
        w = rng.rand_ternary(gen, (k, n), non_zero=2)
        nnz = int(torch.count_nonzero(w))
        p = pack_ternary_device(w, nnz=nnz)
        wd = unpack_ternary(p).to(torch.bfloat16)
        del w
        x = rng.rand_dense(gen, (m, k), dtype=torch.bfloat16)
        pick = tile_for(m, n, torch.bfloat16)[:2]
        y = packed_spmm(x, p, compute_dtype=torch.bfloat16)
        y64 = packed_spmm(x, p, compute_dtype=torch.bfloat16, block_m=64, block_n=128)
        torch.cuda.synchronize()
        check(torch.equal(y, y64), f"B1 wide body != the 64x128 tile at {m}x{k}x{n}")
        del y, y64
        n_calls = 5 if n > 100000 else 20
        us = _device_us(lambda: packed_spmm(x, p, compute_dtype=torch.bfloat16), n_calls)
        us64 = _device_us(lambda: packed_spmm(x, p, compute_dtype=torch.bfloat16, block_m=64,
                                              block_n=128), n_calls)
        lib = _device_us(lambda: torch.matmul(x, wd), n_calls)
        bound_s, bound_by = roofline_bound(
            sparse_flops(m, n, nnz), spmm_bytes(m, n, k, weight_bytes=p.weight_bytes(),
                                                x_itemsize=2, y_itemsize=2, bias=False),
            spec, "bf16")
        dense_s, _ = roofline_bound(2.0 * m * n * k, 0, spec, "bf16")
        row = {"b1_wide_device_us": [m, k, n], "tile_for": list(pick), "us": us,
               "us_64x128": us64, "speedup": us64 / us, "matmul_bf16_us": lib,
               "bound_us": bound_s * 1e6, "bound_by": bound_by,
               "roofline_share": bound_s * 1e6 / us, "dense_bound_us": dense_s * 1e6,
               "bitwise_64x128": True}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del wd, x
    log("B1 bf16 at the prefill's shapes, device us tile_for's / 64x128 / torch.matmul: "
        + ", ".join(f"{'x'.join(map(str, r['b1_wide_device_us']))} {r['us']:.1f} / "
                    f"{r['us_64x128']:.1f} / {r['matmul_bf16_us']:.1f}" for r in rows))
    return rows


# B1's f32 body timed under each tile (phase 5): time_b1_tiles's shapes,
# entry()'s three layers, the LM prefill's projections and two ragged K
B1_F32_SHAPES = ((256, 4096, 4096), (1, 4096, 4096), (1, 1024, 8192), (32, 1024, 3072),
                 (5, 1024, 8192), (64, 1024, 2048), (64, 2048, 2048), (64, 2048, 1024),
                 (32, 1024, 1024), (5, 100, 256), (17, 1000, 300))


def time_b1_f32(torch, dev) -> list:
    """Phase 5: B1's f32 body under every tile of ``F32_TILES`` through its
    C entry at ``B1_F32_SHAPES``, every tile's output bitwise
    ``packed_spmm_f32_chain`` (so every other tile's), and each tile's
    device µs beside ``torch.matmul`` f32 (TF32 off) on the dense W, all in
    one profiler session a shape. Returns a JSON row a shape."""
    import re

    from smmb_tpu_torch.bench.trace import kernel_breakdown
    from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary
    from smmb_tpu_torch.kernels import _build
    from smmb_tpu_torch.kernels.packed_spmm import (
        F32_TILES,
        packed_spmm_f32_chain,
        pieces_aligned,
        tile_for,
    )
    from smmb_tpu_torch.utils import rng

    check(not torch.backends.cuda.matmul.allow_tf32, "phase 5 times torch.matmul f32 with TF32 on")
    fn = _build.packed_spmm_lib().smmb_packed_spmm
    gen = rng.make_generator(8, dev)
    rows = []
    for (m, k, n) in B1_F32_SHAPES:
        p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=10 if k == 4096 else 2))
        x, b = rng.rand_dense(gen, (m, k)), rng.rand_dense(gen, (n,))
        aligned = pieces_aligned(k, n, x.data_ptr(), p.data.data_ptr(), torch.float32)
        outs = {t: torch.empty((m, n), device=dev) for t in F32_TILES}

        def call(tile):
            rc = fn(x.data_ptr(), p.data.data_ptr(), b.data_ptr(), None, outs[tile].data_ptr(),
                    m, k, n, p.data.shape[0], 0, 0, *tile, int(aligned), 1, ALPHA,
                    torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"B1 f32 launch at tile {tile}: CUDA error {rc}")

        for tile in F32_TILES:
            call(tile)
        chain = packed_spmm_f32_chain(x, p, b, ALPHA)
        torch.cuda.synchronize()
        check(all(torch.equal(o, chain) for o in outs.values()),
              f"B1 f32 tiles differ from packed_spmm_f32_chain at {m}x{k}x{n}")
        wd = unpack_ternary(p)

        def every():
            for tile in F32_TILES:
                call(tile)
            torch.matmul(x, wd)

        us = {}
        for r in kernel_breakdown(every, n_calls=30):
            hit = re.search(r"packed_spmm_float<(\d+), (\d+)", r["name"])
            key = f"{hit[1]}x{hit[2]}" if hit else "matmul_f32"
            us[key] = us.get(key, 0.0) + r["us"]
        pick = tile_for(m, n, torch.float32)[:2]
        row = {"b1_f32_device_us": [m, k, n], "aligned": aligned, "tile_for": list(pick),
               "tile_for_us": us[f"{pick[0]}x{pick[1]}"], "matmul_f32_us": us["matmul_f32"],
               "by_tile": {f"{a}x{c}": us[f"{a}x{c}"] for a, c in F32_TILES},
               "tiles_bitwise_chain": True}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port runs on the card")
    from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.mlp_bench import build_mlp, run_mlp_bench
    from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
    from smmb_tpu_torch.formats.packed import pack_ternary_device, unpack_ternary
    from smmb_tpu_torch.kernels import _build
    from smmb_tpu_torch.kernels.packed_spmm import (
        packed_spmm,
        packed_spmm_plain,
        quantize_rows,
        tile_for,
    )
    from smmb_tpu_torch.models.mlp import (
        TernaryMLPConfig,
        init_mlp,
        mlp_forward,
        pack_mlp,
    )
    from smmb_tpu_torch.utils import rng

    # ---------------------------------------------------------------- 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    spec = chip_spec()
    log(f"roofline spec: {spec}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 2
    t = time.time()
    build_logs = _build.build_all()
    log(f"built {sorted(build_logs) or 'nothing (up to date)'} "
        f"in {time.time() - t:.1f}s")
    for src, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "Function properties" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")
    # B1's bf16 and W2A8 modes run on the tensor cores: the built library's
    # SASS holds HMMA (bf16 mma.sync) and IMMA (int8 mma.sync) instructions
    if "packed_spmm.cu" in build_logs:
        for (bm, bn, aligned, ot), regs, stores, loads in _ptxas_kernels(
                build_logs["packed_spmm.cu"],
                r"packed_spmm_floatILi(\d+)ELi(\d+)ELb([01])E(f|13__nv_bfloat16)E"):
            log(f"B1 packed_spmm_float<{bm}x{bn}, "
                f"{'16-byte pieces' if aligned == '1' else 'element loads'}, "
                f"{'f32' if ot == 'f' else 'bf16'} out>: {regs} registers, {stores} bytes "
                f"spill stores, {loads} bytes spill loads")
    else:
        log("packed_spmm.cu was up to date: no ptxas report this run")
    if "packed_spmm.cu" in build_logs:
        for (ot,), regs, stores, loads in _ptxas_kernels(
                build_logs["packed_spmm.cu"], r"packed_spmm_mma_wgI(f|13__nv_bfloat16)E"):
            log(f"B1 packed_spmm_mma_wg<{'f32' if ot == 'f' else 'bf16'} out>: {regs} "
                f"registers, {stores} bytes spill stores, {loads} bytes spill loads")
            check(stores + loads == 0, "B1's wide bf16 body spills")
        serial = [line.strip() for line in build_logs["packed_spmm.cu"].splitlines()
                  if "C7512" in line or "serialized" in line]
        log(f"B1 wgmma serialization warnings: {serial or 'none'}")
    sass = _sass(_build.library_path("packed_spmm.cu"))
    hmma, imma, hgmma = sass.count("HMMA"), sass.count("IMMA"), sass.count("HGMMA")
    log(f"packed_spmm.cu SASS: {hmma} HMMA, {imma} IMMA, {hgmma} HGMMA")
    check(hmma > 0, "B1's bf16 mode has no HMMA in its SASS")
    check(imma > 0, "B1's W2A8 mode has no IMMA in its SASS")
    # its wide bf16 body runs on the warpgroup MMA: HGMMA (wgmma)
    check(hgmma > 0, "B1's wide bf16 body has no HGMMA in its SASS")
    # B9's and B9p's bf16 body runs on mma.sync: HMMA in flash_attention.cu
    fa_hmma = _sass(_build.library_path("flash_attention.cu")).count("HMMA")
    log(f"flash_attention.cu SASS: {fa_hmma} HMMA (the first port's CUDA-core body beside "
        f"the mma body: {B9_PARENT_HMMA})")
    check(fa_hmma > 0, "B9's bf16 body has no HMMA in its SASS")
    check(fa_hmma == B9_PARENT_HMMA, "the CUDA-core flash body uses the tensor cores")
    # B2's mma body (128x128 blocks, f32 in three bf16 passes) runs on mma.sync
    b2_hmma = _sass(_build.library_path("bcsr_spmm.cu")).count("HMMA")
    log(f"bcsr_spmm.cu SASS: {b2_hmma} HMMA")
    check(b2_hmma > 0, "B2's mma body has no HMMA in its SASS")
    if "bcsr_spmm.cu" in build_logs:
        for (bm, bn, f32), regs, stores, loads in _ptxas_kernels(
                build_logs["bcsr_spmm.cu"], r"bcsr_spmm_mmaILi(\d+)ELi(\d+)ELb([01])E"):
            log(f"B2 bcsr_spmm_mma<{bm}x{bn}, {'f32 split' if f32 == '1' else 'bf16'}>: "
                f"{regs} registers, {stores} bytes spill stores, {loads} bytes spill loads")
    else:
        log("bcsr_spmm.cu was up to date: no ptxas report this run")
    if "flash_attention.cu" in build_logs:
        for (hd, pipe), regs, stores, loads in _ptxas_kernels(
                build_logs["flash_attention.cu"], r"flash_prefill_mma_kernelILi(\d+)ELb([01])E"):
            log(f"B9{'p' if pipe == '1' else ''} mma body hd {hd}: {regs} registers, "
                f"{stores} bytes spill stores, {loads} bytes spill loads")
        core = _ptxas_kernels(build_logs["flash_attention.cu"],
                              r"flash_prefill_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)"
                              r"ELb([01])E")
        log(f"B9/B9p CUDA-core body, {len(core)} instantiations (dtype, kv tile, rows a "
            "thread, d vectors a thread, pipelined: registers, spill bytes): " + "; ".join(
                f"{'f32' if t == 'f' else 'bf16'} {bt} {sr} {dv} {p}: {regs}, {st + ld}"
                for (t, bt, sr, dv, p), regs, st, ld in core))
        check(all(st + ld == 0 for *_, st, ld in core), "the CUDA-core flash body spills")
    else:
        log("flash_attention.cu was up to date: no ptxas report this run")
    if "fused_mlp.cu" in build_logs:
        for (mt, tail), regs, stores, loads in _ptxas_kernels(
                build_logs["fused_mlp.cu"], r"mlp_items_kernelILi(\d+)ELb([01])E"):
            log(f"{'B5' if tail == '1' else 'B6'} mlp_items_kernel<{mt} rows>: {regs} "
                f"registers, {stores} bytes spill stores, {loads} bytes spill loads")
        for (mt, quant), regs, stores, loads in _ptxas_kernels(
                build_logs["fused_mlp.cu"], r"qkv_items_kernelILi(\d+)ELb([01])E"):
            log(f"{'B7' if quant == '1' else 'B3'} qkv_items_kernel<{mt} rows>: {regs} "
                f"registers, {stores} bytes spill stores, {loads} bytes spill loads")
    else:
        log("fused_mlp.cu was up to date: no ptxas report this run")
    if "flash_decode.cu" in build_logs:
        for (args,), regs, stores, loads in _ptxas_kernels(
                build_logs["flash_decode.cu"], r"flash_decode_kernelI(\w+?)EEv"):
            log(f"B4/B8 flash_decode_kernel<{_decode_types(args)}>: {regs} registers, "
                f"{stores} bytes spill stores, {loads} bytes spill loads")
    else:
        log("flash_decode.cu was up to date: no ptxas report this run")

    # ---------------------------------------------------------------- 3
    # tolerances, each relative to max(1, max|Y|):
    #  f32  1e-4: f32 sums in another order than the cuBLAS f32 product;
    #  bf16 2**-7: X and Y in bf16; the f32 sums agree to ~1e-6, so
    #       rounding Y to bf16 differs by at most one bf16 ulp (2**-7 rel);
    #  int8 1e-6: same int8 codes and exact integer sums on both sides and
    #       the same separately rounded dequant and bias (f32 output).
    modes = {  # name: (compute dtype, x dtype, tolerance)
        "f32": (torch.float32, torch.float32, 1e-4),
        "bf16": (torch.bfloat16, torch.bfloat16, 2.0 ** -7),
        "int8": (torch.int8, torch.float32, 1e-6),
    }
    # the test shapes, the headline shapes and the entry() MLP's layers
    shapes = [(1, 512, 1024), (16, 512, 512), (8, 1024, 640), (100, 512, 512),
              (4, 100, 256), (8, 2048, 256), (1, 4096, 4096), (256, 4096, 4096),
              (64, 1024, 2048), (64, 2048, 2048), (64, 2048, 1024)]
    gen = rng.make_generator(1234, dev)
    n_checked = 0
    for (m, k, n) in shapes:
        non_zero = 10 if k == 4096 else 2
        w = rng.rand_ternary(gen, (k, n), non_zero=non_zero)
        p = pack_ternary_device(w)
        check(torch.equal(unpack_ternary(p), w), f"pack round trip {k}x{n}")
        b = rng.rand_dense(gen, (n,))
        for name, (cdt, xdt, tol) in modes.items():
            x = rng.rand_dense(gen, (m, k), dtype=xdt)
            for bias, alpha in ((b, ALPHA), (None, None)):
                before = packed_spmm.launches
                y = packed_spmm(x, p, bias, alpha, compute_dtype=cdt)
                check(packed_spmm.launches == before + 1,
                      f"launch count {name} {m}x{k}x{n}")
                ref = packed_spmm_plain(x, p, bias, alpha, compute_dtype=cdt)
                torch.cuda.synchronize()
                check(y.shape == (m, n) and y.dtype == xdt, f"shape/dtype {name}")
                check(bool(torch.isfinite(y).all()), f"non-finite {name} {m}x{k}x{n}")
                err = float((y.float() - ref.float()).abs().max())
                lim = tol * max(1.0, float(ref.float().abs().max()))
                check(err <= lim, f"kernel vs plain {name} {m}x{k}x{n} "
                      f"bias={bias is not None}: err {err:.3e} > {lim:.3e}")
                n_checked += 1
        log(f"kernel == plain at {m}x{k}x{n} in f32, bf16, int8")
    # one K walk for every M: row r of an M-row call is bitwise the M=1 call
    # of row r in the tensor-core modes, whatever tile the wrapper picks
    for (k, n) in ((1024, 8192), (4096, 4096)):
        p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=10))
        b = rng.rand_dense(gen, (n,))
        xr = rng.rand_dense(gen, (256, k))
        for cdt in (torch.bfloat16, torch.int8):
            ones = torch.cat([packed_spmm(xr[r:r + 1], p, b, ALPHA, compute_dtype=cdt)
                              for r in range(256)])
            for m in (2, 5, 16, 17, 64, 256):
                y = packed_spmm(xr[:m], p, b, ALPHA, compute_dtype=cdt)
                check(torch.equal(y, ones[:m]), f"B1 rows of M={m} != M=1 calls "
                      f"{cdt} {k}x{n} (tile {tile_for(m, n, cdt)})")
        log(f"B1 rows of M in (2, 5, 16, 17, 64, 256) == M=1 calls at {k}x{n}, "
            "bf16 and int8")
    check_b1_wide(torch, dev, gen)
    x3 = rng.rand_dense(gen, (3, 4, 512))
    p3 = pack_ternary_device(rng.rand_ternary(gen, (512, 256)))
    y3 = packed_spmm(x3, p3, None, ALPHA)
    ref3 = packed_spmm_plain(x3.reshape(12, 512), p3, None, ALPHA).reshape(3, 4, 256)
    check(y3.shape == (3, 4, 256), "3-D x keeps its leading dims")
    check(float((y3 - ref3).abs().max()) <= 1e-4 * max(1.0, float(ref3.abs().max())),
          "3-D x kernel vs plain")
    c1 = _read_c1([read_b1_f32_headline(torch, dev)], "B1 f32 at the headline")
    log(f"phase 3 passed: {n_checked + 1} kernel calls checked against plain; C1 {c1}")

    # ---------------------------------------------------------------- 4
    cfg, packed, x, _ = build_mlp(4, 4096, 256, 10, dev)
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    y = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    main_launches = packed_spmm.launches
    check(main_launches == cfg.num_layers,
          f"main path launched packed_spmm {main_launches} times, "
          f"expected {cfg.num_layers}")
    y_ref = mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16, use_kernel=False)
    torch.cuda.synchronize()
    check(y.shape == (256, 4096) and bool(torch.isfinite(y).all()),
          "full-width MLP output shape / finiteness")
    # each layer re-rounds its input to bf16; sums that differ in order by
    # ~1e-6 can flip that rounding by one bf16 ulp (2**-8 relative)
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    check(err <= 1e-2 * scale, f"full-width MLP kernel vs plain: {err:.3e} "
          f"vs max|Y| {scale:.3e}")
    log(f"main path (depth 4 x 4096, batch 256, bf16): launches {main_launches}, "
        f"max err {err:.3e} of max|Y| {scale:.3e}")

    ecfg = TernaryMLPConfig(layer_dims=(1024, 2048, 2048, 1024))
    egen = rng.make_generator(1, dev)
    epacked = pack_mlp(init_mlp(egen, ecfg))
    ex = rng.rand_dense(egen, (64, 1024))
    torch.cuda.synchronize()
    packed_spmm.launches = 0
    ey = mlp_forward(epacked, ex, ecfg)
    torch.cuda.synchronize()
    entry_launches = packed_spmm.launches
    check(entry_launches == ecfg.num_layers, f"entry MLP launches {entry_launches}")
    ey_ref = mlp_forward(epacked, ex, ecfg, use_kernel=False)
    torch.cuda.synchronize()
    eerr = float((ey - ey_ref).abs().max())
    escale = float(ey_ref.abs().max())
    check(ey.shape == (64, 1024) and bool(torch.isfinite(ey).all()), "entry MLP shape")
    check(eerr <= 1e-5 * max(1.0, escale), f"entry MLP f32 kernel vs plain: "
          f"{eerr:.3e} vs max|Y| {escale:.3e}")
    log(f"entry() MLP (1024,2048,2048,1024), batch 64, f32: launches "
        f"{entry_launches}, max err {eerr:.3e} of max|Y| {escale:.3e}")

    # ---------------------------------------------------------------- 5
    m, k, n = 256, 4096, 4096
    hgen = rng.make_generator(0, dev)
    hx = rng.rand_dense(hgen, (m, k))
    hw = rng.rand_ternary(hgen, (k, n), non_zero=10)
    hb = rng.rand_dense(hgen, (n,))
    nnz = int(torch.count_nonzero(hw))
    hp = pack_ternary_device(hw, nnz=nnz)
    n_bytes = spmm_bytes(m, n, k, weight_bytes=hp.weight_bytes())
    torch.backends.cuda.matmul.allow_tf32 = False
    hw_dense = unpack_ternary(hp)
    library = {
        "f32": (torch.matmul, (hx, hw_dense)),
        "bf16": (torch.matmul, (hx.to(torch.bfloat16), hw_dense.to(torch.bfloat16))),
        "int8": (torch._int_mm, (quantize_rows(hx)[0], hw_dense.to(torch.int8))),
    }
    per_mode = {}
    for name, (cdt, _, tol) in modes.items():
        y = packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt)
        ref = packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt)
        torch.cuda.synchronize()
        max_err = float((y - ref).abs().max())
        t_kernel = measure(lambda: packed_spmm(hx, hp, hb, ALPHA, compute_dtype=cdt))
        t_plain = measure(lambda: packed_spmm_plain(hx, hp, hb, ALPHA, compute_dtype=cdt))
        lib_fn, lib_args = library[name]
        t_lib = measure(lib_fn, *lib_args)
        # f32 X times the ternary W: the card's rate is bf16's over three passes
        peak = "f32_ternary" if name == "f32" else name
        bound_s, bound_by = roofline_bound(sparse_flops(m, n, nnz), n_bytes, spec, peak)
        dense_s, dense_by = roofline_bound(2.0 * m * n * k, n_bytes, spec, peak)
        per_mode[name] = {
            "mode": name, "shape": [m, k, n], "nnz": nnz, "max_abs_err": max_err,
            "ms": t_kernel.min_s * 1e3, "cuda_core_ms": B1_CUDA_CORE_MS[name],
            "mean_ms": t_kernel.mean_s * 1e3,
            "std_ms": t_kernel.std_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "library_ms": t_lib.min_s * 1e3, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "dense_bound_ms": dense_s * 1e3,
            "dense_bound_by": dense_by,
        }
        print(json.dumps(per_mode[name]), flush=True)

    # M=1: the headline's W, and the LM head's shape (1 x 1024 x 8192, as
    # ``lm`` runs it every decode step), each beside torch.matmul on the
    # dense bf16 W in the same call
    head_w = rng.rand_ternary(hgen, (1024, 8192), non_zero=2)
    head_nnz = int(torch.count_nonzero(head_w))
    head_p = pack_ternary_device(head_w, nnz=head_nnz)
    m1_rows = {}
    for label, (p1, nnz1, b1_) in {"m1_4096": (hp, nnz, hb),
                                   "lm_head": (head_p, head_nnz, None)}.items():
        k1, n1 = p1.rows, p1.cols
        x1 = rng.rand_dense(hgen, (1, k1))
        y1 = packed_spmm(x1, p1, b1_, None, compute_dtype=torch.bfloat16)
        ref1 = packed_spmm_plain(x1, p1, b1_, None, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err1 = float((y1 - ref1).abs().max())
        check(err1 <= 1e-5 * max(1.0, float(ref1.abs().max())), f"B1 M=1 {label}")
        t1 = measure(lambda: packed_spmm(x1, p1, b1_, None, compute_dtype=torch.bfloat16))
        t1_plain = measure(
            lambda: packed_spmm_plain(x1, p1, b1_, None, compute_dtype=torch.bfloat16))
        w1 = unpack_ternary(p1).to(torch.bfloat16)
        x1b = x1.to(torch.bfloat16)
        t1_lib = measure(torch.matmul, x1b, w1)
        bnd, bnd_by = roofline_bound(sparse_flops(1, n1, nnz1),
                                     spmm_bytes(1, n1, k1, weight_bytes=p1.weight_bytes()),
                                     spec, "bf16")
        m1_rows[label] = {"mode": "bf16", "shape": [1, k1, n1], "max_abs_err": err1,
                          "ms": t1.min_s * 1e3, "plain_ms": t1_plain.min_s * 1e3,
                          "library_ms": t1_lib.min_s * 1e3, "bound_ms": bnd * 1e3,
                          "bound_by": bnd_by, "tile": list(tile_for(1, n1)),
                          "device_us": _device_us(lambda: packed_spmm(
                              x1, p1, b1_, None, compute_dtype=torch.bfloat16)),
                          "library_device_us": _device_us(lambda: torch.matmul(x1b, w1))}
        print(json.dumps(m1_rows[label]), flush=True)
    time_b1_tiles(torch, dev)
    time_b1_wide(torch, dev, spec)
    f32_tiles = time_b1_f32(torch, dev)
    order = _b1_order_rows(torch, dev)
    for r in order:
        print(json.dumps({"b1_f32_order": r}), flush=True)
    check(all(r["chain"] and r["rows_bitwise_m1"] for r in order),
          f"B1 f32 left its K order or its rows differ from the M=1 calls: {order}")
    log("B1 f32 bitwise packed_spmm_f32_chain and the M=1 calls at "
        + ", ".join("x".join(map(str, r["shape"])) for r in order) + "; device us by the "
        "tile tile_for picks / torch.matmul f32: " + ", ".join(
            f"{'x'.join(map(str, r['b1_f32_device_us']))} {r['tile_for_us']:.2f} / "
            f"{r['matmul_f32_us']:.2f}" for r in f32_tiles))
    log("B1 at the headline, ms now / the CUDA-core kernel's: " + ", ".join(
        f"{name} {r['ms']:.4f} / {r['cuda_core_ms']}" for name, r in per_mode.items())
        + f"; torch.matmul bf16 {per_mode['bf16']['library_ms']:.4f}; LM head M=1 "
        f"{m1_rows['lm_head']['ms']:.4f} (torch.matmul "
        f"{m1_rows['lm_head']['library_ms']:.4f}), on the device "
        f"{m1_rows['lm_head']['device_us']:.2f} us (torch.matmul "
        f"{m1_rows['lm_head']['library_device_us']:.2f}; the CUDA-core kernel's head "
        f"took {B1_CUDA_CORE_HEAD_DEVICE_MS} ms of device time a decode step)")

    for use_kernel in (True, False):
        r = run_mlp_bench(4, 4096, 256, 10, use_kernel=use_kernel, device=dev)
        print(json.dumps({
            "mlp": r.label, "depth": 4, "dim": 4096, "batch": 256,
            "compute": "bf16", "ms": r.min_s * 1e3, "mean_ms": r.mean_s * 1e3,
            "rows_per_s": r.rows_per_s, "nnz_per_s": r.nnz_per_s,
            "bound_ms": r.bound_s * 1e3, "bound_by": r.bound_by,
            "frac_roofline": r.frac_roofline,
        }), flush=True)

    fused = check_fused_kernels(torch, dev)
    lm = run_lm_path(torch, dev)
    fused_rows = time_fused_kernels(torch, dev, spec, fused, lm)
    flash_err = check_flash_kernels(torch, dev)
    flash = run_flash_lm_path(torch, dev, lm)
    flash_rows = time_flash_kernels(torch, dev, spec, flash_err, flash)
    bcsr_err = check_bcsr_kernel(torch, dev)
    reference = run_reference_benchmark(torch, dev)
    bcsr_rows = time_bcsr_kernel(torch, dev, spec, bcsr_err, reference)
    int8_err = check_int8_kernels(torch, dev)
    int8 = run_int8_lm_path(torch, dev, lm)
    int8_rows = time_int8_kernels(torch, dev, spec, int8_err, int8)
    pipe = check_pipe_kernel(torch, dev, lm)
    run_serving_controls(torch, dev, lm)
    pipe_rows = time_serving_controls(torch, dev, spec, pipe)
    run_finetune_and_mlp_qat(torch, dev, card)
    run_lm_training(torch, dev, card)
    run_moe_lm(torch, dev, card)
    run_lora_lm(torch, dev, card, lm)
    run_runtime(torch, dev, card)
    par = run_parallel(torch, dev, card)
    run_a5(torch, dev, card)
    b1g = run_moe_grouped(torch, dev, card)

    main_mode = per_mode["bf16"]  # the main path's mode and per-layer shape
    summary = {"kernels": [{
        "name": "packed_spmm",
        "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/packed_spmm.cu",
        "replaces": "smmb_tpu/kernels/packed_spmm.py:388",
        "launches": main_launches,
        "max_abs_err": main_mode["max_abs_err"],
        "ms": main_mode["ms"],
        "plain_ms": main_mode["plain_ms"],
        "bound_ms": main_mode["bound_ms"],
        "bound_by": main_mode["bound_by"],
        "library_ms": main_mode["library_ms"],
        "design": "mma.sync; bf16 at large M: wgmma fed by TMA",
    }, *bcsr_rows, *fused_rows, *flash_rows, *int8_rows, *pipe_rows, b1g["kernel_row"]]}
    lm_tp, a4b = par["lm"], par["a4b"]
    moe_tp = a4b["moe_lm"]
    par_launches = {  # phases 28 and 29, a rank's launches on 2 ranks sharing the card
        "packed_spmm": {"sharded SpMMs (column + row + overlap)": par["spmm"]["b1_launches"]["bf16"],
                        "mlp_forward_sharded": par["mlp"]["b1_launches"],
                        "block_forward_tp": par["block"]["b1_launches"],
                        "generate_tp": lm_tp["unit_bf16_plain"]["launches"]["packed_spmm"],
                        "lm_forward_pp": par["pp"]["b1_launches"],
                        "moe_forward_ep": a4b["ep"]["top2_bf16"]["b1_launches"],
                        "moe_block_forward_tp": a4b["tpep_block"]["b1_launches"],
                        "generate_tp (MoE)": moe_tp["plain"]["launches"]["packed_spmm"],
                        "lm_forward_sp": a4b["sp"]["lm"]["b1_launches"],
                        "block_forward_sp (MoE)": a4b["sp"]["moe_block"]["b1_launches"],
                        "lm_forward_pp (MoE)": a4b["pp_moe"]["b1_launches"],
                        "lm_forward_tp (LoRA)": a4b["lora"]["forward"]["b1_launches"]},
        "bcsr_spmm_kernel": {"sharded_bcsr_spmm": par["bcsr"]["f32"]["b2_launches"]},
        "flash_attention": {"generate_tp(use_flash)":
                            lm_tp["unit_bf16_flash"]["launches"]["flash_attention"],
                            "generate_tp(use_flash) (MoE)":
                            moe_tp["flash"]["launches"]["flash_attention"]},
        "flash_attention_decode": {"generate_tp(use_flash)":
                                   lm_tp["unit_bf16_flash"]["launches"]["flash_attention_decode"],
                                   "generate_tp(use_flash) (MoE)":
                                   moe_tp["flash"]["launches"]["flash_attention_decode"]},
        "flash_attention_decode_quant": {"generate_tp(kv_quant, use_flash)": lm_tp[
            "unit_bf16_int8_flash"]["launches"]["flash_attention_decode_quant"],
            "generate_tp(kv_quant, use_flash) (MoE)": moe_tp[
            "int8_flash"]["launches"]["flash_attention_decode_quant"]},
    }
    for row in summary["kernels"]:
        if row["name"] in par_launches:
            row["parallel_launches"] = par_launches[row["name"]]
    log(f"all phases passed in {time.time() - T0:.1f}s")
    print(json.dumps(summary), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# ------------------------------------------------------------ LM slice
def _tern(gen, shape):
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.utils import rng

    return pack_ternary_device(rng.rand_ternary(gen, shape, non_zero=2))


def _fused_inputs(torch, gen, name, m, d, n_or_h, dev, x_dtype=None):
    """Random inputs of one fused kernel at d (K, A, D) and n_or_h (N or H)."""
    from smmb_tpu_torch.utils import rng

    f32 = torch.float32
    sc = lambda v: torch.tensor(v, dtype=f32, device=dev)  # noqa: E731
    xd = x_dtype or f32
    if name == "fused_norm_qkv":
        n = n_or_h
        return (rng.rand_dense(gen, (m, d), dtype=xd),
                1.0 + 0.1 * rng.rand_dense(gen, (d,)), _tern(gen, (d, n)),
                0.5 + rng.rand_dense(gen, (n,)).abs(), rng.rand_dense(gen, (n,)))
    h = n_or_h
    if name == "fused_mlp":
        return (rng.rand_dense(gen, (m, d), dtype=xd), _tern(gen, (d, h)),
                sc(0.37), rng.rand_dense(gen, (h,)), _tern(gen, (h, d)),
                sc(1.21), rng.rand_dense(gen, (d,)))
    return (rng.rand_dense(gen, (m, d), dtype=x_dtype or torch.bfloat16),
            rng.rand_dense(gen, (m, d)), _tern(gen, (d, d)), sc(0.9),
            rng.rand_dense(gen, (d,)), 1.0 + 0.1 * rng.rand_dense(gen, (d,)),
            _tern(gen, (d, h)), sc(0.37), rng.rand_dense(gen, (h,)),
            _tern(gen, (h, d)), sc(1.21), rng.rand_dense(gen, (d,)))


def _fused_kwargs(name, cdt):
    if name == "fused_norm_qkv":
        return dict(eps=1e-6, compute_dtype=cdt)
    if name == "fused_mlp":
        return dict(alpha=ALPHA, compute_dtype=cdt)
    return dict(alpha=ALPHA, eps=1e-6, compute_dtype=cdt)


def _kernel_kwargs(name, cdt):
    """``_fused_kwargs`` plus a hidden slab that divides every H here (the
    TPU kernel's slab, checked by the wrappers; the CUDA kernels ignore it)."""
    slab = {} if name == "fused_norm_qkv" else {"block_h": 512}
    return {**_fused_kwargs(name, cdt), **slab}


def _rows(args, name, r0, r1):
    """The inputs restricted to rows [r0, r1) (activations only)."""
    n_act = 2 if name == "fused_block_tail" else 1
    return tuple(a[r0:r1] if i < n_act else a for i, a in enumerate(args))


# the LM path's shapes: B3 at M=1 (and the GQA width, and at M=5: the
# 8-row tile of a chunk or a verify), B5 at M=1, B6 at M=32;
# B5 at a speculative verify's M=9 on the tests' 512/1536, and B5 and B6 at
# d=2048, H=8192 with M=9 (two row tiles: more items than the card holds
# blocks, so blocks walk several items a phase)
FUSED_SHAPES = [
    ("fused_norm_qkv", 1, 1024, 3072), ("fused_norm_qkv", 1, 1024, 1536),
    ("fused_norm_qkv", 8, 1024, 3072), ("fused_norm_qkv", 5, 1024, 3072),
    ("fused_block_tail", 1, 1024, 4096),
    ("fused_block_tail", 8, 1024, 4096), ("fused_mlp", 32, 1024, 4096),
    ("fused_mlp", 1, 1024, 4096), ("fused_mlp", 3, 512, 1024),
    ("fused_block_tail", 9, 512, 1536), ("fused_block_tail", 9, 2048, 8192),
    ("fused_mlp", 9, 2048, 8192),
]
# the device µs a call at the path shapes (bf16) of the earlier B3 and B7
# (24 blocks of 128 columns) and multi-launch B5 (three launches) and B6
# (two), by the profiler: the median of the earlier tree's four runs of
# ``--fused-ab`` on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's B3, B5, B6
# and B7 rows); logged in phases 9 and 19 beside this run's own times
FUSED_PARENT_US = {"fused_norm_qkv": 11.50, "fused_block_tail": 34.84, "fused_mlp": 37.35,
                   "fused_norm_qkv_quant": 12.05}
FUSED_DESIGN = ("one cooperative launch over the card; items fixed by the shapes in "
                "phases between grid syncs; the earlier kernels' sums kept bitwise")
QKV_DESIGN = ("one launch of one 32-column item a block, weight pieces issued before the "
              "norm; B7's K/V span a thread block cluster sharing its absmax; the earlier "
              "kernels' sums kept bitwise")


# ``--fused-ab DIR``: B3, B7, B5 and B6 of this checkout against DIR's (an
# earlier tree of the port, ``git archive <commit> | tar -x -C DIR``) at the
# LM path's shapes, the rows of a chunk and of a speculative verify, a GQA
# width, a wider head, B3 at the tail gate's most rows (four row tiles) and
# a wider block: (kernel, M, d, N or H, compute dtype[, B7's head_dim, 128
# if absent]); and B1's f32 body (bias and PReLU, the tile each side's
# wrapper picks) at the headline, entry()'s three layers, the LM prefill's
# projections and the LM head: (``packed_spmm``, M, K, N, "f32")
FUSED_AB_CASES = [
    ("fused_norm_qkv", 1, 1024, 3072, "bf16"), ("fused_norm_qkv_quant", 1, 1024, 3072, "bf16"),
    ("fused_norm_qkv", 5, 1024, 3072, "bf16"), ("fused_norm_qkv", 5, 1024, 3072, "f32"),
    ("fused_norm_qkv_quant", 5, 1024, 3072, "bf16"),
    ("fused_norm_qkv_quant", 5, 1024, 3072, "f32"), ("fused_norm_qkv", 1, 1024, 1536, "bf16"),
    ("fused_norm_qkv_quant", 1, 1024, 3072, "bf16", 256), ("fused_norm_qkv", 32, 1024, 3072, "bf16"),
    ("fused_block_tail", 1, 1024, 4096, "bf16"), ("fused_block_tail", 1, 1024, 4096, "f32"),
    ("fused_block_tail", 5, 1024, 4096, "bf16"), ("fused_block_tail", 9, 512, 1536, "f32"),
    ("fused_block_tail", 1, 2048, 8192, "bf16"), ("fused_block_tail", 32, 1024, 4096, "bf16"),
    ("fused_mlp", 32, 1024, 4096, "bf16"), ("fused_mlp", 32, 1024, 4096, "f32"),
    ("fused_mlp", 1, 1024, 4096, "bf16"), ("fused_mlp", 9, 2048, 8192, "bf16"),
    ("packed_spmm", 256, 4096, 4096, "f32"), ("packed_spmm", 64, 1024, 2048, "f32"),
    ("packed_spmm", 64, 2048, 2048, "f32"), ("packed_spmm", 64, 2048, 1024, "f32"),
    ("packed_spmm", 32, 1024, 1024, "f32"), ("packed_spmm", 1, 1024, 8192, "f32"),
]
# B9's and B9p's CUDA-core body (``flash_attention`` through each side's
# wrapper, its own row tile): (``flash_attention``, B, H, KVH, T, hd,
# dtype, causal, window, pipeline_p); the LM prefill, the decode bench's
# prompt, the long prefill causal and not, GQA 8/2 with a window over a
# ragged last tile, hd 64, the bf16 widths off the tensor cores, B9p at
# phase 22's f32 shapes and hd 256, and hd 200, where serial and pipelined
# calls take different kv tiles
FLASH_AB_CASES = [
    ("flash_attention", 1, 8, 8, 32, 128, "f32", True, None, False),
    ("flash_attention", 1, 8, 8, 512, 128, "f32", True, None, False),
    ("flash_attention", 1, 8, 8, 4096, 128, "f32", True, None, False),
    ("flash_attention", 1, 8, 8, 4096, 128, "f32", False, None, False),
    ("flash_attention", 1, 8, 2, 200, 128, "f32", True, 100, False),
    ("flash_attention", 1, 8, 8, 512, 64, "f32", True, None, False),
    ("flash_attention", 1, 4, 4, 512, 256, "bf16", True, None, False),
    ("flash_attention", 1, 2, 2, 256, 512, "bf16", True, None, False),
    ("flash_attention", 1, 8, 8, 32, 128, "f32", True, None, True),
    ("flash_attention", 1, 8, 8, 512, 128, "f32", True, None, True),
    ("flash_attention", 1, 8, 8, 4096, 128, "f32", True, None, True),
    ("flash_attention", 1, 4, 4, 512, 256, "bf16", True, None, True),
    ("flash_attention", 1, 4, 4, 512, 200, "f32", True, None, False),
    ("flash_attention", 1, 4, 4, 512, 200, "f32", True, None, True),
]
AB_CASES = FUSED_AB_CASES + FLASH_AB_CASES


def _own_module(rel: str):
    """A module of this checkout's package loaded from its file
    (``smmb_tpu_torch/<rel>``), whatever package ``sys.path`` puts first: a
    side of ``--fused-ab`` runs DIR's package with this checkout's script."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_smoke_{Path(rel).stem}", HERE / "smmb_tpu_torch" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_side(out, c1_tokens=None, c1_out=None) -> int:
    """One side of ``--fused-ab``, run with the side's package first on
    ``sys.path``: every case's outputs saved to ``out``, and a JSON line a
    case with its device µs and kernel launches a call by this checkout's
    profiler breakdown (bench/trace.py). With ``c1_tokens`` (the plain
    path's tokens of every pair of ``LM_AB_PAIRS``) it also reads C1's
    case on this side (``c1_side``) into the JSON file ``c1_out``."""
    import torch

    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.utils import rng

    trace = _own_module("bench/trace.py")
    dev = torch.device("cuda")
    outs = []

    def emit(i, rows):
        print(json.dumps({"case": AB_CASES[i], "device_us": sum(r["us"] for r in rows),
                          "launches": sum(r["launches"] for r in rows),
                          "kernels": [r["name"][:60] for r in rows]}), flush=True)

    for i, (name, m, d, n, cdt, *hd) in enumerate(FUSED_AB_CASES):
        gen = rng.make_generator(100 + i, dev)
        cdt = torch.bfloat16 if cdt == "bf16" else torch.float32
        fn = packed_spmm if name == "packed_spmm" else getattr(fk, name)
        if name == "packed_spmm":
            w = pack_ternary_device(rng.rand_ternary(gen, (d, n), non_zero=10 if d == 4096 else 2))
            args = (rng.rand_dense(gen, (m, d)), w, rng.rand_dense(gen, (n,)), ALPHA)
            kw = {"compute_dtype": cdt}
        elif name == "fused_norm_qkv_quant":
            hd = hd[0] if hd else 128
            args, kw = _b7_inputs(torch, gen, m, d, (n - d) // (2 * hd), hd, dev)
            kw["compute_dtype"] = cdt
        else:
            args, kw = _fused_inputs(torch, gen, name, m, d, n, dev), _kernel_kwargs(name, cdt)
        y = fn(*args, **kw)
        outs.append([t.cpu() for t in (y if isinstance(y, tuple) else (y,))])
        emit(i, trace.kernel_breakdown(lambda: fn(*args, **kw), n_calls=50))
    for i, (_, b, h, kvh, t, hd, cdt, causal, window, pipe) in enumerate(
            FLASH_AB_CASES, len(FUSED_AB_CASES)):
        gen = rng.make_generator(100 + i, dev)
        dt = torch.bfloat16 if cdt == "bf16" else torch.float32
        q = (rng.rand_dense(gen, (b, t, h, hd)) * 4.0).to(dt).permute(0, 2, 1, 3)
        k = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
        v = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
        kw = dict(causal=causal, window=window, pipeline_p=pipe)
        outs.append([fa.flash_attention(q, k, v, **kw).cpu()])
        emit(i, trace.kernel_breakdown(lambda: fa.flash_attention(q, k, v, **kw),
                                       n_calls=10 if t * hd >= 4096 * 128 else 50))
    torch.save(outs, out)
    if c1_tokens is not None:
        Path(c1_out).write_text(json.dumps(c1_side(torch, dev, torch.load(c1_tokens))))
    return 0


def fused_ab(other) -> int:
    """``--fused-ab DIR``: every case of ``FUSED_AB_CASES`` and
    ``FLASH_AB_CASES`` through DIR's kernels and this checkout's, each
    side in a process of its own, in turns (DIR, this, this, DIR, twice);
    one JSON line a case with each side's device µs in every run and
    whether this side's outputs equal DIR's bitwise. The first run of each side also reads C1's case
    (``c1_side``) on the plain path's tokens, computed here once, and the
    verdict of the A/B is printed (``c1_verdict``). Exits 1 if any output
    differs."""
    import tempfile

    import torch

    print(card_line(), flush=True)
    runs = {"other": [], "this": []}
    c1 = {}
    with tempfile.TemporaryDirectory() as work:
        tokens = Path(work) / "c1_tokens.pt"
        torch.save(c1_tokens(torch, torch.device("cuda")), tokens)
        for i, side in enumerate(("other", "this", "this", "other") * 2):
            out = Path(work) / f"{side}{i}.pt"
            c1_args = [str(tokens), str(Path(work) / f"c1_{side}.json")] if i < 2 else []
            proc = subprocess.run(
                [sys.executable, str(HERE / "chip_smoke.py"), "--fused-side",
                 str(other if side == "other" else HERE), str(out), *c1_args],
                capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"{side} side failed:\n{proc.stdout}\n{proc.stderr}")
            rows = [json.loads(line) for line in proc.stdout.splitlines()
                    if line.startswith("{")]
            for r in rows:
                print(json.dumps({"side": side, "run": i, **r}), flush=True)
            runs[side].append((rows, torch.load(out)))
            if c1_args:
                c1[side] = json.loads(Path(c1_args[1]).read_text())
    c1_verdict(c1["this"], c1["other"])
    same_all = True
    for j, case in enumerate(AB_CASES):
        same = all(torch.equal(a, b) for a, b in zip(runs["other"][0][1][j],
                                                      runs["this"][0][1][j]))
        same_all &= same
        print(json.dumps({"case": case, "bitwise": same, **{
            f"{side}_{key}": [rows[j][key] for rows, _ in runs[side]]
            for side in runs for key in ("device_us", "launches")}}), flush=True)
    print(json.dumps({"all_bitwise": same_all}), flush=True)
    return 0 if same_all else 1


# C1's same-token A/B, the LM case of ``--fused-ab DIR``: DIR's B1 f32 body
# against this checkout's on the f32 paths of phases 8 and 18, both sides
# teacher-forced on the plain path's f32 ``generate`` tokens. DIR for C1's
# candidate is written by ``--c1-candidate DIR``. Pairs of (model seed,
# prompt seed) at the ``lm`` defaults; None is build_lm's own prompt, so the
# first pair is phase 8's LM and prompt.
LM_AB_CFG = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=4)
LM_AB_PAIRS = [(0, None), (0, 7), (1, None), (2, None), (3, None), (4, None)]
LM_AB_PROMPT, LM_AB_STEPS = 32, 64
LM_AB_PATHS = {"float": (False, False), "int8_flash": (True, True), "int8": (False, True)}
# the prefill's B1 calls in call order are, a layer, the cache's k and v,
# then the forward's q, k, v and o; each split runs the named calls on the
# kernel and every other B1 call on its plain version, to find which calls
# start the int8 codes that differ
LM_AB_SPLITS = {"l0_cache_kv": (0, 1), "l0_qkvo": (2, 3, 4, 5), "l1_cache_kv": (6, 7),
                "l1_qkvo": (8, 9, 10, 11)}
# C1's candidate B1 f32 body (``--c1-candidate``): packed_spmm.cu built with
# SMMB_C1_FOLD, each 32-row K chunk summed from zero in registers and folded
# into the running sum with __fadd_rn, chunks in the kernel's K order
C1_FOLD = "#define SMMB_C1_FOLD 1\n"
def c1_candidate(out) -> int:
    """``--c1-candidate DIR``: DIR gets a copy of this checkout's port with
    C1's candidate B1 f32 body: ``C1_FOLD`` switches it on at the top of
    ``packed_spmm.cu`` (a new library name: the build hashes the source)."""
    import shutil

    shutil.copytree(HERE / "smmb_tpu_torch", out / "smmb_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = out / "smmb_tpu_torch" / "kernels" / "csrc" / "packed_spmm.cu"
    text = src.read_text()
    check(text.count("#ifdef SMMB_C1_FOLD") == 1,
          "C1 candidate: packed_spmm.cu has no SMMB_C1_FOLD switch")
    src.write_text(C1_FOLD + text)
    log(f"C1's candidate B1 f32 body written to {src}")
    return 0


def _ab_lm(torch, dev, pair):
    """(cfg, packed, prompt) of one ``LM_AB_PAIRS`` pair."""
    from smmb_tpu_torch.bench.lm_bench import build_lm
    from smmb_tpu_torch.models.lm import TernaryLMConfig
    from smmb_tpu_torch.utils import rng

    cfg = TernaryLMConfig(**LM_AB_CFG, max_len=LM_AB_PROMPT + 3 * LM_AB_STEPS)
    packed, prompt = build_lm(cfg, 1, LM_AB_PROMPT, seed=pair[0], device=dev)
    if pair[1] is not None:
        prompt = torch.randint(0, cfg.vocab, (1, LM_AB_PROMPT), device=dev,
                               generator=rng.make_generator(pair[1], dev))
    return cfg, packed, prompt


def c1_tokens(torch, dev) -> list:
    """The plain path's f32 ``generate`` tokens of every pair and path of
    C1's A/B, with each pair's prompt (CPU tensors)."""
    from smmb_tpu_torch.models.lm import generate

    out = []
    for pair in LM_AB_PAIRS:
        cfg, packed, prompt = _ab_lm(torch, dev, pair)
        toks = {"prompt": prompt.cpu()}
        with plain_kernels():
            for path, (flash, quant) in LM_AB_PATHS.items():
                toks[path] = generate(packed, prompt, cfg, LM_AB_STEPS,
                                      compute_dtype=torch.float32, kv_quant=quant,
                                      use_flash=flash).cpu()
        out.append(toks)
    return out


@contextlib.contextmanager
def _routed_b1(torch, calls, on=None):
    """B1 on the LM path, the i-th call (in call order) on the kernel when
    ``on`` is None or holds i, else on its plain version. With ``on`` None,
    each call's deviation from ``packed_spmm_plain`` on its own input (RMS
    and max of |y - plain| / max(1, max|plain|)) and its reading against
    f64 (``_f64_reading``) are appended to ``calls``."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.models import attention, lm, moe, transformer

    count = [0]

    def routed(x, w, b=None, alpha=None, *, compute_dtype=torch.float32):
        i, count[0] = count[0], count[0] + 1
        ref = packed_spmm_plain(x.reshape(-1, x.shape[-1]), w, b, alpha,
                                compute_dtype=compute_dtype).reshape(*x.shape[:-1], w.cols)
        if on is not None and i not in on:
            return ref
        y = packed_spmm(x, w, b, alpha, compute_dtype=compute_dtype)
        if on is None:
            d = (y - ref).double().abs() / max(1.0, float(ref.abs().max()))
            calls.append({"rms": float(d.square().mean().sqrt()), "max": float(d.max()),
                          **_f64_reading(torch, x, w, b, alpha, y)})
        return y

    mods = (attention, transformer, lm, moe)
    try:
        for mod in mods:
            mod.packed_spmm = routed
        yield
    finally:
        for mod in mods:
            mod.packed_spmm = packed_spmm


def _flip_map(torch, got, want, head_dim) -> list:
    """Int8 codes that differ between two LM caches, a row a layer:
    [K at prefill positions, K at decode positions, V prefill, V decode]."""
    rows = []
    for g, w in zip(got, want):
        b, s, kvd2 = g["kv"].shape
        d = (g["kv"] != w["kv"]).view(b, s, kvd2 // (2 * head_dim), 2, head_dim)
        rows.append([int(d[:, part, :, kv].sum()) for kv in (0, 1)
                     for part in (slice(0, LM_AB_PROMPT), slice(LM_AB_PROMPT, s))])
    return rows


def _ab_path(torch, cfg, packed, prompt, ids, flash, quant) -> dict:
    """One f32 path of C1's A/B on this side's B1, teacher-forced on
    ``ids``: the logits' median and worst step error against the plain
    path and the plain orders' spread (as phases 8 and 18 read them),
    whether those phases' gates would hold, each B1 call's deviation from
    plain at layers 0 and 1, C1's ratios over every call and, over the int8
    cache, the codes that differ by layer, K or V and prefill or decode
    position, alone and under each of ``LM_AB_SPLITS``."""
    f32, hd = torch.float32, cfg.d_model // cfg.n_heads
    calls, caches = [], []
    with _routed_b1(torch, calls):
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, f32, True, flash, quant, caches)
    with plain_kernels():
        plain = _teacher_forced(torch, cfg, packed, prompt, ids, f32, True, flash, quant,
                                caches)
        unfused = _teacher_forced(torch, cfg, packed, prompt, ids, f32, False, flash, quant)
    scale = plain.abs().amax(-1).clamp_min(1.0)
    err = (kern - plain).abs().amax(-1) / scale
    spread = float(((unfused - plain).abs().amax(-1) / scale).max())
    rms, mx = _c1_ratios(calls)
    out = {"median": float(err.median()), "worst": float(err.max()), "spread": spread,
           "b1_l01": [[c["rms"], c["max"]] for c in calls[:12]],
           "c1_rms_ratio": rms, "c1_max_ratio": mx}
    flips = 0
    if quant:
        out["flips"] = _flip_map(torch, caches[0], caches[1], hd)
        flips = sum(map(sum, out["flips"]))
        out["splits"] = {}
        for name, on in LM_AB_SPLITS.items():
            split = []
            with _routed_b1(torch, [], on):
                _teacher_forced(torch, cfg, packed, prompt, ids, f32, True, flash, quant, split)
            out["splits"][name] = _flip_map(torch, split[0], caches[1], hd)
    out["gates_hold"] = (out["median"] <= 1e-4 and out["worst"]
                         <= max(1e-4, spread, INT8_REL if flips else 0.0))
    return out


def _b1_f32_fold(torch, x, w, b, alpha):
    """C1's candidate B1 f32 body (``C1_FOLD``) replayed in plain f32 adds:
    ``packed_spmm_f32_chain``'s K order, each chunk (8 packed rows of each
    of the 4 planes, plane by plane) summed from zero and added to the
    running sum. Then bias and PReLU in f32."""
    from smmb_tpu_torch.formats.packed import GROUP_ROWS, SUB, unpack_ternary

    wd, k = unpack_ternary(w), x.shape[1]
    acc = torch.zeros(x.shape[0], w.cols, device=x.device)
    for pr0 in range(0, w.data.shape[0], 8):
        part = torch.zeros_like(acc)
        for i in range(4):
            col0 = (pr0 // SUB) * GROUP_ROWS + i * SUB + pr0 % SUB
            for col in range(col0, min(col0 + 8, k)):
                part = part + x[:, col:col + 1] * wd[col]
        acc = acc + part
    if b is not None:
        acc = acc + b
    return acc if alpha is None else torch.where(acc > 0, acc, alpha * acc)


def _b1_order_rows(torch, dev) -> list:
    """Which K order this side's B1 f32 body takes, bitwise, at the LM's
    shapes (the prefill's 32×1024×1024, the head's 1×1024×8192), the
    headline and two ragged K: ``chain``, this checkout's
    ``packed_spmm_f32_chain`` (the body's order), or ``fold`` (C1's
    candidate); and whether rows of an M-row call are bitwise the M = 1
    calls."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.utils import rng

    chain = _own_module("kernels/packed_spmm.py").packed_spmm_f32_chain
    gen = rng.make_generator(31, dev)
    rows = []
    for m, k, n in ((32, 1024, 1024), (1, 1024, 8192), (256, 4096, 4096), (5, 100, 256),
                    (17, 1000, 300)):
        w = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=10 if k == 4096 else 2))
        x, b = rng.rand_dense(gen, (m, k)), rng.rand_dense(gen, (n,))
        y = packed_spmm(x, w, b, ALPHA)
        ones = torch.cat([packed_spmm(x[r:r + 1], w, b, ALPHA) for r in range(m)])
        rows.append({"shape": [m, k, n], "rows_bitwise_m1": bool(torch.equal(y, ones)),
                     "chain": bool(torch.equal(y, chain(x, w, b, ALPHA))),
                     "fold": bool(torch.equal(y, _b1_f32_fold(torch, x, w, b, ALPHA)))})
    return rows


def c1_side(torch, dev, tokens) -> dict:
    """C1's case on one side of ``--fused-ab``: B1's f32 headline against
    f64 (phase 3's reading), its K order (``_b1_order_rows``) and each
    pair's three paths (``_ab_path``) on the plain path's ``tokens``."""
    out = {"headline": read_b1_f32_headline(torch, dev),
           "order": _b1_order_rows(torch, dev), "pairs": []}
    for pair, toks in zip(LM_AB_PAIRS, tokens):
        cfg, packed, _ = _ab_lm(torch, dev, pair)
        prompt = toks["prompt"].to(dev)
        out["pairs"].append({"pair": list(pair), **{
            path: _ab_path(torch, cfg, packed, prompt, toks[path].to(dev), flash, quant)
            for path, (flash, quant) in LM_AB_PATHS.items()}})
    return out


def _ab_totals(pair: dict) -> tuple:
    """(worst f32 step error over the three paths, int8 codes that differ
    over both int8 paths) of one side's pair."""
    return (max(pair[p]["worst"] for p in LM_AB_PATHS),
            sum(sum(map(sum, pair[p]["flips"])) for p in LM_AB_PATHS if "flips" in pair[p]))


def c1_verdict(this: dict, other: dict) -> dict:
    """C1's decision rule (PERF.md §6): DIR's B1 (``other``, the candidate)
    is worse on a pair when both its worst f32 step error and its int8
    codes that differ exceed this side's, and worse on most when that holds
    on more than half of the pairs. One JSON line a side (headline reading,
    K order), one a pair, and the verdict."""
    for side, res in (("this", this), ("other", other)):
        print(json.dumps({"c1_side": side, "headline": res["headline"],
                          "order": res["order"]}), flush=True)
    worse = 0
    for a, b in zip(this["pairs"], other["pairs"]):
        (wa, fa), (wb, fb) = _ab_totals(a), _ab_totals(b)
        worse += wb > wa and fb > fa
        print(json.dumps({"c1_pair": a["pair"], "this": a, "other": b,
                          "worst": [wa, wb], "codes_differ": [fa, fb],
                          "other_worse": wb > wa and fb > fa}), flush=True)
    verdict = {"c1_ab": {"pairs": len(this["pairs"]), "other_worse": worse,
                         "worse_on_most": 2 * worse > len(this["pairs"])}}
    print(json.dumps(verdict), flush=True)
    return verdict


def check_fused_kernels(torch, dev) -> dict:
    """Phases 6 and 7. Returns {name: max abs err at the path shape, bf16}."""
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
    # order than the plain version's exact product); bf16 2**-7 (a sum that
    # differs by an f32 ulp can round a staged value to the next bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(77, dev)
    path_err = {}
    for name, m, d, n_or_h in FUSED_SHAPES:
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            before = fn.launches
            y = fn(*args, **_kernel_kwargs(name, cdt))
            check(fn.launches == before + 1, f"{name} launch count")
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            check(y.shape == ref.shape and y.dtype == ref.dtype, f"{name} shape/dtype")
            check(bool(torch.isfinite(y).all()), f"{name} non-finite {m}x{d}x{n_or_h}")
            err = float((y.float() - ref.float()).abs().max())
            lim = tol[cdt] * max(1.0, float(ref.float().abs().max()))
            check(err <= lim, f"{name} kernel vs plain {cdt} {m}x{d}x{n_or_h}: "
                  f"err {err:.3e} > {lim:.3e}")
            if cdt == torch.bfloat16 and (m, d, n_or_h) == _path_shape(name):
                path_err[name] = err
        items = f", {len(fk.qkv_blocks(d, n_or_h))} blocks a row tile"
        if name != "fused_norm_qkv":
            a = d if name == "fused_block_tail" else None
            grid = fk.items_grid(m, d, n_or_h, d, a, dev)
            most = fk.most_items(m, n_or_h, d, a)
            items = f", {grid} blocks for at most {most} items a phase"
            if d == 2048:
                check(most > grid, f"{name} at d=2048: {most} items fit {grid} blocks")
        log(f"{name} == plain at M={m}, {d}x{n_or_h} in f32 and bf16{items}")
    # bf16 x in, bf16 out
    args = _fused_inputs(torch, gen, "fused_mlp", 4, 1024, 2048, dev, torch.bfloat16)
    y = fk.fused_mlp(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    ref = fk.fused_mlp_plain(*args, **_fused_kwargs("fused_mlp", torch.bfloat16))
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16, "bf16 x gives a bf16 result")
    check(float((y.float() - ref.float()).abs().max())
          <= 2.0 ** -7 * max(1.0, float(ref.float().abs().max())), "bf16 in/out fused_mlp")
    log("phase 6 passed: B3, B5, B6 agree with their plain versions")
    check_qkv_rows(torch, dev, gen)

    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        _, _, d, n_or_h = next(s for s in FUSED_SHAPES if s[0] == name)
        fn = getattr(fk, name)
        args = _fused_inputs(torch, gen, name, 8, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _fused_kwargs(name, cdt)
            chunk = fn(*args, **kw)
            row = fn(*_rows(args, name, 0, 1), **kw)
            torch.cuda.synchronize()
            check(torch.equal(chunk[:1], row), f"{name} row 0 of M=8 != M=1 ({cdt})")
    # B6 at the prefill's M=32 and B5 at a verify's M=9: rows bitwise M=1
    for name, m, d, n_or_h, rows in (("fused_mlp", 32, 1024, 4096, (0, 5, 31)),
                                     ("fused_block_tail", 9, 512, 1536, (8,))):
        fn = getattr(fk, name)
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _kernel_kwargs(name, cdt)
            chunk = fn(*args, **kw)
            for r in rows:
                row = fn(*_rows(args, name, r, r + 1), **kw)
                torch.cuda.synchronize()
                check(torch.equal(chunk[r:r + 1], row), f"{name} row {r} of M={m} != M=1 "
                      f"({cdt})")
    log("phase 7 passed: row 0 of an M=8 call, rows 0, 5, 31 of B6 at M=32 and row 8 of "
        "B5 at M=9 equal the M=1 calls bitwise")
    check_fused_launch(torch, dev, gen)
    return path_err


def check_qkv_rows(torch, dev, gen) -> None:
    """Phase 7, B3 and B7 at M = 5 (the 8-row tile of a chunk or a verify):
    every row bitwise the M = 1 call of that row, f32 and bf16."""
    from smmb_tpu_torch.kernels import fused_mlp as fk

    for cdt in (torch.float32, torch.bfloat16):
        args = _fused_inputs(torch, gen, "fused_norm_qkv", 5, 1024, 3072, dev)
        kw = _fused_kwargs("fused_norm_qkv", cdt)
        chunk = fk.fused_norm_qkv(*args, **kw)
        for r in range(5):
            row = fk.fused_norm_qkv(*_rows(args, "fused_norm_qkv", r, r + 1), **kw)
            torch.cuda.synchronize()
            check(torch.equal(chunk[r:r + 1], row), f"B3 row {r} of M=5 != M=1 ({cdt})")
        for hd, kvh in ((128, 8), (256, 4)):
            args, kw = _b7_inputs(torch, gen, 5, 1024, kvh, hd, dev)
            kw["compute_dtype"] = cdt
            chunk = fk.fused_norm_qkv_quant(*args, **kw)
            for r in range(5):
                one = fk.fused_norm_qkv_quant(args[0][r:r + 1], *args[1:], **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(a[r:r + 1], b) for a, b in zip(chunk, one)),
                      f"B7 row {r} of M=5 != M=1 (hd {hd}, {cdt})")
    log("B3 (1024x3072) and B7 (hd 128 and 256): every row of M=5 equals the M=1 call "
        "bitwise, f32 and bf16")


def _graph_probe(torch, fn, eager) -> str:
    """Whether ``fn`` (one wrapper call) is captured in a CUDA graph, and,
    if it is, that its replay is bitwise ``eager`` (checked)."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = fn()
    except Exception as exc:
        torch.cuda.synchronize()
        return f"not captured: {type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
    graph.replay()
    torch.cuda.synchronize()
    ys, es = (y, eager) if isinstance(y, tuple) else ((y,), (eager,))
    check(all(torch.equal(a, b) for a, b in zip(ys, es)),
          "a call replayed from a CUDA graph differs from the eager call")
    return "captured and replayed, bitwise the eager call"


def check_fused_launch(torch, dev, gen) -> None:
    """Phase 7, B5 and B6 as one cooperative launch: the output bitwise the
    same at the occupancy grid and at forced grids of 1, 7 and 33 blocks (a
    grid larger than the card holds refused with an error); one kernel event
    a call in the profiler (B3 and B7 too), the launch counter +1 a call;
    and probes, logged, of whether a B5, a B3 and a B7 call can be captured
    in a CUDA graph, whose replay must then be bitwise the eager call."""
    from smmb_tpu_torch.bench.trace import kernel_breakdown
    from smmb_tpu_torch.kernels import fused_mlp as fk

    bf16 = torch.bfloat16
    for name, m, d, n_or_h in (("fused_block_tail", 1, 1024, 4096),
                               ("fused_block_tail", 9, 512, 1536),
                               ("fused_mlp", 32, 1024, 4096), ("fused_mlp", 9, 2048, 8192)):
        fn = getattr(fk, name)
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        grid = fk.items_grid(m, d, n_or_h, d, d if name == "fused_block_tail" else None, dev)
        for cdt in (torch.float32, torch.bfloat16):
            kw = _kernel_kwargs(name, cdt)
            base = fn(*args, **kw)
            for forced in (1, 7, 33, grid):
                y = fn(*args, **kw, _grid=forced)
                torch.cuda.synchronize()
                check(torch.equal(y, base), f"{name} M={m} {d}x{n_or_h} {cdt}: grid {forced} "
                      f"differs from the occupancy grid {grid}")
        try:
            fn(*args, **_kernel_kwargs(name, torch.bfloat16), _grid=1 << 20)
            refused = False
        except RuntimeError:
            refused = True
        check(refused, f"{name}: a grid of 2**20 blocks was not refused")
        log(f"{name} M={m} {d}x{n_or_h}: bitwise equal at grids 1, 7, 33 and {grid}")
    one_kernel = {"fused_block_tail": "mlp_items_kernel", "fused_mlp": "mlp_items_kernel",
                  "fused_norm_qkv": "qkv_items_kernel", "fused_norm_qkv_quant": "qkv_items_kernel"}
    b7_args, b7_kw = _b7_inputs(torch, gen, 1, 1024, 8, 128, dev)
    b7_kw["compute_dtype"] = bf16
    for name, m, d, n_or_h in (("fused_block_tail", 1, 1024, 4096), ("fused_mlp", 32, 1024, 4096),
                               ("fused_norm_qkv", 1, 1024, 3072),
                               ("fused_norm_qkv_quant", 1, 1024, 3072)):
        fn = getattr(fk, name)
        if name == "fused_norm_qkv_quant":
            args, kw = b7_args, b7_kw
        else:
            args, kw = _fused_inputs(torch, gen, name, m, d, n_or_h, dev), _kernel_kwargs(name, bf16)
        calls = [0]

        def call():
            calls[0] += 1
            fn(*args, **kw)

        before = fn.launches
        rows = kernel_breakdown(call, n_calls=5)
        check(fn.launches - before == calls[0], f"{name}: launches counted "
              f"{fn.launches - before} for {calls[0]} calls")
        check([r["name"] for r in rows if one_kernel[name] not in r["name"]] == []
              and sum(r["launches"] for r in rows) == 1, f"{name}: not one kernel a call: {rows}")
    log("B5, B6, B3 and B7: one kernel event a call in the profiler, counted once a call")
    # the probes record whether the card captures a cooperative launch (B5)
    # and a cluster launch (B7)
    args = _fused_inputs(torch, gen, "fused_block_tail", 1, 1024, 4096, dev)
    kw = _fused_kwargs("fused_block_tail", bf16)
    qkv = _fused_inputs(torch, gen, "fused_norm_qkv", 1, 1024, 3072, dev)
    qkw = _fused_kwargs("fused_norm_qkv", bf16)
    for key, fn in (("b5_cuda_graph", lambda: fk.fused_block_tail(*args, **kw)),
                    ("b3_cuda_graph", lambda: fk.fused_norm_qkv(*qkv, **qkw)),
                    ("b7_cuda_graph", lambda: fk.fused_norm_qkv_quant(*b7_args, **b7_kw))):
        probe = _graph_probe(torch, fn, fn())
        print(json.dumps({key: probe}), flush=True)
        log(f"{key}: {probe}")


def _path_shape(name):
    return {"fused_norm_qkv": (1, 1024, 3072), "fused_block_tail": (1, 1024, 4096),
            "fused_mlp": (32, 1024, 4096)}[name]


def run_lm_path(torch, dev) -> dict:
    """Phase 8: ``generate`` at the default ``lm`` configuration."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, run_lm_bench
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, generate

    layers, prompt_len, steps = 4, 32, 64
    cfg = TernaryLMConfig(vocab=8192, d_model=1024, n_heads=8, d_ff=4096,
                          n_layers=layers, max_len=prompt_len + 3 * steps)
    packed, prompt = build_lm(cfg, 1, prompt_len, device=dev)
    bf16 = torch.bfloat16
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, compute_dtype=bf16)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"generate: launches {launches}")
    check(toks.shape == (1, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "generate tokens shape / range")
    check(launches["fused_mlp"] == layers, "B6 launches once per layer in the prefill")
    check(launches["fused_norm_qkv"] == layers * steps, "B3 once per layer per step")
    check(launches["fused_block_tail"] == layers * steps, "B5 once per layer per step")
    # B1: 6 projections per layer in the prefill (k, v for the cache, then
    # q, k, v, o of the forward, as in JAX) + the head once in the prefill
    # and once per step
    b1 = 6 * layers + 1 + steps
    check(launches["packed_spmm"] == b1, f"B1 launches {launches['packed_spmm']} != {b1}")

    # per-step logits, teacher-forced on the kernel path's tokens, against
    # the plain path: the same entry points on the card with each kernel's
    # plain version in its place. This random model's attention scores are
    # in the hundreds, so one ulp of a staged value can move a step's logits
    # by more than one rounding would; the unfused path through plain
    # products (use_kernel=False) measures that spread, and the kernel path
    # may be no farther from the plain path than that spread or the
    # tolerance, with its median step within the tolerance.
    for cdt, tol in ((bf16, 2.0 ** -7), (torch.float32, 1e-4)):
        ids = toks if cdt == bf16 else generate(packed, prompt, cfg, steps,
                                                compute_dtype=cdt)
        call_errs, readings = [], []
        with _held_b1_calls(torch, call_errs, readings):
            kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        # every B1 call on its own input, where rounding cannot compound
        check(len(call_errs) == 6 * layers + steps and max(call_errs) <= tol,
              f"LM {cdt}: {len(call_errs)} B1 calls, worst vs plain {max(call_errs):.3e}")
        if readings:  # f32: C1's reading at the path's shapes, logged
            rms, mx = _c1_ratios(readings)
            log(f"LM f32 path: {len(readings)} B1 calls against f64, B1/library RMS ratio "
                f"at most {rms:.3f}, max ratio at most {mx:.3f} (C1, logged)")
        with plain_kernels():
            plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True)
        unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False)
        check(bool(torch.isfinite(kern).all()), "LM logits finite")
        check(torch.equal(kern.argmax(-1), ids[0]),
              "teacher-forced kernel path reproduces generate's tokens")
        scale = plain.abs().amax(-1).clamp_min(1.0)
        err = (kern - plain).abs().amax(-1) / scale
        spread = (unfused - plain).abs().amax(-1) / scale
        med, worst = float(err.median()), float(err.max())
        check(med <= tol, f"LM {cdt}: median step error {med:.3e} > {tol:.3e}")
        check(worst <= max(tol, float(spread.max())),
              f"LM {cdt}: worst step error {worst:.3e} beyond the tolerance "
              f"{tol:.3e} and the plain orders' spread {float(spread.max()):.3e}")
        top2 = torch.topk(plain, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / scale
        differs = plain.argmax(-1) != ids[0]
        check(not bool((differs & (gap > tol)).any()),
              f"LM {cdt}: a token differs where the plain top-2 gap exceeds {tol:.1e}")
        log(f"LM {cdt} logits vs plain over {steps} steps: median {med:.2e}, worst "
            f"{worst:.2e} (plain orders' spread {float(spread.max()):.2e}, tolerance "
            f"{tol:.1e}); {int(differs.sum())} near-tied tokens differ; "
            f"{len(call_errs)} B1 calls within {max(call_errs):.2e} of plain")
    r = run_lm_bench(cfg, 1, prompt_len, steps, reps=3, device=dev)
    rp = _plain_lm_tokens_time(torch, cfg, packed, prompt, steps)
    print(json.dumps({"lm": "generate", "layers": layers, "d_model": 1024,
                      "d_ff": 4096, "vocab": 8192, "prompt": prompt_len,
                      "steps": steps, "us_per_token": r.per_token_s * 1e6,
                      "tok_per_s": r.tokens_per_s, "lo_ms": r.lo_s * 1e3,
                      "hi_ms": r.hi_s * 1e3, "plain_us_per_token": rp * 1e6,
                      "launches": launches}), flush=True)
    log(f"phase 8 passed: {r.per_token_s * 1e6:.1f} us/token, "
        f"{r.tokens_per_s:.0f} tok/s (plain path {rp * 1e6:.1f} us/token)")
    return {"launches": launches, "cfg": cfg, "packed": packed, "prompt": prompt}


def _teacher_forced(torch, cfg, packed, prompt, ids, cdt, use_kernel, use_flash=False,
                    kv_quant=False, caches=None):
    """(steps, vocab) f32 logits of lm_prefill then lm_decode_step on ``ids``
    (the final caches appended to ``caches`` when it is a list)."""
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    kw = dict(compute_dtype=cdt, use_kernel=use_kernel, use_flash=use_flash)
    cache = lm_init_cache(cfg, prompt.shape[0], dtype=cdt, quantized=kv_quant,
                          device=prompt.device)
    logits, cache = lm_prefill(packed, prompt, cache, cfg, **kw)
    out = [logits]
    for i in range(ids.shape[1] - 1):
        logits, cache = lm_decode_step(packed, ids[:, i], cache, cfg, **kw)
        out.append(logits)
    torch.cuda.synchronize()
    if caches is not None:
        caches.append(cache)
    return torch.stack(out, 1)[0].float()


INT8_REL = 2e-2  # the int8 cache's relative error bound (tests/test_kv_quant.py)


def _code_steps(torch, got, want) -> int:
    """Codes that differ between two int8 LM caches. Layer 0 sees the same
    embeddings on both paths, so each of its codes may differ by one step
    at most (checked): a value whose f32 sums, taken in two orders, fall on
    either side of a rounding edge. Later layers see the upstream
    difference as well."""
    d0 = (got[0]["kv"].int() - want[0]["kv"].int()).abs()
    check(int(d0.max()) <= 1, f"layer 0's int8 caches differ by {int(d0.max())} codes")
    return sum(int((g["kv"] != w["kv"]).sum()) for g, w in zip(got, want))


@contextlib.contextmanager
def plain_kernels():
    """The LM path's kernels replaced by their plain versions, for the
    reference runs of phases 8, 12 and 18 (the wrappers themselves launch on any
    CUDA tensor); the launch counts do not move."""
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_plain
    from smmb_tpu_torch.models import attention, lm, moe, transformer

    def plain_of(fn):
        return lambda *a, block_h=None, block_n=None, **k: fn(*a, **k)

    swaps = [(fk, n, plain_of(getattr(fk, n + "_plain")))
             for n in ("fused_norm_qkv", "fused_norm_qkv_quant", "fused_block_tail",
                       "fused_mlp")]
    swaps += [(fd, n, getattr(fd, n + "_plain"))
              for n in ("flash_attention_decode", "flash_attention_chunk",
                        "flash_attention_decode_quant", "flash_attention_chunk_quant")]
    swaps += [(fa, "flash_attention", fa.flash_attention_plain)]
    swaps += [(m, "packed_spmm", packed_spmm_plain)
              for m in (attention, transformer, lm, moe)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _plain_lm_tokens_time(torch, cfg, packed, prompt, steps) -> float:
    """µs/token slope of ``generate(use_kernel=False)`` on the card (the
    unfused path through the plain PyTorch products), as lm_bench times the
    kernel path."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.models.lm import generate

    def timed(n):
        return measure(lambda: generate(packed, prompt, cfg, n,
                                        compute_dtype=torch.bfloat16,
                                        use_kernel=False), reps=3).min_s

    return (timed(3 * steps) - timed(steps)) / (2 * steps)


def time_fused_kernels(torch, dev, spec, path_err, lm) -> list:
    """Phase 9: each fused kernel at the path's shape, bf16 compute."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = rng.make_generator(5, dev)
    sources = {"fused_norm_qkv": ":332", "fused_block_tail": ":707", "fused_mlp": ":195"}
    per_launch = {"fused_norm_qkv": "per decode step (4 layers)",
                  "fused_block_tail": "per decode step (4 layers)",
                  "fused_mlp": "per 32-token prefill (4 layers)"}
    rows = []
    for name in ("fused_norm_qkv", "fused_block_tail", "fused_mlp"):
        m, d, n_or_h = _path_shape(name)
        args = _fused_inputs(torch, gen, name, m, d, n_or_h, dev)
        kw = _fused_kwargs(name, torch.bfloat16)
        fn, plain = getattr(fk, name), getattr(fk, name + "_plain")
        t_kernel = measure(lambda: fn(*args, **kw))
        t_plain = measure(lambda: plain(*args, **kw))
        planes = [a for a in args if hasattr(a, "weight_bytes")]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out = fn(*args, **kw)
        n_bytes = (sum(p.weight_bytes() for p in planes)
                   + sum(t.numel() * t.element_size() for t in tensors)
                   + out.numel() * out.element_size())
        nnz = [int(torch.count_nonzero(unpack_ternary(p))) for p in planes]
        ops = 2.0 * m * sum(nnz)  # the ±1 entries this data holds, per row
        bound_s, bound_by = roofline_bound(ops, n_bytes, spec, "bf16")
        # library yardstick: torch.matmul on the pre-decoded dense bf16
        # weights, one call per product of the kernel, times summed; and
        # both sides' device time alone by the profiler (the per-call time
        # of an M=1 call is the host's)
        dense = [unpack_ternary(p, torch.bfloat16) for p in planes]
        t_lib, dev_lib = 0.0, 0.0
        for w in dense:
            a = rng.rand_dense(gen, (m, w.shape[0]), dtype=torch.bfloat16)
            t_lib += measure(torch.matmul, a, w).min_s
            dev_lib += _device_us(lambda: torch.matmul(a, w))
        dev_k = _device_us(lambda: fn(*args, **kw))
        row = {
            "name": name, "route": "cuda",
            "source": "smmb_tpu_torch/kernels/csrc/fused_mlp.cu",
            "replaces": "smmb_tpu/kernels/fused_mlp.py" + sources[name],
            "launches": lm["launches"][name], "max_abs_err": path_err[name],
            "ms": t_kernel.min_s * 1e3, "plain_ms": t_plain.min_s * 1e3,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": t_lib * 1e3, "device_us": dev_k, "library_device_us": dev_lib,
        }
        row["design"] = QKV_DESIGN if name == "fused_norm_qkv" else FUSED_DESIGN
        print(json.dumps({**row, "parent_device_us_recorded": FUSED_PARENT_US[name],
                          "shape": [m, d, n_or_h], "bytes": n_bytes,
                          "ops": ops, "mean_ms": t_kernel.mean_s * 1e3,
                          "launches_are": per_launch[name],
                          "library": f"torch.matmul bf16 on pre-decoded dense W, "
                                     f"sum of {len(dense)} products"}), flush=True)
        rows.append(row)
    log("phase 9 passed: fused kernels timed at the path shapes; device us now / the "
        "earlier kernels' / torch.matmul's: " + ", ".join(
            f"{r['name']} {r['device_us']:.2f} / {FUSED_PARENT_US[r['name']]} / "
            f"{r['library_device_us']:.2f}" for r in rows))
    return rows


# ---------------------------------------------------------- flash slice
# B4 at the shapes of the paths: (label, B, H, KVH, S, pos, window); hd 128
# (the split spans 64 columns at S = 224 and 1024, 256 at S = 8192: the
# chunks at pos - 4 .. pos of "span edge", "decode bench" and "long
# straddle" cross a span boundary, and the window of 1000 at pos 8191 has
# its edge inside a span)
FLASH_DECODE_SHAPES = [
    ("lm path", 1, 8, 8, 224, 32, None), ("lm path", 1, 8, 8, 224, 95, None),
    ("span edge", 1, 8, 8, 224, 66, None),
    ("decode bench", 1, 8, 8, 1024, 512, None), ("GQA 8/2", 1, 8, 2, 1024, 512, None),
    ("window 64", 1, 8, 8, 1024, 512, 64), ("B=4", 4, 8, 8, 1024, 512, None),
    ("long", 1, 8, 8, 8192, 8191, None), ("long straddle", 1, 8, 8, 8192, 7938, None),
    ("long GQA 8/2 window 1000", 1, 8, 2, 8192, 8191, 1000),
    ("long B=4", 4, 8, 8, 8192, 8191, None),
]
# B9: (label, B, H, KVH, T, hd, causal, window); hd 256 and 512 take the
# kernel's 32- and 16-row tiles
FLASH_PREFILL_SHAPES = [
    ("lm prefill", 1, 8, 8, 32, 128, True, None),
    ("T=512 causal", 1, 8, 8, 512, 128, True, None),
    ("T=200", 1, 8, 8, 200, 128, True, None), ("GQA 8/2", 1, 8, 2, 512, 128, True, None),
    ("window 64", 1, 8, 8, 512, 128, True, 64),
    ("non-causal", 1, 8, 8, 256, 128, False, None), ("hd=64", 1, 8, 8, 256, 64, True, None),
    ("hd=256", 1, 4, 4, 200, 256, True, None), ("hd=512", 1, 2, 2, 100, 512, True, None),
]


def _route(route) -> str:
    """A kernel_route result as a log phrase: body and tile."""
    return f"{route.body} body, tile {route.tile}"


def _held(torch, name, y, ref, tol, what) -> float:
    """Max abs error of a kernel's result against its plain version, checked
    against ``tol`` relative to max(1, max|ref|)."""
    torch.cuda.synchronize()
    check(y.shape == ref.shape and y.dtype == ref.dtype, f"{name} shape/dtype {what}")
    check(bool(torch.isfinite(y).all()), f"{name} non-finite {what}")
    err = float((y.float() - ref.float()).abs().max())
    lim = tol * max(1.0, float(ref.float().abs().max()))
    check(err <= lim, f"{name} kernel vs plain {what}: err {err:.3e} > {lim:.3e}")
    return err


def _decode_blocks(fd, b, kvh, s, pos, window, nq=1) -> int:
    """Blocks of one B4/B8 launch: (live spans, KVH, B)."""
    return fd.live_spans(pos, nq, window, fd.split_cols(s))[1] * kvh * b


def _decode_inputs(torch, gen, b, nq, h, kvh, s, cache_dtype):
    """q (B, nq, H, 128) f32 (as B3 gives it, scaled so that the softmax
    has peaks) and random flat (B, S, KVH·128) caches."""
    from smmb_tpu_torch.utils import rng

    q = rng.rand_dense(gen, (b, nq, h, 128)) * 8.0
    kc = rng.rand_dense(gen, (b, s, kvh * 128), dtype=cache_dtype)
    vc = rng.rand_dense(gen, (b, s, kvh * 128), dtype=cache_dtype)
    return q, kc, vc


def check_flash_kernels(torch, dev) -> dict:
    """Phases 10 and 11. Returns the max abs errors at the path shapes."""
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.utils import rng

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (f32 sums in another
    # order than the plain version's exact products, exp2 within 2 ulp);
    # bf16 2**-7 (a p or an output can round to the neighbouring bf16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(91, dev)
    dec = fd.flash_attention_decode
    errs = {}
    for label, b, h, kvh, s, pos, window in FLASH_DECODE_SHAPES:
        for cdt in (torch.float32, torch.bfloat16):
            q, kc, vc = _decode_inputs(torch, gen, b, 5, h, kvh, s, cdt)
            kw = dict(window=window, compute_dtype=cdt)
            what = f"{label} pos {pos} {cdt}"
            before = dec.launches
            y = dec(q[:, 0], kc, vc, pos, **kw)
            check(dec.launches == before + 1, f"B4 launch count {what}")
            err = _held(torch, "B4", y, fd.flash_attention_decode_plain(
                q[:, 0], kc, vc, pos, **kw), tol[cdt], what)
            if (label, pos, cdt) == ("lm path", 95, torch.bfloat16):
                errs["flash_attention_decode"] = err
            # chunk rows pos-4 .. pos against the decode steps, bitwise
            chunk = fd.flash_attention_chunk(q, kc, vc, pos - 4, **kw)
            check(dec.launches == before + 2, f"B4 chunk launch count {what}")
            _held(torch, "B4 chunk", chunk, fd.flash_attention_chunk_plain(
                q, kc, vc, pos - 4, **kw), tol[cdt], what)
            for c in range(5):
                solo = dec(q[:, c], kc, vc, pos - 4 + c, **kw)
                check(torch.equal(chunk[:, c], solo), f"B4 chunk row {c} != decode {what}")
            for r in range(b if b > 1 else 0):
                row = dec(q[r:r + 1, 0], kc[r:r + 1], vc[r:r + 1], pos, **kw)
                check(torch.equal(y[r:r + 1], row), f"B4 batch row {r} != alone {what}")
        blocks = _decode_blocks(fd, b, kvh, s, pos, window)
        check(label != "long" or blocks >= 128, f"B4 {label}: {blocks} blocks")
        log(f"B4 == plain at {label}, B={b} H={h} KVH={kvh} S={s} pos={pos} "
            f"window={window} ({blocks} blocks) in f32 and bf16; chunk and batch rows "
            "bitwise")
    log("phase 10 passed: B4 agrees with its plain version, rows bitwise")

    for label, b, h, kvh, t, hd, causal, window in FLASH_PREFILL_SHAPES:
        routes = {}
        for dt in (torch.float32, torch.bfloat16):
            routes[dt] = fa.kernel_route(dt, hd)
            q = (rng.rand_dense(gen, (b, t, h, hd)) * 4.0).to(dt).permute(0, 2, 1, 3)
            k = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            v = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            kw = dict(causal=causal, window=window)
            before = fa.flash_attention.launches
            y = fa.flash_attention(q, k, v, **kw)
            check(fa.flash_attention.launches == before + 1, f"B9 launch count {label}")
            err = _held(torch, "B9", y, fa.flash_attention_plain(q, k, v, **kw), tol[dt],
                        f"{label} {dt}")
            if (label, dt) == ("lm prefill", torch.float32):
                errs["flash_attention"] = err
        log(f"B9 == plain at {label} (B={b} H={h} KVH={kvh} T={t} hd={hd} "
            f"causal={causal} window={window}) in f32 ({_route(routes[torch.float32])}) "
            f"and bf16 ({_route(routes[torch.bfloat16])})")
    log("phase 11 passed: B9 agrees with its plain version")
    return errs


def run_flash_lm_path(torch, dev, lm) -> dict:
    """Phase 12: the flash LM path at the ``lm`` defaults."""
    from smmb_tpu_torch.bench.decode_bench import run_decode_bench
    from smmb_tpu_torch.bench.lm_bench import parser, run_lm_bench
    from smmb_tpu_torch.bench.trace import lm_decode_step_fn, report
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import (
        generate,
        lm_init_cache,
        lm_prefill,
        lm_prefill_chunked,
    )
    from smmb_tpu_torch.models.transformer import (
        block_decode_step,
        block_extend,
        block_prefill,
        init_block_cache,
    )
    from smmb_tpu_torch.utils import rng

    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]
    layers, steps = cfg.n_layers, 64
    bf16, f32 = torch.bfloat16, torch.float32
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp,
               fa.flash_attention, fd.flash_attention_decode)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, compute_dtype=bf16, use_flash=True)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"generate(use_flash=True): launches {launches}")
    check(toks.shape == (1, steps) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, "flash generate tokens shape / range")
    check(launches["flash_attention"] == layers, "B9 once per layer in the prefill")
    check(launches["flash_attention_decode"] == layers * steps, "B4 once per layer per step")
    check(launches["fused_norm_qkv"] == layers * steps, "B3 once per layer per step")
    check(launches["fused_block_tail"] == layers * steps, "B5 once per layer per step")
    check(launches["fused_mlp"] == layers, "B6 once per layer in the prefill")
    check(launches["packed_spmm"] == 6 * layers + 1 + steps, "B1 as without flash")

    # teacher-forced logits against the plain path, bounded as in phase 8;
    # the spread is the unfused plain path's (no kernel at all) distance
    for cdt, tol in ((bf16, 2.0 ** -7), (f32, 1e-4)):
        ids = toks if cdt == bf16 else generate(packed, prompt, cfg, steps,
                                                compute_dtype=cdt, use_flash=True)
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, True)
        with plain_kernels():
            plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, True)
            unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False, True)
        check(bool(torch.isfinite(kern).all()), "flash LM logits finite")
        check(torch.equal(kern.argmax(-1), ids[0]),
              "teacher-forced flash path reproduces generate's tokens")
        scale = plain.abs().amax(-1).clamp_min(1.0)
        err = (kern - plain).abs().amax(-1) / scale
        spread = (unfused - plain).abs().amax(-1) / scale
        med, worst = float(err.median()), float(err.max())
        check(med <= tol, f"flash LM {cdt}: median step error {med:.3e} > {tol:.3e}")
        check(worst <= max(tol, float(spread.max())),
              f"flash LM {cdt}: worst step error {worst:.3e} beyond {tol:.3e} and the "
              f"plain orders' spread {float(spread.max()):.3e}")
        log(f"flash LM {cdt} logits vs plain over {steps} steps: median {med:.2e}, "
            f"worst {worst:.2e} (spread {float(spread.max()):.2e}, tolerance {tol:.1e})")

    # chunked prefill (B3, B4's chunk entry and B5 at M=8) against lm_prefill
    def prefill(fn, *a, **kw):
        cache = lm_init_cache(cfg, 1, dtype=f32, device=dev)
        return fn(packed, prompt, cache, cfg, *a, compute_dtype=f32, **kw)[0].float()

    before = fd.flash_attention_decode.launches
    chunked = prefill(lm_prefill_chunked, 8, use_flash=True)
    check(fd.flash_attention_decode.launches == before + layers * prompt.shape[1] // 8,
          "lm_prefill_chunked runs B4's chunk entry once per layer per chunk")
    whole = prefill(lm_prefill, use_flash=True)
    with plain_kernels():
        unfused = prefill(lm_prefill, use_kernel=False, use_flash=True)
    scale = max(1.0, float(whole.abs().max()))
    err, spread = float((chunked - whole).abs().max()) / scale, \
        float((unfused - whole).abs().max()) / scale
    check(torch.equal(chunked.argmax(-1), whole.argmax(-1)), "chunked prefill argmax")
    check(err <= max(1e-4, spread), f"chunked prefill vs lm_prefill: {err:.3e} beyond "
          f"1e-4 and the plain orders' spread {spread:.3e}")
    log(f"lm_prefill_chunked(8, flash) vs lm_prefill, f32: {err:.2e} of max|logits| "
        f"(spread {spread:.2e})")

    # block_extend with C=4 against four decode steps: bitwise per row
    bcfg, blk = cfg.block, packed["blocks"][0]
    x = rng.rand_dense(rng.make_generator(17, dev), (1, 36, cfg.d_model))
    kw = dict(compute_dtype=f32, use_flash=True)
    c1 = init_block_cache(bcfg, 1, cfg.max_len, dtype=f32, device=dev)
    _, c1 = block_prefill(blk, x[:, :32], c1, bcfg, **kw)
    c2 = {**c1, "k": c1["k"].clone(), "v": c1["v"].clone()}
    ext, c1 = block_extend(blk, x[:, 32:], c1, bcfg, **kw)
    for i in range(4):
        step, c2 = block_decode_step(blk, x[:, 32 + i:33 + i], c2, bcfg, **kw)
        torch.cuda.synchronize()
        check(torch.equal(ext[:, i], step[:, 0]), f"block_extend row {i} != decode step")
    check(torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"]),
          "block_extend and the decode steps write the same cache")
    log("block_extend (C=4, flash, f32) equals four block_decode_steps bitwise per row")

    out = {"launches": launches}
    runs = {}
    for flash in (False, True, True, False):  # alternating: the host's load drifts
        r = run_lm_bench(cfg, 1, prompt.shape[1], steps, reps=3, device=dev,
                         use_flash=flash)
        runs.setdefault(flash, []).append(r.per_token_s * 1e6)
    for flash in (False, True):
        d = run_decode_bench(device=dev, use_flash=flash)
        args = parser().parse_args(["--flash"] if flash else [])
        tr = report(lm_decode_step_fn(args), {"call": "lm_decode_step", "flash": flash,
                                              "pos": args.prompt_len})
        row = {"flash": flash, "lm_us_per_token": runs[flash],
               "decode_step_us": d.step_s * 1e6, "decode_frac_roofline": d.frac_roofline,
               "decode_prefill_us": d.prefill_s * 1e6, "trace_launches": tr["launches"],
               "trace_call_us": tr["call_us"], "trace_kernel_us": tr["kernel_us"],
               "trace_busy_share": tr["busy_share"],
               "trace_flash_decode_us": _kernel_us(tr, "flash_decode_kernel"),
               **_fused_step(tr)}
        print(json.dumps(row), flush=True)
        out[flash] = row
    log(f"phase 12 passed: flash step {out[True]['trace_launches']:.0f} launches, "
        f"{out[True]['trace_kernel_us']:.1f} us of device time (B4 "
        f"{out[True]['trace_flash_decode_us']:.1f}, B5 {out[True]['trace_b5_us']:.1f} in "
        f"{out[True]['trace_b5_launches']:.0f} launches, B3/B7 {out[True]['trace_qkv_us']:.1f} "
        f"in {out[True]['trace_qkv_launches']:.0f}), busy "
        f"{out[True]['trace_busy_share']:.3f} (without flash "
        f"{out[False]['trace_launches']:.0f}, {out[False]['trace_kernel_us']:.1f} us, "
        f"{out[False]['trace_busy_share']:.3f})")
    return out


def time_flash_kernels(torch, dev, spec, errs, flash) -> list:
    """Phase 13: B4 and B9 at the path shapes and one long shape each."""
    import torch.nn.functional as F

    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.utils import rng

    gen = rng.make_generator(23, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    rows, summary = [], []

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # B4: bf16 cache and compute, q in f32 as B3 gives it
    for label, b, h, kvh, s, pos in (("lm path", 1, 8, 8, 224, 95),
                                     ("long", 1, 8, 8, 8192, 8191)):
        q, kc, vc = _decode_inputs(torch, gen, b, 1, h, kvh, s, bf16)
        q = q[:, 0]
        kw = dict(compute_dtype=bf16)
        t_k = measure(lambda: fd.flash_attention_decode(q, kc, vc, pos, **kw))
        t_p = measure(lambda: fd.flash_attention_decode_plain(q, kc, vc, pos, **kw))
        live = pos + 1
        kl = kc[:, :live].view(b, live, kvh, 128).transpose(1, 2)
        vl = vc[:, :live].view(b, live, kvh, 128).transpose(1, 2)
        qb = q.to(bf16)[:, :, None]
        gqa = {"enable_gqa": True} if kvh < h else {}
        t_l = measure(lambda: F.scaled_dot_product_attention(qb, kl, vl, **gqa))
        # device time alone (the per-call time is the host's at these shapes)
        dev_k = _device_us(lambda: fd.flash_attention_decode(q, kc, vc, pos, **kw))
        dev_l = _device_us(lambda: F.scaled_dot_product_attention(qb, kl, vl, **gqa))
        out = fd.flash_attention_decode(q, kc, vc, pos, **kw)
        n_bytes = nbytes(q, kl, vl, out)
        bound, by = roofline_bound(4.0 * b * h * live * 128, n_bytes, spec, "bf16")
        rows.append({"kernel": "B4 flash_attention_decode", "shape": label,
                     "B": b, "H": h, "KVH": kvh, "S": s, "pos": pos,
                     "blocks": _decode_blocks(fd, b, kvh, s, pos, None),
                     "ms": t_k.min_s * 1e3, "mean_ms": t_k.mean_s * 1e3,
                     "device_us": dev_k, "plain_ms": t_p.min_s * 1e3,
                     "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes,
                     "library_ms": t_l.min_s * 1e3, "library_device_us": dev_l})
        if label == "long":
            rows[-1]["unsplit_ms"] = FLASH_DECODE_UNSPLIT_MS["B4"]
    # B9: the path's prefill in f32 (its projections are f32), the decode
    # bench's prompt and the long in f32 (the CUDA-core body) and the long in
    # bf16 (the mma body), causal (the triangular walk) and not (every kv
    # tile); SDPA in f32 with TF32 off
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for label, b, h, t, dt, causal in (("lm prefill", 1, 8, 32, f32, True),
                                       ("T=512 f32", 1, 8, 512, f32, True),
                                       ("long f32", 1, 8, 4096, f32, True),
                                       ("long", 1, 8, 4096, bf16, True),
                                       ("long non-causal", 1, 8, 4096, bf16, False)):
        q = (rng.rand_dense(gen, (b, h, t, 128)) * 4.0).to(dt)
        k = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        v = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        route = fa.kernel_route(dt, 128)
        if t > 32:  # hold the long rows too: f32 1e-4, bf16 2**-7 of max(1, max|Y|)
            _held(torch, "B9", fa.flash_attention(q, k, v, causal=causal),
                  fa.flash_attention_plain(q, k, v, causal=causal),
                  2.0 ** -7 if dt == bf16 else 1e-4, label)
        t_k = measure(lambda: fa.flash_attention(q, k, v, causal=causal))
        t_p = measure(lambda: fa.flash_attention_plain(q, k, v, causal=causal))
        t_l = measure(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        n = 10 if t == 4096 else 30
        dev_k = _device_us(lambda: fa.flash_attention(q, k, v, causal=causal), n)
        dev_l = _device_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), n)
        n_bytes = 2 * nbytes(q) + nbytes(k, v)
        ops = 4.0 * b * h * 128 * t * ((t + 1) / 2 if causal else t)
        bound, by = roofline_bound(ops, n_bytes, spec, "f32" if dt == f32 else "bf16")
        rows.append({"kernel": "B9 flash_attention", "shape": label, "B": b, "H": h,
                     "T": t, "dtype": str(dt), "causal": causal, "body": route.body,
                     "tile": route.tile, "ms": t_k.min_s * 1e3,
                     "mean_ms": t_k.mean_s * 1e3, "device_us": dev_k,
                     "plain_ms": t_p.min_s * 1e3, "bound_ms": bound * 1e3, "bound_by": by,
                     "bytes": n_bytes, "ops": ops, "library_ms": t_l.min_s * 1e3,
                     "library_device_us": dev_l})
        if route.body == "cuda_core":
            rows[-1]["row_tile"] = fa.row_tile(dt, 128, b, h, h, t, sms=fa._sms(dev.index or 0))
            rows[-1]["parent_device_us"] = B9_PARENT_US[label]
        if label == "long":
            rows[-1]["cuda_core_ms"] = B9_CUDA_CORE_MS["serial"]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for r in rows:
        print(json.dumps({**r, "library": "torch.nn.functional.scaled_dot_product_attention"}),
              flush=True)
    b4 = {r["shape"]: r for r in rows if r["kernel"].startswith("B4")}
    log("B4 (bf16, B=1, H=KVH=8): " + "; ".join(
        f"{k} pos {r['pos']} of S={r['S']}, {r['blocks']} blocks: {r['ms']:.4f} ms a call, "
        f"{r['device_us']:.2f} us on the device (SDPA {r['library_ms']:.4f} ms, "
        f"{r['library_device_us']:.2f} us; bound {r['bound_ms'] * 1e3:.2f} us)"
        for k, r in b4.items()) + f"; unsplit at pos 8191: {FLASH_DECODE_UNSPLIT_MS['B4']} ms")
    b9 = {r["shape"]: r for r in rows if r["kernel"].startswith("B9")}
    log("B9 f32 (CUDA-core body; B=1, H=8, hd 128, causal): " + "; ".join(
        f"T={r['T']}: {r['ms']:.4f} ms a call, {r['device_us']:.2f} us on the device "
        f"({r['row_tile']}-row blocks; the earlier body's {r['parent_device_us']} us; SDPA f32 "
        f"{r['library_device_us']:.2f} us; bound {r['bound_ms'] * 1e3:.2f} us)"
        for r in b9.values() if r["body"] == "cuda_core"))
    log(f"B9 at T=4096 bf16 ({b9['long']['body']} body): causal {b9['long']['ms']:.4f} ms "
        f"(the CUDA-core body's: {B9_CUDA_CORE_MS['serial']} ms; SDPA "
        f"{b9['long']['library_ms']:.4f}, bound {b9['long']['bound_ms']:.4f}), non-causal "
        f"{b9['long non-causal']['ms']:.4f} ms (SDPA "
        f"{b9['long non-causal']['library_ms']:.4f}, bound "
        f"{b9['long non-causal']['bound_ms']:.4f})")
    for name, src, line, row in (
            ("flash_attention_decode", "flash_decode", "flash_decode.py:412", rows[0]),
            ("flash_attention", "flash_attention", "flash_attention.py:662",
             b9["lm prefill"])):
        summary.append({
            "name": name, "route": "cuda",
            "source": f"smmb_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"smmb_tpu/kernels/{line}",
            "launches": flash["launches"][name], "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    summary[0].update(design=FLASH_DECODE_DESIGN, device_us=b4["lm path"]["device_us"],
                      long_ms=b4["long"]["ms"], long_device_us=b4["long"]["device_us"])
    summary[-1].update(design="mma.sync (bf16, hd 64 and 128); CUDA cores (f32, others): "
                              "register micro-tiles, the first port's outputs bitwise",
                       device_us=b9["lm prefill"]["device_us"],
                       long_f32_ms=b9["long f32"]["ms"],
                       long_f32_device_us=b9["long f32"]["device_us"],
                       long_bf16_ms=b9["long"]["ms"])
    log("phase 13 passed: B4 and B9 timed at the path and long shapes")
    return summary

# ------------------------------------------------ reference-benchmark slice
def _bcsr_case(torch, gen, k, n, r, c, keep, non_zero, dev):
    """A block-sparse ternary (K, N) matrix, its prepared BCSR, and a bias."""
    from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
    from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_prepare
    from smmb_tpu_torch.utils import rng

    w = rng.rand_block_ternary(gen, (k, n), block=(r, c), keep=keep, non_zero=non_zero)
    prep = bcsr_prepare(bcsr_from_dense(w, r, c, device=dev), device=dev)
    return w, prep, rng.rand_dense(gen, (n,))


# B2's shapes: (label, M, K, N, r, c, keep, non_zero, block_m)
BCSR_SHAPES = [
    ("test 8x128 blocks", 16, 512, 512, 8, 128, 0.3, 2, 256),
    ("128x128 blocks, M=100", 100, 512, 1024, 128, 128, 0.4, 2, 256),
    ("M=140, block_m=64", 140, 256, 512, 8, 128, 0.3, 2, 64),
    ("64x128 blocks", 8, 512, 512, 64, 128, 0.5, 2, 256),
    ("256x128 blocks", 5, 1024, 512, 256, 128, 0.5, 2, 256),
    ("showcase 256x1024x4096", 256, 1024, 4096, 128, 128, 1.0, 2, 256),
    ("block-sparse 256x4096x4096", 256, 4096, 4096, 128, 128, 0.3, 10, 256),
    ("showcase 64x1024x4096", 64, 1024, 4096, 128, 128, 1.0, 2, 256),
    ("showcase 1x1024x4096", 1, 1024, 4096, 128, 128, 1.0, 2, 256),
]
# the shapes phase 16 times; the first is the main path's (the showcase's
# largest case, f32, as run_showcase runs it)
BCSR_TIMED = ("showcase 256x1024x4096", "block-sparse 256x4096x4096", "showcase 64x1024x4096",
              "showcase 1x1024x4096")
# B2's times before its tensor-core redesign: the CUDA-core body, measured
# by this script's phase 16 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's
# B2 row); recorded, not measured by this run, so phase 16's rows carry them
# as ``parent_ms_recorded`` and the kernels line leaves them out
BCSR_PARENT_MS = {("showcase 256x1024x4096", "f32"): 0.1329,
                  ("showcase 256x1024x4096", "bf16"): 0.1303,
                  ("block-sparse 256x4096x4096", "f32"): 0.2068,
                  ("block-sparse 256x4096x4096", "bf16"): 0.2089}
BCSR_DESIGN = ("128x128 blocks: mma.sync, f32 X split into three exact bf16 passes, "
               "per-block hi and mid+lo sums folded with __fadd_rn; bf16 one pass; "
               "4- and 8-row blocks: CUDA cores")


def check_bcsr_kernel(torch, dev) -> dict:
    """Phase 14. Returns {(label, dtype): max abs error with bias and PReLU}."""
    from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
    from smmb_tpu_torch.kernels.bcsr_spmm import (
        MMA_TILES,
        _launch,
        bcsr_prepare,
        bcsr_route,
        bcsr_spmm_kernel,
        bcsr_spmm_kernel_plain,
        bcsr_tile,
    )
    from smmb_tpu_torch.ops.dense import gemm
    from smmb_tpu_torch.utils import rng
    from smmb_tpu_torch.utils.compare import TOL_DENSE

    # tolerances, relative to max(1, max|Y|): f32 1e-4 (exact products
    # summed in f32 in another order than the plain version's product);
    # bf16 2**-7 (the same f32 sums rounded once to bf16 differ by at most
    # one bf16 ulp)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(55, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    for label, m, k, n, r, c, keep, nz, block_m in BCSR_SHAPES:
        w, prep, b = _bcsr_case(torch, gen, k, n, r, c, keep, nz, dev)
        check(prep.k > 0, f"B2 {label}: no stored block")
        route = bcsr_route(r, c)
        check(route == ("mma" if r % 64 == 0 else "cuda_core"), f"B2 route {label}")
        for dt in (torch.float32, torch.bfloat16):
            x = rng.rand_dense(gen, (m, k), dtype=dt)
            for bias, alpha in ((b, ALPHA), (None, None)):
                what = f"{label} {dt} bias={bias is not None}"
                before = bcsr_spmm_kernel.launches
                y = bcsr_spmm_kernel(x, prep, bias, alpha, block_m=block_m)
                check(bcsr_spmm_kernel.launches == before + 1, f"B2 launch count {what}")
                err = _held(torch, "B2", y, bcsr_spmm_kernel_plain(x, prep, bias, alpha),
                            tol[dt], what)
                if bias is not None:
                    errs[(label, dt)] = err
                for resident in (True, False):
                    again = bcsr_spmm_kernel(x, prep, bias, alpha, block_m=block_m,
                                             x_resident=resident)
                    torch.cuda.synchronize()
                    check(torch.equal(again, y), f"B2 x_resident={resident} != default {what}")
            if route == "mma" and m == 256:
                # no split of K: rows of M-row calls are the M=1 calls, bitwise,
                # under the tile bcsr_tile picks and under every tile at M=256
                ones = torch.cat([bcsr_spmm_kernel(x[i:i + 1], prep, b, ALPHA)
                                  for i in range(m)])
                for rows in (2, 5, 16, 17, 64, 256):
                    y = bcsr_spmm_kernel(x[:rows], prep, b, ALPHA)
                    torch.cuda.synchronize()
                    check(torch.equal(y, ones[:rows]), f"B2 rows of M={rows} != M=1 "
                          f"calls {label} {dt} (tile {bcsr_tile(rows, n, c, sms)})")
                for tile in MMA_TILES:  # the C entry under a forced tile
                    y = _launch(x, prep, b, ALPHA, tile)
                    torch.cuda.synchronize()
                    check(torch.equal(y, ones), f"B2 tile {tile} != M=1 calls {label} {dt}")
            if route == "mma" and m == 256 and dt == torch.float32:
                # the showcase's own check: absolute TOL_DENSE against the dense
                # oracle (an f32 product with its own rounding; the f64 one beside)
                y = bcsr_spmm_kernel(x, prep, b)
                dense_err = float((y - gemm(x, w, b)).abs().max())
                check(dense_err <= TOL_DENSE, f"B2 {label} f32 vs gemm: {dense_err:.3e} > "
                      f"TOL_DENSE {TOL_DENSE}")
                exact_err = float((y.double() - (x.double() @ w.double() + b.double()))
                                  .abs().max())
                log(f"B2 {label} f32: max abs err {dense_err:.3e} against gemm "
                    f"(TOL_DENSE {TOL_DENSE}), {exact_err:.3e} against the f64 product; "
                    "rows of M = 2..256 and every tile bitwise the M=1 calls in f32 and bf16")
        log(f"B2 == plain at {label} (M={m}, K={k}, N={n}, {r}x{c} blocks, "
            f"{prep.k} stored; route {route}"
            + (f", tile {bcsr_tile(m, n, c, sms)}" if route == "mma" else "")
            + ") in f32 and bf16; x_resident bitwise")
    # the empty matrix: no launch, the activated bias
    prep = bcsr_prepare(bcsr_from_dense(torch.zeros(256, 256), 8, 128, device=dev), device=dev)
    b = torch.arange(256, dtype=torch.float32, device=dev) - 128.0
    before = bcsr_spmm_kernel.launches
    y = bcsr_spmm_kernel(torch.ones(4, 256, device=dev), prep, b, alpha=ALPHA)
    check(bcsr_spmm_kernel.launches == before, "B2 launched on an empty matrix")
    check(torch.equal(y, torch.where(b > 0, b, ALPHA * b).expand(4, 256)),
          "B2 empty matrix gives the activated bias")
    log("phase 14 passed: B2 agrees with its plain version; the empty matrix "
        "launches nothing")
    return errs


def run_reference_benchmark(torch, dev) -> dict:
    """Phase 15: the showcase (counted), a sweep slice, the capacity case."""
    import dataclasses

    from smmb_tpu_torch.bench import capacity, sweep
    from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_spmm_kernel
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

    def held(results, what):
        for r in results:
            row = dataclasses.asdict(r)
            print(json.dumps({"bench": what, **row}), flush=True)
            check(r.valid and r.time_s == r.time_s and r.time_s > 0,
                  f"{what}: row {r.case} {r.kernel} invalid or untimed")

    counted = (bcsr_spmm_kernel, packed_spmm)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t = time.time()
    results = sweep.run_showcase()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"showcase: {len(results)} rows in {time.time() - t:.1f}s, launches {launches}")
    held(results, "showcase")
    log("showcase bcsr_kernel max_err: " + ", ".join(
        f"{r.case} {r.max_err:.3e}" for r in results if r.kernel == "bcsr_kernel"))
    cases = [f"{m}x{k}x{n}@0.50" for m, k, n in sweep.SHOWCASE_CASES]
    for case in cases:
        names = {r.kernel for r in results if r.case == case}
        check("bcsr_kernel" in names, f"showcase {case} has no bcsr_kernel row")
    check(all(v > 0 for v in launches.values()), f"showcase launches {launches}")
    showcase_b2 = {r.case: r for r in results if r.kernel == "bcsr_kernel"}

    t = time.time()
    swept = sweep.run_sweep(ms=[64], ks=[1024], ns=[2048], reps=3)
    held(swept, "sweep")
    log("sweep bcsr_kernel max_err: " + ", ".join(
        f"{r.case} {r.max_err:.3e}" for r in swept if r.kernel == "bcsr_kernel"))
    log(f"sweep slice (64x1024x2048 at 1/2, 1/8, 1/16) in {time.time() - t:.1f}s")

    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    held(capacity.run_capacity_case(64000, 16384, 4096, 2), "capacity")
    stats = capacity.hbm_stats()
    log(f"capacity 64000x16384x4096@1/2 in {time.time() - t:.1f}s; {stats}")
    log("phase 15 passed: the showcase, a sweep slice and the capacity case, "
        "every row valid and timed")
    return {"launches": launches, "showcase_b2": showcase_b2}


def time_bcsr_kernel(torch, dev, spec, errs, reference) -> list:
    """Phase 16: B2 at the showcase's largest case, the block-sparse shape and
    the showcase's M=64 and M=1, f32 and bf16: per call and on the device
    alone (the profiler), beside ``torch.matmul`` on the dense W and the
    CUDA-core body's recorded ``BCSR_PARENT_MS``; and on the device under
    every tile of the mma body through its C entry, each tile's output
    bitwise the wrapper's (one K walk for every tile)."""
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.kernels.bcsr_spmm import (
        MMA_TILES,
        _launch,
        bcsr_route,
        bcsr_spmm_kernel,
        bcsr_spmm_kernel_plain,
        bcsr_tile,
    )
    from smmb_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = rng.make_generator(8, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {s[0]: s for s in BCSR_SHAPES}
    rows = []
    for label in BCSR_TIMED:
        _, m, k, n, r, c, keep, nz, _ = shapes[label]
        w, prep, b = _bcsr_case(torch, gen, k, n, r, c, keep, nz, dev)
        nnz = int(torch.count_nonzero(w))
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = rng.rand_dense(gen, (m, k), dtype=dt)
            t_k = measure(lambda: bcsr_spmm_kernel(x, prep, b, ALPHA))
            t_p = measure(lambda: bcsr_spmm_kernel_plain(x, prep, b, ALPHA))
            wd = w.to(dt)
            t_l = measure(torch.matmul, x, wd)
            out = bcsr_spmm_kernel(x, prep, b, ALPHA)
            by_tile = {}
            for tile in MMA_TILES:
                y = _launch(x, prep, b, ALPHA, tile)
                torch.cuda.synchronize()
                check(torch.equal(y, out), f"B2 tile {tile} != the wrapper's at {label} {name}")
                by_tile[f"{tile[0]}x{tile[1]}"] = _device_us(
                    lambda t=tile: _launch(x, prep, b, ALPHA, t))
            n_bytes = sum(t.numel() * t.element_size()
                          for t in (x, prep.values, prep.blk_row, prep.col_start, b, out))
            ops = 2.0 * m * nnz  # the ±1 entries this data holds, per row
            # f32 X times the ternary W: three exact bf16 passes on the tensor
            # cores; the CUDA cores' f32 rate beside it, as the parent was bound
            bound, by = roofline_bound(ops, n_bytes, spec,
                                       "f32_ternary" if name == "f32" else name)
            rows.append({"kernel": "B2 bcsr_spmm_kernel", "shape": label, "dtype": name,
                         "route": bcsr_route(r, c), "tile": list(bcsr_tile(m, n, c, sms)),
                         "stored_blocks": prep.k, "nnz": nnz, "ms": t_k.min_s * 1e3,
                         "mean_ms": t_k.mean_s * 1e3, "plain_ms": t_p.min_s * 1e3,
                         "device_us": _device_us(lambda: bcsr_spmm_kernel(x, prep, b, ALPHA)),
                         "parent_ms_recorded": BCSR_PARENT_MS.get((label, name)),
                         "device_us_by_tile": by_tile,
                         "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes,
                         "ops": ops, "executed_ops": 2.0 * m * prep.k * r * c,
                         "library_ms": t_l.min_s * 1e3,
                         "library_device_us": _device_us(lambda: torch.matmul(x, wd)),
                         "library": f"torch.matmul {name} on the dense W"
                                    + (" (TF32 off)" if name == "f32" else "")})
            if name == "f32":
                cc, cc_by = roofline_bound(ops, n_bytes, spec, "f32")
                rows[-1].update(cuda_core_bound_ms=cc * 1e3, cuda_core_bound_by=cc_by)
            print(json.dumps(rows[-1]), flush=True)
    main_row = rows[0]  # the showcase's largest case in f32, as the showcase runs it
    log("B2 ms now / the CUDA-core body's (device us; torch.matmul ms, device us): "
        + "; ".join(f"{r['shape']} {r['dtype']} {r['ms']:.4f} / {r['parent_ms_recorded']} "
                    f"({r['device_us']:.2f}; {r['library_ms']:.4f}, "
                    f"{r['library_device_us']:.2f})" for r in rows))
    picks = []
    for r in rows:
        pick = "x".join(map(str, r["tile"]))
        best = min(r["device_us_by_tile"], key=r["device_us_by_tile"].get)
        picks.append(f"{r['shape']} {r['dtype']} {pick} {r['device_us_by_tile'][pick]:.2f} "
                     f"(fastest {best} {r['device_us_by_tile'][best]:.2f})")
    log("B2 device us under bcsr_tile's pick, outputs bitwise across tiles: "
        + "; ".join(picks))
    log("phase 16 passed: B2 timed at the showcase, block-sparse, M=64 and M=1 shapes, "
        "and under every tile")
    return [{
        "name": "bcsr_spmm_kernel", "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/bcsr_spmm.cu",
        "replaces": "smmb_tpu/kernels/bcsr_spmm.py:260",
        "launches": reference["launches"]["bcsr_spmm_kernel"],
        "max_abs_err": errs[("showcase 256x1024x4096", torch.float32)],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "design": BCSR_DESIGN,
        "device_us": main_row["device_us"],
    }]


# ------------------------------------------------------ int8-cache slice
# B7: (label, M, d, KVH, hd); N = d + 2·KVH·hd
QUANT_QKV_SHAPES = [
    ("lm path", 1, 1024, 8, 128), ("GQA 8/2", 1, 1024, 2, 128), ("hd 256", 1, 1024, 4, 256),
    ("M=8", 8, 1024, 8, 128), ("M=5", 5, 1024, 8, 128), ("M=5 hd 256", 5, 1024, 4, 256),
    ("hd 512", 1, 1024, 2, 512),
]
# B8: (label, B, H, KVH, S, pos, window); hd 128
QUANT_DECODE_SHAPES = [
    ("lm path", 1, 8, 8, 224, 95, None), ("GQA 8/2", 1, 8, 2, 1024, 512, None),
    ("window 64", 1, 8, 8, 1024, 512, 64), ("B=4", 4, 8, 8, 1024, 512, None),
    ("long", 1, 8, 8, 8192, 8191, None), ("long straddle", 1, 8, 8, 8192, 7938, None),
    ("long GQA 8/2 window 1000", 1, 8, 2, 8192, 8191, 1000),
    ("long B=4", 4, 8, 8, 8192, 8191, None),
]


def _b7_inputs(torch, gen, m, d, kvh, hd, dev, x_dtype=None):
    args = _fused_inputs(torch, gen, "fused_norm_qkv", m, d, d + 2 * kvh * hd, dev, x_dtype)
    return args, dict(eps=1e-6, d_model=d, kv_heads=kvh, head_dim=hd)


def _int8_cache(torch, gen, b, s, kvh, n, dev):
    """An int8 cache of S slots with the first n written by the port's own
    post-hoc quantize from random f32 k and v."""
    from smmb_tpu_torch.models import attention
    from smmb_tpu_torch.utils import rng

    cfg = attention.TernaryAttentionConfig(d_model=kvh * 128, n_heads=kvh)
    cache = attention.init_kv_cache(cfg, b, s, quantized=True, device=dev)
    k = rng.rand_dense(gen, (b, n, kvh, 128))
    v = rng.rand_dense(gen, (b, n, kvh, 128))
    return attention._cache_write(cache, k, v, 0)


def check_int8_kernels(torch, dev) -> dict:
    """Phase 17. Returns the max abs errors at the path shapes (bf16)."""
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.models import attention
    from smmb_tpu_torch.utils import rng

    # tolerances as phases 6 and 10, relative to max(1, max|Y|): f32 1e-4,
    # bf16 2**-7; B7's codes within 1 of the plain version's (its y's f32
    # sums run in another order, which can move a value across a .5) and its
    # scales within 1e-5 relative; B8 within 2e-2 relative of B4 on the f32
    # dequantized cache (B8 scales the f32 scores and p, B4 rounds the
    # dequantized values to the compute dtype)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(171, dev)
    errs = {}
    for label, m, d, kvh, hd in QUANT_QKV_SHAPES:
        for x_dtype in (torch.float32, torch.bfloat16):
            args, kw = _b7_inputs(torch, gen, m, d, kvh, hd, dev, x_dtype)
            for cdt in (torch.float32, torch.bfloat16):
                what = f"{label} x {x_dtype} compute {cdt}"
                before = fk.fused_norm_qkv_quant.launches
                q, codes, scales = fk.fused_norm_qkv_quant(*args, compute_dtype=cdt, **kw)
                check(fk.fused_norm_qkv_quant.launches == before + 1, f"B7 launch count {what}")
                y = fk.fused_norm_qkv(*args, eps=1e-6, compute_dtype=cdt)
                pq, pcodes, pscales = fk.fused_norm_qkv_quant_plain(*args, compute_dtype=cdt,
                                                                    **kw)
                torch.cuda.synchronize()
                check(torch.equal(q, y[:, :d]), f"B7 q != B3's columns {what}")
                want_codes, want_scales = fk.quantize_heads(y, d, kvh, hd)
                if x_dtype == torch.float32:  # B3's output is its f32 y
                    check(torch.equal(codes, want_codes) and torch.equal(scales, want_scales),
                          f"B7 codes/scales != the quantize of B3's f32 y {what}")
                else:  # B3's output is y rounded to bf16
                    check(int((codes.int() - want_codes.int()).abs().max()) <= 1,
                          f"B7 codes beyond 1 of the quantize of B3's bf16 y {what}")
                q_err = _held(torch, "B7 q", q, pq, tol[cdt], what)
                check(int((codes.int() - pcodes.int()).abs().max()) <= 1,
                      f"B7 codes beyond 1 of the plain version {what}")
                s_err = float((scales - pscales).abs().max())
                check(s_err <= 1e-5 * float(pscales.abs().max()), f"B7 scales {what}: {s_err:.3e}")
                deq = float((codes.float() * scales.repeat_interleave(hd, 1)
                             - pcodes.float() * pscales.repeat_interleave(hd, 1)).abs().max())
                if (label, x_dtype, cdt) == ("lm path", torch.float32, torch.bfloat16):
                    errs["fused_norm_qkv_quant"] = max(q_err, deq)
                if m > 1:
                    one = fk.fused_norm_qkv_quant(args[0][:1], *args[1:], compute_dtype=cdt, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a[:1], b) for a, b in zip((q, codes, scales), one)),
                          f"B7 row 0 of M={m} != M=1 {what}")
        log(f"B7 == plain at {label} (M={m}, d={d}, KVH={kvh}, hd={hd}) in f32 and bf16; "
            f"q bitwise B3's, codes bitwise the quantize of B3's f32 y")

    dec = fd.flash_attention_decode_quant
    for label, b, h, kvh, s, pos, window in QUANT_DECODE_SHAPES:
        cache = _int8_cache(torch, gen, b, s, kvh, pos + 1, dev)
        kv, sc = cache["kv"], cache["kv_scale"]
        kc, vc = (t.reshape(b, s, kvh * 128).contiguous()
                  for t in attention._cache_kv(cache, kvh))
        q = rng.rand_dense(gen, (b, 4, h, 128)) * 8.0
        for cdt in (torch.float32, torch.bfloat16):
            kw = dict(window=window, compute_dtype=cdt)
            what = f"{label} pos {pos} {cdt}"
            before = dec.launches
            y = dec(q[:, 0], kv, sc, pos, **kw)
            check(dec.launches == before + 1, f"B8 launch count {what}")
            err = _held(torch, "B8", y, fd.flash_attention_decode_quant_plain(
                q[:, 0], kv, sc, pos, **kw), tol[cdt], what)
            if (label, cdt) == ("lm path", torch.bfloat16):
                errs["flash_attention_decode_quant"] = err
            b4 = fd.flash_attention_decode(q[:, 0], kc, vc, pos, **kw)
            torch.cuda.synchronize()
            rel = float((y.float() - b4.float()).abs().max()) / max(1.0, float(
                b4.float().abs().max()))
            check(rel <= 2e-2, f"B8 vs B4 on the dequantized cache {what}: {rel:.3e}")
            chunk = fd.flash_attention_chunk_quant(q, kv, sc, pos - 3, **kw)
            check(dec.launches == before + 2, f"B8 chunk launch count {what}")
            _held(torch, "B8 chunk", chunk, fd.flash_attention_chunk_quant_plain(
                q, kv, sc, pos - 3, **kw), tol[cdt], what)
            for c in range(4):
                solo = dec(q[:, c], kv, sc, pos - 3 + c, **kw)
                check(torch.equal(chunk[:, c], solo), f"B8 chunk row {c} != decode {what}")
            for r in range(b if b > 1 else 0):
                row = dec(q[r:r + 1, 0], kv[r:r + 1], sc[r:r + 1], pos, **kw)
                check(torch.equal(y[r:r + 1], row), f"B8 batch row {r} != alone {what}")
        blocks = _decode_blocks(fd, b, kvh, s, pos, window)
        check(label != "long" or blocks >= 128, f"B8 {label}: {blocks} blocks")
        log(f"B8 == plain at {label}, B={b} H={h} KVH={kvh} S={s} pos={pos} "
            f"window={window} ({blocks} blocks) in f32 and bf16; within 2e-2 of B4; chunk "
            "and batch rows bitwise")
    log("phase 17 passed: B7 and B8 agree with their plain versions")
    return errs


def run_int8_lm_path(torch, dev, lm) -> dict:
    """Phase 18: the int8 LM path at the ``lm`` defaults."""
    from smmb_tpu_torch.bench.lm_bench import parser, run_lm_bench
    from smmb_tpu_torch.bench.trace import lm_decode_step_fn, report
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import generate, lm_init_cache, lm_prefill_chunked
    from smmb_tpu_torch.models.transformer import (
        block_decode_step,
        block_extend,
        block_prefill,
        init_block_cache,
    )
    from smmb_tpu_torch.utils import rng

    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]
    layers, steps = cfg.n_layers, 64
    bf16, f32 = torch.bfloat16, torch.float32
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_norm_qkv_quant, fk.fused_block_tail,
               fk.fused_mlp, fa.flash_attention, fd.flash_attention_decode,
               fd.flash_attention_decode_quant)
    out, toks = {}, {}
    for flash in (True, False):
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        toks[flash] = generate(packed, prompt, cfg, steps, compute_dtype=bf16, kv_quant=True,
                               use_flash=flash)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        log(f"generate(kv_quant=True, use_flash={flash}): launches {launches}")
        t = toks[flash]
        check(t.shape == (1, steps) and int(t.min()) >= 0 and int(t.max()) < cfg.vocab,
              "int8 generate tokens shape / range")
        want = {"packed_spmm": 6 * layers + 1 + steps, "fused_norm_qkv": 0,
                "fused_norm_qkv_quant": layers * steps, "fused_block_tail": layers * steps,
                "fused_mlp": layers, "flash_attention": layers if flash else 0,
                "flash_attention_decode": 0,
                "flash_attention_decode_quant": layers * steps if flash else 0}
        check(launches == want, f"int8 generate(use_flash={flash}) launches {launches} != "
              f"{want}")
        out[flash] = {"launches": launches}

    # teacher-forced logits against the same routing with plain versions,
    # bounded as in phase 8 by the unfused plain path's spread (here it also
    # quantizes k and v after their cast to the compute dtype, B7 before).
    # The quantizer is a step function: where the kernel's and the plain
    # version's f32 sums straddle a rounding edge, a code differs by one
    # step, and that step is the int8 cache's own error, which JAX's tests
    # bound at INT8_REL. The caches are compared code by code (layer 0's,
    # whose inputs are the same on both paths, to one step), and only a run
    # whose caches differ is held to that bound.
    for flash in (True, False):
        for cdt, tol in ((bf16, 2.0 ** -7), (f32, 1e-4)):
            ids = toks[flash] if cdt == bf16 else generate(
                packed, prompt, cfg, steps, compute_dtype=cdt, kv_quant=True, use_flash=flash)
            caches, call_errs = [], []
            with _held_b1_calls(torch, call_errs):
                kern = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, flash, True,
                                       caches)
            check(len(call_errs) == 6 * layers + steps and max(call_errs) <= tol,
                  f"int8 LM {cdt}: {len(call_errs)} B1 calls, worst vs plain "
                  f"{max(call_errs):.3e}")
            with plain_kernels():
                plain = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, True, flash, True,
                                        caches)
                unfused = _teacher_forced(torch, cfg, packed, prompt, ids, cdt, False, flash,
                                          True)
            flips = _code_steps(torch, caches[0], caches[1])
            check(bool(torch.isfinite(kern).all()), "int8 LM logits finite")
            check(torch.equal(kern.argmax(-1), ids[0]),
                  "teacher-forced int8 path reproduces generate's tokens")
            scale = plain.abs().amax(-1).clamp_min(1.0)
            err = (kern - plain).abs().amax(-1) / scale
            spread = (unfused - plain).abs().amax(-1) / scale
            med, worst = float(err.median()), float(err.max())
            bound = max(tol, float(spread.max()), INT8_REL if flips else 0.0)
            what = f"int8 LM flash={flash} {cdt}"
            check(med <= tol, f"{what}: median step error {med:.3e} > {tol:.3e}")
            check(worst <= bound,
                  f"{what}: worst step error {worst:.3e} beyond {bound:.3e} (tolerance "
                  f"{tol:.1e}, plain orders' spread {float(spread.max()):.3e}, {flips} codes "
                  "differ)")
            log(f"{what} logits vs plain over {steps} steps: median {med:.2e}, worst "
                f"{worst:.2e} (spread {float(spread.max()):.2e}, tolerance {tol:.1e}); "
                f"{flips} of {sum(c['kv'].numel() for c in caches[0])} cache codes differ")

    # chunked prefill over int8 (B7, B8's chunk entry and B5 at M=8) against
    # the same routing with plain versions, f32
    def chunked(use_kernel=True):
        cache = lm_init_cache(cfg, 1, dtype=f32, quantized=True, device=dev)
        logits, cache = lm_prefill_chunked(packed, prompt, cache, cfg, 8, compute_dtype=f32,
                                           use_kernel=use_kernel, use_flash=True)
        return logits[0].float(), cache

    before = (fd.flash_attention_decode_quant.launches, fk.fused_norm_qkv_quant.launches)
    got, got_cache = chunked()
    n_chunks = layers * prompt.shape[1] // 8
    check((fd.flash_attention_decode_quant.launches, fk.fused_norm_qkv_quant.launches)
          == (before[0] + n_chunks, before[1] + n_chunks),
          "int8 lm_prefill_chunked runs B7 and B8's chunk entry once per layer per chunk")
    with plain_kernels():
        (plain, plain_cache), (unfused, _) = chunked(), chunked(use_kernel=False)
    flips = _code_steps(torch, got_cache, plain_cache)
    scale = max(1.0, float(plain.abs().max()))
    err, spread = float((got - plain).abs().max()) / scale, \
        float((unfused - plain).abs().max()) / scale
    bound = max(1e-4, spread, INT8_REL if flips else 0.0)
    top2 = torch.topk(plain, 2).values
    check(bool(got.argmax() == plain.argmax()) or float(top2[0] - top2[1]) <= bound * scale,
          "int8 chunked prefill argmax differs beyond a near tie")
    check(err <= bound, f"int8 chunked prefill vs plain: {err:.3e} beyond {bound:.3e} "
          f"(1e-4, the plain orders' spread {spread:.3e}, {flips} codes differ)")
    log(f"lm_prefill_chunked(8, flash, int8) vs plain, f32: {err:.2e} of max|logits| "
        f"(spread {spread:.2e}; {flips} cache codes differ)")

    # block_extend with C=4 over int8 against four decode steps: bitwise per row
    bcfg, blk = cfg.block, packed["blocks"][0]
    x = rng.rand_dense(rng.make_generator(18, dev), (1, 36, cfg.d_model))
    for cdt in (f32, bf16):
        kw = dict(compute_dtype=cdt, use_flash=True)
        c1 = init_block_cache(bcfg, 1, cfg.max_len, quantized=True, device=dev)
        _, c1 = block_prefill(blk, x[:, :32], c1, bcfg, **kw)
        c2 = {**c1, "kv": c1["kv"].clone(), "kv_scale": c1["kv_scale"].clone()}
        ext, c1 = block_extend(blk, x[:, 32:], c1, bcfg, **kw)
        for i in range(4):
            step, c2 = block_decode_step(blk, x[:, 32 + i:33 + i], c2, bcfg, **kw)
            torch.cuda.synchronize()
            check(torch.equal(ext[:, i], step[:, 0]), f"int8 block_extend row {i} != decode "
                  f"step ({cdt})")
        check(torch.equal(c1["kv"], c2["kv"]) and torch.equal(c1["kv_scale"], c2["kv_scale"]),
              f"int8 block_extend and the decode steps write the same cache ({cdt})")
    log("int8 block_extend (C=4, flash, f32 and bf16) equals four block_decode_steps "
        "bitwise per row")

    runs = {}
    for flash in (False, True, True, False):  # alternating: the host's load drifts
        r = run_lm_bench(cfg, 1, prompt.shape[1], steps, reps=3, device=dev,
                         use_flash=flash, kv_quant=True)
        runs.setdefault(flash, []).append(r.per_token_s * 1e6)
    for flash in (False, True):
        args = parser().parse_args(["--kv-quant"] + (["--flash"] if flash else []))
        tr = report(lm_decode_step_fn(args), {"call": "lm_decode_step", "kv_quant": True,
                                              "flash": flash, "pos": args.prompt_len})
        row = {"kv_quant": True, "flash": flash, "lm_us_per_token": runs[flash],
               "trace_launches": tr["launches"], "trace_call_us": tr["call_us"],
               "trace_kernel_us": tr["kernel_us"], "trace_busy_share": tr["busy_share"],
               "trace_flash_decode_us": _kernel_us(tr, "flash_decode_kernel"),
               **_fused_step(tr)}
        print(json.dumps(row), flush=True)
        out[flash].update(row)
    log(f"phase 18 passed: int8 flash step {out[True]['trace_launches']:.0f} launches, "
        f"{out[True]['trace_kernel_us']:.1f} us of device time (B8 "
        f"{out[True]['trace_flash_decode_us']:.1f}, B5 {out[True]['trace_b5_us']:.1f} in "
        f"{out[True]['trace_b5_launches']:.0f} launches, B3/B7 {out[True]['trace_qkv_us']:.1f} "
        f"in {out[True]['trace_qkv_launches']:.0f}), busy "
        f"{out[True]['trace_busy_share']:.3f} (without flash "
        f"{out[False]['trace_launches']:.0f}, {out[False]['trace_kernel_us']:.1f} us, "
        f"{out[False]['trace_busy_share']:.3f})")
    return out


def time_int8_kernels(torch, dev, spec, errs, int8) -> list:
    """Phase 19: B7 at the path shape, B8 at the path shape and pos 8191."""
    import torch.nn.functional as F

    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.models import attention
    from smmb_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = rng.make_generator(19, dev)
    bf16 = torch.bfloat16

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = []
    # B7: M=1, 1024 x 3072, bf16 compute, x in f32 as the LM's residual stream
    args, kw = _b7_inputs(torch, gen, 1, 1024, 8, 128, dev)
    kw["compute_dtype"] = bf16
    plane = args[2]
    t_k = measure(lambda: fk.fused_norm_qkv_quant(*args, **kw))
    t_p = measure(lambda: fk.fused_norm_qkv_quant_plain(*args, **kw))
    outs = fk.fused_norm_qkv_quant(*args, **kw)
    n_bytes = plane.weight_bytes() + nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                                            *outs)
    ops = 2.0 * int(torch.count_nonzero(unpack_ternary(plane)))
    bound, by = roofline_bound(ops, n_bytes, spec, "bf16")
    dense = unpack_ternary(plane, bf16)
    a = rng.rand_dense(gen, (1, 1024), dtype=bf16)
    t_l = measure(torch.matmul, a, dense)
    rows.append({"kernel": "B7 fused_norm_qkv_quant", "shape": [1, 1024, 3072],
                 "ms": t_k.min_s * 1e3, "mean_ms": t_k.mean_s * 1e3,
                 "plain_ms": t_p.min_s * 1e3, "bound_ms": bound * 1e3, "bound_by": by,
                 "bytes": n_bytes, "ops": ops, "library_ms": t_l.min_s * 1e3,
                 "device_us": _device_us(lambda: fk.fused_norm_qkv_quant(*args, **kw)),
                 "library_device_us": _device_us(lambda: torch.matmul(a, dense)),
                 "parent_device_us_recorded": FUSED_PARENT_US["fused_norm_qkv_quant"],
                 "library": "torch.matmul bf16 on the pre-decoded dense Wqkv"})
    # B8: bf16 compute, q in f32 as B7 gives it
    for label, b, h, kvh, s, pos in (("lm path", 1, 8, 8, 224, 95),
                                     ("long", 1, 8, 8, 8192, 8191)):
        cache = _int8_cache(torch, gen, b, s, kvh, pos + 1, dev)
        kv, sc = cache["kv"], cache["kv_scale"]
        q = rng.rand_dense(gen, (b, h, 128)) * 8.0
        kw = dict(compute_dtype=bf16)
        t_k = measure(lambda: fd.flash_attention_decode_quant(q, kv, sc, pos, **kw))
        t_p = measure(lambda: fd.flash_attention_decode_quant_plain(q, kv, sc, pos, **kw))
        live = pos + 1
        # the library call reads the live prefix of the dequantized bf16 cache;
        # the dequantization itself is not timed
        kd, vd = attention._cache_kv(cache, kvh)
        kl = kd[:, :live].to(bf16).transpose(1, 2).contiguous()
        vl = vd[:, :live].to(bf16).transpose(1, 2).contiguous()
        qb = q.to(bf16)[:, :, None]
        gqa = {"enable_gqa": True} if kvh < h else {}
        t_l = measure(lambda: F.scaled_dot_product_attention(qb, kl, vl, **gqa))
        dev_k = _device_us(lambda: fd.flash_attention_decode_quant(q, kv, sc, pos, **kw))
        dev_l = _device_us(lambda: F.scaled_dot_product_attention(qb, kl, vl, **gqa))
        out = fd.flash_attention_decode_quant(q, kv, sc, pos, **kw)
        n_bytes = nbytes(q, kv[:, :live], sc[..., :live], out)
        bound, by = roofline_bound(4.0 * b * h * live * 128, n_bytes, spec, "bf16")
        rows.append({"kernel": "B8 flash_attention_decode_quant", "shape": label, "B": b,
                     "H": h, "KVH": kvh, "S": s, "pos": pos,
                     "blocks": _decode_blocks(fd, b, kvh, s, pos, None),
                     "ms": t_k.min_s * 1e3, "mean_ms": t_k.mean_s * 1e3,
                     "device_us": dev_k, "plain_ms": t_p.min_s * 1e3,
                     "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes,
                     "library_ms": t_l.min_s * 1e3, "library_device_us": dev_l,
                     "library": "torch.nn.functional.scaled_dot_product_attention on the "
                                "dequantized bf16 live prefix (dequantization not timed)"})
        if label == "long":
            rows[-1]["unsplit_ms"] = FLASH_DECODE_UNSPLIT_MS["B8"]
    for r in rows:
        print(json.dumps(r), flush=True)
    log("B8 (bf16, B=1, H=KVH=8): " + "; ".join(
        f"{r['shape']} pos {r['pos']} of S={r['S']}, {r['blocks']} blocks: {r['ms']:.4f} ms "
        f"a call, {r['device_us']:.2f} us on the device (SDPA {r['library_ms']:.4f} ms, "
        f"{r['library_device_us']:.2f} us; bound {r['bound_ms'] * 1e3:.2f} us)"
        for r in rows[1:]) + f"; unsplit at pos 8191: {FLASH_DECODE_UNSPLIT_MS['B8']} ms")
    launches = int8[True]["launches"]
    summary = []
    for name, src, line, row in (
            ("fused_norm_qkv_quant", "fused_mlp", "fused_mlp.py:489", rows[0]),
            ("flash_attention_decode_quant", "flash_decode", "flash_decode.py:412", rows[1])):
        summary.append({
            "name": name, "route": "cuda",
            "source": f"smmb_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"smmb_tpu/kernels/{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    summary[0].update(design=QKV_DESIGN, device_us=rows[0]["device_us"],
                      library_device_us=rows[0]["library_device_us"])
    summary[1].update(design=FLASH_DECODE_DESIGN, device_us=rows[1]["device_us"],
                      long_ms=rows[2]["ms"], long_device_us=rows[2]["device_us"])
    log(f"B7: {rows[0]['device_us']:.2f} us on the device (torch.matmul "
        f"{rows[0]['library_device_us']:.2f})")
    log("phase 19 passed: B7 and B8 timed at the path shapes and B8 at pos 8191")
    return summary


# ------------------------------------------------- serving-controls slice
def check_pipe_kernel(torch, dev, lm) -> dict:
    """Phase 20: B9p against its plain version and the serial kernel, and
    the LM prefill through B9p (the counted run of its launches)."""
    import types

    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.models import attention
    from smmb_tpu_torch.models.lm import lm_init_cache, lm_prefill
    from smmb_tpu_torch.utils import rng

    # tolerances as phase 11's: f32 1e-4, bf16 2**-7, relative to max(1, max|Y|)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
    gen = rng.make_generator(201, dev)
    fn = fa.flash_attention
    out, n_bitwise = {}, 0
    for label, b, h, kvh, t, hd, causal, window in FLASH_PREFILL_SHAPES:
        if not causal:
            continue
        routes = {}
        for dt in (torch.float32, torch.bfloat16):
            route = routes[dt] = fa.kernel_route(dt, hd, True)
            q = (rng.rand_dense(gen, (b, t, h, hd)) * 4.0).to(dt).permute(0, 2, 1, 3)
            k = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            v = rng.rand_dense(gen, (b, kvh, t, hd), dtype=dt)
            what = f"{label} {dt}"
            before = (fn.launches, fn.pipe_launches)
            y = fn(q, k, v, window=window, pipeline_p=True)
            check((fn.launches, fn.pipe_launches) == (before[0], before[1] + 1),
                  f"B9p counts one pipe launch and no serial one {what}")
            err = _held(torch, "B9p", y, fa.flash_attention_plain(
                q, k, v, window=window, block_kv=route.tile, pipeline_p=True), tol[dt], what)
            if route == fa.kernel_route(dt, hd):
                serial = fn(q, k, v, window=window)
                torch.cuda.synchronize()
                check(torch.equal(y, serial), f"B9p != the serial kernel bitwise {what}")
                n_bitwise += 1
            if (label, dt) == ("lm prefill", torch.float32):
                out["max_abs_err"] = err
        log(f"B9p == plain at {label} (B={b} H={h} KVH={kvh} T={t} hd={hd} window={window}) "
            f"in f32 ({_route(routes[torch.float32])}) and bf16 "
            f"({_route(routes[torch.bfloat16])})")
    q = torch.zeros((1, 2, 8, 128), device=dev)
    try:
        fn(q, q, q, causal=False, pipeline_p=True)
        check(False, "B9p took a non-causal call")
    except ValueError:
        pass

    # the LM prefill with B9p in B9's place: the only route to B9p is its
    # keyword (no model entry point passes it, as in JAX), so the counted
    # run swaps it in for the serial kernel, and the logits stay bitwise
    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]

    def prefill():
        cache = lm_init_cache(cfg, 1, dtype=torch.float32, device=dev)
        return lm_prefill(packed, prompt, cache, cfg, use_flash=True)[0]

    serial = prefill()
    torch.cuda.synchronize()
    fn.launches = fn.pipe_launches = 0
    attention.fa = types.SimpleNamespace(
        flash_attention=lambda *a, **kw: fn(*a, pipeline_p=True, **kw))
    try:
        piped = prefill()
        torch.cuda.synchronize()
    finally:
        attention.fa = fa
    out["launches"] = fn.pipe_launches
    check((fn.launches, fn.pipe_launches) == (0, cfg.n_layers),
          f"LM prefill through B9p: launches {fn.launches} serial, {fn.pipe_launches} pipe")
    check(torch.equal(piped, serial), "LM prefill logits through B9p != through B9")
    log(f"phase 20 passed: B9p agrees with its plain version, bitwise the serial kernel at "
        f"{n_bitwise} shape/dtype pairs; the LM prefill through B9p ({out['launches']} "
        "launches) gives the serial prefill's logits bitwise")
    return out


def _first_diff(a, b):
    """The first step where two token rows differ, or None."""
    diff = (a != b).nonzero()
    return int(diff[0]) if len(diff) else None


def _ragged_teacher_forced(torch, cfg, packed, batch, mask, ids, cdt):
    """(B, steps, vocab) f32 logits of a batched, ragged-cache run (prefill
    with ``mask`` then decode steps with per-row positions) fed ``ids``."""
    from smmb_tpu_torch.models.lm import lm_decode_step, lm_init_cache, lm_prefill

    kw = dict(compute_dtype=cdt)
    cache = lm_init_cache(cfg, batch.shape[0], dtype=cdt, ragged=True, device=batch.device)
    logits, cache = lm_prefill(packed, batch, cache, cfg, prompt_mask=mask, **kw)
    out, pos = [logits], mask.to(torch.int64).sum(dim=1)
    for i in range(ids.shape[1] - 1):
        logits, cache = lm_decode_step(packed, ids[:, i], cache, cfg, pos_ids=pos + i, **kw)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1).float()


NEAR_TIE = 1e-5  # a top-2 logit gap under this share of max|logit| is a near tie


def _hold_rows(torch, what, cfg, packed, got, prompts, refs, batch, mask, cdt) -> list:
    """Each row of a batched run ``got`` (B, steps) against its own batch-1
    run ``refs[r]``. Where a row first differs, the batch-1 route's logits
    at that step (teacher-forced) give the top-2 gap and the distance to the
    batched route's logits there (teacher-forced on the same tokens). The
    flip is a near tie when the gap is under NEAR_TIE of max|logit| or under
    that distance; any other flip fails. Returns the near ties."""
    ties, batched = [], None
    for r, (prompt, ref) in enumerate(zip(prompts, refs)):
        step = _first_diff(got[r], ref[0])
        if step is None:
            continue
        if batched is None:
            ids = torch.cat([x for x in refs], 0)
            batched = _ragged_teacher_forced(torch, cfg, packed, batch, mask, ids, cdt)
        alone = _teacher_forced(torch, cfg, packed, prompt, ref, cdt, True)[step]
        top2 = torch.topk(alone, 2).values
        scale = float(alone.abs().max())
        gap = float(top2[0] - top2[1]) / scale
        dist = float((alone - batched[r, step]).abs().max()) / scale
        log(f"{what} row {r} first differs at step {step}: top-2 gap {gap:.3e}, route "
            f"distance {dist:.3e} of max|logit| {scale:.3e}")
        check(gap <= max(NEAR_TIE, dist), f"{what} row {r} flips at step {step} beyond a near "
              f"tie (gap {gap:.3e} > {NEAR_TIE:.0e} and > route distance {dist:.3e})")
        ties.append({"run": what, "row": r, "step": step, "gap": gap, "distance": dist})
    return ties


def run_serving_controls(torch, dev, lm) -> dict:
    """Phase 21: speculative decoding, batched and ragged serving, beam
    search and prefix forking at the ``lm`` defaults."""
    import dataclasses

    from smmb_tpu_torch.bench.spec_bench import configs
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import (
        fork_cache,
        generate,
        generate_beam,
        init_lm,
        lm_decode_step,
        lm_init_cache,
        lm_prefill,
        pack_lm,
    )
    from smmb_tpu_torch.models.spec_decode import generate_speculative
    from smmb_tpu_torch.utils import rng

    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]
    layers, steps, k = cfg.n_layers, 64, 4
    bf16, f32 = torch.bfloat16, torch.float32
    _, dcfg = configs(vocab=cfg.vocab, prompt_len=prompt.shape[1], steps=steps, k=k)
    dcfg = dataclasses.replace(dcfg, max_len=cfg.max_len)  # the target's position table
    draft = pack_lm(init_lm(rng.make_generator(1, dev), dcfg))
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp,
               fa.flash_attention, fd.flash_attention_decode)
    want = generate(packed, prompt, cfg, steps, compute_dtype=bf16, use_flash=True)
    out = {"ties": []}
    for name, d, d_cfg in (("random draft", draft, dcfg), ("self-draft", packed, cfg)):
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        got, stats = generate_speculative(packed, d, prompt, cfg, d_cfg, steps, k=k,
                                          compute_dtype=bf16, use_flash=True, return_stats=True)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        rounds = stats["rounds"]
        chunk, decode = layers * rounds, d_cfg.n_layers * (k + 1) * rounds
        log(f"generate_speculative(use_flash=True, {name}, bf16, k={k}, {steps} steps): "
            f"{rounds} rounds, mean accepted {stats['mean_accepted']:.3f} of {k}; launches "
            f"{launches}; B4 chunk {chunk}, B4 decode {decode}")
        check(launches["flash_attention_decode"] == chunk + decode,
              f"spec ({name}): B4 ran {launches['flash_attention_decode']} times, not "
              f"{chunk} verify chunks + {decode} draft steps")
        check(launches["flash_attention"] == layers + d_cfg.n_layers,
              f"spec ({name}): B9 once per layer of each prefill")
        check(all(v > 0 for v in launches.values()), f"spec ({name}) left a kernel unlaunched")
        step = _first_diff(got[0], want[0])
        check(step is None, f"flash spec ({name}) differs from flash generate at step {step}")
        print(json.dumps({"spec": name, "k": k, "steps": steps, "rounds": rounds,
                          "mean_accepted": stats["mean_accepted"], "launches": launches,
                          "b4_chunk": chunk, "b4_decode": decode}), flush=True)
        out[name] = {"launches": launches, **stats}
    log("flash speculative decoding equals flash generate token for token (bf16, both drafts)")

    # batched speculative decoding, f32, B = 4: each row against its own generate
    bsteps = 32
    bprompt = torch.randint(0, cfg.vocab, (4, prompt.shape[1]),
                            generator=rng.make_generator(5, dev), device=dev)
    got, stats = generate_speculative(packed, draft, bprompt, cfg, dcfg, bsteps, k=k,
                                      compute_dtype=f32, return_stats=True)
    rows = [bprompt[r:r + 1] for r in range(4)]
    refs = [generate(packed, p, cfg, bsteps, compute_dtype=f32) for p in rows]
    out["ties"] += _hold_rows(torch, "batched spec", cfg, packed, got, rows, refs, bprompt,
                              torch.ones_like(bprompt, dtype=torch.bool), f32)
    log(f"batched spec (B=4, f32, k={k}, {bsteps} steps): {stats['rounds']} rounds, mean "
        f"accepted {stats['mean_accepted']:.3f}; rows held against their own generate")

    # a ragged batch: prompts of 5, 12 and 9 tokens left-padded to 12, f32
    rgen = rng.make_generator(6, dev)
    rows = [torch.randint(0, cfg.vocab, (1, n), generator=rgen, device=dev) for n in (5, 12, 9)]
    batch = torch.cat([torch.cat([torch.zeros((1, 12 - p.shape[1]), dtype=p.dtype, device=dev),
                                  p], 1) for p in rows])
    mask = torch.arange(12, device=dev)[None] >= torch.tensor([[7], [0], [3]], device=dev)
    got = generate(packed, batch, cfg, bsteps, compute_dtype=f32, prompt_mask=mask)
    refs = [generate(packed, p, cfg, bsteps, compute_dtype=f32) for p in rows]
    out["ties"] += _hold_rows(torch, "ragged generate", cfg, packed, got, rows, refs, batch,
                              mask, f32)
    log(f"ragged generate (5, 12, 9 tokens left-padded to 12, f32, {bsteps} steps): rows held "
        "against their own generate")

    # beam search, bf16: beam 1 is greedy; beam 4 sorted and no worse
    want = generate(packed, prompt, cfg, 16, compute_dtype=bf16)
    b1, s1 = generate_beam(packed, prompt, cfg, 16, beam=1, compute_dtype=bf16)
    b4, s4 = generate_beam(packed, prompt, cfg, 16, beam=4, compute_dtype=bf16)
    torch.cuda.synchronize()
    step = _first_diff(b1[0], want[0])
    if step is not None:
        alone = _teacher_forced(torch, cfg, packed, prompt, want, bf16, True)[step]
        top2 = torch.topk(alone, 2).values
        gap = float(top2[0] - top2[1]) / float(alone.abs().max())
        log(f"beam 1 first differs from generate at step {step}: top-2 gap {gap:.3e}")
        check(gap <= NEAR_TIE, f"beam 1 flips at step {step} beyond a near tie ({gap:.3e})")
        out["ties"].append({"run": "beam 1", "row": 0, "step": step, "gap": gap})
    check(b4.shape == (4, 16) and bool((s4[1:] <= s4[:-1] + 1e-6).all()),
          f"beam 4 scores not sorted best first: {s4.tolist()}")
    check(len({tuple(h) for h in b4.tolist()}) == 4, "beam 4 holds a hypothesis twice")
    # a wider beam keeps the greedy prefix only while it ranks in the top 4,
    # so its best is not bound to score at least greedy's: recorded, not held
    out["beam"] = {"beam4_scores": s4.tolist(), "beam1_score": float(s1[0]),
                   "beam4_best_at_least_beam1": float(s4[0]) >= float(s1[0])}
    log(f"generate_beam (bf16, 16 steps): beam 1 == generate; beam 4 scores "
        f"{[round(float(v), 3) for v in s4]} vs beam 1's {float(s1[0]):.3f}")

    # fork_cache to 4 rows and one decode step, bf16, against the same
    # routing with plain versions (bounded as phase 8: the tolerance or the
    # unfused plain path's spread)
    div = torch.tensor([5, 17, 42, cfg.vocab - 1], device=dev)

    def forked_step(use_kernel=True):
        cache = lm_init_cache(cfg, 1, dtype=bf16, device=dev)
        _, cache = lm_prefill(packed, prompt, cache, cfg, compute_dtype=bf16,
                              use_kernel=use_kernel)
        forked = fork_cache(cache, 4)
        check(all(f["k"].shape[0] == 4 and f["k"].data_ptr() != c["k"].data_ptr()
                  for f, c in zip(forked, cache)), "fork_cache rows are copies of their own")
        logits, _ = lm_decode_step(packed, div, forked, cfg, compute_dtype=bf16,
                                   use_kernel=use_kernel)
        torch.cuda.synchronize()
        return logits.float()

    kern = forked_step()
    with plain_kernels():
        plain, unfused = forked_step(), forked_step(use_kernel=False)
    scale = plain.abs().amax(-1).clamp_min(1.0)
    err = (kern - plain).abs().amax(-1) / scale
    spread = (unfused - plain).abs().amax(-1) / scale
    tol = 2.0 ** -7
    check(bool(torch.isfinite(kern).all()), "forked logits finite")
    check(bool((err <= torch.clamp(spread, min=tol)).all()),
          f"fork_cache rows vs plain: {err.tolist()} beyond {tol:.1e} and the spread "
          f"{spread.tolist()}")
    log(f"fork_cache(4) + decode step, bf16: rows vs plain {[f'{e:.2e}' for e in err.tolist()]} "
        f"(spread {[f'{e:.2e}' for e in spread.tolist()]}, tolerance {tol:.1e})")
    print(json.dumps({"near_ties": out["ties"], "beam": out["beam"]}), flush=True)
    log(f"phase 21 passed: the serving controls; {len(out['ties'])} near-tie flips")
    return out


def time_serving_controls(torch, dev, spec, pipe) -> list:
    """Phase 22: B9p against the serial kernel, its plain version, its bound
    and SDPA; the spec bench's three rows."""
    import torch.nn.functional as F

    from smmb_tpu_torch.bench import spec_bench
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import roofline_bound
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.utils import rng

    gen = rng.make_generator(22, dev)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for label, b, h, t, dt in (("lm prefill", 1, 8, 32, f32), ("T=512 f32", 1, 8, 512, f32),
                               ("long f32", 1, 8, 4096, f32), ("long", 1, 8, 4096, bf16)):
        q = (rng.rand_dense(gen, (b, h, t, 128)) * 4.0).to(dt)
        k = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        v = rng.rand_dense(gen, (b, h, t, 128), dtype=dt)
        times = {}
        for pipe_p in (False, True, True, False):  # in turns: the host's load drifts
            times.setdefault(pipe_p, []).append(
                measure(lambda: fa.flash_attention(q, k, v, pipeline_p=pipe_p)).min_s * 1e3)
        t_p = measure(lambda: fa.flash_attention_plain(q, k, v, pipeline_p=True))
        t_l = measure(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        n = 10 if t == 4096 else 30
        dev_us = {pipe_p: _device_us(lambda: fa.flash_attention(q, k, v, pipeline_p=pipe_p), n)
                  for pipe_p in (True, False)}
        dev_l = _device_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), n)
        n_bytes = sum(x.numel() * x.element_size() for x in (q, q, k, v))  # q, out, k, v
        ops = 4.0 * b * h * 128 * t * (t + 1) / 2
        bound, by = roofline_bound(ops, n_bytes, spec, "f32" if dt == f32 else "bf16")
        rows.append({"kernel": "B9p flash_attention(pipeline_p=True)", "shape": label, "B": b,
                     "H": h, "T": t, "dtype": str(dt), "ms": min(times[True]),
                     "pipe_ms_runs": times[True], "serial_ms_runs": times[False],
                     "serial_ms": min(times[False]), "plain_ms": t_p.min_s * 1e3,
                     "bound_ms": bound * 1e3, "bound_by": by, "bytes": n_bytes, "ops": ops,
                     "library_ms": t_l.min_s * 1e3,
                     "library": "torch.nn.functional.scaled_dot_product_attention "
                                "(is_causal)", "body": fa.kernel_route(dt, 128, True).body,
                     "device_us": dev_us[True], "serial_device_us": dev_us[False],
                     "library_device_us": dev_l})
        if dt == f32:
            rows[-1]["parent_device_us"] = B9_PARENT_US[f"B9p {label}"]
        if label == "long":
            rows[-1]["cuda_core_ms"] = B9_CUDA_CORE_MS["pipe"]
            rows[-1]["cuda_core_serial_ms"] = B9_CUDA_CORE_MS["serial"]
        print(json.dumps(rows[-1]), flush=True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log("B9p f32 (CUDA-core body; B=1, H=8, hd 128): " + "; ".join(
        f"T={r['T']}: {r['ms']:.4f} ms a call, {r['device_us']:.2f} us on the "
        f"device (serial {r['serial_device_us']:.2f} us; the earlier body's "
        f"{r['parent_device_us']} us; SDPA f32 {r['library_device_us']:.2f} us; bound "
        f"{r['bound_ms'] * 1e3:.2f} us)" for r in rows if r["dtype"] == str(f32)))
    long = rows[-1]
    log(f"B9p at T=4096 bf16 ({long['body']} body): {long['ms']:.4f} ms vs serial "
        f"{long['serial_ms']:.4f} ms (the CUDA-core body's: B9p "
        f"{B9_CUDA_CORE_MS['pipe']} ms, serial {B9_CUDA_CORE_MS['serial']} ms; bound "
        f"{long['bound_ms']:.4f} ms, SDPA {long['library_ms']:.4f} ms)")

    t = time.time()
    bench = spec_bench.main([])
    print(json.dumps({"spec_bench": bench, "command": "python -m smmb_tpu_torch spec"}),
          flush=True)
    log(f"spec bench in {time.time() - t:.1f}s: " + ", ".join(
        f"{name} {r['us_per_token']:.1f} us/token" for name, r in bench.items()))
    log("phase 22 passed: B9p and the spec bench timed")
    row = rows[0]  # the LM prefill's shape, as B9's row
    return [{
        "name": "flash_attention_pipe", "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "smmb_tpu/kernels/flash_attention.py:607",
        "launches": pipe["launches"], "max_abs_err": pipe["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    }]


# ------------------------------------------------------------ C1: B1 f32 vs f64

# C1 (ROADMAP queue B, beside the B1 f32 item) is read per call, where rounding cannot compound: B1's
# f32 output and the library's f32 product of the same operands
# (``packed_spmm_plain``: the decode, then torch.matmul with TF32 off, the
# flag ``ops.dense.full_f32_matmul`` sets), each against an f64 product,
# relative to max(1, max|y64|). C1's limits: at every call B1's RMS error at
# most C1_RMS_FACTOR times the library's and its largest error at most
# C1_MAX_FACTOR times the library's. B1's f32 mode misses them: C1 is a
# measured precision gap, so the readings and the calls beyond the limits
# are logged, not gated; a redesign of B1's f32 mode that meets them must
# also hold phases 8 and 18 as they stand (ROADMAP queue B).
C1_RMS_FACTOR = 1.25
C1_MAX_FACTOR = 2.0


def _f64_reading(torch, x, w, b, alpha, y) -> dict:
    """One B1 f32 call ``y`` on the operands it received (x already scaled)
    beside the library's f32 product, both against
    ``PReLU(x·W + b, α)`` in f64: RMS and max of |error| / max(1, max|y64|)."""
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_plain

    x2 = x.reshape(-1, x.shape[-1])
    with torch.no_grad():
        y64 = x2.double() @ unpack_ternary(w, torch.float64)
        if b is not None:
            y64 = y64 + b.double()
        if alpha is not None:  # the f32 slope both products use
            y64 = torch.where(y64 > 0, y64, float(torch.tensor(alpha)) * y64)
        lib = packed_spmm_plain(x2, w, b, alpha, compute_dtype=torch.float32)
        scale = max(1.0, float(y64.abs().max()))

        def stats(a):
            e = (a.reshape(y64.shape).double() - y64).abs() / scale
            return float(e.square().mean().sqrt()), float(e.max())

        (b1_rms, b1_max), (lib_rms, lib_max) = stats(y), stats(lib)
    return {"shape": [x2.shape[0], w.rows, w.cols], "b1_rms": b1_rms, "b1_max": b1_max,
            "lib_rms": lib_rms, "lib_max": lib_max}


def _ratio(a: float, b: float) -> float:
    return a / b if b > 0 else (0.0 if a == 0 else math.inf)


def _c1_ratios(readings: list) -> tuple:
    """The worst B1/library RMS and max ratios of C1 readings."""
    return (max(_ratio(r["b1_rms"], r["lib_rms"]) for r in readings),
            max(_ratio(r["b1_max"], r["lib_max"]) for r in readings))


def _read_c1(readings: list, what: str) -> dict:
    """C1's reading of B1 f32 calls: the worst B1/library ratios and the
    calls beyond C1's limits, logged: C1 is a measured precision gap, not a
    gate, until a redesign of B1's f32 mode takes it up (ROADMAP queue B)."""
    check(len(readings) > 0, f"{what}: no B1 f32 call was read against f64")
    rms, mx = _c1_ratios(readings)
    beyond = sum(not (r["b1_rms"] <= C1_RMS_FACTOR * r["lib_rms"]
                      and r["b1_max"] <= C1_MAX_FACTOR * r["lib_max"]) for r in readings)
    log(f"{what}: {len(readings)} B1 f32 calls against f64 (C1, a measured gap, logged): B1/library "
        f"RMS ratio at most {rms:.3f} (limit {C1_RMS_FACTOR}), max ratio at most {mx:.3f} "
        f"(limit {C1_MAX_FACTOR}), {beyond} calls beyond; B1 RMS "
        f"{min(r['b1_rms'] for r in readings):.3e}–{max(r['b1_rms'] for r in readings):.3e}, "
        f"library RMS {min(r['lib_rms'] for r in readings):.3e}–"
        f"{max(r['lib_rms'] for r in readings):.3e}")
    return {"calls": len(readings), "beyond_limits": beyond, "worst_rms_ratio": rms,
            "worst_max_ratio": mx}


def read_b1_f32_headline(torch, dev) -> dict:
    """Phase 3: B1's f32 call at the headline (M=256, K=N=4096, ~10% nnz,
    bias and PReLU) read against f64 beside the library (C1)."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.utils import rng

    gen = rng.make_generator(3, dev)
    x = rng.rand_dense(gen, (256, 4096))
    w = pack_ternary_device(rng.rand_ternary(gen, (4096, 4096), non_zero=10))
    b = rng.rand_dense(gen, (4096,))
    reading = _f64_reading(torch, x, w, b, ALPHA, packed_spmm(x, w, b, ALPHA))
    print(json.dumps({"c1_headline": reading}), flush=True)
    return reading


# ------------------------------------------------------------ training slice

FINETUNE = dict(depth=4, dim=4096, batch=256, non_zero=10)  # BASELINE config 5
LM_TRAIN = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=4)  # `lm` CLI
LM_TRAIN_BATCH = (8, 256)  # tokens a step: accum_steps=2 microbatches of 4x256

def _timed_step(torch, step):
    """(step(), host ms, peak MiB allocated) of one training step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated() / 2 ** 20


def _log_steps(what, card, losses, ms, peak) -> dict:
    row = {"train": what, "losses": losses, "step_ms": ms, "peak_mib": peak, "card": card}
    log(f"{what}: losses {', '.join(f'{x:.6g}' for x in losses)}; step ms "
        f"{', '.join(f'{x:.1f}' for x in ms)}; peak {max(peak):.0f} MiB ({card})")
    return row


def _map_tree(fn, tree):
    """``fn`` applied to every tensor of a parameter tree (dicts, lists)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _masters(tree):
    """A master tree made f32 and off the ternary grid (``a + 0.01``, as the
    JAX tests perturb theirs), detached leaves."""
    return _map_tree(lambda t: (t + 0.01).detach(), tree)


def _check_full_f32(torch, x, w, what) -> float:
    """One QAT product (``qat_linear``) against its f64 value, relative to
    max|y|. ``full_f32_matmul`` turns TF32 off itself, so reading the flag
    proves nothing; the product's error does. TF32 rounds every input to 10
    mantissa bits (~2.8e-4 relative rms), which puts the largest error of a
    product with 10^5 or more outputs near 1e-4 of max|y|; a full f32 sum
    of 4096 terms sits near 1e-7."""
    from smmb_tpu_torch.models.train import absmean_scale, qat_linear, ternarize_ste

    with torch.no_grad():
        y = qat_linear(x, w).double()
        ref = x.double() @ (ternarize_ste(w) * absmean_scale(w)).double()
    err = float((y - ref).abs().max() / ref.abs().max())
    check(err <= 1e-5, f"{what}: a QAT product is {err:.2e} of max|y| off its f64 value "
          "(TF32 on?)")
    log(f"{what}: one QAT product {err:.3e} of max|y| off its f64 value (limit 1e-5)")
    return err


def _served_stages(torch, packed, tokens, cfg) -> list:
    """(stage, kernel output, plain output) for each block and the head of
    ``lm_forward``, each stage fed the plain path's input, so no stage
    carries another's rounding."""
    from smmb_tpu_torch.models import lm
    from smmb_tpu_torch.models import transformer as tb

    x = packed["embed"][tokens] + packed["pos"][None, :tokens.shape[1]]
    out = []
    for i, blk in enumerate(packed["blocks"]):
        kern = tb.block_forward(blk, x, cfg.block)
        x = tb.block_forward(blk, x, cfg.block, use_kernel=False)
        out.append((f"block {i}", kern, x))
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    out.append(("head", lm._head_logits(packed, h, cfg, torch.float32, True),
                lm._head_logits(packed, h, cfg, torch.float32, False)))
    return out


@contextlib.contextmanager
def _held_b1_calls(torch, errs, readings=None):
    """B1 on the LM path with each call held against ``packed_spmm_plain``
    on the same input: appends max|y - plain| / max(1, max|plain|) to
    ``errs``, and, when ``readings`` is a list, each f32 call's reading
    against f64 (``_f64_reading``) to it."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.models import attention, lm, moe, transformer
    from smmb_tpu_torch.parallel import sharded

    def held(x, w, b=None, alpha=None, *, compute_dtype=torch.float32):
        y = packed_spmm(x, w, b, alpha, compute_dtype=compute_dtype)
        ref = packed_spmm_plain(x.reshape(-1, x.shape[-1]), w, b, alpha,
                                compute_dtype=compute_dtype).reshape(y.shape)
        errs.append(float((y - ref).abs().max()) / max(1.0, float(ref.abs().max())))
        if readings is not None and compute_dtype == torch.float32:
            readings.append(_f64_reading(torch, x, w, b, alpha, y))
        return y

    mods = (attention, transformer, lm, moe, sharded)
    try:
        for mod in mods:
            mod.packed_spmm = held
        yield
    finally:
        for mod in mods:
            mod.packed_spmm = packed_spmm


def _lecun(params: dict) -> dict:
    """``init_lm`` masters with every projection's and the head's master
    times 1/sqrt(fan_in) (LeCun scale: attention scores O(sqrt(hd)));
    embeddings, norms and biases as they are. Works on dense and MoE trees."""
    def scaled(w):
        return (w / math.sqrt(w.shape[-2])).detach()

    for blk in params["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            blk["attn"][name] = scaled(blk["attn"][name])
        tree = blk["moe"] if "moe" in blk else blk
        for name in ("w_up", "w_down"):
            tree[name] = scaled(tree[name])
    params["head"] = scaled(params["head"])
    return params


def run_conditioned_lm(torch, dev, card) -> dict:
    """Phase 24, second case: a well-conditioned LM at the ``lm`` widths
    (``_lecun`` masters from seed 26), three QAT steps as the first case
    takes them, packed with ``quantize=True``; its served f32 logits on the
    kernels held at every one of the 2×256 positions within the LM rule
    2e-4 + 1.1e-4·max|logit| of ``qat_lm_forward`` and of the plain serving
    path, and its B1 calls read against f64 (C1)."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import (
        TernaryLMConfig,
        init_lm,
        lm_forward,
        make_lm_train_step,
        pack_lm,
        qat_lm_forward,
    )
    from smmb_tpu_torch.utils import rng

    (batch, seq), steps = LM_TRAIN_BATCH, 3
    cfg = TernaryLMConfig(**LM_TRAIN, max_len=seq)
    gen = rng.make_generator(26, dev)
    params = _lecun(init_lm(gen, cfg))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    init_opt, train_step = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2,
                                              attn_chunk=64)
    opt = init_opt(params)

    def step():
        nonlocal params, opt
        params, opt, loss = train_step(params, opt, tokens)
        return float(loss)

    losses, ms, peak = zip(*(_timed_step(torch, step) for _ in range(steps)))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"well-conditioned LM QAT: the loss did not fall: {losses}")
    row = _log_steps("well-conditioned LM QAT (LeCun masters, seed 26)", card, list(losses),
                     list(ms), list(peak))
    ev = tokens[:2]
    with torch.no_grad():
        packed = pack_lm(params, quantize=True)
        qat = qat_lm_forward(params, ev, cfg)
        packed_spmm.launches = 0
        served = lm_forward(packed, ev, cfg)
        torch.cuda.synchronize()
        launches = packed_spmm.launches
        plain = lm_forward(packed, ev, cfg, use_kernel=False)
        errs, readings = [], []
        with _held_b1_calls(torch, errs, readings):
            lm_forward(packed, ev, cfg)
    check(launches == 6 * cfg.n_layers + 1, f"served LM forward launched B1 {launches} times")
    check(bool(torch.isfinite(served).all()), "well-conditioned served logits finite")
    stats = {}
    for name, ref in (("kernels vs QAT", qat), ("kernels vs plain serving", plain)):
        e = (served - ref).abs().amax(-1).flatten()
        lim = 2e-4 + 1.1e-4 * float(ref.abs().max())
        stats[name] = {"rule": lim, "median": float(e.median()), "worst": float(e.max()),
                       "beyond_rule": int((e > lim).sum()), "positions": e.numel()}
    log("well-conditioned LM served (lm_forward, f32 kernels): " + "; ".join(
        f"{k}: median {v['median']:.3e}, worst {v['worst']:.3e} (rule {v['rule']:.3e}), "
        f"{v['beyond_rule']} of {v['positions']} beyond" for k, v in stats.items())
        + f"; max|logit| {float(qat.abs().max()):.3f}; B1 calls vs plain {max(errs):.3e}")
    for name, v in stats.items():
        check(v["beyond_rule"] == 0, f"well-conditioned LM, {name}: {v['beyond_rule']} "
              f"positions beyond the rule {v['rule']:.3e} (worst {v['worst']:.3e})")
    check(max(errs) <= 1e-4, f"well-conditioned LM: B1 calls vs plain {max(errs):.3e} > 1e-4")
    c1 = _read_c1(readings, "phase 24 well-conditioned LM")
    return {**row, "served": stats, "b1_call_worst": max(errs), "c1": c1,
            "c1_readings": readings}


def run_finetune_and_mlp_qat(torch, dev, card) -> None:
    """Phase 23: frozen-backbone fine-tuning through B1 (``make_packed_linear``:
    forward on W, backward on Wᵀ) and QAT of the MLP, at BASELINE config 5's
    widths (depth 4, dim 4096, batch 256, ~10% nnz, alpha 0.2)."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.kernels.packed_vjp import make_packed_linear, pack_with_transpose
    from smmb_tpu_torch.models.mlp import TernaryMLPConfig, mlp_forward, pack_mlp
    from smmb_tpu_torch.models.train import make_adam, make_train_step, qat_forward
    from smmb_tpu_torch.utils import rng

    depth, dim, batch, steps = FINETUNE["depth"], FINETUNE["dim"], FINETUNE["batch"], 5
    gen = rng.make_generator(23, dev)
    ws = [rng.rand_ternary(gen, (dim, dim), non_zero=FINETUNE["non_zero"])
          for _ in range(depth)]
    planes = [pack_with_transpose(w) for w in ws]
    x0 = rng.rand_dense(gen, (batch, dim))
    target = rng.rand_dense(gen, (batch, dim))
    gy = rng.rand_dense(gen, (batch, dim))
    b0 = rng.rand_dense(gen, (dim,))
    # keeps each layer's activations O(1): 1/sqrt(nonzeros a column)
    in_scale = float(sum(int(torch.count_nonzero(w)) for w in ws) / (depth * dim)) ** -0.5
    out = {"finetune": {}}
    for name, cdt, tol in (("f32", torch.float32, 1e-4), ("bf16", torch.bfloat16, 2.0 ** -7)):
        w, wt = planes[0]

        def one(kernel):
            x = x0.to(cdt, copy=True).requires_grad_(True)
            b = b0.clone().requires_grad_(True)
            if kernel:
                y = make_packed_linear(w, wt, ALPHA, cdt)(x, b)
            else:
                y = packed_spmm_plain(x, w, b, ALPHA, compute_dtype=cdt)
            (y.float() * gy).sum().backward()
            return y.detach(), x.grad, b.grad

        before = packed_spmm.launches
        got = one(True)
        check(packed_spmm.launches == before + 2, "make_packed_linear launches B1 once "
              "forward (on W) and once backward (on the Wᵀ planes)")
        want = one(False)
        errs = {}
        for g, r, what in zip(got, want, ("y", "dx", "db")):
            check(g.shape == r.shape and bool(torch.isfinite(g).all()), f"{what} {name}")
            err = float((g.float() - r.float()).abs().max())
            lim = tol * max(1.0, float(r.float().abs().max()))
            check(err <= lim, f"packed VJP {name} {what}: {err:.3e} > {lim:.3e} against "
                  "autograd through the plain version")
            errs[what] = err
        log(f"packed VJP {name} at {batch}x{dim}x{dim}: y/dx/db vs plain autograd "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

        layers = [make_packed_linear(w_, wt_, ALPHA, cdt) for w_, wt_ in planes]
        biases = {"b": [torch.zeros((dim,), device=dev) for _ in range(depth)]}
        opt = make_adam(biases, 1e-2)
        xin = x0.to(cdt)

        def step():
            opt.zero_grad(set_to_none=True)
            h = xin
            for layer, b in zip(layers, biases["b"]):
                h = layer(h * in_scale, b)
            loss = torch.mean((h.float() - target) ** 2)
            loss.backward()
            opt.step()
            return float(loss.detach())

        torch.cuda.synchronize()
        packed_spmm.launches = 0
        losses, ms, peak = zip(*(_timed_step(torch, step) for _ in range(steps)))
        launches = packed_spmm.launches
        # forward on every layer; backward on every layer but the first,
        # whose input needs no gradient
        per_step = 2 * depth - 1
        check(launches == steps * per_step, f"fine-tuning {name}: B1 launches {launches} "
              f"!= {steps} steps x {per_step}")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"fine-tuning {name}: the loss did not fall: {losses}")
        row = _log_steps(f"finetune biases through B1 {name}", card, list(losses), list(ms),
                         list(peak))
        out["finetune"][name] = {**row, "max_abs_err": errs, "b1_launches_per_step": per_step}

    # QAT of the MLP: f32 masters off the ternary grid (the ternary codes
    # keep the ~10% pattern: |noise| < 0.02 lies under half the absmean)
    cfg = TernaryMLPConfig(layer_dims=(dim,) * (depth + 1))
    params = {"w": [(0.5 * w + 0.02 * rng.rand_dense(gen, w.shape)) for w in ws],
              "b": [rng.rand_dense(gen, (dim,)) for _ in range(depth)]}
    init_opt, train_step = make_train_step(alpha=ALPHA, learning_rate=1e-3)
    opt = init_opt(params)

    def qat_step():
        nonlocal params, opt
        params, opt, loss = train_step(params, opt, x0, target)
        return float(loss)

    losses, ms, peak = zip(*(_timed_step(torch, qat_step) for _ in range(steps)))
    f32_err = _check_full_f32(torch, x0, params["w"][0], "MLP QAT")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"MLP QAT: the loss did not fall: {losses}")
    out["mlp_qat"] = _log_steps("MLP QAT make_train_step f32", card, list(losses), list(ms),
                                list(peak))
    with torch.no_grad():
        packed = pack_mlp(params, quantize=True)
        trained = qat_forward(params, x0, ALPHA)
        packed_spmm.launches = 0
        served = mlp_forward(packed, x0, cfg)
        torch.cuda.synchronize()
    check(packed_spmm.launches == depth, f"served MLP launched B1 {packed_spmm.launches} times")
    err = float((served - trained).abs().max())
    lim = max(1e-4, 2e-6 * float(trained.abs().max()))
    check(err <= lim, f"MLP served (B1 f32) vs QAT forward: {err:.3e} > {lim:.3e}")
    out["mlp_qat"].update(served_err=err, qat_product_vs_f64=f32_err)
    print(json.dumps({"phase": 23, **out}), flush=True)
    log(f"phase 23 passed: trained MLP served on B1 f32 within {err:.3e} of the QAT forward "
        f"(limit {lim:.3e}, max|y| {float(trained.abs().max()):.3e})")


def run_lm_training(torch, dev, card) -> None:
    """Phase 24: QAT of the LM at the ``lm`` CLI's widths (gradient
    accumulation, chunked attention), its packed serving against the QAT
    forward and a short ``generate``; draft distillation at the ``spec``
    CLI's configurations."""
    from smmb_tpu_torch.bench import spec_bench
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import (
        TernaryLMConfig,
        generate,
        init_lm,
        lm_forward,
        make_lm_train_step,
        pack_lm,
        qat_lm_forward,
    )
    from smmb_tpu_torch.models.spec_decode import make_draft_distill_step
    from smmb_tpu_torch.models.train import param_leaves
    from smmb_tpu_torch.utils import rng

    (batch, seq), steps = LM_TRAIN_BATCH, 3
    layers = LM_TRAIN["n_layers"]
    cfg = TernaryLMConfig(**LM_TRAIN, max_len=seq)
    gen = rng.make_generator(24, dev)
    params = _masters(init_lm(gen, cfg))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    # the accum_steps=1 step's loss from a copy of the same masters
    ref = _map_tree(lambda t: t.detach().clone(), params)
    out = {}
    init1, step1 = make_lm_train_step(cfg, learning_rate=1e-3, attn_chunk=64)
    _, _, loss1 = step1(ref, init1(ref), tokens)
    loss1 = float(loss1)
    del ref
    init_opt, train_step = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2,
                                              attn_chunk=64)
    opt = init_opt(params)

    def step():
        nonlocal params, opt
        params, opt, loss = train_step(params, opt, tokens)
        return float(loss)

    losses, ms, peak = zip(*(_timed_step(torch, step) for _ in range(steps)))
    f32_err = _check_full_f32(torch, params["embed"][tokens[:2]],
                              params["blocks"][0]["attn"]["wq"], "LM QAT")
    check(abs(losses[0] - loss1) <= 1e-5 * abs(loss1), f"accum_steps=2 first loss "
          f"{losses[0]!r} != the accum_steps=1 step's {loss1!r} within rtol 1e-5")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"LM QAT: the loss did not fall: {losses}")
    out["lm_qat"] = _log_steps(f"LM QAT {LM_TRAIN}, batch {batch}x{seq}, accum 2, "
                               "attn_chunk 64", card, list(losses), list(ms), list(peak))
    out["lm_qat"].update(accum1_loss=loss1, qat_product_vs_f64=f32_err)

    # The served logits against the QAT forward. This random model (ternary
    # masters at unit scale) puts attention scores in the hundreds, so a
    # rounding seeded in one layer grows through the next ones and, at a
    # position near an attention tie, moves the logits past the LM rule
    # (2e-4 + 1.1e-4·max|·|): cuBLAS against itself at batch 1 and 2 does.
    # So the rule holds every position of each stage (a block, the head) on
    # the kernels against the same stage on the plain products, both fed the
    # plain path's input, and every B1 call of the served forward is held
    # against its plain version on its own input (phase 3's f32 tolerance).
    # End to end the median position is held at the rule; the worst
    # positions are logged beside two plain orders' (ROADMAP §C).
    ev = tokens[:2]
    with torch.no_grad():
        packed = pack_lm(params, quantize=True)
        qat = qat_lm_forward(params, ev, cfg)
        packed_spmm.launches = 0
        served = lm_forward(packed, ev, cfg)
        torch.cuda.synchronize()
        launches = packed_spmm.launches
        plain = lm_forward(packed, ev, cfg, use_kernel=False)
        qat1 = qat_lm_forward(params, ev[:1], cfg)
        stages = _served_stages(torch, packed, ev, cfg)
        call_errs, readings = [], []
        with _held_b1_calls(torch, call_errs, readings):
            lm_forward(packed, ev, cfg)
    check(launches == 6 * layers + 1, f"served LM forward launched B1 {launches} times")
    check(bool(torch.isfinite(served).all()), "served LM logits finite")
    check(len(call_errs) == launches and max(call_errs) <= 1e-4,
          f"served LM: B1 calls vs plain on their own inputs {max(call_errs):.3e} > 1e-4 "
          "of max(1, max|y|)")

    def rule(a):
        return 2e-4 + 1.1e-4 * float(a.abs().max())

    def per_position(a, b):
        return (a - b).abs().amax(-1).flatten()

    lim = rule(qat)
    pairs = {"kernels vs QAT": per_position(served, qat),
             "plain serving vs QAT": per_position(plain, qat),
             "kernels vs plain serving": per_position(served, plain),
             "QAT at batch 1 vs 2": per_position(qat1, qat[:1])}
    stats = {name: {"median": float(e.median()), "worst": float(e.max()),
                    "beyond_rule": int((e > lim).sum()), "positions": e.numel()}
             for name, e in pairs.items()}
    staged = {name: {"worst": float(per_position(kern, ref).max()), "rule": rule(ref)}
              for name, kern, ref in stages}
    out["lm_qat"].update(served_rule=lim, served_vs_qat=stats, stages=staged,
                         b1_call_worst=max(call_errs))
    log(f"trained LM served (lm_forward, f32 kernels), rule {lim:.3e}: "
        + "; ".join(f"{k}: median {v['median']:.3e}, worst {v['worst']:.3e}, "
                    f"{v['beyond_rule']} of {v['positions']} beyond" for k, v in stats.items()))
    log("stages on the kernels vs the plain products, the plain path's input: "
        + "; ".join(f"{k} worst {v['worst']:.3e} (rule {v['rule']:.3e})"
                    for k, v in staged.items())
        + f"; B1 calls vs plain {max(call_errs):.3e} of max(1, max|y|)")
    for name in ("kernels vs QAT", "plain serving vs QAT", "kernels vs plain serving"):
        check(stats[name]["median"] <= lim,
              f"LM served, {name}: median position {stats[name]['median']:.3e} > {lim:.3e}")
    for name, v in staged.items():
        check(v["worst"] <= v["rule"], f"LM served, {name} on the kernels vs the plain "
              f"products: worst position {v['worst']:.3e} > {v['rule']:.3e}")
    out["lm_qat"]["c1"] = _read_c1(readings, "phase 24 served LM")
    out["lm_qat"]["c1_readings"] = readings

    gsteps, prompt = 16, tokens[:1, :32]
    counted = (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, gsteps, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    check(toks.shape == (1, gsteps) and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          "generate on the trained model: tokens shape / range")
    check(launches == {"packed_spmm": 6 * layers + 1 + gsteps,
                       "fused_norm_qkv": layers * gsteps,
                       "fused_block_tail": layers * gsteps, "fused_mlp": layers},
          f"generate on the trained model: launches {launches}")
    out["lm_qat"]["generate_launches"] = launches
    log(f"generate on the trained, packed LM ({gsteps} steps, bf16): launches {launches}")
    del params, opt, packed
    out["conditioned"] = run_conditioned_lm(torch, dev, card)

    tcfg, dcfg = spec_bench.configs()
    target, _, _ = spec_bench.build(tcfg, dcfg, 32, device=dev)
    dgen = rng.make_generator(25, dev)
    draft = _masters(init_lm(dgen, dcfg))
    dtoks = torch.randint(0, tcfg.vocab, (8, 128), generator=dgen, device=dev)
    init_d, distill_step = make_draft_distill_step(target, tcfg, dcfg, learning_rate=5e-3)
    dopt = init_d(draft)

    def agreement():
        with torch.no_grad():
            t = lm_forward(target, dtoks, tcfg).argmax(-1)
            d = lm_forward(pack_lm(draft, quantize=True), dtoks, dcfg).argmax(-1)
        return float((t == d).float().mean())

    a0 = agreement()

    def dstep():
        nonlocal draft, dopt
        draft, dopt, loss = distill_step(draft, dopt, dtoks)
        return float(loss)

    torch.cuda.synchronize()
    packed_spmm.launches = 0
    dsteps = 5
    losses, ms, peak = zip(*(_timed_step(torch, dstep) for _ in range(dsteps)))
    per_step = 6 * tcfg.n_layers + 1  # the target's forward: B1 only at 1024 rows
    check(packed_spmm.launches == dsteps * per_step,
          f"distillation: B1 launches {packed_spmm.launches} != {dsteps} x {per_step}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"distillation: the loss did not fall: {losses}")
    a1 = agreement()
    out["distill"] = _log_steps("draft distillation (spec CLI target and draft, 8x128)",
                                card, list(losses), list(ms), list(peak))
    out["distill"].update(agreement_before=a0, agreement_after=a1,
                          b1_launches_per_step=per_step,
                          draft_params=sum(t.numel() for t in param_leaves(draft)))
    print(json.dumps({"phase": 24, **out}), flush=True)
    log(f"phase 24 passed: distillation argmax agreement {a0:.4f} -> {a1:.4f} "
        "(logged, not gated)")


# ------------------------------------------------------------ MoE and LoRA slice

MOE_LM = dict(n_experts=8, top_k=2)  # Mixtral's routing at the `lm` widths
NEAR_GATE = 1e-4  # a route flip is exempt only at a rank-k gap under this share


def _moe_routes(torch, blk, x, bcfg):
    """(chosen experts (N, k), ascending; the gates sorted descending (N, E))
    of an MoE half's router on the residual stream ``x``, as serving routes."""
    from smmb_tpu_torch.models import moe
    from smmb_tpu_torch.models.transformer import rmsnorm

    h = rmsnorm(x, blk["norm2"], bcfg.eps).reshape(-1, x.shape[-1])
    logits = moe.router_logits(h, blk["moe"]["router"])
    expert = moe._assign(logits, moe._round8(h.shape[0]), bcfg.top_k)[0]
    return (expert.sort(dim=1).values,
            torch.softmax(logits, dim=-1).sort(dim=-1, descending=True).values)


def _hold_stages(torch, what, packed, tokens, cfg) -> dict:
    """Each block and the head of ``lm_forward`` (f32) on the kernels
    against the plain products, both fed the plain path's input, held at
    every position within the stage's rule 2e-4 + 1.1e-4·max|·|. In an MoE
    block a position beyond the rule is exempt only where the two paths
    routed its token to different experts at a near tie of the plain
    path's gates (rank k against rank k+1 within NEAR_GATE of the largest);
    a different route at a wider gap fails."""
    from smmb_tpu_torch.models import lm
    from smmb_tpu_torch.models import moe_block as mb
    from smmb_tpu_torch.models import transformer as tb
    from smmb_tpu_torch.models.attention import attention_forward

    f32, bcfg = torch.float32, cfg.block
    x = packed["embed"][tokens] + packed["pos"][None, :tokens.shape[1]]
    out, exempt = {}, 0
    for i, blk in enumerate(packed["blocks"]):
        flips = None
        if "moe" in blk:
            h = tb.rmsnorm(x, blk["norm1"], bcfg.eps)
            mids = [x + attention_forward(blk["attn"], h, bcfg.attn, use_kernel=uk)
                    for uk in (True, False)]
            kern = mb._moe_half(blk, mids[0], bcfg, f32, True)
            plain = mb._moe_half(blk, mids[1], bcfg, f32, False)
            (ek, _), (ep, gates) = (_moe_routes(torch, blk, m, bcfg) for m in mids)
            flips = (ek != ep).any(dim=1)
            k = bcfg.top_k
            near = gates[:, k - 1] - gates[:, k] <= NEAR_GATE * gates[:, 0]
            check(not bool((flips & ~near).any()), f"{what}, block {i}: "
                  f"{int((flips & ~near).sum())} tokens routed to other experts on the "
                  "kernels at a gate gap wider than a near tie")
        else:
            kern = tb.block_forward(blk, x, bcfg)
            plain = tb.block_forward(blk, x, bcfg, use_kernel=False)
        err = (kern - plain).abs().amax(-1).flatten()
        rule = 2e-4 + 1.1e-4 * float(plain.abs().max())
        beyond = err > rule
        if flips is not None:
            exempt += int((beyond & flips).sum())
            beyond = beyond & ~flips
        out[f"block {i}"] = {"worst": float(err.max()), "rule": rule,
                             "route_flips": 0 if flips is None else int(flips.sum())}
        check(not bool(beyond.any()), f"{what}, block {i} on the kernels vs the plain "
              f"products: {int(beyond.sum())} positions beyond the rule {rule:.3e} "
              f"(worst {float(err.max()):.3e})")
        x = plain
    h = tb.rmsnorm(x, packed["norm_f"], cfg.eps)
    kern = lm._head_logits(packed, h, cfg, f32, True)
    plain = lm._head_logits(packed, h, cfg, f32, False)
    err = (kern - plain).abs().amax(-1).flatten()
    rule = 2e-4 + 1.1e-4 * float(plain.abs().max())
    out["head"] = {"worst": float(err.max()), "rule": rule}
    check(float(err.max()) <= rule, f"{what}, the head on the kernels vs the plain "
          f"products: worst position {float(err.max()):.3e} > {rule:.3e}")
    log(f"{what}, stages on the kernels vs the plain products (the plain path's input): "
        + "; ".join(f"{k} worst {v['worst']:.3e} (rule {v['rule']:.3e}"
                    + (f", {v['route_flips']} near-tie route flips" if v.get("route_flips")
                       else "") + ")" for k, v in out.items())
        + f"; {exempt} positions exempt by a near-tie route flip")
    return {"stages": out, "exempt_positions": exempt}


def _counted():
    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

    return (packed_spmm, fk.fused_norm_qkv, fk.fused_block_tail, fk.fused_mlp,
            fk.fused_norm_qkv_quant, fa.flash_attention, fd.flash_attention_decode)


def _generate_counted(torch, packed, prompt, cfg, steps, **kw):
    """(tokens, launches of every LM kernel) of one ``generate`` call, the
    counts set to 0 just before it and read just after."""
    from smmb_tpu_torch.models.lm import generate

    counted = _counted()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    toks = generate(packed, prompt, cfg, steps, **kw)
    torch.cuda.synchronize()
    return toks, {fn.__name__: fn.launches for fn in counted}


def run_moe_lm(torch, dev, card) -> None:
    """Phase 25: the MoE LM (A3.3) at the ``lm`` widths with 8 experts,
    top-2: ``generate`` with and without flash and its launch counts, the
    teacher-forced f32 logits held call by call and stage by stage, the
    ``lm --experts 8 --top-k 2`` bench, and three QAT steps."""
    from smmb_tpu_torch.bench.lm_bench import build_lm, config_from_args, parser, run_lm_bench
    from smmb_tpu_torch.models.lm import TernaryLMConfig

    layers, prompt_len, steps, e = LM_TRAIN["n_layers"], 32, 64, MOE_LM["n_experts"]
    cfg = TernaryLMConfig(**LM_TRAIN, max_len=prompt_len + 3 * steps, **MOE_LM)
    packed, prompt = build_lm(cfg, 1, prompt_len, device=dev)
    out = {}
    # B1: per layer in the prefill 6 projections, per layer a decode step
    # the fused QKV plane and wo; the head once in the prefill and once a
    # step. The experts: in bf16 two B1g launches a layer a call (the
    # grouped experts); in f32 (the slab loop) 2 B1 launches per expert.
    # No fused kernel (the MoE half has no MLP; its attention gets
    # normalized input, no prenorm).
    b1 = layers * 6 + 1 + steps * (layers * 2 + 1)
    b1_slab = layers * (6 + 2 * e) + 1 + steps * (layers * (2 + 2 * e) + 1)
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

    for flash in (False, True):
        packed_spmm.launches_grouped = 0
        toks, launches = _generate_counted(torch, packed, prompt, cfg, steps,
                                           compute_dtype=torch.bfloat16, use_flash=flash)
        launches["packed_spmm(grouped)"] = packed_spmm.launches_grouped
        log(f"MoE generate (E={e}, top-2, bf16, flash={flash}): launches {launches}")
        check(toks.shape == (1, steps) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab, "MoE generate tokens shape / range")
        want = {"packed_spmm": b1, "fused_norm_qkv": 0, "fused_block_tail": 0,
                "fused_mlp": 0, "fused_norm_qkv_quant": 0,
                "flash_attention": layers if flash else 0,
                "flash_attention_decode": layers * steps if flash else 0,
                "packed_spmm(grouped)": 2 * layers * (1 + steps)}
        check(launches == want, f"MoE generate launches {launches} != {want}")
        out[f"generate_launches{'_flash' if flash else ''}"] = launches

    # teacher-forced f32 on the kernels' own tokens: every B1 call of the
    # prefill and the decode steps against its plain version on its own
    # input, then each stage of the forward over the same 96 tokens
    ids, _ = _generate_counted(torch, packed, prompt, cfg, steps, compute_dtype=torch.float32)
    errs = []
    with _held_b1_calls(torch, errs):
        kern = _teacher_forced(torch, cfg, packed, prompt, ids, torch.float32, True)
    check(torch.equal(kern.argmax(-1), ids[0]),
          "teacher-forced MoE kernel path reproduces generate's tokens")
    # the teacher-forced run takes one decode step fewer than generate
    check(len(errs) == b1_slab - (layers * (2 + 2 * e) + 1) and max(errs) <= 1e-4,
          f"MoE teacher-forced: {len(errs)} B1 calls, worst vs plain {max(errs):.3e} > 1e-4")
    with plain_kernels():
        plain = _teacher_forced(torch, cfg, packed, prompt, ids, torch.float32, True)
    e2e = (kern - plain).abs().amax(-1)
    with torch.no_grad():
        stages = _hold_stages(torch, "MoE LM", packed, torch.cat([prompt, ids], 1), cfg)
    out.update(b1_calls=len(errs), b1_call_worst=max(errs), **stages,
               end_to_end={"median": float(e2e.median()), "worst": float(e2e.max()),
                           "rule": 2e-4 + 1.1e-4 * float(plain.abs().max())})
    log(f"MoE teacher-forced f32: {len(errs)} B1 calls within {max(errs):.3e} of plain; end "
        f"to end (logged) median {float(e2e.median()):.3e}, worst {float(e2e.max()):.3e}")

    args = parser().parse_args(["--experts", str(e), "--top-k", str(MOE_LM["top_k"])])
    r = run_lm_bench(config_from_args(args), args.batch, args.prompt_len, args.steps,
                     reps=3, device=dev)
    out["lm_bench"] = {"us_per_token": r.per_token_s * 1e6, "tok_per_s": r.tokens_per_s,
                       "lo_ms": r.lo_s * 1e3, "hi_ms": r.hi_s * 1e3, "card": card}
    log(f"lm --experts {e} --top-k {MOE_LM['top_k']}: {r.per_token_s * 1e6:.1f} us/token, "
        f"{r.tokens_per_s:.0f} tok/s ({card})")
    del packed

    # QAT at phase 24's batch, twice, each case's steps also taken by the
    # port on CPU tensors from the same masters and tokens. On unit-scale
    # masters (phase 24's first case) the first step's loss is held against
    # the CPU's and the later ones logged: one Adam step of a model this
    # chaotic lands elsewhere under another f32 order. On LeCun-scale
    # masters (phase 24's second case) the first step's loss and gradients
    # are held against the CPU's at the twins' rule and the loss falls. In
    # both the aux is positive and aux_weight moves the loss.
    out["qat"] = {name: _moe_qat(torch, dev, card, seed, lecun)
                  for name, seed, lecun in (("unit_scale", 27, False), ("lecun", 29, True))}
    print(json.dumps({"phase": 25, **out}), flush=True)
    log("phase 25 passed")


# the unit-scale MoE QAT case's first loss on the card against the port's on
# CPU tensors, relative (a forward on the same masters; set before the run
# that read it). After the first Adam step the two trajectories part (PR
# 17: 9.3e-3 at the second step), so the later steps are logged.
MOE_QAT_CPU_RTOL = 1e-3
# the LeCun-scale case's first step against the CPU's, as the training twins
# hold one step: the loss within 3e-5 of it, every gradient within 3e-5 of
# the largest |g| of all tensors
MOE_QAT_GRAD_REL = 3e-5


def _moe_qat(torch, dev, card, seed, lecun) -> dict:
    """Three MoE LM QAT steps at phase 24's batch (accum 2, attn_chunk 64)
    from seed ``seed``, taken again on CPU tensors (three steps on unit-scale
    masters, one on LeCun-scale ones) and held against them; the loss must
    fall when ``lecun``."""
    from smmb_tpu_torch.models.lm import (
        TernaryLMConfig,
        _qat_lm_forward_aux,
        init_lm,
        make_lm_train_step,
    )
    from smmb_tpu_torch.utils import rng

    (batch, seq) = LM_TRAIN_BATCH
    cfg = TernaryLMConfig(**LM_TRAIN, max_len=seq, **MOE_LM)
    gen = rng.make_generator(seed, dev)
    params = init_lm(gen, cfg)
    params = _lecun(params) if lecun else _masters(params)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    on_cpu = (_map_tree(lambda t: t.detach().to("cpu", copy=True), params), tokens.cpu())
    ref = _map_tree(lambda t: t.detach().clone(), params)
    init0, step0 = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2, attn_chunk=64,
                                      aux_weight=0.0)
    _, _, loss0 = step0(ref, init0(ref), tokens)
    loss0 = float(loss0)
    del ref
    init_opt, train_step = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2,
                                              attn_chunk=64)
    opt = init_opt(params)
    with torch.no_grad():
        aux = float(_qat_lm_forward_aux(params, tokens[:4], cfg, attn_chunk=64)[1])
    grads = []

    def step():
        nonlocal params, opt
        params, opt, loss = train_step(params, opt, tokens)
        if lecun and not grads:  # the first step's gradients, left in .grad
            grads.extend(_grads(torch, params))
        return float(loss)

    what = f"MoE LM QAT ({'LeCun' if lecun else 'unit'}-scale masters, seed {seed})"
    losses, ms, peak = zip(*(_timed_step(torch, step) for _ in range(3)))
    check(all(math.isfinite(x) for x in losses), f"{what}: losses {losses}")
    cpu_losses, cpu_ms, cpu_grads = _cpu_qat_steps(torch, cfg, *on_cpu, 1 if lecun else 3)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)]
    row_cpu = {"cpu_losses": cpu_losses, "cpu_step_ms": cpu_ms, "card_vs_cpu_rel": rel}
    msg = (f"{what} on CPU tensors (the port, {torch.get_num_threads()} threads): losses "
           f"{', '.join(f'{x:.6g}' for x in cpu_losses)}; step s "
           f"{', '.join(f'{x / 1e3:.1f}' for x in cpu_ms)}; card against CPU, relative: "
           f"{', '.join(f'{x:.3e}' for x in rel)}")
    if lecun:
        gmax = max(float(g.abs().max()) for g in cpu_grads)
        gerr = max(float((a - b).abs().max()) for a, b in zip(grads, cpu_grads))
        row_cpu.update(grad_err=gerr, grad_max=gmax)
        log(f"{msg}; first step's gradients within {gerr:.3e} of the CPU's, max|g| "
            f"{gmax:.3e} (limits {MOE_QAT_GRAD_REL} of the loss and of max|g|)")
        check(rel[0] <= MOE_QAT_GRAD_REL and gerr <= MOE_QAT_GRAD_REL * gmax,
              f"{what}: the first step against the CPU's: loss {rel[0]:.3e}, gradients "
              f"{gerr:.3e} of max|g| {gmax:.3e}")
        check(losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")
    else:
        log(f"{msg} (limit {MOE_QAT_CPU_RTOL} on the first; the later ones logged)")
        check(rel[0] <= MOE_QAT_CPU_RTOL,
              f"{what}: first loss {losses[0]!r} against the CPU's {cpu_losses[0]!r}")
    check(aux > 0, f"{what}: aux {aux} is not positive")
    check(loss0 != losses[0], f"{what}: aux_weight=0 gives the same loss {loss0!r}")
    row = _log_steps(f"{what} {LM_TRAIN} {MOE_LM}, batch {batch}x{seq}, accum 2, "
                     "attn_chunk 64", card, list(losses), list(ms), list(peak))
    log(f"{what}: aux {aux:.6g} on the first microbatch; first loss {losses[0]!r} "
        f"(aux_weight 1e-2) against {loss0!r} (aux_weight 0)")
    return {**row, **row_cpu, "aux_first_microbatch": aux, "loss_aux_weight_0": loss0}


def _grads(torch, params) -> list:
    """Every master's .grad on the CPU (zeros where a master took none), in
    ``param_leaves`` order."""
    from smmb_tpu_torch.models.train import param_leaves

    return [(p.grad if p.grad is not None else torch.zeros_like(p)).detach().to(
        "cpu", copy=True) for p in param_leaves(params)]


def _cpu_qat_steps(torch, cfg, params, tokens, steps) -> tuple:
    """``steps`` LM QAT steps of ``_moe_qat``'s settings through the port on
    CPU tensors: (losses, host ms a step, the first step's gradients)."""
    from smmb_tpu_torch.models.lm import make_lm_train_step

    init_opt, train_step = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2,
                                              attn_chunk=64)
    opt, losses, ms, grads = init_opt(params), [], [], None
    for _ in range(steps):
        t = time.perf_counter()
        params, opt, loss = train_step(params, opt, tokens)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t) * 1e3)
        grads = grads or _grads(torch, params)
    return losses, ms, grads


def run_lora_lm(torch, dev, card, lm) -> None:
    """Phase 26: LoRA (A3.4) on phase 8's LM at the ``lm`` widths, rank 8 on
    wq, wv, w_up and w_down: one ``make_lora_train_step`` step, the base's
    packed bytes unchanged, ``generate`` on the adapted model with its
    launch counts, and its served f32 logits held call by call and stage
    by stage."""
    from smmb_tpu_torch.models.lm import lm_forward
    from smmb_tpu_torch.models.lora import attach_lora, init_lora_lm, make_lora_train_step
    from smmb_tpu_torch.utils import rng

    cfg, packed, prompt = lm["cfg"], lm["packed"], lm["prompt"]
    layers, steps = cfg.n_layers, 16
    targets = ("wq", "wv", "w_up", "w_down")
    gen = rng.make_generator(28, dev)
    adapters = init_lora_lm(gen, cfg, rank=8, targets=targets)
    tokens = torch.randint(0, cfg.vocab, (4, 128), generator=gen, device=dev)
    before = {id(t): t.data.clone() for t in _packed_planes(packed)}
    init_opt, train_step = make_lora_train_step(packed, cfg, learning_rate=1e-3)
    opt = init_opt(adapters)

    def step():
        nonlocal adapters, opt
        adapters, opt, loss = train_step(adapters, opt, tokens)
        return float(loss)

    (loss,), (ms,), (peak,) = zip(_timed_step(torch, step))
    check(math.isfinite(loss), f"LoRA step loss {loss}")
    check(all(torch.equal(t.data, before[id(t)]) for t in _packed_planes(packed)),
          "the LoRA step changed the packed base's bytes")
    moved = max(float(b.detach().abs().max()) for blk in adapters for _, b in blk.values())
    check(moved > 0, "the LoRA step left every B at zero")
    out = {"step": _log_steps("LoRA step (rank 8, wq/wv/w_up/w_down, 4x128)", card, [loss],
                              [ms], [peak])}
    model = attach_lora(packed, [{n: (a.detach(), b.detach()) for n, (a, b) in blk.items()}
                                 for blk in adapters])
    # adapted Q/V take the per-projection path (3 B1 calls a step, no B3),
    # adapted w_up/w_down keep the block off B5 and B6 (2 B1 calls)
    b1 = layers * 8 + 1 + steps * (layers * 6 + 1)
    toks, launches = _generate_counted(torch, model, prompt, cfg, steps,
                                       compute_dtype=torch.bfloat16)
    log(f"LoRA generate ({steps} steps, bf16): launches {launches}")
    want = {"packed_spmm": b1, "fused_norm_qkv": 0, "fused_block_tail": 0, "fused_mlp": 0,
            "fused_norm_qkv_quant": 0, "flash_attention": 0, "flash_attention_decode": 0}
    check(launches == want, f"LoRA generate launches {launches} != {want}")
    check(toks.shape == (1, steps) and int(toks.max()) < cfg.vocab, "LoRA generate tokens")
    ev = tokens[:2]
    errs = []
    with torch.no_grad():
        with _held_b1_calls(torch, errs):
            served = lm_forward(model, ev, cfg)
        base = lm_forward(packed, ev, cfg)
        stages = _hold_stages(torch, "LoRA LM", model, ev, cfg)
    check(len(errs) == 6 * layers + 1 and max(errs) <= 1e-4,
          f"LoRA served: {len(errs)} B1 calls, worst vs plain {max(errs):.3e} > 1e-4")
    check(bool(torch.isfinite(served).all()), "LoRA served logits finite")
    shift = float((served - base).abs().max())
    check(shift > 0, "the trained adapters do not change the served logits")
    out.update(generate_launches=launches, b1_call_worst=max(errs), adapter_shift=shift,
               **stages)
    print(json.dumps({"phase": 26, **out}), flush=True)
    log(f"phase 26 passed: {len(errs)} B1 calls within {max(errs):.3e} of plain; the "
        f"adapters move the logits by up to {shift:.3e}")


# ------------------------------------------------------------ runtime slice

RUNTIME_CORPUS = 1 << 26  # tokens of phase 27's corpus: 256 MB of uint32
# measure_device's per-call device time against the profiler's device time of
# the same call (bench/trace.py): at least GRAPH_LO times it and at most
# GRAPH_HI times it plus GRAPH_ADD_US (a graph's gap between two kernels)
GRAPH_LO, GRAPH_HI, GRAPH_ADD_US = 0.9, 1.25, 2.0


def run_runtime(torch, dev, card) -> dict:
    """Phase 27: the runtime and ``measure_device``."""
    from smmb_tpu_torch.bench.measure import measure, measure_device
    from smmb_tpu_torch.bench.trace import kernel_breakdown
    from smmb_tpu_torch.formats.bcsr import bcsr_from_dense
    from smmb_tpu_torch.formats.packed import TernaryPacked, pack_ternary_device
    from smmb_tpu_torch.formats.tcsc import tcsc_from_dense
    from smmb_tpu_torch.kernels import fused_mlp as fk
    from smmb_tpu_torch.kernels.bcsr_spmm import (
        bcsr_prepare,
        bcsr_spmm_kernel,
        bcsr_spmm_kernel_plain,
    )
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, make_lm_train_step
    from smmb_tpu_torch.runtime import data, native
    from smmb_tpu_torch.utils import rng

    out = {}
    t = time.perf_counter()
    check(native.native_available(), "the native runtime library did not build")
    out["build_s"] = time.perf_counter() - t
    check(native.library_path().parent == HERE / "smmb_tpu_torch" / "_build",
          "the runtime library lies outside smmb_tpu_torch/_build")

    # the headline W of phase 3's C1 reading (seed 3), its formats built natively
    gen = rng.make_generator(3, dev)
    x = rng.rand_dense(gen, (256, 4096))
    w = rng.rand_ternary(gen, (4096, 4096), non_zero=10)
    b = rng.rand_dense(gen, (4096,))
    w_np = w.cpu().numpy()
    t = time.perf_counter()
    p = native.pack_ternary_native(w_np, dev)
    out["pack_native_s"] = time.perf_counter() - t
    t = time.perf_counter()
    tcsc = native.tcsc_from_dense_native(w_np, dev)
    out["tcsc_native_s"] = time.perf_counter() - t
    t = time.perf_counter()
    bcsr = native.bcsr_from_dense_native(w_np, 128, 128, dev)
    out["bcsr_native_s"] = time.perf_counter() - t
    t = time.perf_counter()
    p_dev = pack_ternary_device(w)
    torch.cuda.synchronize()
    out["pack_device_s"] = time.perf_counter() - t
    check(torch.equal(p.data, p_dev.data) and p.nnz == int(torch.count_nonzero(w)),
          "natively packed planes differ from pack_ternary_device's")
    t_np, t_bc = tcsc_from_dense(w_np, dev), bcsr_from_dense(w_np, 128, 128, dev)
    check(all(torch.equal(getattr(tcsc, f), getattr(t_np, f)) for f in
              ("col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg")),
          "native TCSC differs from formats.tcsc's")
    check(bcsr.k == t_bc.k and all(torch.equal(getattr(bcsr, f), getattr(t_bc, f)) for f in
                                   ("b_row_start", "b_col_idx", "b_values")),
          "native BCSR differs from formats.bcsr's")
    prepared = bcsr_prepare(bcsr, dev)
    for name, cdt, tol in (("f32", torch.float32, 1e-4), ("bf16", torch.bfloat16, 2.0 ** -7)):
        before = (packed_spmm.launches, bcsr_spmm_kernel.launches)
        y = packed_spmm(x, p, b, ALPHA, compute_dtype=cdt)
        ref = packed_spmm_plain(x, p, b, ALPHA, compute_dtype=cdt)
        xb = x.to(cdt)
        y2, ref2 = bcsr_spmm_kernel(xb, prepared, b, ALPHA), bcsr_spmm_kernel_plain(xb, prepared,
                                                                                   b, ALPHA)
        torch.cuda.synchronize()
        check((packed_spmm.launches, bcsr_spmm_kernel.launches)
              == (before[0] + 1, before[1] + 1), f"B1 and B2 launch once each ({name})")
        for what, got, want in (("B1", y, ref), ("B2", y2, ref2)):
            err = float((got.float() - want.float()).abs().max())
            lim = tol * max(1.0, float(want.float().abs().max()))
            check(err <= lim, f"{what} {name} on the native formats vs plain: {err:.3e} > "
                  f"{lim:.3e}")
            out[f"{what}_{name}_err"] = err
    log(f"native runtime built in {out['build_s']:.1f}s; headline W packed natively in "
        f"{out['pack_native_s']:.3f}s (pack_ternary_device {out['pack_device_s']:.3f}s), "
        f"TCSC {out['tcsc_native_s']:.3f}s, BCSR 128x128 {out['bcsr_native_s']:.3f}s, each "
        "byte-identical to the port's formats; B1 and B2 on them within their tolerances")

    # a corpus from the seed, read back by TokenDataset
    import tempfile

    import numpy as np

    vocab = LM_TRAIN["vocab"]
    with tempfile.TemporaryDirectory() as work:
        path = str(Path(work) / "corpus.u32")
        t = time.perf_counter()
        data.write_token_file(path, np.random.default_rng(27).integers(
            0, vocab, RUNTIME_CORPUS, dtype=np.uint32))
        out["corpus_write_s"] = time.perf_counter() - t
        ds = data.TokenDataset(path, seq_len=256, batch=8, seed=27)
        n, t = 0, time.perf_counter()
        for batch in ds.batches(0):
            n += 1
            if n == 4096:
                break
        out["windows_per_s"] = n * 8 / (time.perf_counter() - t)
        check(batch.shape == (8, 257) and batch.dtype == torch.int64
              and 0 <= int(batch.min()) and int(batch.max()) < vocab, "TokenDataset batch")
        log(f"corpus of {RUNTIME_CORPUS} tokens written in {out['corpus_write_s']:.2f}s; "
            f"TokenDataset (seq 256, batch 8, native): {out['windows_per_s']:.0f} windows/s "
            f"over {n} batches of {len(ds)}")

        # three LM QAT steps at the `lm` widths on its batches (phase 24's
        # accumulation and attn_chunk; windows of 256 tokens, phase 24's rows)
        (bs, seq) = LM_TRAIN_BATCH
        cfg = TernaryLMConfig(**LM_TRAIN, max_len=seq)
        params = _masters(init_lm(rng.make_generator(27, dev), cfg))
        init_opt, train_step = make_lm_train_step(cfg, learning_rate=1e-3, accum_steps=2,
                                                  attn_chunk=64)
        opt = init_opt(params)
        batches = data.TokenDataset(path, seq_len=seq - 1, batch=bs, seed=27).batches(0)

        def step():
            nonlocal params, opt
            params, opt, loss = train_step(params, opt, next(batches).to(dev))
            return float(loss)

        losses, ms, peak = zip(*(_timed_step(torch, step) for _ in range(3)))
    check(all(math.isfinite(v) for v in losses), f"LM QAT on the corpus: losses {losses}")
    out["lm_qat"] = _log_steps(f"LM QAT {LM_TRAIN} on TokenDataset batches {bs}x{seq}, "
                               "accum 2, attn_chunk 64", card, list(losses), list(ms),
                               list(peak))

    # measure_device at the LM's M=1 calls, against the profiler's device time
    bf16 = torch.bfloat16
    hgen = rng.make_generator(27, dev)
    head = pack_ternary_device(rng.rand_ternary(hgen, (1024, 8192), non_zero=2))
    x1 = rng.rand_dense(hgen, (1, 1024))
    qkv = _fused_inputs(torch, hgen, "fused_norm_qkv", 1, 1024, 3072, dev)
    qkv_kw = _kernel_kwargs("fused_norm_qkv", bf16)
    cases = {
        "b1_head_1x1024x8192": (lambda a, d: packed_spmm(
            a, TernaryPacked(d, head.rows, head.cols, head.nnz), compute_dtype=bf16),
            (x1, head.data)),
        "b3_1x1024x3072": (lambda *a: fk.fused_norm_qkv(*a, **qkv_kw), qkv),
    }
    out["measure_device"] = {}
    for name, (fn, args) in cases.items():
        graph_us = measure_device(fn, *args).min_s * 1e6
        prof_us = sum(r["us"] for r in kernel_breakdown(fn, *args, n_calls=50))
        host_us = measure(fn, *args).min_s * 1e6
        row = {"call": name, "graph_us": graph_us, "profiler_us": prof_us, "host_us": host_us,
               "limits_us": [GRAPH_LO * prof_us, GRAPH_HI * prof_us + GRAPH_ADD_US]}
        if name.startswith("b1"):  # W streamed from device memory, a copy a call
            row["graph_rotated_us"] = measure_device(fn, *args, rotate_argnums=(1,)).min_s * 1e6
        print(json.dumps({"measure_device": row, "card": card}), flush=True)
        check(row["limits_us"][0] <= graph_us <= row["limits_us"][1],
              f"measure_device {name}: {graph_us:.2f} us outside {row['limits_us']} "
              f"(profiler {prof_us:.2f} us)")
        out["measure_device"][name] = row
    log("phase 27 passed: " + "; ".join(
        f"{k} {r['graph_us']:.2f} us under a graph, {r['profiler_us']:.2f} by the profiler, "
        f"{r['host_us']:.2f} a call by measure" for k, r in out["measure_device"].items()))
    return out


# ------------------------------------------------------------ parallel layer
PAR_HEADLINE = (256, 4096, 4096, 10)  # M, K, N, non_zero of the sharded SpMMs
PAR_MODES = {  # name: (compute dtype, x dtype, tolerance of max(1, max|Y|))
    "f32": ("float32", "float32", 1e-4),
    "bf16": ("bfloat16", "bfloat16", 2.0 ** -7),
    "int8": ("int8", "float32", 1e-6),
}
PAR_BCSR = (256, 1024, 4096)  # the showcase's largest case, all 128x128 blocks stored
PAR_CALLS = 20  # calls a timed batch of a sharded call (every rank the same)
PAR_LM = dict(vocab=8192, d_model=1024, n_heads=8, d_ff=4096, n_layers=4)  # the `lm` CLI's
PAR_PROMPT, PAR_STEPS = 32, 64
DP_BATCH = (4, 128)  # tokens of a DP step: 2 rows a rank on 2 ranks
PAR_MLP = (4, 4096, 256, 10)  # depth, dim, batch, non_zero: BASELINE config 5
PAR_BLOCK = dict(d_model=4096, n_heads=8, d_ff=4096)  # scaling's tp_block
LM_RULE = (2e-4, 1.1e-4)  # the LM rule: 2e-4 + 1.1e-4·max|logit|
BF16_TOL = 2.0 ** -7  # bf16 results, relative to max(1, max|ref|)


def _rank_log(world, msg: str, phase: int = 28) -> None:
    if world.rank == 0:
        log(f"[phase {phase}, rank 0 of {world.size}] {msg}")


@contextlib.contextmanager
def _plain_sharded():
    """The parallel layer's per-rank bodies on their plain versions (B1 and
    B2); the launch counts do not move."""
    from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_spmm_kernel_plain
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm_plain
    from smmb_tpu_torch.parallel import bcsr_sharded, sharded

    saved = (sharded.packed_spmm, bcsr_sharded.bcsr_spmm_kernel)
    sharded.packed_spmm = packed_spmm_plain
    bcsr_sharded.bcsr_spmm_kernel = (
        lambda x, w, b=None, alpha=None, **_: bcsr_spmm_kernel_plain(x, w, b, alpha))
    try:
        yield
    finally:
        sharded.packed_spmm, bcsr_sharded.bcsr_spmm_kernel = saved


def _par_time(torch, fn, calls=PAR_CALLS) -> float:
    """ms a call of ``fn`` (a fixed number of calls, so that the ranks issue
    the same collectives)."""
    from smmb_tpu_torch.bench.measure import measure

    return measure(fn, calls=calls, reps=5).min_s * 1e3


def _par_alone(torch, world, fn) -> float | None:
    """ms a call of ``fn`` timed on rank 0 while the other ranks wait at a
    barrier (None on them)."""
    import torch.distributed as dist

    from smmb_tpu_torch.bench.measure import measure

    t = measure(fn, reps=5).min_s * 1e3 if world.rank == 0 else None
    dist.barrier()
    return t


def _par_spmms(torch, world, mesh) -> dict:
    """Phase 28a: the sharded SpMMs at the headline in each mode: column
    shards gathered bitwise the unsharded B1 call; row and ring-overlap
    shards against the same sharded calls on the plain bodies, and against
    an unsharded reference: in f32 and bf16 the unsharded B1 call; in int8,
    whose sharded paths quantize X per K chunk (as JAX's), the unsharded B1
    call on each chunk of X and of the dense W, summed in f32, then the
    bias and the PReLU."""
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.overlap import sharded_spmm_column_overlapped
    from smmb_tpu_torch.parallel.sharded import (
        shard_packed_columns,
        shard_packed_rows,
        sharded_spmm_column,
        sharded_spmm_row,
    )
    from smmb_tpu_torch.utils import rng

    m, k, n, nz = PAR_HEADLINE
    dev = mesh.device
    gen = rng.make_generator(0, dev)
    x32 = rng.rand_dense(gen, (m, k))
    w = rng.rand_ternary(gen, (k, n), non_zero=nz)
    b = rng.rand_dense(gen, (n,))
    p = pack_ternary_device(w)
    pc, pr = shard_packed_columns(p, mesh), shard_packed_rows(p, mesh)
    kc = k // mesh.model
    w_chunks = [pack_ternary_device(w[j * kc:(j + 1) * kc]) for j in range(mesh.model)]
    out, launches = {}, {}
    for name, (cdt_name, xdt_name, tol) in PAR_MODES.items():
        cdt, x = getattr(torch, cdt_name), x32.to(getattr(torch, xdt_name))
        xk = pm.local_cols(x, mesh)
        kw = dict(mesh=mesh, alpha=ALPHA, compute_dtype=cdt)
        whole = packed_spmm(x, p, b, ALPHA, compute_dtype=cdt)
        torch.cuda.synchronize()
        packed_spmm.launches = 0
        col = pm.all_gather(sharded_spmm_column(x, pc, b, **kw), mesh, pm.MODEL_AXIS, dim=-1)
        row = sharded_spmm_row(xk, pr, b, **kw)
        ring = pm.all_gather(sharded_spmm_column_overlapped(xk, pc, b, **kw), mesh,
                             pm.MODEL_AXIS, dim=-1)
        torch.cuda.synchronize()
        launches[name] = packed_spmm.launches
        check(launches[name] == 1 + 1 + mesh.model,
              f"sharded SpMMs {name}: {launches[name]} B1 launches a rank, "
              f"expected {2 + mesh.model}")
        with _plain_sharded():
            row_p = sharded_spmm_row(xk, pr, b, **kw)
            ring_p = pm.all_gather(sharded_spmm_column_overlapped(xk, pc, b, **kw), mesh,
                                   pm.MODEL_AXIS, dim=-1)
        if name == "int8":
            acc = sum(packed_spmm(x[:, j * kc:(j + 1) * kc], w_chunks[j], None, None,
                                  compute_dtype=cdt).float() for j in range(mesh.model))
            unsharded = torch.where(acc + b > 0, acc + b, ALPHA * (acc + b))
        else:
            unsharded = whole
        check(torch.equal(col, whole), f"column shards {name} not bitwise the unsharded B1 call")
        errs = {}
        for what, got, ref in (("row", row, row_p), ("overlap", ring, ring_p),
                               ("row_unsharded", row, unsharded),
                               ("overlap_unsharded", ring, unsharded)):
            err = float((got.float() - ref.float()).abs().max())
            lim = tol * max(1.0, float(ref.float().abs().max()))
            check(err <= lim, f"{what} shards {name} vs "
                  f"{'the unsharded reference' if 'unsharded' in what else 'plain'}: "
                  f"{err:.3e} > {lim:.3e}")
            errs[what] = err
        xs = (x, pc, b)
        times = {
            "unsharded_ms": _par_alone(torch, world,
                                       lambda: packed_spmm(x, p, b, ALPHA, compute_dtype=cdt)),
            "column_ms": _par_time(torch, lambda: sharded_spmm_column(*xs, **kw)),
            "row_ms": _par_time(torch, lambda: sharded_spmm_row(xk, pr, b, **kw)),
            "overlap_ms": _par_time(torch,
                                    lambda: sharded_spmm_column_overlapped(xk, pc, b, **kw)),
        }
        out[name] = {"row_err": errs["row"], "overlap_err": errs["overlap"],
                     "row_unsharded_err": errs["row_unsharded"],
                     "overlap_unsharded_err": errs["overlap_unsharded"], **times}
        _rank_log(world, f"sharded SpMMs {name} at {m}x{k}x{n}: column bitwise, row "
                  f"{errs['row']:.2e}, overlap {errs['overlap']:.2e} vs plain, row "
                  f"{errs['row_unsharded']:.2e}, overlap {errs['overlap_unsharded']:.2e} vs "
                  f"unsharded (limit {tol:.1e} of max(1, max|Y|)); ms a call: " + ", ".join(
                      f"{k_} {v:.4f}" for k_, v in times.items() if v is not None))
    return {"modes": out, "b1_launches": launches}


def _par_bcsr(torch, world, mesh) -> dict:
    """Phase 28b: ``sharded_bcsr_spmm`` at the showcase's 256×1024×4096
    (128×128 blocks), f32 and bf16, against its plain bodies."""
    from smmb_tpu_torch.kernels.bcsr_spmm import bcsr_spmm_kernel
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.bcsr_sharded import shard_bcsr_columns, sharded_bcsr_spmm
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    gen = rng.make_generator(5, dev)
    m, k, n = PAR_BCSR
    _, prep, b = _bcsr_case(torch, gen, k, n, 128, 128, 1.0, 2, dev)
    shards = shard_bcsr_columns(prep, mesh)
    x32 = rng.rand_dense(gen, (m, k))
    out = {}
    for name, dt, tol in (("f32", torch.float32, 1e-4), ("bf16", torch.bfloat16, 2.0 ** -7)):
        x = x32.to(dt)
        torch.cuda.synchronize()
        bcsr_spmm_kernel.launches = 0
        y = pm.all_gather(sharded_bcsr_spmm(x, shards, b, mesh=mesh, alpha=ALPHA), mesh,
                          pm.MODEL_AXIS, dim=-1)
        torch.cuda.synchronize()
        launches = bcsr_spmm_kernel.launches
        check(launches == 1, f"sharded BCSR {name}: {launches} B2 launches a rank")
        with _plain_sharded():
            ref = pm.all_gather(sharded_bcsr_spmm(x, shards, b, mesh=mesh, alpha=ALPHA), mesh,
                                pm.MODEL_AXIS, dim=-1)
        err = float((y.float() - ref.float()).abs().max())
        lim = tol * max(1.0, float(ref.float().abs().max()))
        check(err <= lim, f"sharded BCSR {name} vs plain: {err:.3e} > {lim:.3e}")
        whole = bcsr_spmm_kernel(x, prep, b, ALPHA)
        ms = _par_time(torch, lambda: sharded_bcsr_spmm(x, shards, b, mesh=mesh, alpha=ALPHA))
        alone = _par_alone(torch, world, lambda: bcsr_spmm_kernel(x, prep, b, ALPHA))
        out[name] = {"err": err, "bitwise_unsharded": bool(torch.equal(y, whole)), "ms": ms,
                     "unsharded_ms": alone, "b2_launches": launches}
        _rank_log(world, f"sharded BCSR {name} 256x1024x4096: {err:.2e} vs plain (limit "
                  f"{lim:.2e}), bitwise the unsharded B2 call: {out[name]['bitwise_unsharded']}; "
                  f"{ms:.4f} ms a call (unsharded {alone})")
    return out


def _par_mlp_block(torch, world, mesh) -> dict:
    """Phase 28c: ``mlp_forward_sharded`` at BASELINE config 5 against
    ``mlp_forward``, and ``block_forward_tp`` at scaling's ``tp_block``
    (4096-d, 8 heads, 4096-ff) against ``block_forward``, f32, each within
    max(TOL_DENSE, 2e-5·max|ref|)."""
    from smmb_tpu_torch.bench.mlp_bench import build_mlp
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.mlp import mlp_forward, mlp_forward_sharded, shard_mlp
    from smmb_tpu_torch.models.transformer import (
        TernaryBlockConfig,
        block_forward,
        init_block,
        pack_block,
    )
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.tp_transformer import block_forward_tp, shard_block_tp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    out = {}
    cfg, packed, x, _ = build_mlp(*PAR_MLP, dev)
    sh = shard_mlp(packed, mesh)
    packed_spmm.launches = 0
    y = mlp_forward_sharded(sh, x, cfg, mesh=mesh)
    torch.cuda.synchronize()
    launches = packed_spmm.launches
    ref = mlp_forward(packed, x, cfg)
    err = float((y - ref).abs().max())
    lim = max(1e-4, 2e-5 * float(ref.abs().max()))
    check(launches == cfg.num_layers, f"sharded MLP: {launches} B1 launches a rank")
    check(err <= lim, f"sharded MLP vs mlp_forward: {err:.3e} > {lim:.3e}")
    out["mlp"] = {"err": err, "limit": lim, "b1_launches": launches,
                  "ms": _par_time(torch, lambda: mlp_forward_sharded(sh, x, cfg, mesh=mesh)),
                  "unsharded_ms": _par_alone(torch, world, lambda: mlp_forward(packed, x, cfg))}
    _rank_log(world, f"sharded MLP (config 5, f32): {err:.3e} vs mlp_forward (limit {lim:.3e}),"
              f" {launches} B1 launches a rank; ms {out['mlp']['ms']:.4f} (one rank alone "
              f"{out['mlp']['unsharded_ms']})")

    bcfg = TernaryBlockConfig(**PAR_BLOCK)
    bpacked = pack_block(init_block(rng.make_generator(4, dev), bcfg))
    xb = rng.rand_dense(rng.make_generator(5, dev), (2, 128, bcfg.d_model)) * 0.1
    bsh = shard_block_tp(bpacked, mesh)
    for flash in (False, True):
        packed_spmm.launches = 0
        pm.CALLS.clear()
        yb = block_forward_tp(bsh, xb, bcfg, mesh=mesh, use_flash=flash)
        torch.cuda.synchronize()
        launches = packed_spmm.launches
        reduces = pm.CALLS[("all_reduce", pm.MODEL_AXIS)]
        refb = block_forward(bpacked, xb, bcfg, use_flash=flash)
        errb = float((yb - refb).abs().max())
        limb = max(1e-4, 2e-5 * float(refb.abs().max()))
        check(launches == 6 and reduces == 2,
              f"TP block: {launches} B1 launches, {reduces} all_reduces a rank")
        check(errb <= limb, f"TP block (flash {flash}) vs block_forward: {errb:.3e} > {limb:.3e}")
        key = "block_flash" if flash else "block"
        out[key] = {"err": errb, "limit": limb, "b1_launches": launches,
                    "ms": _par_time(torch, lambda: block_forward_tp(bsh, xb, bcfg, mesh=mesh,
                                                                   use_flash=flash)),
                    "unsharded_ms": _par_alone(torch, world, lambda: block_forward(
                        bpacked, xb, bcfg, use_flash=flash))}
        _rank_log(world, f"TP block 4096-d (flash {flash}, f32): {errb:.3e} vs block_forward "
                  f"(limit {limb:.3e}); 6 B1 launches and 2 all_reduces a rank; ms "
                  f"{out[key]['ms']:.4f} (one rank alone {out[key]['unsharded_ms']})")
    return out


def _tp_teacher_forced(torch, cfg, sharded, prompt, ids, mesh, cdt, flash, quant):
    from smmb_tpu_torch.parallel.tp_transformer import (
        lm_decode_step_tp,
        lm_init_cache_tp,
        lm_prefill_tp,
    )

    kw = dict(mesh=mesh, compute_dtype=cdt, use_flash=flash)
    cache = lm_init_cache_tp(cfg, prompt.shape[0], mesh, dtype=cdt, quantized=quant)
    logits, cache = lm_prefill_tp(sharded, prompt, cache, cfg, **kw)
    out = [logits]
    for i in range(ids.shape[1] - 1):
        logits, cache = lm_decode_step_tp(sharded, ids[:, i], cache, cfg, **kw)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1)[0].float()


def _wrong_head_shard(torch, sharded, mesh, hd):
    """A control for the TP LM's gates: ``sharded`` with rank 1's layer-0
    Q/K/V heads in the wrong order (each plane and bias rolled by one head),
    the fault a wrong head offset makes; rank 0's shard as it is."""
    from smmb_tpu_torch.formats.packed import TernaryPacked, concat_packed_cols
    from smmb_tpu_torch.parallel import mesh as pm

    if mesh.index(pm.MODEL_AXIS) != 1:
        return sharded
    a = dict(sharded["blocks"][0]["attn"])
    for name in ("wq", "wk", "wv"):
        w, bname = a[name], name.replace("w", "b")
        a[name] = TernaryPacked(torch.roll(w.data, hd, dims=1).contiguous(), w.rows, w.cols,
                                w.nnz)
        a[bname] = torch.roll(a[bname], hd, dims=0)
    a["wqkv"] = concat_packed_cols([a["wq"], a["wk"], a["wv"]])
    a["bqkv"] = torch.cat([a["bq"], a["bk"], a["bv"]])
    blocks = list(sharded["blocks"])
    blocks[0] = {**blocks[0], "attn": a}
    return {**sharded, "blocks": blocks}


def _tp_step_split(torch, fn) -> dict:
    """Where one ``fn()`` (a ``generate_tp`` call) spends its host time:
    in the TP layer's collectives, split into waiting for the card to reach
    them (a synchronize at entry) and the staged collective itself, and
    the rest (launches and the card's work between them)."""
    from smmb_tpu_torch.parallel import tp_transformer as tp

    spent = {"wait_ms": 0.0, "collective_ms": 0.0, "calls": 0}

    def timed(real):
        def call(*a, **k):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = real(*a, **k)
            t2 = time.perf_counter()
            spent["wait_ms"] += (t1 - t0) * 1e3
            spent["collective_ms"] += (t2 - t1) * 1e3
            spent["calls"] += 1
            return y
        return call

    saved = tp.all_reduce, tp.all_gather
    tp.all_reduce, tp.all_gather = timed(saved[0]), timed(saved[1])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        tp.all_reduce, tp.all_gather = saved
    return {"total_ms": total, **spent,
            "rest_ms": total - spent["wait_ms"] - spent["collective_ms"]}


def _tokens_us(torch, fn) -> float:
    """µs a token: the slope of ``fn(steps)``'s host time between 16 and
    64 steps (the prefill cancelling), the best of 3."""
    def t(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(steps)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    fn(16)
    return min((t(PAR_STEPS) - t(16)) / (PAR_STEPS - 16) for _ in range(3)) * 1e6


def _par_lm(torch, world, mesh) -> dict:
    """Phase 28d: ``generate_tp`` at the ``lm`` widths on model = 2, plain,
    with ``use_flash`` and with ``kv_quant`` + ``use_flash``: launches a
    rank; every B1 call of the TP path held against ``packed_spmm_plain``
    on its own input (f32 1e-4, bf16 2^-7 of max(1, max|plain|), both LMs);
    tokens against the single-rank ``generate``; teacher-forced logits
    against the single-rank path's, gated at every position on the
    LeCun-scale LM (f32: the LM rule; bf16: 2^-7 of max(1, max|logit|), a
    rank's Q/K/V heads in the wrong order as the control that must fail
    it), logged on the unit-scale LM; µs a token beside ``generate``'s
    (unit-scale, bf16); then ``lm_forward_pp`` with 2 stages against
    ``lm_forward`` on the LeCun-scale LM (f32, the LM rule)."""
    import torch.distributed as dist

    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, generate, init_lm, lm_forward, pack_lm
    from smmb_tpu_torch.parallel.pp_lm import lm_forward_pp, shard_lm_pp
    from smmb_tpu_torch.parallel.tp_transformer import generate_tp, shard_lm_tp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    cfg = TernaryLMConfig(**PAR_LM, max_len=PAR_PROMPT + 3 * PAR_STEPS)
    bf16 = torch.bfloat16
    gen = rng.make_generator(0, dev)
    unit = pack_lm(init_lm(gen, cfg))
    prompt = torch.randint(0, cfg.vocab, (1, PAR_PROMPT), generator=gen, device=dev)
    lecun = pack_lm(_lecun(init_lm(rng.make_generator(26, dev), cfg)), quantize=True)
    counted = (packed_spmm, fa.flash_attention, fd.flash_attention_decode,
               fd.flash_attention_decode_quant)
    out = {"lm": {}}
    # the LM rule is an f32 rule (phase 24's): in bf16 the routes round X to
    # bf16 before or after its absmean scale (B1 takes X·s, B3/B5/B6 scale
    # their f32 sums), ~2^-8 apart, so bf16 logits are held to the port's
    # bf16 tolerance, as its bf16 B1 calls are
    runs = (("lecun", lecun, torch.float32, True), ("lecun", lecun, bf16, True),
            ("unit", unit, bf16, False))
    tf_calls = 6 * cfg.n_layers + 1 + (PAR_STEPS - 1) * (4 * cfg.n_layers + 1)
    for model_name, packed, cdt, gated in runs:
        sharded = shard_lm_tp(packed, mesh)
        dt_name = "f32" if cdt == torch.float32 else "bf16"
        call_tol = 1e-4 if cdt == torch.float32 else BF16_TOL
        for path, (flash, quant) in {"plain": (False, False), "flash": (True, False),
                                     "int8_flash": (True, True)}.items():
            kw = dict(compute_dtype=cdt, use_flash=flash, kv_quant=quant)
            want = generate(packed, prompt, cfg, PAR_STEPS, **kw)
            torch.cuda.synchronize()
            for fn in counted:
                fn.launches = 0
            toks = generate_tp(sharded, prompt, cfg, PAR_STEPS, mesh=mesh, **kw)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counted}
            want_b1 = 6 * cfg.n_layers + 1 + PAR_STEPS * (4 * cfg.n_layers + 1)
            check(launches["packed_spmm"] == want_b1,
                  f"generate_tp {path}: {launches['packed_spmm']} B1 launches, want {want_b1}")
            check(launches["flash_attention"] == (cfg.n_layers if flash else 0),
                  f"generate_tp {path}: B9 launches {launches['flash_attention']}")
            steps_b4 = cfg.n_layers * PAR_STEPS if flash else 0
            check(launches["flash_attention_decode"] == (0 if quant else steps_b4)
                  and launches["flash_attention_decode_quant"] == (steps_b4 if quant else 0),
                  f"generate_tp {path}: B4/B8 launches {launches}")
            check(toks.shape == (1, PAR_STEPS) and int(toks.min()) >= 0
                  and int(toks.max()) < cfg.vocab, "generate_tp tokens shape / range")
            ref = _teacher_forced(torch, cfg, packed, prompt, want, cdt, True, use_flash=flash,
                                  kv_quant=quant)
            call_errs = []
            with _held_b1_calls(torch, call_errs):
                got = _tp_teacher_forced(torch, cfg, sharded, prompt, want, mesh, cdt, flash,
                                         quant)
            check(len(call_errs) == tf_calls and max(call_errs) <= call_tol,
                  f"generate_tp {model_name} {dt_name} {path}: {len(call_errs)} B1 calls (want "
                  f"{tf_calls}), worst vs plain {max(call_errs):.3e} > {call_tol:.1e}")
            e = (got - ref).abs().amax(-1)
            lim = (LM_RULE[0] + LM_RULE[1] * float(ref.abs().max()) if cdt == torch.float32
                   else BF16_TOL * max(1.0, float(ref.abs().max())))
            row = {"launches": launches, "same_tokens": int((toks == want).sum()),
                   "worst": float(e.max()), "median": float(e.median()), "rule": lim,
                   "beyond_rule": int((e > lim).sum()), "gated": gated,
                   "b1_calls_worst": max(call_errs)}
            if gated:
                check(row["beyond_rule"] == 0,
                      f"generate_tp {path} {dt_name} on the LeCun-scale LM: {row['beyond_rule']} of "
                      f"{e.numel()} positions beyond {lim:.3e} (worst {row['worst']:.3e})")
            if gated and cdt == bf16 and path == "plain":
                ctrl = _tp_teacher_forced(torch, cfg, _wrong_head_shard(
                    torch, sharded, mesh, cfg.d_model // cfg.n_heads), prompt, want, mesh, cdt,
                    flash, quant)
                ec = (ctrl - ref).abs().amax(-1)
                row["control_worst"], row["control_beyond"] = float(ec.max()), int((ec > lim).sum())
                check(row["control_beyond"] > 0,
                      f"the bf16 TP gate's control (rank 1's layer-0 heads in the wrong order) "
                      f"stays within {lim:.3e} (worst {row['control_worst']:.3e})")
            if model_name == "unit":
                row["tp_us_per_token"] = _tokens_us(torch, lambda s: generate_tp(
                    sharded, prompt, cfg, s, mesh=mesh, **kw))
                us = [None]
                if world.rank == 0:
                    us[0] = _tokens_us(torch, lambda s: generate(packed, prompt, cfg, s, **kw))
                dist.barrier()
                row["single_us_per_token"] = us[0]
                row["step_split"] = _tp_step_split(torch, lambda: generate_tp(
                    sharded, prompt, cfg, PAR_STEPS, mesh=mesh, **kw))
            out["lm"][f"{model_name}_{dt_name}_{path}"] = row
            _rank_log(world, f"generate_tp {model_name} {dt_name} {path}: launches a rank {launches}; "
                      f"{row['same_tokens']} of {PAR_STEPS} tokens as generate's; teacher-forced "
                      f"logits worst {row['worst']:.3e}, median {row['median']:.3e}, rule "
                      f"{lim:.3e}, {row['beyond_rule']} beyond ({'gated' if gated else 'logged'}); "
                      f"{len(call_errs)} B1 calls within {row['b1_calls_worst']:.2e} of plain"
                      + (f"; control (wrong head order) worst {row['control_worst']:.3e}, "
                         f"{row['control_beyond']} beyond" if "control_worst" in row else "")
                      + (f"; {row['tp_us_per_token']:.1f} us/token on 2 ranks sharing the card, "
                         f"generate alone {row['single_us_per_token']}; a generate_tp call "
                         f"{row['step_split']}" if "tp_us_per_token" in row else ""))

    toks = torch.randint(0, cfg.vocab, (4, 2 * PAR_PROMPT), generator=rng.make_generator(7, dev),
                         device=dev)
    packed_spmm.launches = 0
    y = lm_forward_pp(shard_lm_pp(lecun, mesh), toks, cfg, mesh=mesh, microbatches=2)
    torch.cuda.synchronize()
    launches = packed_spmm.launches
    ref = lm_forward(lecun, toks, cfg)
    e = (y - ref).abs().amax(-1).flatten()
    lim = LM_RULE[0] + LM_RULE[1] * float(ref.abs().max())
    beyond = int((e > lim).sum())
    check(beyond == 0, f"lm_forward_pp: {beyond} positions beyond the LM rule {lim:.3e} "
          f"(worst {float(e.max()):.3e})")
    out["pp"] = {"worst": float(e.max()), "rule": lim, "b1_launches": launches}
    _rank_log(world, f"lm_forward_pp, 2 stages x 2 microbatches, f32, LeCun-scale LM: worst "
              f"{float(e.max()):.3e} (rule {lim:.3e}), {launches} B1 launches a rank")
    return out


def _par_dp(torch, world, mesh) -> dict:
    """Phase 28e: three ``make_lm_train_step_dp`` steps on 2 ranks against
    one rank's steps on the whole batch: the first loss within 1e-5
    relative, and on LeCun-scale masters the second and third too (on
    unit-scale ones an Adam step under another f32 order lands elsewhere:
    logged). The exchange itself: the first step's averaged gradients (each
    leaf's ``.grad`` as the DP step hands it to Adam) within 1e-6 of the
    largest |g| of the mean of one rank's gradients on each DP rank's rows,
    on both masters. Against one rank's gradients on the whole batch they
    are logged, beside one rank's own mean over the halves against its
    whole batch: a batch of 4 rows and two of 2 sum in other f32 orders."""
    import torch.distributed as dist

    from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, make_lm_train_step
    from smmb_tpu_torch.models.train import param_leaves
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.dp_train import make_lm_train_step_dp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    batch, seq = DP_BATCH
    cfg = TernaryLMConfig(**PAR_LM, max_len=seq)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=rng.make_generator(9, dev),
                           device=dev)
    dmesh = pm.make_mesh(2, 1, device=dev)

    def grads(params):
        return [torch.zeros_like(q) if q.grad is None else q.grad.clone()
                for q in param_leaves(params)]

    def single_steps(masters, toks, steps):
        init1, step1 = make_lm_train_step(cfg, learning_rate=1e-3)
        p1 = masters()
        o1, losses = init1(p1), []
        for i in range(steps):
            p1, o1, loss = step1(p1, o1, toks)
            losses.append(float(loss))
            if i == 0:
                g = grads(p1)
        return losses, g

    def parted(a, b):  # worst leaf's max|a - b| over the largest |b|, and the leaf
        gmax = max(float(y.abs().max()) for y in b)
        errs = [float((x - y).abs().max()) / gmax for x, y in zip(a, b)]
        return max(errs), errs.index(max(errs))

    out = {}
    for name, masters in (("unit", lambda: init_lm(rng.make_generator(11, dev), cfg)),
                          ("lecun", lambda: _lecun(init_lm(rng.make_generator(11, dev), cfg)))):
        params = masters()
        init_opt, step, place = make_lm_train_step_dp(cfg, dmesh, learning_rate=1e-3)
        p, o, t = place(params, init_opt(params), tokens)
        dp, dp_grads = [], None
        for i in range(3):
            p, o, loss = step(p, o, t)
            dp.append(float(loss))
            if i == 0 and world.rank == 0:
                dp_grads = grads(p)
        single, row = [None] * 3, {}
        if world.rank == 0:
            single, g1 = single_steps(masters, tokens, 3)
            rows = batch // 2
            halves = [single_steps(masters, tokens[h * rows:(h + 1) * rows], 1)[1]
                      for h in range(2)]
            g_half = [(a + b) / 2 for a, b in zip(*halves)]
            ex, ex_leaf = parted(dp_grads, g_half)
            whole, whole_leaf = parted(dp_grads, g1)
            split, split_leaf = parted(g_half, g1)
            rel = [abs(a - b) / abs(b) for a, b in zip(dp, single)]
            row = {"exchange_err": ex, "exchange_leaf": ex_leaf, "whole_err": whole,
                   "whole_leaf": whole_leaf, "split_err": split, "split_leaf": split_leaf,
                   "loss_rel": rel}
            check(rel[0] <= 1e-5, f"DP first loss ({name}) {dp[0]!r} vs one rank "
                  f"{single[0]!r}: {rel[0]:.2e} relative > 1e-5")
            check(len(dp_grads) == len(g_half) and ex <= 1e-6,
                  f"DP first step's averaged gradients ({name}): leaf {ex_leaf} {ex:.2e} of "
                  f"the largest |g| from the mean of one rank's on the DP ranks' rows > 1e-6")
            if name == "lecun":
                check(max(rel[1:]) <= 1e-5, f"DP later losses ({name}) {dp[1:]} vs one rank "
                      f"{single[1:]}: {max(rel[1:]):.2e} relative > 1e-5")
            _rank_log(world, f"DP training ({name}-scale masters), 2 ranks x {rows} rows of "
                      f"{seq} tokens: losses {dp} vs one rank on the whole batch {single} "
                      f"(relative {', '.join(f'{r:.2e}' for r in rel)}); the first step's "
                      f"averaged gradients {ex:.2e} of the largest |g| from the mean of one "
                      f"rank's on the DP ranks' rows (leaf {ex_leaf} of {len(g1)}, gated); "
                      f"logged: {whole:.2e} from one rank's on the whole batch (leaf "
                      f"{whole_leaf}), where one rank's own mean over the halves reads "
                      f"{split:.2e} (leaf {split_leaf})")
        dist.barrier()
        out[name] = {"dp_losses": dp, "single_losses": single, **row}
    return out


def _collective_latency(torch, world, mesh) -> dict:
    """µs a model-axis all_reduce of one (1, 1024) f32 row, the TP decode
    step's size: of a CUDA tensor (staged through host memory) and of a CPU
    tensor (gloo alone), 200 calls each with nothing between them."""
    import torch.distributed as dist

    from smmb_tpu_torch.parallel import mesh as pm

    out = {}
    for name, dev in (("staged_cuda_us", mesh.device), ("host_us", torch.device("cpu"))):
        t = torch.ones((1, 1024), device=dev)
        for _ in range(10):
            pm.all_reduce(t, mesh, pm.MODEL_AXIS)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(200):
            pm.all_reduce(t, mesh, pm.MODEL_AXIS)
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
    _rank_log(world, f"a (1, 1024) f32 all_reduce over 2 ranks: {out['staged_cuda_us']:.1f} us "
              f"staged from the card, {out['host_us']:.1f} us of host tensors")
    return out


# ------------------------------------------------------------ phase 29
A4B_EP = (256, 1024, 4096, 8)  # tokens, d_model, d_ff, experts: scaling's ep_moe
A4B_BLOCK_X = (2, 64)  # the TP-EP block's batch x tokens
A4B_SP_T = 4096  # the SP prefill's tokens (2048 a rank on 2 ranks)
A4B_SP_MOE_T = 512  # the SP MoE block's tokens
A4B_PP_TOKENS = (4, 64)
A4B_LORA = (8, 0.01)  # adapter rank, the wave added to A and B (live adapters)
A4B_CALLS = 5  # calls a timed batch of a phase 29 call


def _lm_rule(torch, got, ref, scale=None) -> dict:
    """Every position of ``got`` against ``ref`` by the LM rule, its
    max|logit| that of ``scale`` (default ``ref``)."""
    e = (got - ref).abs().amax(-1).flatten()
    lim = LM_RULE[0] + LM_RULE[1] * float((ref if scale is None else scale).abs().max())
    return {"worst": float(e.max()), "median": float(e.median()), "rule": lim,
            "beyond": int((e > lim).sum()), "positions": e.numel(),
            "worst_at": int(e.argmax())}


def _gate_margins(torch, packed, tokens, cfg) -> list:
    """(positions,) the smallest top-k router margin over the MoE blocks of
    ``lm_forward``'s plain path on ``tokens`` (batch 1): the rank-k gate
    minus the rank-k+1 gate over the largest, as phase 25's near-tie rule
    reads it."""
    from smmb_tpu_torch.models import moe_block as mb
    from smmb_tpu_torch.models.attention import attention_forward
    from smmb_tpu_torch.models.transformer import rmsnorm

    bcfg, k = cfg.block, cfg.top_k
    x = packed["embed"][tokens] + packed["pos"][None, :tokens.shape[1]]
    margins = None
    for blk in packed["blocks"]:
        mid = x + attention_forward(blk["attn"], rmsnorm(x, blk["norm1"], bcfg.eps), bcfg.attn,
                                    use_kernel=False)
        _, gates = _moe_routes(torch, blk, mid, bcfg)
        m = (gates[:, k - 1] - gates[:, k]) / gates[:, 0]
        margins = m if margins is None else torch.minimum(margins, m)
        x = mb._moe_half(blk, mid, bcfg, torch.float32, False)
    return margins


def _a4b_ep(torch, world, mesh) -> dict:
    """Phase 29a: ``moe_forward_ep`` at scaling's ``ep_moe`` shape (8
    experts of 1024→4096→1024, 256 tokens), top-1 and top-2, f32 and bf16,
    bitwise the single-rank ``moe_forward`` on the same tokens; 2·E/model B1
    launches and one all_reduce a call; ms a call beside one rank alone."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.moe import TernaryMoEConfig, init_moe, moe_forward, pack_moe
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.ep_moe import moe_forward_ep, shard_moe_ep
    from smmb_tpu_torch.utils import rng

    n, d, f, e = A4B_EP
    dev = mesh.device
    out = {}
    want_b1 = 2 * e // mesh.model
    for k in (1, 2):
        cfg = TernaryMoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k)
        packed = pack_moe(init_moe(rng.make_generator(4, dev), cfg))
        sh = shard_moe_ep(packed, mesh)
        x32 = rng.rand_dense(rng.make_generator(5, dev), (n, d)) * 0.5
        for name, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(cdt)
            packed_spmm.launches = 0
            pm.CALLS.clear()
            y = moe_forward_ep(sh, x, cfg, mesh=mesh, compute_dtype=cdt)
            torch.cuda.synchronize()
            launches, reduces = packed_spmm.launches, dict(pm.CALLS)
            ref = moe_forward(packed, x, cfg, compute_dtype=cdt)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            check(torch.equal(y, ref), f"moe_forward_ep top-{k} {name}: {err:.3e} from the "
                  "single-rank moe_forward, not bitwise")
            check(launches == want_b1 and reduces == {("all_reduce", pm.MODEL_AXIS): 1},
                  f"moe_forward_ep top-{k} {name}: {launches} B1 launches (want {want_b1}), "
                  f"collectives {reduces}")
            row = {"bitwise": True, "b1_launches": launches,
                   "ms": _par_time(torch, lambda: moe_forward_ep(sh, x, cfg, mesh=mesh,
                                                                compute_dtype=cdt),
                                   calls=A4B_CALLS),
                   "single_ms": _par_alone(torch, world, lambda: moe_forward(
                       packed, x, cfg, compute_dtype=cdt))}
            out[f"top{k}_{name}"] = row
            _rank_log(world, f"moe_forward_ep (E={e}, {d}->{f}->{d}, {n} tokens, top-{k}, "
                      f"{name}): bitwise moe_forward; {launches} B1 launches and 1 all_reduce a "
                      f"rank; {row['ms']:.4f} ms a call on 2 ranks sharing the card "
                      f"(moe_forward alone {row['single_ms']})", phase=29)
    return out


def _a4b_tpep_block(torch, world, mesh) -> dict:
    """Phase 29b: ``moe_block_forward_tp`` at the ``lm`` widths with 8
    experts, top-2 (f32) within max(1e-4, 5e-5·max|ref|) of
    ``moe_block_forward``; 12 B1 launches and 2 all_reduces a rank; the
    smallest router margin logged."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models import moe_block as mb
    from smmb_tpu_torch.models.attention import attention_forward
    from smmb_tpu_torch.models.transformer import rmsnorm
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.tp_moe import moe_block_forward_tp, shard_moe_block_tp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    bcfg = mb.TernaryMoEBlockConfig(d_model=PAR_LM["d_model"], n_heads=PAR_LM["n_heads"],
                                    d_ff=PAR_LM["d_ff"], **MOE_LM)
    packed = mb.pack_moe_block(mb.init_moe_block(rng.make_generator(6, dev), bcfg))
    x = rng.rand_dense(rng.make_generator(7, dev), (*A4B_BLOCK_X, bcfg.d_model)) * 0.1
    sh = shard_moe_block_tp(packed, mesh)
    packed_spmm.launches = 0
    pm.CALLS.clear()
    y = moe_block_forward_tp(sh, x, bcfg, mesh=mesh)
    torch.cuda.synchronize()
    launches, reduces = packed_spmm.launches, dict(pm.CALLS)
    ref = mb.moe_block_forward(packed, x, bcfg)
    err = (y - ref).abs().amax(-1).flatten()
    lim = max(1e-4, 5e-5 * float(ref.abs().max()))
    mid = x + attention_forward(packed["attn"], rmsnorm(x, packed["norm1"], bcfg.eps), bcfg.attn)
    _, gates = _moe_routes(torch, packed, mid, bcfg)
    k = bcfg.top_k
    margin = (gates[:, k - 1] - gates[:, k]) / gates[:, 0]
    worst = int(err.argmax())
    want_b1 = 4 + 2 * bcfg.n_experts // mesh.model
    check(launches == want_b1 and reduces == {("all_reduce", pm.MODEL_AXIS): 2},
          f"TP-EP block: {launches} B1 launches (want {want_b1}), collectives {reduces}")
    check(float(err.max()) <= lim, f"TP-EP block vs moe_block_forward: {float(err.max()):.3e} "
          f"> {lim:.3e} at token {worst}, its router margin {float(margin[worst]):.3e}")
    out = {"err": float(err.max()), "limit": lim, "b1_launches": launches,
           "margin_min": float(margin.min()), "margin_at_worst": float(margin[worst]),
           "ms": _par_time(torch, lambda: moe_block_forward_tp(sh, x, bcfg, mesh=mesh),
                           calls=A4B_CALLS),
           "single_ms": _par_alone(torch, world, lambda: mb.moe_block_forward(packed, x, bcfg))}
    _rank_log(world, f"TP-EP block (lm widths, E=8, top-2, {A4B_BLOCK_X}, f32): "
              f"{out['err']:.3e} vs moe_block_forward (limit {lim:.3e}); {launches} B1 launches, "
              f"2 all_reduces a rank; smallest router margin {out['margin_min']:.3e} (at the worst token "
              f"{out['margin_at_worst']:.3e}); {out['ms']:.4f} ms a call on 2 ranks sharing the "
              f"card (moe_block_forward alone {out['single_ms']})", phase=29)
    return out


def _moe_lecun_lm(torch, dev):
    """Phase 25's MoE LM (the ``lm`` widths, 8 experts, top-2) on LeCun-scale
    masters (phase 25's backward's seed), packed with ``quantize=True``."""
    from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, pack_lm
    from smmb_tpu_torch.utils import rng

    cfg = TernaryLMConfig(**PAR_LM, max_len=PAR_PROMPT + 3 * PAR_STEPS, **MOE_LM)
    return cfg, pack_lm(_lecun(init_lm(rng.make_generator(29, dev), cfg)), quantize=True)


def _a4b_moe_lm(torch, world, mesh, cfg, packed) -> dict:
    """Phase 29c: ``generate_tp`` on the MoE LM (phase 25's config on
    LeCun-scale masters, model = 2), plain, ``use_flash`` and ``kv_quant`` +
    ``use_flash``: in bf16 its launches a rank and every B1 call held
    against ``packed_spmm_plain`` on its own input (2^-7 of max(1,
    max|plain|)); in f32 its tokens beside the single-rank ``generate``'s
    and its teacher-forced logits within the LM rule of the single-rank
    path at every position, the smallest router margin at the worst
    position logged; µs/token beside ``generate``'s (plain, bf16)."""
    import torch.distributed as dist

    from smmb_tpu_torch.kernels import flash_attention as fa
    from smmb_tpu_torch.kernels import flash_decode as fd
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import generate
    from smmb_tpu_torch.parallel.tp_transformer import generate_tp, shard_lm_tp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    f32, bf16 = torch.float32, torch.bfloat16
    layers, e_loc = cfg.n_layers, cfg.n_experts // mesh.model
    prompt = torch.randint(0, cfg.vocab, (1, PAR_PROMPT), generator=rng.make_generator(0, dev),
                           device=dev)
    sharded = shard_lm_tp(packed, mesh)
    counted = (packed_spmm, fa.flash_attention, fd.flash_attention_decode,
               fd.flash_attention_decode_quant)
    # B1 a rank: the prefill's Q, K, V, O and 2 a local expert a layer and
    # the head; a decode step's fused Q/K/V, O and 2 a local expert a layer
    # and the head
    prefill_b1, step_b1 = layers * (4 + 2 * e_loc) + 1, layers * (2 + 2 * e_loc) + 1
    want_b1 = prefill_b1 + PAR_STEPS * step_b1
    out = {}
    for path, (flash, quant) in {"plain": (False, False), "flash": (True, False),
                                 "int8_flash": (True, True)}.items():
        kw = dict(use_flash=flash, kv_quant=quant)
        errs = []
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        with _held_b1_calls(torch, errs):
            toks16 = generate_tp(sharded, prompt, cfg, PAR_STEPS, mesh=mesh, compute_dtype=bf16,
                                 **kw)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        check(launches["packed_spmm"] == want_b1,
              f"MoE generate_tp {path}: {launches['packed_spmm']} B1 launches, want {want_b1}")
        check(launches["flash_attention"] == (layers if flash else 0),
              f"MoE generate_tp {path}: B9 launches {launches['flash_attention']}")
        steps_b4 = layers * PAR_STEPS if flash else 0
        check(launches["flash_attention_decode"] == (0 if quant else steps_b4)
              and launches["flash_attention_decode_quant"] == (steps_b4 if quant else 0),
              f"MoE generate_tp {path}: B4/B8 launches {launches}")
        check(len(errs) == want_b1 and max(errs) <= BF16_TOL,
              f"MoE generate_tp {path} bf16: {len(errs)} B1 calls, worst vs plain "
              f"{max(errs):.3e} > {BF16_TOL:.1e}")
        check(toks16.shape == (1, PAR_STEPS) and int(toks16.min()) >= 0
              and int(toks16.max()) < cfg.vocab, "MoE generate_tp tokens shape / range")
        want = generate(packed, prompt, cfg, PAR_STEPS, compute_dtype=f32, **kw)
        toks = generate_tp(sharded, prompt, cfg, PAR_STEPS, mesh=mesh, compute_dtype=f32, **kw)
        ref = _teacher_forced(torch, cfg, packed, prompt, want, f32, True, use_flash=flash,
                              kv_quant=quant)
        got = _tp_teacher_forced(torch, cfg, sharded, prompt, want, mesh, f32, flash, quant)
        row = {"launches": launches, "b1_calls_worst": max(errs),
               "same_tokens": int((toks == want).sum()), **_lm_rule(torch, got, ref)}
        with torch.no_grad():
            margins = _gate_margins(torch, packed, torch.cat([prompt, want], 1), cfg)
        # logits row i predicts token i + 1 of the prompt-and-ids sequence
        row["margin_min"] = float(margins[PAR_PROMPT - 1:].min())
        row["margin_at_worst"] = float(margins[PAR_PROMPT - 1 + row["worst_at"]])
        check(row["beyond"] == 0, f"MoE generate_tp {path} f32: {row['beyond']} of "
              f"{row['positions']} positions beyond the LM rule {row['rule']:.3e} (worst "
              f"{row['worst']:.3e}, router margin there {row['margin_at_worst']:.3e})")
        if path == "plain":
            row["tp_us_per_token"] = _tokens_us(torch, lambda s: generate_tp(
                sharded, prompt, cfg, s, mesh=mesh, compute_dtype=bf16))
            us = [None]
            if world.rank == 0:
                us[0] = _tokens_us(torch, lambda s: generate(packed, prompt, cfg, s,
                                                          compute_dtype=bf16))
            dist.barrier()
            row["single_us_per_token"] = us[0]
        out[path] = row
        _rank_log(world, f"MoE generate_tp {path}: launches a rank {launches} (bf16, every B1 "
                  f"call within {max(errs):.2e} of plain); f32: {row['same_tokens']} of "
                  f"{PAR_STEPS} tokens as generate's, teacher-forced worst {row['worst']:.3e}, "
                  f"median {row['median']:.3e}, rule {row['rule']:.3e}; smallest router margin "
                  f"{row['margin_min']:.3e}, at the worst position {row['margin_at_worst']:.3e}"
                  + (f"; {row['tp_us_per_token']:.1f} us/token on 2 ranks sharing the card, "
                     f"generate alone {row['single_us_per_token']}" if path == "plain" else ""),
                  phase=29)
    return out


def _a4b_sp(torch, world, mesh) -> dict:
    """Phase 29d: ``lm_forward_sp`` on the dense LeCun-scale LM at the
    ``lm`` widths, T = 4096 (f32), within the LM rule of ``lm_forward`` at
    every position, 25 B1 launches, 4 ring shifts and no all_gather a rank,
    µs a token beside ``lm_forward``'s; ``ring_attention`` at B=1, H=8,
    hd=128, T=4096, causal, within 2e-5 of ``_attention_math``; one SP MoE
    block (lm widths, E=8, top-2, T=512) within max(1e-4, 5e-5·max|ref|)
    of ``moe_block_forward``."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models import moe_block as mb
    from smmb_tpu_torch.models.attention import TernaryAttentionConfig, _attention_math
    from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, lm_forward, pack_lm
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.ring_attention import local_seq, ring_attention
    from smmb_tpu_torch.parallel.sp_block import block_forward_sp, lm_forward_sp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    t = A4B_SP_T
    cfg = TernaryLMConfig(**PAR_LM, max_len=t)
    packed = pack_lm(_lecun(init_lm(rng.make_generator(26, dev), cfg)), quantize=True)
    toks = torch.randint(0, cfg.vocab, (1, t), generator=rng.make_generator(8, dev), device=dev)
    tl = local_seq(toks, mesh)
    packed_spmm.launches = 0
    pm.CALLS.clear()
    y = lm_forward_sp(packed, tl, cfg, mesh=mesh)
    torch.cuda.synchronize()
    launches, calls = packed_spmm.launches, dict(pm.CALLS)
    ref = lm_forward(packed, toks, cfg)
    torch.cuda.synchronize()
    row = _lm_rule(torch, y, local_seq(ref, mesh), scale=ref)  # the rule of the whole T
    want_b1 = 6 * cfg.n_layers + 1
    check(launches == want_b1
          and calls == {("ring_shift", pm.MODEL_AXIS): cfg.n_layers * (mesh.model - 1)},
          f"lm_forward_sp: {launches} B1 launches (want {want_b1}), collectives {calls}")
    check(row["beyond"] == 0, f"lm_forward_sp T={t}: {row['beyond']} positions of the rank's "
          f"{row['positions']} beyond the LM rule {row['rule']:.3e} (worst {row['worst']:.3e})")
    row["b1_launches"] = launches
    row["ms"] = _par_time(torch, lambda: lm_forward_sp(packed, tl, cfg, mesh=mesh), calls=2)
    row["single_ms"] = _par_alone(torch, world, lambda: lm_forward(packed, toks, cfg))
    row["us_per_token"] = row["ms"] * 1e3 / t
    row["single_us_per_token"] = None if row["single_ms"] is None else row["single_ms"] * 1e3 / t
    out = {"lm": row}
    _rank_log(world, f"lm_forward_sp (lm widths, LeCun-scale, T={t}, f32): worst "
              f"{row['worst']:.3e}, median {row['median']:.3e} (rule {row['rule']:.3e}); "
              f"{launches} B1 launches, {mesh.model - 1} ring shift a layer a rank; prefill "
              f"{row['us_per_token']:.3f} us/token on 2 ranks sharing the card (lm_forward "
              f"alone {row['single_us_per_token']})", phase=29)
    del ref

    g = rng.make_generator(9, dev)
    h, hd = PAR_LM["n_heads"], PAR_LM["d_model"] // PAR_LM["n_heads"]
    q, k, v = (rng.rand_dense(g, (1, t, h, hd)) * 0.5 for _ in range(3))
    acfg = TernaryAttentionConfig(d_model=h * hd, n_heads=h, causal=True)
    pm.CALLS.clear()
    yr = ring_attention(*(local_seq(a, mesh) for a in (q, k, v)), mesh=mesh)
    shifts = dict(pm.CALLS)
    full = _attention_math(q.reshape(1, t, -1), k.reshape(1, t, -1), v.reshape(1, t, -1), acfg)
    err = float((yr.reshape(1, t // mesh.model, -1) - local_seq(full, mesh)).abs().max())
    check(err <= 2e-5 and shifts == {("ring_shift", pm.MODEL_AXIS): mesh.model - 1},
          f"ring_attention T={t}: {err:.3e} from _attention_math (limit 2e-5), {shifts}")
    out["ring"] = {"err": err, "limit": 2e-5,
                   "ms": _par_time(torch, lambda: ring_attention(
                       *(local_seq(a, mesh) for a in (q, k, v)), mesh=mesh), calls=A4B_CALLS)}
    _rank_log(world, f"ring_attention (B=1, H={h}, hd={hd}, T={t}, causal, f32): {err:.3e} "
              f"from _attention_math (limit 2e-5); {out['ring']['ms']:.3f} ms a call", phase=29)
    del q, k, v, full

    bcfg = mb.TernaryMoEBlockConfig(d_model=PAR_LM["d_model"], n_heads=h, d_ff=PAR_LM["d_ff"],
                                    **MOE_LM)
    bp = mb.pack_moe_block(mb.init_moe_block(rng.make_generator(10, dev), bcfg))
    xb = rng.rand_dense(rng.make_generator(11, dev), (1, A4B_SP_MOE_T, bcfg.d_model)) * 0.1
    packed_spmm.launches = 0
    yb = block_forward_sp(bp, local_seq(xb, mesh), bcfg, mesh=mesh)
    torch.cuda.synchronize()
    launches = packed_spmm.launches
    refb = mb.moe_block_forward(bp, xb, bcfg)
    eb = (yb - local_seq(refb, mesh)).abs().amax(-1).flatten()
    lim = max(1e-4, 5e-5 * float(refb.abs().max()))
    check(launches == 4 + 2 * bcfg.n_experts, f"SP MoE block: {launches} B1 launches")
    check(float(eb.max()) <= lim, f"SP MoE block T={A4B_SP_MOE_T} vs moe_block_forward: "
          f"{float(eb.max()):.3e} > {lim:.3e}")
    out["moe_block"] = {"err": float(eb.max()), "limit": lim, "b1_launches": launches}
    _rank_log(world, f"SP MoE block (lm widths, E=8, top-2, T={A4B_SP_MOE_T}, f32): "
              f"{float(eb.max()):.3e} vs moe_block_forward (limit {lim:.3e}); {launches} B1 "
              "launches a rank", phase=29)
    return out


def _a4b_pp_moe(torch, world, mesh, cfg, packed) -> dict:
    """Phase 29e: ``lm_forward_pp`` on the MoE LM (2 stages, 2
    microbatches, f32) within the LM rule of ``lm_forward``."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import lm_forward
    from smmb_tpu_torch.parallel.pp_lm import lm_forward_pp, shard_lm_pp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    toks = torch.randint(0, cfg.vocab, A4B_PP_TOKENS, generator=rng.make_generator(12, dev),
                         device=dev)
    packed_spmm.launches = 0
    y = lm_forward_pp(shard_lm_pp(packed, mesh), toks, cfg, mesh=mesh, microbatches=2)
    torch.cuda.synchronize()
    launches = packed_spmm.launches
    row = {**_lm_rule(torch, y, lm_forward(packed, toks, cfg)), "b1_launches": launches}
    per = cfg.n_layers // mesh.model
    want_b1 = per * 2 * (4 + 2 * cfg.n_experts) + 1
    check(launches == want_b1, f"MoE lm_forward_pp: {launches} B1 launches, want {want_b1}")
    check(row["beyond"] == 0, f"MoE lm_forward_pp: {row['beyond']} positions beyond the LM "
          f"rule {row['rule']:.3e} (worst {row['worst']:.3e})")
    _rank_log(world, f"MoE lm_forward_pp (2 stages x 2 microbatches, {A4B_PP_TOKENS}, f32): "
              f"worst {row['worst']:.3e} (rule {row['rule']:.3e}); {launches} B1 launches a rank",
              phase=29)
    return row


def _a4b_lora(torch, world, mesh) -> dict:
    """Phase 29f: LoRA under TP on the dense LeCun-scale LM at the ``lm``
    widths, rank 8 on all six targets (live adapters): ``lm_forward_tp``
    within the LM rule of the single-rank adapted ``lm_forward`` at every
    position, then ``generate_tp``'s teacher-forced logits within the LM
    rule of the single-rank path (f32)."""
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.lm import TernaryLMConfig, generate, init_lm, lm_forward, pack_lm
    from smmb_tpu_torch.models.lora import attach_lora, init_lora_lm
    from smmb_tpu_torch.parallel.tp_transformer import lm_forward_tp, shard_lm_tp
    from smmb_tpu_torch.utils import rng

    dev = mesh.device
    f32 = torch.float32
    rank, wave = A4B_LORA
    cfg = TernaryLMConfig(**PAR_LM, max_len=PAR_PROMPT + 3 * PAR_STEPS)
    base = pack_lm(_lecun(init_lm(rng.make_generator(26, dev), cfg)), quantize=True)
    adapters = init_lora_lm(rng.make_generator(30, dev), cfg, rank=rank,
                            targets=("wq", "wk", "wv", "wo", "w_up", "w_down"))

    def live(a):
        return a + wave * torch.sin(torch.arange(a.numel(), dtype=f32, device=dev)).reshape(
            a.shape)

    adapters = [{k: tuple(live(a) for a in v) for k, v in blk.items()} for blk in adapters]
    model = attach_lora(base, adapters)
    sharded = shard_lm_tp(model, mesh)
    toks = torch.randint(0, cfg.vocab, (2, 2 * PAR_PROMPT), generator=rng.make_generator(13, dev),
                         device=dev)
    packed_spmm.launches = 0
    y = lm_forward_tp(sharded, toks, cfg, mesh=mesh)
    torch.cuda.synchronize()
    launches = packed_spmm.launches
    ref = lm_forward(model, toks, cfg)
    moved = float((ref - lm_forward(base, toks, cfg)).abs().max())
    fwd = {**_lm_rule(torch, y, ref), "b1_launches": launches, "adapters_move": moved}
    check(moved > 1e-3, f"LoRA under TP: the adapters move the logits by {moved:.3e} only")
    check(launches == 6 * cfg.n_layers + 1, f"LoRA lm_forward_tp: {launches} B1 launches")
    check(fwd["beyond"] == 0, f"LoRA lm_forward_tp: {fwd['beyond']} positions beyond the LM "
          f"rule {fwd['rule']:.3e} (worst {fwd['worst']:.3e})")
    prompt = toks[:1, :PAR_PROMPT]
    want = generate(model, prompt, cfg, PAR_STEPS, compute_dtype=f32)
    tf = _lm_rule(torch, _tp_teacher_forced(torch, cfg, sharded, prompt, want, mesh, f32, False,
                                            False),
                  _teacher_forced(torch, cfg, model, prompt, want, f32, True))
    check(tf["beyond"] == 0, f"LoRA generate_tp teacher-forced: {tf['beyond']} positions beyond "
          f"the LM rule {tf['rule']:.3e} (worst {tf['worst']:.3e})")
    _rank_log(world, f"LoRA under TP (rank {rank}, all six targets, LeCun-scale lm widths, "
              f"f32): lm_forward_tp worst {fwd['worst']:.3e} (rule {fwd['rule']:.3e}; the "
              f"adapters move the logits by {moved:.3e}), {launches} B1 launches a rank; "
              f"generate_tp teacher-forced worst {tf['worst']:.3e} (rule {tf['rule']:.3e})",
              phase=29)
    return {"forward": fwd, "teacher_forced": tf}


def _a4b_rank(torch, world, mesh) -> dict:
    """Phase 29: the second half of the parallel layer, in phase 28's world."""
    t = time.time()
    out = {"ep": _a4b_ep(torch, world, mesh), "tpep_block": _a4b_tpep_block(torch, world, mesh)}
    cfg, moe_lm = _moe_lecun_lm(torch, mesh.device)
    out["moe_lm"] = _a4b_moe_lm(torch, world, mesh, cfg, moe_lm)
    out["pp_moe"] = _a4b_pp_moe(torch, world, mesh, cfg, moe_lm)
    del moe_lm
    out["sp"] = _a4b_sp(torch, world, mesh)
    out["lora"] = _a4b_lora(torch, world, mesh)
    out["seconds"] = time.time() - t
    _rank_log(world, f"phase 29's checks took {out['seconds']:.1f}s", phase=29)
    return out


def _parallel_rank(world) -> dict:
    """Phase 28's 2-rank world on one card: every check of phases 28 and 29,
    on the (1 × 2) mesh (DP on (2 × 1)); returns the rank's readings."""
    import torch

    from smmb_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(1, world.size, device=world.device)
    pm.make_mesh(2, 1, device=world.device)  # every rank makes every group, in order
    out = {"latency": _collective_latency(torch, world, mesh),
           "spmm": _par_spmms(torch, world, mesh), "bcsr": _par_bcsr(torch, world, mesh)}
    out.update(_par_mlp_block(torch, world, mesh))
    out.update(_par_lm(torch, world, mesh))
    out["dp"] = _par_dp(torch, world, mesh)
    out["a4b"] = _a4b_rank(torch, world, mesh)
    out["staged"] = dict(pm.STAGED)
    return out


def _nccl_rank(world) -> dict:
    """Phase 28's 1-rank NCCL world: the mesh's collectives through NCCL
    (none staged), the column shard bitwise and the row shard within f32
    1e-4 of the unsharded B1 call, one TP block against ``block_forward``,
    and (phase 29) one ``moe_forward_ep`` call bitwise ``moe_forward``."""
    import torch

    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.models.moe import TernaryMoEConfig, init_moe, moe_forward, pack_moe
    from smmb_tpu_torch.models.transformer import (
        TernaryBlockConfig,
        block_forward,
        init_block,
        pack_block,
    )
    from smmb_tpu_torch.parallel import mesh as pm
    from smmb_tpu_torch.parallel.ep_moe import moe_forward_ep, shard_moe_ep
    from smmb_tpu_torch.parallel.sharded import (
        shard_packed_columns,
        shard_packed_rows,
        sharded_spmm_column,
        sharded_spmm_row,
    )
    from smmb_tpu_torch.parallel.tp_transformer import block_forward_tp, shard_block_tp
    from smmb_tpu_torch.utils import rng

    mesh = pm.make_mesh(1, 1, device=world.device)
    dev = mesh.device
    m, k, n, nz = PAR_HEADLINE
    gen = rng.make_generator(0, dev)
    x = rng.rand_dense(gen, (m, k))
    p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=nz))
    b = rng.rand_dense(gen, (n,))
    whole = packed_spmm(x, p, b, ALPHA)
    pm.CALLS.clear()
    col = pm.all_gather(sharded_spmm_column(x, shard_packed_columns(p, mesh), b, mesh=mesh,
                                            alpha=ALPHA), mesh, pm.MODEL_AXIS, dim=-1)
    row = sharded_spmm_row(x, shard_packed_rows(p, mesh), b, mesh=mesh, alpha=ALPHA)
    check(torch.equal(col, whole), "NCCL world: the column shard is not the unsharded call")
    err = float((row - whole).abs().max())
    check(err <= 1e-4 * max(1.0, float(whole.abs().max())), f"NCCL world: row {err:.3e}")
    bcfg = TernaryBlockConfig(d_model=1024, n_heads=8, d_ff=4096)
    bp = pack_block(init_block(rng.make_generator(4, dev), bcfg))
    xb = rng.rand_dense(rng.make_generator(5, dev), (2, 32, 1024)) * 0.1
    yb = block_forward_tp(shard_block_tp(bp, mesh), xb, bcfg, mesh=mesh)
    refb = block_forward(bp, xb, bcfg)
    errb = float((yb - refb).abs().max())
    check(errb <= max(1e-4, 2e-5 * float(refb.abs().max())), f"NCCL world: TP block {errb:.3e}")
    n, d, f, e = A4B_EP
    ecfg = TernaryMoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=2)
    epacked = pack_moe(init_moe(rng.make_generator(4, dev), ecfg))
    ex = rng.rand_dense(rng.make_generator(5, dev), (n, d)) * 0.5
    ey = moe_forward_ep(shard_moe_ep(epacked, mesh), ex, ecfg, mesh=mesh)
    check(torch.equal(ey, moe_forward(epacked, ex, ecfg)),
          "NCCL world: moe_forward_ep is not the single-rank moe_forward")
    torch.cuda.synchronize()
    calls = {f"{op} {axis}": c for (op, axis), c in pm.CALLS.items()}
    check(not pm.STAGED and calls.get("all_reduce model", 0) >= 3
          and calls.get("all_gather model", 0) >= 1,
          f"NCCL world: collectives {calls}, staged {dict(pm.STAGED)}")
    return {"row_err": err, "block_err": errb, "ep_bitwise": True, "collectives": calls}


def run_parallel(torch, dev, card) -> dict:
    """Phases 28 and 29: the parallel layer on one card. NCCL refuses two
    ranks on one device, so the checks run in a 2-rank gloo world, each rank
    on the H100, its collectives staged through host memory (mesh.py logs
    and counts them); a 1-rank NCCL world runs the NCCL path; then
    ``python -m smmb_tpu_torch scaling`` over (1, 1) and (1, 2)."""
    from smmb_tpu_torch.parallel.mesh import run_world

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.time()
    ranks = run_world(_parallel_rank, 2, backend="gloo", device="cuda", timeout=600)
    log(f"2-rank gloo world ({time.time() - t:.1f}s): staged through host memory, rank 0 "
        f"{ranks[0]['staged']}, rank 1 {ranks[1]['staged']}")
    check(ranks[0]["staged"].get("all_reduce", 0) > 0, "gloo world staged no all_reduce")
    t = time.time()
    nccl = run_world(_nccl_rank, 1, backend="nccl", device="cuda", timeout=300)[0]
    log(f"1-rank NCCL world ({time.time() - t:.1f}s): row {nccl['row_err']:.2e}, TP block "
        f"{nccl['block_err']:.2e}, collectives {nccl['collectives']}, none staged")
    t = time.time()
    cli = subprocess.run([sys.executable, "-m", "smmb_tpu_torch", "scaling", "--mesh", "1x1,1x2",
                          "--reps", "3"], cwd=HERE, capture_output=True, text=True, timeout=420)
    print(cli.stdout, flush=True)
    check(cli.returncode == 0, f"scaling CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    pts = [json.loads(line) for line in cli.stdout.splitlines() if line.startswith("{")]
    parts = {"column", "row", "overlap", "bcsr_column", "tp_block", "pp_lm", "ep_moe"}
    check({(q["partitioning"], q["mesh"]) for q in pts}
          == {(q, s) for q in parts for s in ("1x1", "1x2")}, f"scaling points {pts}")
    check(all(q["shared"] == (q["mesh"] == "1x2") for q in pts),
          "scaling: the 2-rank points must be labelled as sharing the card")
    log(f"scaling CLI ({time.time() - t:.1f}s): {len(pts)} points, the 1x2 ones labelled as "
        f"2 ranks sharing {card}")
    r0 = ranks[0]
    par = {"card": card, "latency": r0["latency"], "spmm": r0["spmm"], "bcsr": r0["bcsr"], "mlp": r0["mlp"],
           "block": r0["block"], "block_flash": r0["block_flash"], "lm": r0["lm"],
           "pp": r0["pp"], "dp": r0["dp"], "nccl": nccl, "scaling": pts,
           "ranks": "2 ranks sharing one card (gloo)"}
    a4b = {"card": card, "ranks": "2 ranks sharing one card (gloo)", **r0["a4b"],
           "nccl_ep_bitwise": nccl["ep_bitwise"]}
    par["a4b"] = a4b
    print(json.dumps({"phase28": {k: v for k, v in par.items() if k != "a4b"}}), flush=True)
    log("phase 28 passed: " + "; ".join(
        f"generate_tp {k} {v['tp_us_per_token']:.1f} us/token (generate "
        f"{v['single_us_per_token']:.1f})" for k, v in r0["lm"].items()
        if "tp_us_per_token" in v))
    print(json.dumps({"phase29": a4b}), flush=True)
    sp, moe_plain = a4b["sp"]["lm"], a4b["moe_lm"]["plain"]
    log(f"phase 29 passed ({a4b['seconds']:.1f}s in the gloo world, {card}, 2 ranks sharing "
        f"the card): SP prefill {sp['us_per_token']:.3f} us/token (lm_forward alone "
        f"{sp['single_us_per_token']:.3f}); MoE generate_tp {moe_plain['tp_us_per_token']:.1f} "
        f"us/token (generate alone {moe_plain['single_us_per_token']:.1f})")
    return par


A5_SHAPE = (256, 4096, 4096, 10)  # M, K, N, non_zero: the headline, ~10% nnz
# phase 5's spread of one tile's device time at the headline between runs:
# the widest range of a tile's µs over four recorded runs of this script,
# relative to its least (int8 16x128, 47.51-49.33 µs; PERF.md §6, A5's
# entry). The pick's time may exceed tile_for's by at most this share.
A5_TILE_SPREAD = 0.0384
# in-turn measure_device pairs of the pick and tile_for's tile, each side's
# median compared: graph captures of one int8 call read 61.49-65.95 µs late
# in this script, so the least of two or five a side compared one low
# outlier with another (PERF.md §6, A5's entry)
A5_PAIRS = 7
A5_EXAMPLES = ("torch_lm_generate", "torch_transformer_serving", "torch_train_and_serve",
               "torch_serving_features")


def _a5_autotune(torch, dev, tmp) -> list:
    """Phase 30a: ``autotune_packed_spmm`` at the headline in bf16 and int8
    with its cache in ``tmp`` (``_a5_tune_mode``), the module's cache path
    restored after."""
    import os

    from smmb_tpu_torch.bench import autotune
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.utils import rng

    m, k, n, nz = A5_SHAPE
    gen = rng.make_generator(30, dev)
    x = rng.rand_dense(gen, (m, k))
    p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=nz))
    saved, autotune.CACHE_PATH = autotune.CACHE_PATH, os.path.join(tmp, "autotune.json")
    try:
        return [_a5_tune_mode(torch, autotune, x, p, cdt) for cdt in (torch.bfloat16, torch.int8)]
    finally:
        autotune.CACHE_PATH = saved


def _a5_tune_mode(torch, autotune, x, p, cdt) -> dict:
    """One mode of phase 30a: each candidate's µs logged (the autotuner's
    verbose lines), the pick bitwise ``tile_for``'s output and, timed again
    by ``measure_device`` in ``A5_PAIRS`` in-turn pairs (each side's
    median), no slower than it by more than ``A5_TILE_SPREAD``; a second call answered from the cache with the timer
    disabled."""
    import io

    from smmb_tpu_torch.bench.measure import measure_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, tile_for, tiles_of

    m, k, n, nz = A5_SHAPE
    mode = str(cdt).split(".")[1]
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cfg = autotune.autotune_packed_spmm(m, k, n, cdt, non_zero=nz, verbose=True)
    tune_s = time.perf_counter() - t
    cands = {}
    for line in buf.getvalue().splitlines():
        cand, _, us = line.strip().rpartition(": ")
        c = json.loads(cand)
        cands[f"{c['block_m']}x{c['block_n']}"] = float(us.split()[0])
    pick, tiles = (cfg["block_m"], cfg["block_n"]), tiles_of(cdt)
    check(set(cfg) == {"block_m", "block_n"} and pick in tiles,
          f"autotune {mode} picked {cfg}, not one of {tiles}")
    check(len(cands) == len(tiles), f"autotune {mode} timed {cands}")

    def no_timer(*a, **kw):
        raise AssertionError("autotune measured on a cached key")

    autotune.measure_device = no_timer
    try:
        again = autotune.autotune_packed_spmm(m, k, n, cdt, non_zero=nz)
    finally:
        autotune.measure_device = measure_device
    check(again == cfg, f"autotune {mode}: the cache answered {again}, not {cfg}")

    xin = x.to(cdt) if cdt == torch.bfloat16 else x
    y_pick = packed_spmm(xin, p, compute_dtype=cdt, **cfg)
    y_rule = packed_spmm(xin, p, compute_dtype=cdt)
    torch.cuda.synchronize()
    check(torch.equal(y_pick, y_rule), f"autotune {mode}: the pick {pick}'s output is not "
          f"bitwise tile_for's")
    rule = tile_for(m, n, cdt)[:2]
    t_pick, t_rule = [], []
    for _ in range(A5_PAIRS):  # in turns
        t_pick.append(measure_device(lambda: packed_spmm(xin, p, compute_dtype=cdt, **cfg))
                      .min_s * 1e6)
        t_rule.append(measure_device(lambda: packed_spmm(xin, p, compute_dtype=cdt)).min_s * 1e6)
    us_pick, us_rule = statistics.median(t_pick), statistics.median(t_rule)
    limit = us_rule * (1 + A5_TILE_SPREAD)
    row = {"a5_autotune": [m, k, n], "mode": mode, "candidates_us": cands, "pick": list(pick),
           "tile_for": list(rule), "pick_us": us_pick, "tile_for_us": us_rule,
           "limit_us": limit, "pick_runs_us": t_pick, "tile_for_runs_us": t_rule,
           "tune_s": tune_s}
    print(json.dumps(row), flush=True)
    check(us_pick <= limit, f"autotune {mode}: the pick {pick} {us_pick:.3f} us > tile_for's "
          f"{rule} {us_rule:.3f} us x (1 + {A5_TILE_SPREAD})")
    return row


def _a5_cli(tmp) -> dict:
    """Phase 30b: ``python -m smmb_tpu_torch.bench.autotune 256 4096 4096
    --dtype bf16`` in a subprocess prints one JSON config as its last line."""
    import os

    import torch

    from smmb_tpu_torch.kernels.packed_spmm import tiles_of

    env = {**os.environ, "SMMB_TORCH_AUTOTUNE_CACHE": os.path.join(tmp, "cli.json")}
    t = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "smmb_tpu_torch.bench.autotune", "256", "4096",
                          "4096", "--dtype", "bf16"], cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=300)
    print(cli.stdout, flush=True)
    check(cli.returncode == 0, f"autotune CLI exited {cli.returncode}:\n{cli.stderr[-4000:]}")
    lines = cli.stdout.strip().splitlines()
    cfg = json.loads(lines[-1])
    check(isinstance(cfg, dict)
          and (cfg.get("block_m"), cfg.get("block_n")) in tiles_of(torch.bfloat16),
          f"autotune CLI's last line is not a config: {lines[-1]!r}")
    return {"config": cfg, "seconds": time.perf_counter() - t}


def _a5_trace(torch, dev, tmp) -> dict:
    """Phase 30c: ``capture_trace`` of one headline B1 call in bf16 inside
    ``annotate("b1")``: the Chrome trace holds the kernel's events and the
    ``b1`` range."""
    import os

    from smmb_tpu_torch.bench.trace import annotate, capture_trace
    from smmb_tpu_torch.formats.packed import pack_ternary_device
    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm
    from smmb_tpu_torch.utils import rng

    m, k, n, nz = A5_SHAPE
    gen = rng.make_generator(31, dev)
    x = rng.rand_dense(gen, (m, k), dtype=torch.bfloat16)
    p = pack_ternary_device(rng.rand_ternary(gen, (k, n), non_zero=nz))

    def call(x):
        with annotate("b1"):
            return packed_spmm(x, p, compute_dtype=torch.bfloat16)

    d = capture_trace(call, x, trace_dir=os.path.join(tmp, "trace"), n_calls=3)
    files = [os.path.join(d, f) for f in os.listdir(d) if f.endswith(".json")]
    check(len(files) == 1, f"capture_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "packed_spmm" in e.get("name", "")]
    ranges = [e for e in events if e.get("name") == "b1"]
    # capture_trace runs a session whose calls show no kernel again with a
    # longer warm-up; what it writes must hold B1's kernel
    check(len(kernels) >= 1, "the trace holds no B1 kernel event for 3 calls")
    check(len(ranges) >= 3, f"the trace holds {len(ranges)} 'b1' ranges for 3 calls")
    return {"file_bytes": os.path.getsize(files[0]), "events": len(events),
            "b1_kernel_events": len(kernels), "b1_ranges": len(ranges),
            "kernel": kernels[0]["name"][:80] if kernels else None,
            "kernel_us": [e.get("dur") for e in kernels]}


def _a5_examples(torch) -> dict:
    """Phase 30d: the four port-owned examples, each ``main([])`` on the card
    returning 0, with its wall time and B1 launches."""
    import importlib

    from smmb_tpu_torch.kernels.packed_spmm import packed_spmm

    sys.path.insert(0, str(HERE / "examples"))
    out = {}
    for name in A5_EXAMPLES:
        before = packed_spmm.launches
        t = time.perf_counter()
        rc = importlib.import_module(name).main([])
        torch.cuda.synchronize()
        out[name] = {"rc": rc, "seconds": time.perf_counter() - t,
                     "b1_launches": packed_spmm.launches - before}
        log(f"example {name}: rc {rc} in {out[name]['seconds']:.2f} s, "
            f"{out[name]['b1_launches']} B1 launches")
        check(rc == 0, f"example {name} returned {rc}")
        check(out[name]["b1_launches"] > 0, f"example {name} launched no B1")
    return out


def run_a5(torch, dev, card) -> dict:
    """Phase 30: A5 on the card: the B1 tile autotuner and its CLI,
    ``capture_trace``/``annotate``, the four port-owned examples."""
    import shutil
    import tempfile

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="smmb_a5_")
    try:
        tune = _a5_autotune(torch, dev, tmp)
        cli = _a5_cli(tmp)
        trace = _a5_trace(torch, dev, tmp)
        examples = _a5_examples(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"card": card, "autotune": tune, "cli": cli, "trace": trace, "examples": examples,
           "seconds": time.time() - t0}
    print(json.dumps({"phase30": out}), flush=True)
    log(f"phase 30 passed in {out['seconds']:.1f}s ({card}): autotune picks " + ", ".join(
        f"{r['mode']} {r['pick'][0]}x{r['pick'][1]} {r['pick_us']:.2f} us (tile_for "
        f"{r['tile_for'][0]}x{r['tile_for'][1]} {r['tile_for_us']:.2f})" for r in tune)
        + f"; CLI {cli['config']} in {cli['seconds']:.1f}s; trace {trace['b1_kernel_events']} "
        f"B1 events; examples " + ", ".join(f"{k} {v['seconds']:.2f}s"
                                            for k, v in examples.items()))
    return out


# Mellum2-12B-A2.5B's routed layer (PERF.md §4): 64 experts, top-8, d 2304,
# expert width 896; the prefill's tokens (2 prompts of 8192) and a short one
MOE_GROUPED = dict(d_model=2304, d_ff=896, n_experts=64, top_k=8)
MOE_GROUPED_TOKENS = (512, 16384)
# one period of its 3:1 pattern at the published widths, for the prefill
# that must not synchronise with the host
MOE_GROUPED_LM = dict(vocab=98304, d_model=2304, n_heads=32, n_kv_heads=4, head_dim=128,
                      d_ff=896, n_layers=4, max_len=4096, rope=True, rope_theta=5e5,
                      n_experts=64, top_k=8, layer_windows=(1024, 1024, 1024, None),
                      residual_f32=False)
MOE_GROUPED_PROMPT = (2, 2048)


def _grouped_segments(torch, moe, packed, x, cfg):
    """The grouped rows of ``x``'s routing: (xs, offsets, host offsets)."""
    logits = moe.router_logits(x, packed["router"])
    expert, slot, _, _ = moe._assign(logits, moe._round8(x.shape[0]), cfg.top_k)
    _, offsets, token, row_expert = moe.grouped_layout(expert, slot, cfg.n_experts)
    xs = (x.index_select(0, token).to(torch.float32)
          * packed["s_up"][row_expert][:, None]).to(torch.bfloat16)
    return xs, offsets, offsets.tolist()


B1G_PLAIN_TOL = 2.0 ** -7  # B1's bf16 tolerance, relative to max(1, max|ref|)


def _b1g_plain_err(y, ref, what: str) -> float:
    """B1g's rows against B1's plain version: the largest difference over
    max(1, max|ref|), checked against ``B1G_PLAIN_TOL``."""
    err = float((y.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))
    check(err <= B1G_PLAIN_TOL, f"B1g vs plain, {what}: {err:.3e} > {B1G_PLAIN_TOL:.1e}")
    return err


def _b1g_prefill_row(torch, calls, launches) -> dict:
    """B1g's row of the kernels summary, from the Mellum-shaped prefill's own
    B1g calls (their inputs kept): the kernel against the per-expert loop of
    B1's plain version on the same rows (checked), against a per-expert
    bf16 ``torch.matmul`` loop on the dense W, and the roofline bound of
    each call's hit experts (X rows, their 2-bit planes, Y and bias once;
    ``2·m_e·nnz_e + m_e·N`` operations), all summed over the calls."""
    from smmb_tpu_torch.bench.flops import sparse_flops, spmm_bytes
    from smmb_tpu_torch.bench.measure import measure
    from smmb_tpu_torch.bench.roofline import chip_spec, roofline_bound
    from smmb_tpu_torch.formats.packed import unpack_ternary
    from smmb_tpu_torch.kernels.packed_spmm import grouped_spmm, packed_spmm_plain
    from smmb_tpu_torch.models.moe import expert_plane

    spec = chip_spec()
    torch.backends.cuda.matmul.allow_tf32 = False
    ms = plain_ms = lib_ms = bound_s = ops_all = ops_s = bytes_s = 0.0
    dev_us = lib_us = 0.0
    max_err, rel_err = 0.0, 0.0
    for i, ((x, w, b, offsets, *rest), kw, y) in enumerate(calls):
        alpha = rest[0] if rest else kw.get("alpha")
        od = kw.get("out_dtype") or x.dtype
        host = offsets.tolist()
        segs = [(e, lo, hi) for e, (lo, hi) in enumerate(zip(host[:-1], host[1:])) if hi > lo]
        planes = {e: expert_plane(w, e) for e, _, _ in segs}
        xin = x.to(od)

        def plain_loop():
            return [packed_spmm_plain(xin[lo:hi], planes[e], b[e], alpha,
                                      compute_dtype=torch.bfloat16) for e, lo, hi in segs]

        for (e, lo, hi), ref in zip(segs, plain_loop()):
            max_err = max(max_err, float((y[lo:hi].float() - ref.float()).abs().max()))
            rel_err = max(rel_err, _b1g_plain_err(y[lo:hi], ref, f"prefill call {i}, expert {e}"))
        dense = {e: unpack_ternary(p, torch.bfloat16) for e, p in planes.items()}
        xb = x.to(torch.bfloat16)

        def lib_loop():
            return [xb[lo:hi] @ dense[e] for e, lo, hi in segs]

        def kernel():
            return grouped_spmm(x, w, b, offsets, alpha, out_dtype=od)

        ms += measure(kernel).min_s * 1e3
        plain_ms += measure(plain_loop, reps=3).min_s * 1e3
        lib_ms += measure(lib_loop).min_s * 1e3
        dev_us += _device_us(kernel, 10)
        lib_us += _device_us(lib_loop, 5)
        k, n = x.shape[1], w.cols
        ops = sum(sparse_flops(hi - lo, n, int(torch.count_nonzero(dense[e])))
                  for e, lo, hi in segs)
        n_bytes = sum(spmm_bytes(hi - lo, n, k, weight_bytes=planes[e].weight_bytes(),
                                 x_itemsize=2, y_itemsize=y.element_size())
                      for e, lo, hi in segs)
        bound_s += roofline_bound(ops, n_bytes, spec, "bf16")[0]
        ops_all += ops
        ops_s += ops / spec.peak_ops("bf16")
        bytes_s += n_bytes / (spec.hbm_gbps * 1e9)
        del dense
    row = {
        "name": "grouped_spmm", "route": "cuda",
        "source": "smmb_tpu_torch/kernels/csrc/packed_spmm.cu",
        "replaces": "smmb_tpu/models/moe.py:321",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": lib_ms, "device_us": dev_us, "library_device_us": lib_us,
        "design": "mma.sync 64x128 (16x128 at few rows an expert), the expert and row tile "
                  "found on the card",
    }
    print(json.dumps({"phase": 31, "b1g_row": row, "plain_rel_err": rel_err,
                      "calls": len(calls), "ops": ops_all,
                      "launches_are": "a 2 x 2048 Mellum-shaped lm_prefill (4 layers)",
                      "plain": "packed_spmm_plain a hit expert, summed",
                      "library": "torch.matmul bf16 on dense W a hit expert, summed"}),
          flush=True)
    log(f"B1g over the Mellum-shaped prefill's {launches} launches: {ms:.3f} ms (device "
        f"{dev_us:.1f} us), plain loop {plain_ms:.3f} ms, bound {bound_s * 1e3:.3f} ms, "
        f"matmul loop {lib_ms:.3f} ms (device {lib_us:.1f} us); within {rel_err:.2e} of the "
        f"plain version's rows (limit {B1G_PLAIN_TOL:.1e})")
    return row


def run_moe_grouped(torch, dev, card) -> dict:
    """Phase 31: B1g (``grouped_spmm``, ``expert_spmm_grouped``) at
    Mellum2's routed layer: every expert's rows bitwise B1's on the same
    rows and plane (up with PReLU to f32, down to bf16; 16,384 tokens on
    the 64-row tile and 512 on the 16-row one; an unaligned shape on the
    element loads); its device µs against the 128-launch per-expert B1 loop
    and a per-expert bf16 ``torch.matmul`` loop on dense W; ``moe_forward``'s
    device µs on the slab path and grouped at 512 and 16,384 tokens, the
    two bitwise; and a Mellum-shaped ``lm_prefill`` (4 layers at the
    published widths, one period of the 3:1 pattern) under
    ``torch.cuda.set_sync_debug_mode("error")`` and the profiler, whose host
    events must hold no device-to-host copy and no synchronise."""
    from smmb_tpu_torch.formats.packed import TernaryPacked, unpack_ternary
    from smmb_tpu_torch.kernels.packed_spmm import grouped_spmm, packed_spmm, packed_spmm_plain
    from smmb_tpu_torch.models import moe
    from smmb_tpu_torch.models.lm import TernaryLMConfig, init_lm, lm_init_cache, lm_prefill
    from smmb_tpu_torch.models.lm import pack_lm
    from smmb_tpu_torch.utils import rng

    out = {"card": card}
    cfg = moe.TernaryMoEConfig(**MOE_GROUPED)
    masters = moe.init_moe(rng.make_generator(31, dev), cfg)
    for name in ("w_up", "w_down"):  # LeCun scale, as the benchmark's masters
        masters[name] = masters[name] / masters[name].shape[1] ** 0.5
    packed = moe.pack_moe(masters, quantize=True)
    del masters
    planes = {name: [TernaryPacked(data=packed[name].data[e], rows=packed[name].rows,
                                   cols=packed[name].cols, nnz=packed[name].nnz)
                     for e in range(cfg.n_experts)] for name in ("w_up", "w_down")}
    for n in MOE_GROUPED_TOKENS:
        x = rng.rand_dense(rng.make_generator(32 + n, dev), (n, cfg.d_model)).to(torch.bfloat16)
        xs, offsets, host = _grouped_segments(torch, moe, packed, x, cfg)
        segs = [(lo, hi) for lo, hi in zip(host[:-1], host[1:])]
        row = {"rows": host[-1], "experts_hit": sum(hi > lo for lo, hi in segs),
               "rows_min": min(hi - lo for lo, hi in segs),
               "rows_max": max(hi - lo for lo, hi in segs)}
        up = grouped_spmm(xs, packed["w_up"], packed["b_up"], offsets, cfg.alpha,
                          out_dtype=torch.float32)
        hs = (up * packed["s_down"].repeat_interleave(
            torch.tensor([hi - lo for lo, hi in segs], device=dev))[:, None]).to(torch.bfloat16)
        down = grouped_spmm(hs, packed["w_down"], packed["b_down"], offsets)
        plain_err = 0.0
        for e, (lo, hi) in enumerate(segs):
            if hi == lo:
                continue
            ref_up = packed_spmm(xs[lo:hi].float(), planes["w_up"][e], packed["b_up"][e],
                                 cfg.alpha, compute_dtype=torch.bfloat16)
            ref_dn = packed_spmm(hs[lo:hi], planes["w_down"][e], packed["b_down"][e],
                                 compute_dtype=torch.bfloat16)
            check(torch.equal(up[lo:hi], ref_up) and torch.equal(down[lo:hi], ref_dn),
                  f"B1g at {n} tokens: expert {e}'s rows differ from B1's")
            # and against B1's plain version, which shares none of its code
            plain_up = packed_spmm_plain(xs[lo:hi].float(), planes["w_up"][e],
                                         packed["b_up"][e], cfg.alpha,
                                         compute_dtype=torch.bfloat16)
            plain_dn = packed_spmm_plain(hs[lo:hi], planes["w_down"][e], packed["b_down"][e],
                                         compute_dtype=torch.bfloat16)
            plain_err = max(plain_err, _b1g_plain_err(up[lo:hi], plain_up, f"up at {n}, {e}"),
                            _b1g_plain_err(down[lo:hi], plain_dn, f"down at {n}, {e}"))
        row["plain_rel_err"] = plain_err

        def b1_loop(inp, name, alpha, dtype):
            return [packed_spmm(inp[lo:hi] if dtype is None else inp[lo:hi].to(dtype),
                                planes[name][e], packed["b" + name[1:]][e], alpha,
                                compute_dtype=torch.bfloat16)
                    for e, (lo, hi) in enumerate(segs) if hi > lo]

        dense = {name: [unpack_ternary(p).to(torch.bfloat16) for p in planes[name]]
                 for name in ("w_up", "w_down")}

        def mm_loop(inp, name):
            return [inp[lo:hi] @ dense[name][e] for e, (lo, hi) in enumerate(segs) if hi > lo]

        row["b1g_us"] = {
            "up": _device_us(lambda: grouped_spmm(xs, packed["w_up"], packed["b_up"], offsets,
                                                  cfg.alpha, out_dtype=torch.float32), 10),
            "down": _device_us(lambda: grouped_spmm(hs, packed["w_down"], packed["b_down"],
                                                    offsets), 10)}
        row["b1_loop_us"] = {"up": _device_us(lambda: b1_loop(xs, "w_up", cfg.alpha, None), 5),
                             "down": _device_us(lambda: b1_loop(hs, "w_down", None, None), 5)}
        row["matmul_loop_us"] = {"up": _device_us(lambda: mm_loop(xs, "w_up"), 5),
                                 "down": _device_us(lambda: mm_loop(hs, "w_down"), 5)}
        del dense
        grouped = moe.moe_forward(packed, x, cfg, compute_dtype=torch.bfloat16, no_drop=True)
        cap = moe._round8(n)
        route = moe._assign(moe.router_logits(x, packed["router"]), cap, cfg.top_k)
        slab = moe._slab_forward(packed, x, cfg, *route, cap, torch.bfloat16, True)
        check(torch.equal(grouped, slab), f"moe_forward at {n} tokens: grouped differs from "
              "the slab path")
        row["moe_forward_us"] = {
            "grouped": _device_us(lambda: moe.moe_forward(packed, x, cfg,
                                                          compute_dtype=torch.bfloat16,
                                                          no_drop=True), 5),
            "slab": _device_us(lambda: moe._slab_forward(packed, x, cfg, *route, cap,
                                                         torch.bfloat16, True), 3)}
        del slab, grouped, up, down, hs, xs
        torch.cuda.empty_cache()
        out[f"tokens_{n}"] = row
        print(json.dumps({"phase": 31, "tokens": n, **row}), flush=True)
        log(f"B1g at {n} tokens ({row['experts_hit']} experts hit, {row['rows_min']}-"
            f"{row['rows_max']} rows each): bitwise B1 on every expert's rows, within "
            f"{row['plain_rel_err']:.2e} of max(1, max|ref|) of the plain version's "
            f"(limit {B1G_PLAIN_TOL:.1e}); up/down device "
            f"us {row['b1g_us']['up']:.1f}/{row['b1g_us']['down']:.1f}, B1 loop "
            f"{row['b1_loop_us']['up']:.1f}/{row['b1_loop_us']['down']:.1f}, matmul loop "
            f"{row['matmul_loop_us']['up']:.1f}/{row['matmul_loop_us']['down']:.1f}; "
            f"moe_forward grouped {row['moe_forward_us']['grouped']:.1f} us, slab "
            f"{row['moe_forward_us']['slab']:.1f} us ({card})")
    del packed, planes

    # element loads: K and N not a whole number of 16-byte pieces
    ucfg = moe.TernaryMoEConfig(d_model=72, d_ff=40, n_experts=5, top_k=2)
    upk = moe.pack_moe(moe.init_moe(rng.make_generator(33, dev), ucfg), quantize=True)
    ux = rng.rand_dense(rng.make_generator(34, dev), (300, 72)).to(torch.bfloat16)
    xs, offsets, host = _grouped_segments(torch, moe, upk, ux, ucfg)
    y = grouped_spmm(xs, upk["w_up"], upk["b_up"], offsets, ucfg.alpha)
    for e, (lo, hi) in enumerate(zip(host[:-1], host[1:])):
        plane = TernaryPacked(data=upk["w_up"].data[e], rows=72, cols=40, nnz=upk["w_up"].nnz)
        check(torch.equal(y[lo:hi], packed_spmm(xs[lo:hi], plane, upk["b_up"][e], ucfg.alpha,
                                                compute_dtype=torch.bfloat16)),
              f"B1g on element loads: expert {e}'s rows differ from B1's")
        if hi > lo:
            _b1g_plain_err(y[lo:hi], packed_spmm_plain(xs[lo:hi], plane, upk["b_up"][e],
                                                       ucfg.alpha, compute_dtype=torch.bfloat16),
                           f"element loads, expert {e}")

    # the serving path holds no host synchronisation
    mcfg = TernaryLMConfig(**MOE_GROUPED_LM)
    params = init_lm(rng.make_generator(35, dev), mcfg)
    for tree, keys in [(params, ("embed", "pos", "norm_f"))] + [
            (b, ("norm1", "norm2")) for b in params["blocks"]]:
        for key in keys:  # the dense leaves in bf16: a bf16 stream, as served
            tree[key] = tree[key].bfloat16()
    lm = pack_lm(params, quantize=True)
    del params
    toks = torch.randint(0, mcfg.vocab, MOE_GROUPED_PROMPT, device=dev)

    def prefill():
        cache = lm_init_cache(mcfg, toks.shape[0], dtype=torch.bfloat16, device=dev)
        return lm_prefill(lm, toks, cache, mcfg, compute_dtype=torch.bfloat16, use_flash=True)

    prefill()
    torch.cuda.synchronize()
    calls = []

    def recorded(*args, **kwargs):  # keeps each call's inputs; reads nothing back
        y = grouped_spmm(*args, **kwargs)
        calls.append((args, kwargs, y))
        return y

    packed_spmm.launches_grouped = 0
    moe.grouped_spmm = recorded
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = prefill()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        moe.grouped_spmm = grouped_spmm
    torch.cuda.synchronize()
    launches = packed_spmm.launches_grouped
    check(launches == 2 * mcfg.n_layers == len(calls), f"lm_prefill: {launches} B1g launches")
    out["kernel_row"] = _b1g_prefill_row(torch, calls, launches)
    del calls
    torch.cuda.empty_cache()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    # a copy to the host shows as a DtoH memcpy and its stream synchronise;
    # aten::item also serves CPU scalars (B9's wrapper rounds its scale on
    # the host), so it is counted, not flagged
    bad = sorted({n for n in names if "DtoH" in n or "Synchronize" in n or n == "aten::nonzero"})
    spans = sorted({n for n in names if n.startswith(("moe.", "kernel.B1g", "attn.prefill"))})
    # the block's own closing synchronise is the one allowed
    check(bad in ([], ["cudaDeviceSynchronize"]),
          f"lm_prefill's host events hold copies to the host or synchronises: {bad}")
    out["prefill_no_sync"] = {"sync_debug": "error", "host_events": len(names),
                              "flagged": bad, "cpu_items": names.count("aten::item"),
                              "spans": spans, "finite": bool(torch.isfinite(logits).all())}
    log(f"Mellum-shaped lm_prefill (4 layers, 2 x 2048): no synchronise under "
        f"set_sync_debug_mode('error'); profiler events flagged {bad} (the block's closing "
        f"synchronise), {names.count('aten::item')} aten::item on host scalars; spans {spans}")
    print(json.dumps({"phase": 31, **out}), flush=True)
    log("phase 31 passed")
    return out


def moe_grouped_alone() -> int:
    """``python3 chip_smoke.py --moe-grouped``: build, then phase 31 alone."""
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port runs on the card")
    from smmb_tpu_torch.kernels import _build

    _build.build_all()
    run_moe_grouped(torch, torch.device("cuda"), card_line())
    return 0


def _packed_planes(packed) -> list:
    """Every ``TernaryPacked`` plane of a packed LM tree."""
    from smmb_tpu_torch.formats.packed import TernaryPacked

    if isinstance(packed, TernaryPacked):
        return [packed]
    if isinstance(packed, dict):
        return [p for v in packed.values() for p in _packed_planes(v)]
    if isinstance(packed, (list, tuple)):
        return [p for v in packed for p in _packed_planes(v)]
    return []


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fused-side"]:
        sys.path.insert(0, sys.argv[2])
        sys.exit(fused_side(*sys.argv[3:6]))
    if sys.argv[1:2] == ["--fused-ab"]:
        sys.exit(fused_ab(Path(sys.argv[2]).resolve()))
    if sys.argv[1:2] == ["--c1-candidate"]:
        sys.exit(c1_candidate(Path(sys.argv[2]).resolve()))
    if sys.argv[1:2] == ["--moe-grouped"]:
        sys.exit(moe_grouped_alone())
    sys.exit(main())
