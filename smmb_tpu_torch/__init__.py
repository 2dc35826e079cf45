"""smmb_tpu_torch — the PyTorch/CUDA port of smmb_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and ``numpy`` and never JAX or ``smmb_tpu``. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; on a CPU tensor
each kernel wrapper runs its plain PyTorch version.

It carries the packed ternary MLP serving path, the ternary LM's serving
path (dense or routed MoE blocks, float and int8 KV caches, flash
attention, chunked extend, ragged batches, prefix forking, beam search,
speculative decoding and LoRA adapters over the frozen packed base), their
training (STE training of the MLP, the LM and the MoE, draft distillation,
adapter training, fine-tuning through the packed kernel) and the reference
benchmark (showcase, sweep and capacity):

- ``formats``: the 2-bit ``TernaryPacked`` format, TCSC, TCSCPadded, BCSR
  and the legacy threshold constructors, their arrays identical to JAX's;
- ``ops``: dense oracles, the plain decode-then-matmul packed SpMM and the
  TCSC/BCSR ops;
- ``kernels``: hand-written CUDA kernels for ``sm_90a`` built at first use:
  ``packed_spmm`` (``csrc/packed_spmm.cu``), ``bcsr_spmm_kernel``
  (``csrc/bcsr_spmm.cu``) and ``fused_norm_qkv``,
  ``fused_mlp``, ``fused_block_tail`` (``csrc/fused_mlp.cu``),
  ``flash_attention_decode`` / ``flash_attention_chunk``
  (``csrc/flash_decode.cu``) and ``flash_attention`` (``csrc/flash_attention.cu``,
  with its pipelined variant under ``pipeline_p``), and
  ``make_packed_linear``, an autograd function over ``packed_spmm``
  (forward on W, backward on the packed Wᵀ);
- ``models``: the packed ternary MLP (``mlp_forward``, ``PackedTernaryMLP``)
  and the LM (``attention``, ``transformer``, ``moe`` and ``moe_block``,
  ``lm``: ``generate``, ``fork_cache``, ``generate_beam``; ``spec_decode``:
  ``generate_speculative``; ``lora``: ``attach_lora``) and their training
  (``train``: ``make_train_step``; ``make_lm_train_step``,
  ``make_moe_train_step``, ``make_draft_distill_step``,
  ``make_lora_train_step``);
- ``nn``: the ``TernaryDense`` QAT layer, ``convert_to_packed`` and the
  ``PackedTernaryDense`` serving layer;
- ``convert``: parameters and formats carried across from the JAX package;
- ``io``: ``.npz`` save/load in the JAX package's file layout;
- ``bench``: CUDA-event timing, the H100 roofline, the showcase/sweep and
  capacity benchmarks with their report layer, the MLP, headline, LM,
  decode and speculative-decoding benches, and the profiler breakdown.
"""

__version__ = "0.1.0"

from smmb_tpu_torch.formats.bcsr import BCSR, bcsr_from_dense, bcsr_to_dense
from smmb_tpu_torch.formats.packed import (
    TernaryPacked,
    pack_ternary,
    pack_ternary_device,
    unpack_ternary,
)
from smmb_tpu_torch.formats.tcsc import TCSC, tcsc_from_dense, tcsc_to_dense
from smmb_tpu_torch.kernels.bcsr_spmm import BCSRPrepared, bcsr_prepare, bcsr_spmm_kernel
from smmb_tpu_torch.kernels.flash_attention import flash_attention
from smmb_tpu_torch.kernels.flash_decode import flash_attention_chunk, flash_attention_decode
from smmb_tpu_torch.kernels.fused_mlp import fused_block_tail, fused_mlp, fused_norm_qkv
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
from smmb_tpu_torch.models.lm import (
    TernaryLMConfig,
    generate,
    init_lm,
    lm_decode_step,
    lm_extend,
    lm_forward,
    lm_prefill,
    lm_prefill_chunked,
    pack_lm,
)
from smmb_tpu_torch.models.mlp import (
    PackedTernaryMLP,
    TernaryMLPConfig,
    init_mlp,
    mlp_forward,
    pack_mlp,
)
from smmb_tpu_torch.nn import PackedTernaryDense
from smmb_tpu_torch.ops import (
    bcsr_spmm,
    bcsr_spmm_prelu,
    gemm,
    gemm_prelu,
    packed_spmm_ref,
    prelu,
    tcsc_spmm,
    tcsc_spmm_padded,
    tcsc_spmm_prelu,
)
