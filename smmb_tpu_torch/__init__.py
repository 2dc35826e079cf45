"""smmb_tpu_torch — the PyTorch/CUDA port of smmb_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and ``numpy`` and never JAX or ``smmb_tpu``. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; on a CPU tensor
each kernel wrapper runs its plain PyTorch version.

It carries the packed ternary MLP serving path and the ternary LM's
serving path (dense blocks, float KV cache):

- ``formats``: the 2-bit ``TernaryPacked`` format, byte-identical to JAX's;
- ``ops``: dense oracles and the plain decode-then-matmul packed SpMM;
- ``kernels``: hand-written CUDA kernels for ``sm_90a`` built at first use:
  ``packed_spmm`` (``csrc/packed_spmm.cu``) and ``fused_norm_qkv``,
  ``fused_mlp``, ``fused_block_tail`` (``csrc/fused_mlp.cu``);
- ``models``: the packed ternary MLP (``mlp_forward``, ``PackedTernaryMLP``)
  and the LM (``attention``, ``transformer``, ``lm``: ``generate``);
- ``nn``: the ``PackedTernaryDense`` serving layer;
- ``convert``: parameters carried across from the JAX package;
- ``bench``: CUDA-event timing, the H100 roofline, the MLP, headline, LM
  and decode benches, and the profiler breakdown.
"""

__version__ = "0.1.0"

from smmb_tpu_torch.formats.packed import (
    TernaryPacked,
    pack_ternary,
    pack_ternary_device,
    unpack_ternary,
)
from smmb_tpu_torch.kernels.fused_mlp import fused_block_tail, fused_mlp, fused_norm_qkv
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
from smmb_tpu_torch.models.lm import (
    TernaryLMConfig,
    generate,
    init_lm,
    lm_decode_step,
    lm_forward,
    lm_prefill,
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
from smmb_tpu_torch.ops import gemm, gemm_prelu, packed_spmm_ref, prelu
