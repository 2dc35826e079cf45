"""smmb_tpu_torch — the PyTorch/CUDA port of smmb_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and ``numpy`` and never JAX or ``smmb_tpu``. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; on a CPU tensor
each kernel wrapper runs its plain PyTorch version.

This slice carries the packed ternary MLP serving path:

- ``formats``: the 2-bit ``TernaryPacked`` format, byte-identical to JAX's;
- ``ops``: dense oracles and the plain decode-then-matmul packed SpMM;
- ``kernels``: ``packed_spmm``, a hand-written CUDA kernel for ``sm_90a``
  (``kernels/csrc/packed_spmm.cu``) built at first use;
- ``models``: the packed ternary MLP (``mlp_forward``, ``PackedTernaryMLP``);
- ``nn``: the ``PackedTernaryDense`` serving layer;
- ``convert``: parameters carried across from the JAX package;
- ``bench``: CUDA-event timing, the H100 roofline, MLP and headline benches.
"""

__version__ = "0.1.0"

from smmb_tpu_torch.formats.packed import (
    TernaryPacked,
    pack_ternary,
    pack_ternary_device,
    unpack_ternary,
)
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
from smmb_tpu_torch.models.mlp import (
    PackedTernaryMLP,
    TernaryMLPConfig,
    init_mlp,
    mlp_forward,
    pack_mlp,
)
from smmb_tpu_torch.nn import PackedTernaryDense
from smmb_tpu_torch.ops import gemm, gemm_prelu, packed_spmm_ref, prelu
