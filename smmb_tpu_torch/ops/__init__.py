from smmb_tpu_torch.ops.dense import gemm, gemm_prelu, prelu
from smmb_tpu_torch.ops.spmm import (
    bcsr_spmm,
    bcsr_spmm_prelu,
    packed_spmm_ref,
    tcsc_spmm,
    tcsc_spmm_padded,
    tcsc_spmm_prelu,
)
