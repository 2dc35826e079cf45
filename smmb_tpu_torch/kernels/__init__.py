from smmb_tpu_torch.kernels.bcsr_spmm import (
    BCSRPrepared,
    bcsr_prepare,
    bcsr_spmm_kernel,
    bcsr_spmm_kernel_plain,
)
from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
