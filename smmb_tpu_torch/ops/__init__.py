from smmb_tpu_torch.ops.dense import gemm, gemm_prelu, prelu
from smmb_tpu_torch.ops.spmm import packed_spmm_ref
