from smmb_tpu_torch.kernels.packed_spmm import packed_spmm, packed_spmm_plain
