"""The parallel layer of the port (counterpart of smmb_tpu/parallel/): one
process per rank over ``torch.distributed``; see parallel/mesh.py."""

from smmb_tpu_torch.parallel.bcsr_sharded import (
    shard_bcsr_columns,
    sharded_bcsr_spmm,
)
from smmb_tpu_torch.parallel.dp_train import make_lm_train_step_dp
from smmb_tpu_torch.parallel.mesh import make_mesh, run_world
from smmb_tpu_torch.parallel.overlap import sharded_spmm_column_overlapped
from smmb_tpu_torch.parallel.pp_lm import lm_forward_pp, shard_lm_pp
from smmb_tpu_torch.parallel.sharded import (
    shard_packed_columns,
    shard_packed_rows,
    sharded_spmm_column,
    sharded_spmm_row,
)
from smmb_tpu_torch.parallel.tp_transformer import (
    block_decode_step_tp,
    block_forward_tp,
    block_prefill_tp,
    generate_tp,
    init_block_cache_tp,
    lm_decode_step_tp,
    lm_forward_tp,
    lm_init_cache_tp,
    lm_prefill_tp,
    shard_block_tp,
    shard_lm_tp,
)
