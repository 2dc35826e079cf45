from smmb_tpu_torch.models.mlp import (
    PackedTernaryMLP,
    TernaryMLPConfig,
    init_mlp,
    mlp_forward,
    pack_mlp,
)
from smmb_tpu_torch.models.train import absmean_scale, ternarize_ste
