from smmb_tpu_torch.models.mlp import (
    PackedTernaryMLP,
    TernaryMLPConfig,
    init_mlp,
    mlp_forward,
    pack_mlp,
)
from smmb_tpu_torch.models.train import (
    absmean_scale,
    make_train_step,
    qat_forward,
    ternarize_ste,
)
from smmb_tpu_torch.models.attention import attention_math_chunked, qat_attention_forward
from smmb_tpu_torch.models.transformer import qat_block_forward
from smmb_tpu_torch.models.lm import make_lm_train_step, qat_lm_forward
from smmb_tpu_torch.models.spec_decode import make_draft_distill_step
from smmb_tpu_torch.models.moe import TernaryMoEConfig, make_moe_train_step, moe_forward
from smmb_tpu_torch.models.lora import attach_lora, init_lora_lm, make_lora_train_step
