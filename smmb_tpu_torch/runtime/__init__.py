from smmb_tpu_torch.runtime.data import TokenDataset, write_token_file
from smmb_tpu_torch.runtime.native import (
    bcsr_from_dense_native,
    native_available,
    pack_ternary_native,
    tcsc_from_dense_native,
)
