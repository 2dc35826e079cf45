from smmb_tpu_torch.formats.bcsr import BCSR, bcsr_block_rows, bcsr_from_dense, bcsr_to_dense
from smmb_tpu_torch.formats.legacy import (
    bcsr_from_dense_threshold,
    pack_ternary_threshold,
    tcsc_from_dense_threshold,
    ternarize_threshold,
)
from smmb_tpu_torch.formats.packed import (
    GROUP_ROWS,
    SUB,
    VALUES_PER_BYTE,
    TernaryPacked,
    concat_packed_cols,
    decode_words,
    pack_ternary,
    pack_ternary_device,
    unpack_ternary,
)
from smmb_tpu_torch.formats.tcsc import (
    TCSC,
    TCSCPadded,
    tcsc_from_dense,
    tcsc_pad_columns,
    tcsc_to_dense,
)
