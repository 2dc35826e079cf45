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
