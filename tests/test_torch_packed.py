"""Port parity: the 2-bit packed format (smmb_tpu_torch.formats.packed)
against smmb_tpu.formats.packed — the packed bytes must be identical, so a
plane packed by either package serves in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smmb_tpu.formats import packed as jpacked
from smmb_tpu_torch.convert import packed_from_numpy
from smmb_tpu_torch.formats import packed as tpacked

torch.set_num_threads(2)


def _matrix(seed, shape, values=(-1.0, 0.0, 1.0)):
    rs = np.random.default_rng(seed)
    return rs.choice(np.asarray(values, np.float32), size=shape)


@pytest.mark.parametrize(
    "shape", [(512, 64), (1024, 96), (100, 33), (1, 8), (513, 40), (2048, 128)]
)
def test_pack_bytes_equal_jax(shape):
    # includes K % 512 != 0 (zero padding) and non-±1 entries (encode as 0)
    w = _matrix(shape[0], shape, values=(-1.0, 0.0, 1.0, 2.0, -0.5, 1.5))
    jp = jpacked.pack_ternary(w)
    tp = tpacked.pack_ternary(w, device="cpu")
    assert tp.data.dtype == torch.int8
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    assert (tp.rows, tp.cols, tp.nnz) == (jp.rows, jp.cols, jp.nnz)
    assert tp.packed_rows == jp.packed_rows and tp.padded_rows == jp.padded_rows
    assert tp.weight_bytes() == jp.weight_bytes()


@pytest.mark.parametrize("shape", [(512, 64), (300, 48)])
def test_pack_device_matches_host_and_jax(shape):
    w = _matrix(7, shape, values=(-1.0, 0.0, 1.0, 2.0, -2.0))
    host = tpacked.pack_ternary(w, device="cpu")
    dev = tpacked.pack_ternary_device(torch.from_numpy(w))
    jdev = jpacked.pack_ternary_device(jnp.asarray(w))
    assert torch.equal(dev.data, host.data)
    np.testing.assert_array_equal(dev.data.numpy(), np.asarray(jdev.data))
    assert dev.nnz == -1


def test_unpack_roundtrip():
    w = _matrix(3, (700, 72))
    p = tpacked.pack_ternary(w, device="cpu")
    np.testing.assert_array_equal(tpacked.unpack_ternary(p).numpy(), w)
    assert p.density == pytest.approx(np.count_nonzero(w) / w.size)


def test_decode_words_equal_jax_for_every_byte():
    # every byte value, including the unused code 0b10 (decodes to -2)
    words = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    words = np.concatenate([words, words[::-1]], axis=1)
    want = np.asarray(jpacked.decode_words(jnp.asarray(words)))
    got = tpacked.decode_words(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)
    got_bf16 = tpacked.decode_words(torch.from_numpy(words), torch.bfloat16)
    np.testing.assert_array_equal(got_bf16.float().numpy(), want)


def test_jax_planes_serve_in_port():
    w = _matrix(5, (1000, 64))
    jp = jpacked.pack_ternary(w)
    tp = packed_from_numpy(np.asarray(jp.data), jp.rows, jp.cols, jp.nnz, device="cpu")
    np.testing.assert_array_equal(
        tpacked.unpack_ternary(tp).numpy(), np.asarray(jpacked.unpack_ternary(jp))
    )


def test_packed_ignores_non_unit_values():
    w = np.array([[1.0, 2.0], [-1.0, 0.5], [-3.0, 1.0]], np.float32)
    p = tpacked.pack_ternary(w, device="cpu")
    dense = tpacked.unpack_ternary(p).numpy()
    np.testing.assert_array_equal(dense, [[1, 0], [-1, 0], [0, 1]])
    assert p.nnz == 3


def test_concat_packed_cols():
    ws = [_matrix(i, (300, c)) for i, c in enumerate((16, 8, 24))]
    fused = tpacked.concat_packed_cols(
        [tpacked.pack_ternary(w, device="cpu") for w in ws]
    )
    np.testing.assert_array_equal(
        tpacked.unpack_ternary(fused).numpy(), np.concatenate(ws, axis=1)
    )
    assert fused.cols == 48 and fused.nnz == sum(np.count_nonzero(w) for w in ws)


def test_concat_packed_cols_rejects_row_mismatch():
    a = tpacked.pack_ternary(_matrix(0, (128, 8)), device="cpu")
    b = tpacked.pack_ternary(_matrix(1, (256, 8)), device="cpu")
    with pytest.raises(ValueError):
        tpacked.concat_packed_cols([a, b])


def test_packed_from_numpy_rejects_wrong_width():
    with pytest.raises(ValueError):
        packed_from_numpy(np.zeros((128, 8), np.int8), 512, 16, 0, device="cpu")


def test_constants_equal_jax():
    assert (tpacked.VALUES_PER_BYTE, tpacked.SUB, tpacked.GROUP_ROWS) == (
        jpacked.VALUES_PER_BYTE, jpacked.SUB, jpacked.GROUP_ROWS
    )
