"""The operation and byte counts against hand counts at two shapes each."""

from __future__ import annotations

import pytest

from perfbench_tiny_cells import PKG  # noqa: F401  (puts the repo on sys.path)

from perfbench.counts import ops, ternary_lm, ternary_mlp

LM = {"vocab": 1000, "d_model": 256, "n_layers": 3, "n_heads": 4, "n_kv_heads": 2,
      "d_ff": 512}


@pytest.mark.parametrize("m,k,n,nnz,flops,nbytes", [
    # 2·M·nnz + M·N; M·K·2 + K·N/4 + M·N·2 + 4·N
    (256, 4096, 4096, 1677722, 2 * 256 * 1677722 + 256 * 4096,
     256 * 4096 * 2 + 4096 * 4096 // 4 + 256 * 4096 * 2 + 4 * 4096),
    (1, 2560, 128256, 164167680, 2 * 164167680 + 128256,
     2560 * 2 + 2560 * 128256 // 4 + 128256 * 2 + 4 * 128256),
])
def test_ternary_item(m, k, n, nnz, flops, nbytes):
    item = ops.ternary_item(m, k, n, nnz, 2)
    assert item.ops == flops and item.bytes == nbytes


@pytest.mark.parametrize("b,h,kvh,hd,t", [(1, 2, 1, 4, 3), (4, 20, 5, 128, 4096)])
def test_causal_attention(b, h, kvh, hd, t):
    pairs = sum(range(1, t + 1))  # query i attends keys 0..i
    item = ops.prefill_attention_item(b, h, kvh, hd, t, 2)
    assert item.ops == 2 * 2 * b * h * hd * pairs
    assert item.bytes == 2 * b * t * hd * (h + h + kvh + kvh)


def test_bound_takes_the_larger():
    peaks = ops.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks.bf16_flops == 989e12 and peaks.hbm_bytes_per_s == 3.35e12
    assert ops.Item(989e12, 1.0).bound_s(peaks) == 1.0
    assert ops.Item(1.0, 3.35e12).bound_s(peaks) == 1.0
    with pytest.raises(ValueError):
        ops.peaks_for("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("b,t", [(1, 5), (4, 64)])
def test_lm_prefill_request(b, t):
    nnz = {"wq": 100, "wk": 50, "wv": 50, "wo": 100, "w_up": 300, "w_down": 300, "head": 7000}
    w = ternary_lm.prefill_request(LM, nnz, b, t)
    m = b * t
    # blocks: 2·M·nnz for every kind, plus M·N bias adds per layer
    cols = 256 + 128 + 128 + 256 + 512 + 256
    blocks = 2 * m * 900 + 3 * m * cols
    head = 2 * b * 7000 + b * 1000  # the last position of each prompt only
    attn = 3 * 4 * b * 4 * 64 * t * (t + 1) // 2
    assert w["flops"] == blocks + head + attn
    assert sum(i.ops for i in w["flash"]) == attn


@pytest.mark.parametrize("b,pos", [(1, 0), (64, 1279)])
def test_lm_decode_step(b, pos):
    nnz = {"wq": 100, "wk": 50, "wv": 50, "wo": 100, "w_up": 300, "w_down": 300, "head": 7000}
    w = ternary_lm.decode_step(LM, nnz, b, pos)
    cols = 256 + 128 + 128 + 256 + 512 + 256
    attn = 3 * 4 * b * 4 * 64 * (pos + 1)
    assert w["flops"] == 2 * b * 900 + 3 * b * cols + 2 * b * 7000 + b * 1000 + attn
    assert not w["flash"]


def test_mlp_forward():
    cfg = {"layer_dims": [8, 16, 4]}
    w = ternary_mlp.forward(cfg, [10, 6], 3)
    assert w["flops"] == (2 * 3 * 10 + 3 * 16) + (2 * 3 * 6 + 3 * 4)
    assert [i.bytes for i in w["spmm"]] == [3 * 8 * 2 + 32 + 3 * 16 * 2 + 64,
                                            3 * 16 * 2 + 16 + 3 * 4 * 2 + 16]


def test_kernel_groups():
    assert "packed_spmm_mma" in ops.kernel_group("ternary_projections")
    assert "flash_prefill_mma_kernel" in ops.kernel_group("flash_prefill")
