"""The port-owned examples (examples/torch_lm_generate.py,
torch_transformer_serving.py, torch_train_and_serve.py and
torch_serving_features.py, the counterparts of JAX's four) run end to end on
CPU tensors with ``--cpu``: each ``main`` returns 0 only when the claims it
prints hold. Without ``--cpu`` and without a card they raise, and none of
them imports JAX or smmb_tpu.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import torch_lm_generate  # noqa: E402
import torch_serving_features  # noqa: E402
import torch_train_and_serve  # noqa: E402
import torch_transformer_serving  # noqa: E402

torch.set_num_threads(2)
EXAMPLES = {"lm_generate": torch_lm_generate, "transformer_serving": torch_transformer_serving,
            "train_and_serve": torch_train_and_serve,
            "serving_features": torch_serving_features}


def test_lm_generate_cpu(capsys):
    rc = torch_lm_generate.main(["--cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "training loss fell: True" in out
    assert "packed wq: (128, 64) int8 (8192 B vs 16384 B dense fp32)" in out
    assert "pattern accuracy:" in out and "continuation:" in out


def test_transformer_serving_cpu(capsys):
    rc = torch_transformer_serving.main(["--cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "768 KiB packed vs 12288 KiB dense fp32 (16.0x smaller)" in out
    assert "served 128 tokens -> (2, 64, 512), finite: True" in out


def test_train_and_serve_cpu(tmp_path, capsys):
    path = tmp_path / "ternary_mlp.npz"
    rc = torch_train_and_serve.main(["--cpu", "--out", str(path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert path.exists()
    assert f"artifact round-trip bitwise: True -> {path}" in out
    assert "serving output: (256, 64) finite: True" in out


def test_serving_features_cpu(capsys):
    rc = torch_serving_features.main(["--cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for claim in ("(token-identical to greedy: True)", "chunked prefill matches one-shot: True",
                  "ragged row 0 == its solo run: True", "claims: all hold"):
        assert claim in out, claim
    loss = out.split("LoRA adapters: loss ")[1].split(";")[0]
    first, last = (float(v) for v in loss.split(" -> "))
    assert last < first


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_need_a_card_without_cpu(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--out", str(tmp_path / "m.npz")] if name == "train_and_serve" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        EXAMPLES[name].main(args)


def test_examples_import_no_jax():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, "examples")
        import torch_lm_generate, torch_serving_features, torch_train_and_serve
        import torch_transformer_serving
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "smmb_tpu", "flax"))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
