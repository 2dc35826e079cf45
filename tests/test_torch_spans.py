"""The port's spans (smmb_tpu_torch/utils/spans.py) at its layer boundaries.

With no profiler session, ``span`` returns the shared no-op and nothing is
recorded. Under ``torch.profiler`` on the CPU, a 2-layer LM at d_model 512
(so that the fused QKV route B3 and the fused tail B5 are taken at decode M)
and 4 heads of 128 (so that B4's gate can admit a batch-1 step) gives one
span a layer boundary, each gate's route in its name, nested as the calls
nest; the packed MLP gives one ``mlp.forward`` and one ``kernel.B1`` a
layer. The kernel wrappers run their plain versions here. Outputs are
bitwise the same with the profiler on and off.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from smmb_tpu_torch.models import lm as tlm
from smmb_tpu_torch.models import mlp as tmlp
from smmb_tpu_torch.utils import rng, spans

torch.set_num_threads(2)
CFG = tlm.TernaryLMConfig(vocab=512, d_model=512, n_heads=4, d_ff=1024, n_layers=2,
                          max_len=16)


@pytest.fixture(scope="module")
def lm():
    packed = tlm.pack_lm(tlm.init_lm(rng.make_generator(0, "cpu"), CFG))
    gen = torch.Generator().manual_seed(1)
    prompts = {b: torch.randint(0, CFG.vocab, (b, 8), generator=gen) for b in (1, 16)}
    return packed, prompts


def _prefill(packed, prompt, use_flash):
    cache = tlm.lm_init_cache(CFG, prompt.shape[0], device="cpu")
    return tlm.lm_prefill(packed, prompt, cache, CFG, use_flash=use_flash)


def _recorded(fn):
    """fn()'s result and its spans [(name, start, end)] under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)}
    names |= set(spans.ATTN_DECODE) | set(spans.ATTN_EXTEND)
    # the raw events (building FunctionEvents would take most of the test)
    got = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in names]
    return out, got


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _count(got):
    return collections.Counter(name for name, _, _ in got)


def test_span_off_is_the_shared_noop(lm, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert spans.span(spans.LM_HEAD) is spans.OFF
    with spans.span(spans.KERNEL_B1) as entered:
        assert entered is None
    made = []
    monkeypatch.setattr(spans, "_record_function", lambda name: made.append(name))
    packed, prompts = lm
    logits, cache = _prefill(packed, prompts[16], False)
    tlm.lm_decode_step(packed, logits.argmax(-1), cache, CFG)
    assert made == []


def test_decode_b16_spans_nest(lm):
    packed, prompts = lm
    logits, cache = _prefill(packed, prompts[16], False)
    _, got = _recorded(lambda: tlm.lm_decode_step(packed, logits.argmax(-1), cache, CFG))
    n = _count(got)
    assert n["lm.decode_step"] == 1 and n["lm.head"] == 1
    assert n["block.attn"] == 2 and n["attn.decode[plain]"] == 2
    # batch 16 is within the fused routes' 32 rows
    assert n["attn.qkv[B3]"] == 2 and n["block.tail[B5]"] == 2
    assert n["kernel.B3"] == 2 and n["kernel.B5"] == 2 and n["kernel.B1"] == 1
    by = collections.defaultdict(list)
    for s in got:
        by[s[0]].append(s)
    step = by["lm.decode_step"][0]
    assert all(_inside(s, step) for s in got)
    attn = by["block.attn"]
    for name in ("attn.decode[plain]", "attn.qkv[B3]"):
        assert all(any(_inside(s, a) for a in attn) for s in by[name])
    assert not any(_inside(by["lm.head"][0], a) for a in attn)
    assert all(_inside(s, b) for s, b in zip(by["kernel.B5"], by["block.tail[B5]"]))
    assert _inside(by["kernel.B1"][0], by["lm.head"][0])


def test_decode_b1_flash_routes(lm):
    packed, prompts = lm
    logits, cache = _prefill(packed, prompts[1], True)
    _, got = _recorded(lambda: tlm.lm_decode_step(packed, logits.argmax(-1), cache, CFG,
                                                  use_flash=True))
    n = _count(got)
    assert n["attn.decode[B4]"] == 2 and n["kernel.B4"] == 2
    assert n["attn.decode[plain]"] == 0
    assert n["attn.qkv[B3]"] == 2 and n["block.tail[B5]"] == 2


def test_prefill_routes(lm):
    packed, prompts = lm
    _, got = _recorded(lambda: _prefill(packed, prompts[16], True))
    n = _count(got)
    assert n["lm.prefill"] == 1 and n["lm.head"] == 1
    assert n["attn.prefill[B9]"] == 2 and n["kernel.B9"] == 2
    assert n["attn.kv_fill"] == 2 and n["block.attn"] == 2
    # 16 × 8 rows are above B6's 32, so the MLP half is two B1 calls
    assert n["block.mlp[B1]"] == 2 and n["block.mlp[B6]"] == 0
    _, plain = _recorded(lambda: _prefill(packed, prompts[1], False))
    n = _count(plain)
    assert n["attn.prefill[plain]"] == 2 and n["attn.prefill[B9]"] == 0
    assert n["block.mlp[B6]"] == 2  # 8 rows: the fused MLP half


def test_mlp_forward_spans():
    cfg = tmlp.TernaryMLPConfig(layer_dims=(512, 512, 512, 512))
    packed = tmlp.pack_mlp(tmlp.init_mlp(rng.make_generator(2, "cpu"), cfg))
    x = rng.rand_dense(rng.make_generator(3, "cpu"), (4, 512))
    _, got = _recorded(lambda: tmlp.mlp_forward(packed, x, cfg, compute_dtype=torch.bfloat16))
    assert _count(got) == {"mlp.forward": 1, "kernel.B1": 3}


def test_outputs_bitwise_with_and_without_profiler(lm):
    packed, prompts = lm

    def serve():
        out = []
        for use_flash in (False, True):
            logits, cache = _prefill(packed, prompts[1], use_flash)
            step = tlm.lm_decode_step(packed, logits.argmax(-1), cache, CFG,
                                      use_flash=use_flash)[0]
            out += [logits, step]
        return out

    off = serve()
    on, got = _recorded(serve)
    assert _count(got)["lm.decode_step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(off, on))
