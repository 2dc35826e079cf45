"""Named host spans at the port's layer boundaries, for a profiler trace.

``span(name)`` is the port's one span primitive. While a profiler session
records (``torch.autograd._profiler_enabled()``: the active step of a
``torch.profiler`` session, or ``torch.autograd.profiler.emit_nvtx()``) it
enters ``torch.profiler.record_function(name)``; otherwise it returns one
shared no-op context manager, so a span costs a call and a flag read with
nothing recording, and allocates nothing. Under ``emit_nvtx()`` a
``record_function`` range is an NVTX range, which is how ``nsys`` sees the
spans; no NVTX range is pushed otherwise.

Spans nest on the one host thread that issues the work, so each span's
parent is the span around it. A route's span names the route the gate chose
(``attn.decode[B4]``), so the count of a name in a trace is the count of
that route. Every name is a constant of this module, so a call builds no
string. Spans carry no request id: every entry point serves its whole batch
at once, so an ``lm.*`` span is the unit of work; ids wait for admission of
requests into a running batch.

The names, from the entry points down (``[…]`` is the route):

- ``lm.prefill``, ``lm.decode_step``: the entry points' bodies
  (``models/lm.py``); ``lm.head``: the head's product and scale multiply;
- ``mlp.forward``: ``models/mlp.py::mlp_forward``;
- ``block.attn``: a block's norm1 and attention and the residual add, up to
  the pre-``wo`` mix where B5 takes ``wo``; ``block.tail[B5]``: the fused
  tail; ``block.mlp[B6]``, ``block.mlp[B1]``: norm2 and the MLP half
  (``models/transformer.py``);
- ``attn.qkv[B3|B7|B1]``: a decode or extend step's projection, rope and
  cache write; ``attn.decode[B4|B8|plain]``, ``attn.extend[B4|B8|plain]``:
  the cache read; ``attn.prefill[B9|plain]``: the prefill's attention math,
  ``attn.prefill[B9/w|plain/w]`` in a layer with a sliding window;
  ``attn.kv_fill``: the prefill's K/V projections, rope and cache write
  (``models/attention.py``);
- ``block.moe``: an MoE block's norm2, routed half and residual
  (``models/moe_block.py``); inside it ``moe.route`` (the router's logits
  and the assignments), ``moe.dispatch`` (rows into expert order, scaled),
  the two ``kernel.B1g`` calls and ``moe.combine`` (``models/moe.py``);
- ``kernel.B1`` … ``kernel.B9p``, ``kernel.B1g``: each kernel wrapper's
  call on one 2-D (or head-layout) input, CPU or CUDA: checks, casts, tile
  choice and launch (``kernels/*.py``), beside its ``.launches`` counter
  (B1g's: ``packed_spmm.launches_grouped``).
"""

from __future__ import annotations

import torch

LM_PREFILL = "lm.prefill"
LM_DECODE_STEP = "lm.decode_step"
LM_HEAD = "lm.head"
MLP_FORWARD = "mlp.forward"

BLOCK_ATTN = "block.attn"
BLOCK_TAIL_B5 = "block.tail[B5]"
BLOCK_MLP_B6 = "block.mlp[B6]"
BLOCK_MLP_B1 = "block.mlp[B1]"

ATTN_QKV_B3 = "attn.qkv[B3]"
ATTN_QKV_B7 = "attn.qkv[B7]"
ATTN_QKV_B1 = "attn.qkv[B1]"
# a cache read's names by route: B4 (float cache), B8 (int8 cache), plain math
ATTN_DECODE = ("attn.decode[B4]", "attn.decode[B8]", "attn.decode[plain]")
ATTN_EXTEND = ("attn.extend[B4]", "attn.extend[B8]", "attn.extend[plain]")
ATTN_PREFILL_B9 = "attn.prefill[B9]"
ATTN_PREFILL_B9_WINDOW = "attn.prefill[B9/w]"
ATTN_PREFILL_PLAIN = "attn.prefill[plain]"
ATTN_PREFILL_PLAIN_WINDOW = "attn.prefill[plain/w]"
# a prefill's names by route (B9, plain math), each full, then windowed
ATTN_PREFILL = (ATTN_PREFILL_B9, ATTN_PREFILL_B9_WINDOW, ATTN_PREFILL_PLAIN,
                ATTN_PREFILL_PLAIN_WINDOW)
ATTN_KV_FILL = "attn.kv_fill"

BLOCK_MOE = "block.moe"
MOE_ROUTE = "moe.route"
MOE_DISPATCH = "moe.dispatch"
MOE_COMBINE = "moe.combine"

KERNEL_B1 = "kernel.B1"
KERNEL_B1G = "kernel.B1g"
KERNEL_B2 = "kernel.B2"
KERNEL_B3 = "kernel.B3"
KERNEL_B4 = "kernel.B4"
KERNEL_B5 = "kernel.B5"
KERNEL_B6 = "kernel.B6"
KERNEL_B7 = "kernel.B7"
KERNEL_B8 = "kernel.B8"
KERNEL_B9 = "kernel.B9"
KERNEL_B9P = "kernel.B9p"


class _Off:
    """The span with nothing recording: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_recording = torch.autograd._profiler_enabled
_record_function = torch.profiler.record_function


def span(name: str):
    """A context manager naming the work inside it ``name`` in a profiler
    trace (``with span(LM_HEAD): ...``); the shared no-op ``OFF`` when no
    profiler session records."""
    return _record_function(name) if _recording() else OFF
