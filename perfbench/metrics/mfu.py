"""``mfu``: the whole step's share of the card's bf16 peak, in %: the
operations all the window's completed work needs (ternary products at
``2·M·nnz + M·N``, attention over the causal half or the cached keys, the
head where its logits are used), counted from the shapes, over the window's
seconds on the host clock times the bf16 peak. The card's power limit is
printed beside the result."""


def read(ctx):
    flops, secs = ctx.window.get("flops"), ctx.window.get("seconds")
    if not flops or not secs:
        return None
    return 100.0 * flops / (secs * ctx.peaks.bf16_flops)
