"""Seconds from ``Trainer(...)`` to the end of the warm-up call: the
trainer, its static operands (bit packs or dense adjacencies, built on
first use), the kernels' loading and the first call of the entry."""


def read(ctx):
    s = ctx.spans.get("trainer_warm")
    return sum(s) if s else None
