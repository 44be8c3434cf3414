"""Seconds of the host graph: the span around the program's ``CSRMat``,
``HeterGraph`` and ``DataIterator`` over the benchmark's graph."""


def read(ctx):
    s = ctx.spans.get("graph_build")
    return sum(s) if s else None
