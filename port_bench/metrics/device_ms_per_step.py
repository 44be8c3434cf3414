"""Device time a training step, in ms: the union of device activity in the
traced window over the optimiser steps taken in it.  Steadier than the
end-to-end rate on a shared host, whose CPU sets the pace of these
host-bound steps."""


def read(ctx):
    t = ctx.trace
    if not t or t.get("busy_s", 0.0) <= 0.0 or ctx.steps <= 0:
        return None
    return 1e3 * t["busy_s"] / ctx.steps
