"""Share of the untraced calls' seconds in which the card was idle, in %:
100 * (1 - device time a step * their steps / their seconds).  The device
time a step is the union of device activity over the steps of the traced
calls (``device_ms_per_step``); the untraced calls run at the program's
own pace, where the profiler's host overhead lengthens the traced ones'
idle gaps."""


def read(ctx):
    t = ctx.trace
    if (not t or t.get("busy_s", 0.0) <= 0.0 or ctx.steps <= 0
            or ctx.free_steps <= 0 or ctx.free_s <= 0.0):
        return None
    busy = t["busy_s"] / ctx.steps * ctx.free_steps
    return 100.0 * (1.0 - busy / ctx.free_s)
