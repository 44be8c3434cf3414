"""Useful FLOPs over the untraced calls of the traced run, over their
seconds and the card's float32 peak (the precision the configurations
compute in), in %: each training step by ``flops.step_flops``, the
batch's edges taken out of the train graph and the batch scored.  The
untraced calls run at the program's own pace; the profiler slows the
traced ones."""

from port_bench import flops


def read(ctx):
    if ctx.free_steps <= 0 or ctx.free_s <= 0.0:
        return None
    b = ctx.train_batch
    total = ctx.free_steps * flops.step_flops(
        ctx.model_cfg, ctx.edges["train"] - b, b)["step"]
    return 100.0 * total / (ctx.free_s * flops.PEAKS["fp32_flops"])
