"""The bit walks' share of their roofline, in %: the summed least time of
the window's walk launches (``flops.bit_walk_least_s``) over their summed
device time, each launch's bf16 table kernel included.  Every forward
walks once into users and once into items a block, and every backward
gives each type's gradient once a block, so half the walks go each way."""

from port_bench import flops

NAMES = ("walk_kernel", "table_kernel")


def read(ctx):
    ks = [k for k in ctx.trace.get("kernels", ())
          if any(n in k[0] for n in NAMES)]
    walks = sum(1 for k in ks if "walk_kernel" in k[0])
    if not walks:
        return None
    c = ctx.model_cfg
    f = c.embed_units + 1            # the raw rows and the bias's ones
    e = ctx.edges["train"]
    both = (flops.bit_walk_least_s(c.num_links, c.num_users, c.num_items, f,
                                   e)
            + flops.bit_walk_least_s(c.num_links, c.num_items, c.num_users,
                                     f, e))
    return 100.0 * walks * both / 2 / sum(k[1] for k in ks)
