"""The adjacency products' share of their roofline, in %: the least time of
the window's bf16 GEMM launches (``flops.bmm_least_s``: bytes at the HBM
rate or multiply-adds at the bf16 peak) over their device time.  Only the
0/1 adjacency's products take bf16 operands on the ``dense`` path: each
block's forward aggregates into users ``(R, Nu, Ni) @ (R, Ni, U)`` and
into items ``(R, Ni, Nu) @ (R, Nu, U)``, and the backward of each gives
the other type's gradient in two products (the cotangent's bf16 part and
its remainder), so half the launches have each shape."""

from port_bench import flops


def read(ctx):
    ks = [k for k in ctx.trace.get("kernels", ())
          if "gemm" in k[0] and "bf16" in k[0]]
    if not ks:
        return None
    c = ctx.model_cfg
    u = c.agg_units[-1]
    both = (flops.bmm_least_s(c.num_links, c.num_users, c.num_items, u)
            + flops.bmm_least_s(c.num_links, c.num_items, c.num_users, u))
    return 100.0 * len(ks) * both / 2 / sum(k[1] for k in ks)
