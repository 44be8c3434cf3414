import pytest

from port_bench import flops


def cfg(**kw):
    from types import SimpleNamespace

    base = dict(nblocks=1, num_links=2, agg_units=(4,), out_units=(3,),
                embed_units=2, gen_rating_mid_map=5, agg_accum="sum",
                use_dae=True, num_users=10, num_items=6)
    return SimpleNamespace(**dict(base, **kw))


def test_step_flops_by_hand():
    # 1 block, 2 levels, agg 4 ('sum'), out 3, embed 2, mid 5, DAE;
    # 10 users, 6 items, 7 edges, 4 pairs.
    f = flops.step_flops(cfg(), 7, 4)
    agg = 2 * (1 * 1 * 2 * 7) * 2          # messages * embed
    proj = 1 * 2 * 1 * 2 * 16 * 2 * 4
    out = 1 * 2 * 16 * 4 * 3
    dec = 1 * (2 * 4 * 2 * 3 * 5 + 2 * 4 * 5)
    rec = 1 * 2 * 16 * 3 * 2
    assert f["fwd"] == agg + proj + out + dec + rec
    assert f["step"] == 3 * f["fwd"]
    stack = flops.step_flops(cfg(agg_accum="stack", use_dae=False), 7, 4)
    assert stack["fwd"] == agg + proj + 2 * out + dec


def test_mfu_arithmetic():
    # 67e12 FLOPs in 2 s of untraced calls is 50% of the float32 peak.
    from types import SimpleNamespace

    from port_bench.metrics import train_mfu

    c = cfg(num_links=1, agg_units=(1,), out_units=(1,), embed_units=1,
            gen_rating_mid_map=1, use_dae=False, num_users=1, num_items=1)
    one = flops.step_flops(c, 0, 0)["step"]
    ctx = SimpleNamespace(trace={"busy_s": 1.0, "window_s": 9.0}, steps=3,
                          free_steps=int(67e12 // one), free_s=2.0,
                          train_batch=0, edges={"train": 0}, model_cfg=c)
    assert train_mfu.read(ctx) == pytest.approx(
        100 * ctx.free_steps * one / (2 * 67e12))
    assert train_mfu.read(ctx) == pytest.approx(50.0, rel=1e-6)
    # A traced run whose window was all traced has no untraced calls.
    ctx.free_steps = 0
    assert train_mfu.read(ctx) is None


def test_bit_walk_bytes_by_hand():
    # 2 levels, 16 dst, 8 src, f 3: 2*16*8/8 + 8*3*4 + 2*16*3*4 bytes.
    nbytes = 32 + 96 + 384
    assert flops.bit_walk_least_s(2, 16, 8, 3, 0) == pytest.approx(
        nbytes / 3.35e12)
    # Many set bits: the float32 adds bound it.
    assert flops.bit_walk_least_s(2, 16, 8, 3, 10**12) == pytest.approx(
        3e12 / 67e12)


def test_bmm_bytes_by_hand():
    # (2, 3, 4) @ (2, 4, 5) bf16 -> float32: 2*(12+20)*2 + 2*15*4 bytes.
    assert flops.bmm_least_s(2, 3, 4, 5) == pytest.approx(248 / 3.35e12)
    big = flops.bmm_least_s(1, 8192, 8192, 8192)
    assert big == pytest.approx(2 * 8192**3 / 989e12)
