"""The port's traced-graph analyzer (``launch/graph_analysis.py``)
against the JAX package's HLO analyzer: the ring model and the roofline
bound at the reference's constants and on the H100 table, FLOPs of a
loop, its unrolled form and a nested loop, and one traced DTensor
redistribution on a 4-rank fake mesh."""

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro.launch import hlo_analysis as JH

from repro_torch.core.chips import H100_SXM, ChipSpec
from repro_torch.launch import graph_analysis as G

REF_CHIP = ChipSpec(name="reference", peak_flops=JH.PEAK_FLOPS,
                    hbm_bw=JH.HBM_BW, link_bw=JH.ICI_BW, hbm_bytes=0)


def test_collective_ring_model_equals_reference():
    s, j = G.CollectiveStats(), JH.CollectiveStats()
    for kind, b, n in (("all-reduce", 1000.0, 4), ("all-gather", 1000.0, 4),
                       ("collective-permute", 1000.0, 4),
                       ("reduce-scatter", 1000.0, 4),
                       ("all-to-all", 512.0, 8), ("all-reduce", 3.0, 1)):
        s.add(kind, b, n)
        j.add(kind, b, n)
    assert s.per_op["all-gather"] == pytest.approx(750.0)
    assert s.per_op["collective-permute"] == pytest.approx(1000.0)
    assert s.per_op["all-reduce"] == pytest.approx(1500.0)
    assert (s.per_op, s.per_op_count, s.raw_result_bytes,
            s.modeled_bytes) == (j.per_op, j.per_op_count,
                                 j.raw_result_bytes, j.modeled_bytes)


@pytest.mark.parametrize("chip", [REF_CHIP, H100_SXM], ids=["ref", "h100"])
def test_roofline_bound_selection(chip):
    for kw, bound in (({"flops_per_device": chip.peak_flops}, "compute"),
                      ({"bytes_per_device": chip.hbm_bw}, "memory"),
                      ({"collective_bytes": chip.link_bw}, "collective")):
        args = dict(flops_per_device=0.0, bytes_per_device=0.0,
                    collective_bytes=0.0)
        args.update(kw)
        t = G.roofline_terms(chip=chip, **args)
        assert t["bound"] == bound
        assert t["t_bound_s"] == pytest.approx(1.0)
        if chip is REF_CHIP:
            assert t == JH.roofline_terms(**args)
    t = G.roofline_terms(flops_per_device=989e12, bytes_per_device=3.35e12,
                         collective_bytes=0.9e12)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == \
        pytest.approx((1.0, 1.0, 2.0))
    assert t["bound"] == "collective"


def _trace(fn, *shapes):
    return make_fx(fn, tracing_mode="fake")(
        *[torch.empty(s) for s in shapes])


def test_loop_and_unrolled_count_the_same():
    def loop_mm(x, w):
        for _ in range(7):
            x = x @ w
        return x

    def unroll_mm(x, w):
        x = x @ w
        x = x @ w
        x = x @ w
        x = x @ w
        x = x @ w
        x = x @ w
        return x @ w

    want = 7 * 2 * 128 ** 3
    a = G.analyze_graph(_trace(loop_mm, (128, 128), (128, 128)))
    b = G.analyze_graph(_trace(unroll_mm, (128, 128), (128, 128)))
    assert a.flops == pytest.approx(want, rel=1e-6)
    assert b.flops == pytest.approx(want, rel=1e-6)
    # each matmul reads two (128, 128) f32 operands and writes one
    assert a.bytes == b.bytes == 7 * 3 * 128 * 128 * 4


def test_nested_loop():
    def nested(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    a = G.analyze_graph(_trace(nested, (64, 64), (64, 64)))
    assert a.flops == pytest.approx(15 * 2 * 64 ** 3, rel=1e-6)
    assert a.collectives.modeled_bytes == 0.0


def test_memory_terms_walk():
    """Arguments, outputs and the peak of the live intermediates."""
    def chain(x):
        a = x * 2.0              # 4 KiB, live until c
        b = a + 1.0              # 4 KiB
        c = a * b                # frees a and b after this
        v = c.view(-1)           # a view: no new buffer
        return v.sum()

    m = G.memory_terms(_trace(chain, (32, 32)))
    assert m["argument_bytes"] == 32 * 32 * 4
    assert m["output_bytes"] == 4
    assert m["temp_bytes"] == 3 * 32 * 32 * 4


def test_in_place_moves_bytes_but_allocates_nothing():
    def update(p, g):
        p.mul_(0.5)              # reads and writes p: 2 x 4 KiB
        return p.view(-1)        # a view: nothing

    gm = _trace(update, (32, 32), (32, 32))
    assert G.analyze_graph(gm).bytes == 2 * 32 * 32 * 4
    assert G.memory_terms(gm)["temp_bytes"] == 0


@pytest.fixture
def fake_mesh():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, release_mesh
    assert not dist.is_initialized()
    mesh = make_mesh((4,), ("model",), device="cpu")
    yield mesh
    release_mesh()
    assert not dist.is_initialized()


def test_traced_redistribute_on_a_fake_mesh(fake_mesh):
    """A (64, 32) f32 tensor sharded on dim 0 over 4 ranks, gathered:
    one all-gather in a group of 4, whose result is the whole tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def gather(local):
        d = DTensor.from_local(local, fake_mesh, (Shard(0),),
                               run_check=False)
        return d.redistribute(fake_mesh, (Replicate(),)).to_local()

    gm = _trace(gather, (16, 32))
    stats = G.parse_collectives(gm)
    assert stats.per_op_count == {"all-gather": 1}
    full = 64 * 32 * 4
    assert stats.raw_result_bytes == full
    assert stats.per_op["all-gather"] == pytest.approx(3 / 4 * full)
    (node,) = [n for n in gm.graph.nodes if n.op == "call_function"
               and G._op_name(n) == "all_gather_into_tensor"]
    assert G._group_size(node) == 4
    cost = G.analyze_graph(gm)
    assert cost.collectives.per_op == stats.per_op
    assert G.dtype_bytes(torch.bfloat16) == 2
