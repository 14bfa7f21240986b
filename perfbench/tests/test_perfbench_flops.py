"""Work counted from shapes, against hand counts at both configurations'
widths, and the attention bound against the kernel table's bound_ms."""

import pytest

from perfbench import flops
from perfbench.registry import Benchmark

PEAK = flops.peaks("NVIDIA H100 80GB HBM3")


def shapes(name):
    cfg = Benchmark().cell(name).config
    if cfg["env"] == "DiscreteCarFlag-v0":
        return flops.shapes(cfg, 3, False, 3)
    return flops.shapes(cfg, 6, True, 6)


def test_forward_flops_one_token_carflag():
    # Embedding 2*3*64; per layer QKV 2*64*192, out 2*64*64, MLP
    # 2*2*64*256, attention 4*1*64; head 2*64*64 + 2*64*3.
    per_layer = 24576 + 8192 + 65536 + 256
    assert flops.forward_flops(shapes("carflag_dtqn.s1"), 1, 1) == \
        384 + 2 * per_layer + 8192 + 384


def test_forward_flops_one_token_gridverse_bag():
    s = shapes("gv7x7_dtqn_bag25.s1")
    embed = 2 * 48 * 128
    per_layer = 98304 + 32768 + 262144 + 512
    bag = 25 * embed + 2 * 32768 + 25 * 2 * 32768 + 4 * 25 * 128
    head = 2 * 256 * 128 + 2 * 128 * 6
    assert flops.forward_flops(s, 1, 1) == embed + 2 * per_layer + bag + head


def test_causal_attention_counts_unmasked_pairs():
    s = shapes("carflag_dtqn.s1")
    # Two layers, each 4 * pairs * features more per window of 50 steps.
    no_attention = 50 * (flops.forward_flops(s, 1, 1)
                         - 2 * 4 * 64)
    assert flops.forward_flops(s, 1, 50) == no_attention + 2 * 4 * 1275 * 64


def test_iteration_flops_carflag():
    s = shapes("carflag_dtqn.s1")
    fwd = flops.forward_flops(s, 32, 50)
    update = 3 * fwd + 2 * fwd - 32 * 50 * 384
    it = flops.iteration_flops(s, 1, 64, 32, 64)
    assert it == flops.forward_flops(s, 64, 50) + 64 * update
    # About 1.7 GFLOP an env step (64 env steps an iteration).
    assert 1.6e9 < it / 64 < 1.9e9
    assert flops.iteration_flops(s, 5, 64, 32, 64) == 5 * it


def test_iteration_flops_bag_has_the_evict_forward():
    s = shapes("gv7x7_dtqn_bag25.s1")
    with_evict = flops.iteration_flops(s, 1, 64, 32, 64)
    no_bag = s._replace(bag=0)
    assert with_evict > flops.iteration_flops(no_bag, 1, 64, 32, 64)
    assert with_evict - flops.forward_flops(s, 64 * 26, 50) == (
        flops.forward_flops(s, 64, 50)
        + 64 * (3 * flops.forward_flops(s, 32, 50)
                + flops.backward_flops(s, 32, 50)))


@pytest.mark.parametrize("kind,expected", [("attention_fwd", 0.000489),
                                           ("attention_bwd", 0.000856)])
def test_bound_matches_the_kernel_table(kind, expected):
    ms = flops.bound_ms(kind, 32, 50, 50, 8, 8, True,
                        PEAK["hbm_bytes_per_s"], PEAK["float32"])
    assert round(ms, 6) == expected


def test_applications_count_the_graphed_launches():
    # A graphed flagless iteration launches 386 forwards and 128 backwards.
    apps = flops.attention_applications(shapes("carflag_dtqn.s1"), 1, 64, 32,
                                        64)
    by_kind = {}
    for a in apps:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + a.count
    assert by_kind == {"attention_fwd": 386, "attention_bwd": 128}
    bag = flops.attention_applications(shapes("gv7x7_dtqn_bag25.s5"), 5, 64,
                                       32, 64)
    assert {(a.kind, a.batch, a.lk) for a in bag} >= {
        ("attention_fwd", 5 * 64 * 26, 50), ("attention_fwd", 5 * 64 * 26, 25),
        ("attention_bwd", 5 * 32, 25)}


def test_peaks_by_card_name():
    assert PEAK["float32"] == 67e12
    with pytest.raises(KeyError):
        flops.peaks("cpu")
