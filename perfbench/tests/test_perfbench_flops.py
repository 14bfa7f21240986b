"""Work counted from shapes, through each configuration's own work module,
against hand counts at both configurations' widths, and the attention
bound against the kernel table's bound_ms and a hand count where the
query-key and value widths differ."""

import pytest

from perfbench import flops
from perfbench.reference.envs import make_env
from perfbench.registry import Benchmark

PEAK = flops.peaks("NVIDIA H100 80GB HBM3")


def counts(name):
    """(the configuration's work module, its config, its reference env)."""
    cell = Benchmark().cell(name)
    return cell.family.work, cell.config, make_env(cell.config["env"])


def shapes(name):
    work, cfg, env = counts(name)
    return work.shapes(cfg, env)


def dtqn():
    return counts("carflag_dtqn.s1")[0]


def test_forward_flops_one_token_carflag():
    # Embedding 2*3*64; per layer QKV 2*64*192, out 2*64*64, MLP
    # 2*2*64*256, attention 4*1*64; head 2*64*64 + 2*64*3.
    per_layer = 24576 + 8192 + 65536 + 256
    assert dtqn().forward_flops(shapes("carflag_dtqn.s1"), 1, 1) == \
        384 + 2 * per_layer + 8192 + 384


def test_forward_flops_one_token_gridverse_bag():
    s = shapes("gv7x7_dtqn_bag25.s1")
    embed = 2 * 48 * 128
    per_layer = 98304 + 32768 + 262144 + 512
    bag = 25 * embed + 2 * 32768 + 25 * 2 * 32768 + 4 * 25 * 128
    head = 2 * 256 * 128 + 2 * 128 * 6
    assert dtqn().forward_flops(s, 1, 1) == embed + 2 * per_layer + bag + head


def test_causal_attention_counts_unmasked_pairs():
    s, work = shapes("carflag_dtqn.s1"), dtqn()
    # Two layers, each 4 * pairs * features more per window of 50 steps.
    no_attention = 50 * (work.forward_flops(s, 1, 1)
                         - 2 * 4 * 64)
    assert work.forward_flops(s, 1, 50) == no_attention + 2 * 4 * 1275 * 64


def test_iteration_flops_carflag():
    work, cfg, env = counts("carflag_dtqn.s1")
    s = work.shapes(cfg, env)
    fwd = work.forward_flops(s, 32, 50)
    update = 3 * fwd + 2 * fwd - 32 * 50 * 384
    it = work.iteration_flops(cfg, env, 1, 64, 32, 64)
    assert it == work.forward_flops(s, 64, 50) + 64 * update
    # About 1.7 GFLOP an env step (64 env steps an iteration).
    assert 1.6e9 < it / 64 < 1.9e9
    assert work.iteration_flops(cfg, env, 5, 64, 32, 64) == 5 * it


def test_iteration_flops_bag_has_the_evict_forward():
    work, cfg, env = counts("gv7x7_dtqn_bag25.s1")
    s = work.shapes(cfg, env)
    with_evict = work.iteration_flops(cfg, env, 1, 64, 32, 64)
    no_bag = dict(cfg, bag_size=0)
    assert with_evict > work.iteration_flops(no_bag, env, 1, 64, 32, 64)
    assert with_evict - work.forward_flops(s, 64 * 26, 50) == (
        work.forward_flops(s, 64, 50)
        + 64 * (3 * work.forward_flops(s, 32, 50)
                + work.backward_flops(s, 32, 50)))


@pytest.mark.parametrize("kind,expected", [("attention_fwd", 0.000489),
                                           ("attention_bwd", 0.000856)])
def test_bound_matches_the_kernel_table(kind, expected):
    a = flops.Application(kind, 32, 50, 50, True, 1, heads=8, dk=8, dv=8)
    ms = flops.bound_ms(a, PEAK["hbm_bytes_per_s"], PEAK["float32"])
    assert round(ms, 6) == expected


@pytest.mark.parametrize("kind", ["attention_fwd", "attention_bwd"])
def test_bound_prices_query_key_and_value_widths_apart(kind):
    # 16 heads, query-key width 192, value width 128 (a latent attention's
    # head), B=4, causal L=64: 2080 unmasked pairs, float32.
    a = flops.Application(kind, 4, 64, 64, True, 1, heads=16, dk=192,
                          dv=128)
    if kind == "attention_fwd":
        # q, k: 64 x 192 each; v, out: 64 x 128 each; Q K^T and P V.
        nbytes = 4 * 4 * 16 * (64 * 192 * 2 + 64 * 128 * 2)
        products = 192 + 128
    else:
        # q, k, dq, dk: 64 x 192 each; v, dout, dv: 64 x 128 each; Q K^T,
        # dS K, dS^T Q at 192, dO V^T, P^T dO at 128.
        nbytes = 4 * 4 * 16 * (64 * 192 * 4 + 64 * 128 * 3)
        products = 3 * 192 + 2 * 128
    flop = 2 * 4 * 16 * 2080 * products
    inf = float("inf")
    assert flops.bound_ms(a, 3.35e12, inf) == 1e3 * (nbytes / 3.35e12)
    assert flops.bound_ms(a, inf, 67e12) == 1e3 * (flop / 67e12)
    assert flops.bound_ms(a, 3.35e12, 67e12) == 1e3 * max(
        nbytes / 3.35e12, flop / 67e12)


def test_applications_count_the_graphed_launches():
    # A graphed flagless iteration launches 386 forwards and 128 backwards.
    work, cfg, env = counts("carflag_dtqn.s1")
    apps = work.attention_applications(cfg, env, 1, 64, 32, 64)
    by_kind = {}
    for a in apps:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + a.count
    assert by_kind == {"attention_fwd": 386, "attention_bwd": 128}
    # Every head of DTQN's one width, inner_embed / num_heads.
    assert {(a.heads, a.dk, a.dv) for a in apps} == {(8, 8, 8)}
    work, cfg, env = counts("gv7x7_dtqn_bag25.s5")
    bag = work.attention_applications(cfg, env, 5, 64, 32, 64)
    assert {(a.kind, a.batch, a.lk) for a in bag} >= {
        ("attention_fwd", 5 * 64 * 26, 50), ("attention_fwd", 5 * 64 * 26, 25),
        ("attention_bwd", 5 * 32, 25)}
    assert {(a.heads, a.dk, a.dv) for a in bag} == {(8, 16, 16)}


def test_peaks_by_card_name():
    assert PEAK["float32"] == 67e12
    with pytest.raises(KeyError):
        flops.peaks("cpu")
