#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dtqn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the attention kernels from dtqn_tpu_torch/csrc with nvcc and
     print each instance's registers and spills (-Xptxas -v);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edges of every kernel instance
     (PARITY_CASES; float32, TF32 off; atol 2e-5 forward, 5e-5
     gradients), and check that two backward launches are bit-equal;
  4. drive the main path through the port's entry points at the flagless
     bench.py configuration (DiscreteCarFlag-v0, DTQN in_embed 64, 8 heads,
     2 layers, context 50, batch 32, 64 envs, buffer 500k, target update
     10k): init, random prepopulation, two train iterations of 64 updates;
     check the launch counts, the updates and the Q-values against the
     plain path on the CPU;
  5. time each kernel, its plain version and the matching PyTorch call
     (scaled_dot_product_attention, timed here only) at the main path's
     shapes, inside CUDA graphs so that host launch cost is left out;
  6. profile one more train iteration (torch.profiler): the device's busy
     share, device operations per update and the costliest kernels.

Before the last line it prints the card line and one ``{"kernels": [...]}``
JSON line; the last line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
Q_ATOL = 1e-4
KERNEL_SOURCE = "dtqn_tpu_torch/csrc/attention.cu"
REPLACES = {
    "attention_fwd": "dtqn_tpu/ops/pallas_attention.py:62",
    "attention_bwd": "dtqn_tpu/ops/pallas_attention.py:77",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rand(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


# ------------------------------------------------------------------ parity
# (B, Lq, Lk, heads, causal, E): the main path's act and update shapes;
# unaligned and cross-attention shapes; Lk at the keys-per-lane edges
# (1, 32, 33, 64, 65); B = 1; causal L = 1; head widths 16, 32 and 64; and
# head widths 4 and 12, which the kernels pad and load a float at a time.
# Between them they reach every kernel instance.
PARITY_CASES = [
    (64, 50, 50, 8, True, 64), (32, 50, 50, 8, True, 64),
    (4, 7, 3, 8, False, 64), (4, 1, 50, 8, False, 64),
    (4, 50, 10, 8, False, 64),
    (4, 50, 1, 8, False, 64), (4, 50, 32, 8, False, 64),
    (4, 50, 33, 8, False, 64), (4, 50, 64, 8, False, 64),
    (4, 50, 65, 8, False, 64), (2, 64, 64, 8, True, 64),
    (2, 65, 65, 8, True, 64),
    (1, 50, 50, 8, True, 64), (4, 1, 1, 8, True, 64),
    (2, 20, 20, 4, False, 64), (3, 50, 50, 4, True, 64),
    (2, 100, 100, 2, True, 64), (2, 50, 50, 1, True, 64),
    (2, 7, 65, 1, False, 64),
    (2, 30, 30, 16, True, 64), (2, 40, 40, 4, True, 48),
]


def parity(ca):
    """Each kernel against its plain version on the same card inputs, and
    two backward launches against each other (bit-equal)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"attention_fwd": 0.0, "attention_bwd": 0.0}
    covered = set()
    for b, lq, lk, h, causal, e in PARITY_CASES:
        for kind in errs:
            cfg = ca.launch_config(kind, lq, lk, e // h)
            covered.add((cfg.head_dim_pad, cfg.keys_per_lane))
        q, dout = rand(gen, b, lq, e), rand(gen, b, lq, e)
        k, v = rand(gen, b, lk, e), rand(gen, b, lk, e)
        out = ca.attention_fwd(q, k, v, h, causal)
        ref = ca.plain_attention_fwd(q, k, v, h, causal)
        grads = ca.attention_bwd(q, k, v, dout, h, causal)
        again = ca.attention_bwd(q, k, v, dout, h, causal)
        ref_grads = ca.plain_attention_bwd(q, k, v, dout, h, causal)
        torch.cuda.synchronize()
        e_fwd = (out - ref).abs().max().item()
        e_bwd = max((a - r).abs().max().item()
                    for a, r in zip(grads, ref_grads))
        log(f"parity B={b} Lq={lq} Lk={lk} H={h} D={e // h} "
            f"causal={causal}: fwd {e_fwd:.3e} bwd {e_bwd:.3e}")
        check(e_fwd <= FWD_ATOL, f"attention_fwd disagrees: {e_fwd}")
        check(e_bwd <= GRAD_ATOL, f"attention_bwd disagrees: {e_bwd}")
        check(all(torch.equal(a, r) for a, r in zip(grads, again)),
              "two attention_bwd launches on the same inputs differ")
        errs["attention_fwd"] = max(errs["attention_fwd"], e_fwd)
        errs["attention_bwd"] = max(errs["attention_bwd"], e_bwd)
    check(covered == set(ca.INSTANCES),
          f"parity reaches instances {sorted(covered)}, not all of "
          f"{sorted(ca.INSTANCES)}")
    # The act path and the DDQN selector take the first maximum, as
    # jnp.argmax does.
    ties = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]], device="cuda")
    check(torch.argmax(ties, dim=-1).tolist() == [1, 0],
          "torch.argmax on the card does not take the first maximum")
    return errs


# --------------------------------------------------------------- main path
def main_path(seed, ca):
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import (
        make_prepopulate_fn,
        make_train_chunk_fn,
    )
    from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

    num_envs, updates = 64, 64
    cfg = AgentConfig(
        model="DTQN", num_envs=num_envs, context_len=50, history=50,
        inner_embed=64, num_heads=8, num_layers=2, batch_size=32,
        buffer_size=500_000, target_update_frequency=10_000,
    )
    agent = Agent(cfg, make_env("DiscreteCarFlag-v0"))  # the card
    check(agent.device.type == "cuda", "Agent did not default to cuda")
    prepopulate = make_prepopulate_fn(agent, max(40_000 // num_envs, 1))
    train_iter = make_train_chunk_fn(
        agent, EpsilonSchedule(1.0, 0.1, 200_000),
        updates_per_iter=updates, iters_per_chunk=1,
    )

    ca.reset_launch_counts()
    t0 = time.perf_counter()
    state = agent.init_state(seed)
    prepopulate(state)
    torch.cuda.synchronize()
    t_prepop = time.perf_counter() - t0
    flushed = int(state.buffer.flushed_total)
    check(flushed > cfg.batch_size, f"prepopulation flushed only {flushed}")
    train_iter(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_iter(state)
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    launches = dict(ca.launch_counts)

    train_steps = int(state.train_steps)
    nonfinite = int(state.nonfinite_grads)
    check(train_steps == 2 * updates, f"train_steps {train_steps}")
    check(nonfinite == 0, f"{nonfinite} non-finite gradient steps")
    # Per iteration: one act forward, and per update three forwards
    # (policy and target on next_obs, the loss) and one backward; two
    # layers each.
    layers = cfg.num_layers
    expect_fwd = 2 * layers * (1 + 3 * updates)
    expect_bwd = 2 * layers * updates
    check(launches["attention_fwd"] == expect_fwd,
          f"attention_fwd launched {launches['attention_fwd']} times, "
          f"expected {expect_fwd}")
    check(launches["attention_bwd"] == expect_bwd,
          f"attention_bwd launched {launches['attention_bwd']} times, "
          f"expected {expect_bwd}")
    diags = {k: float(v) for k, v in state.diagnostics.means().items()}
    check(all(map(math.isfinite, diags.values())),
          f"diagnostics not finite: {diags}")

    # What comes out is right: the trained policy's Q on the run's own
    # contexts, kernel path on the card vs plain path on the CPU.
    cpu_net = agent.build_network()
    cpu_net.load_state_dict(state.network.state_dict())
    with torch.no_grad():
        q_gpu = state.network(state.context.obs, state.context.action)
        q_cpu = cpu_net(state.context.obs.cpu(), state.context.action.cpu())
    check(tuple(q_gpu.shape) == (num_envs, 50, 3), f"Q shape {q_gpu.shape}")
    check(bool(torch.isfinite(q_gpu).all()), "non-finite Q on the card")
    q_err = (q_gpu.cpu() - q_cpu).abs().max().item()
    check(q_err <= Q_ATOL, f"card Q differs from CPU Q by {q_err}")

    result = {
        "env_steps_per_s": num_envs / t_iter,
        "updates_per_s": updates / t_iter,
        "timed_iteration_s": t_iter,
        "init_and_prepopulate_s": t_prepop,
        "flushed_episodes": flushed,
        "train_steps": train_steps,
        "nonfinite_grads": nonfinite,
        "launches": launches,
        "q_max_abs_err_vs_cpu": q_err,
        "diagnostics": diags,
    }
    log(f"main path: {json.dumps(result)}")
    return result, state, train_iter


def profile_iteration(state, train_iter, updates=64, top=12):
    """Where one train iteration's time goes (torch.profiler): the device's
    busy share of the wall time, kernel launches, and the kernels with the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_iter(state)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        n, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, us + ev.self_device_time_total)
    device_us = sum(us for _, us in by_name.values())
    launches = sum(n for n, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    attention = {}
    for kind in ("attention_fwd", "attention_bwd"):
        hits = [nu for name, nu in by_name.items() if f"{kind}_kernel" in name]
        attention[kind] = {"count": sum(n for n, _ in hits),
                           "device_us": sum(us for _, us in hits)}
    result = {
        "profiled_wall_us": wall_us,
        "device_busy_us": device_us,
        "device_busy_share": device_us / wall_us,
        "device_ops_per_update": launches / updates,
        "attention_kernels": attention,
        "top_kernels": [
            {"name": name[:80], "count": n, "device_us": us}
            for name, (n, us) in ranked
        ],
    }
    log(f"profile of one train iteration: {json.dumps(result)}")
    return result


# ------------------------------------------------------------------ timing
def graph_ms(fn, calls=100, replays=20):
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA
    graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(kind, b, length, heads, d):
    """Least time on an H100 SXM: each input read once and each output
    written once over HBM, or the causal triangle's multiply-adds over the
    float32 rate, whichever is larger."""
    e = heads * d
    tri = length * (length + 1) // 2
    if kind == "attention_fwd":
        nbytes, products = 4 * (4 * b * length * e), 2
    else:
        nbytes, products = 4 * (7 * b * length * e), 5
    flops = products * 2 * b * heads * d * tri
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timings(ca, b, length=50, heads=8, d=8):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    e = heads * d
    q, k, v, dout = (rand(gen, b, length, e) for _ in range(4))

    def heads_view(x):
        return x.view(b, length, heads, d).transpose(1, 2)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            heads_view(q), heads_view(k), heads_view(v), is_causal=True
        )

    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    do_h = heads_view(dout)

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg)
        torch.autograd.grad(out, (qg, kg, vg), do_h)

    fwd = {
        "ms": graph_ms(lambda: ca.attention_fwd(q, k, v, heads, True)),
        "plain_ms": graph_ms(
            lambda: ca.plain_attention_fwd(q, k, v, heads, True)),
        "library_ms": graph_ms(lambda: sdpa(q, k, v)),
    }
    # SDPA's backward alone is no single call: time forward + backward and
    # take the forward's time off.
    lib_both = graph_ms(sdpa_fwd_bwd)
    bwd = {
        "ms": graph_ms(lambda: ca.attention_bwd(q, k, v, dout, heads, True)),
        "plain_ms": graph_ms(
            lambda: ca.plain_attention_bwd(q, k, v, dout, heads, True)),
        "library_ms": max(lib_both - fwd["library_ms"], 0.0),
    }
    out = {}
    for name, t in (("attention_fwd", fwd), ("attention_bwd", bwd)):
        bound, by = bound_ms(name, b, length, heads, d)
        out[name] = dict(t, bound_ms=bound, bound_by=by)
    log(f"timings B={b} L={length} H={heads} D={d} causal: "
        f"{json.dumps(out)}")
    return out


def run(seed):
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from dtqn_tpu_torch.ops import cuda_attention as ca
    except ImportError as e:
        raise SmokeFailure(f"the dtqn_tpu_torch package is missing: {e}")

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    ca.build(verbose=True)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    usage = ca.ptxas_usage()
    for u in usage:
        log(f"ptxas: {json.dumps(u)}")
    check(len(usage) == 2 * len(ca.INSTANCES),
          f"ptxas reported {len(usage)} kernels")
    errs = parity(ca)
    main, state, train_iter = main_path(seed, ca)
    t_main = timings(ca, 32)  # each update's batch
    t_act = timings(ca, 64)  # the act forward's batch

    kernels = []
    for name in ("attention_fwd", "attention_bwd"):
        t = t_main[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES[name],
            "launches": main["launches"][name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": "B=32 L=50 H=8 D=8 causal f32",
        })
    prof = profile_iteration(state, train_iter)
    print(json.dumps({"main_path": main, "timings_b64": t_act,
                      "profile": prof, "ptxas": usage}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    try:
        run(args.seed)
    except SmokeFailure as e:
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
