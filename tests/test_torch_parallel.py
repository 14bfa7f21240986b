"""The port's several-device path (``dtqn_tpu_torch/parallel``) on the CPU.

Two gloo ranks, started once for the module, train sharded runs through
``run_experiment``; each is held against the one-device run of the same
configuration to the tolerances of the JAX package's own test
(``tests/test_sharding.py``): parameters and targets within rtol 2e-4 /
atol 2e-5, diagnostics within rtol 1e-3 / atol 1e-4, counters, generator
and replay contents exact.  In one process: a mesh of one rank is the
one-device path bit for bit, ``shard_state`` and its inverse, the field
classification (against the JAX package's), the "must divide" guard and
the sweep's refusal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxAgentConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.parallel import mesh as jax_mesh
from dtqn_tpu.train.loop import make_prepopulate as jax_prepopulate
from dtqn_tpu.train.loop import make_train_chunk as jax_train_chunk
from dtqn_tpu.utils.epsilon import EpsilonSchedule as JaxEpsilonSchedule
from dtqn_tpu_torch import run
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.config import ExperimentConfig
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.parallel import (
    make_distributed_train_chunk,
    make_mesh,
    process_info,
    shard_state,
    state_shardings,
)
from dtqn_tpu_torch.parallel.distributed import init_distributed, spawn
from dtqn_tpu_torch.parallel.mesh import REPLICATED, SHARDED, join_shards
from dtqn_tpu_torch.train.loop import make_prepopulate_fn, make_train_chunk_fn
from dtqn_tpu_torch.train.runner import run_experiment, run_ranks
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.checkpoint import _leaves
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
DIAG_TOL = dict(rtol=1e-3, atol=1e-4)
# tests/test_sharding.py's setup: 16 envs, context 8, in_embed 16, 2 heads,
# 1 layer, batch 8, a 20-step cap, target update every 10, one update per
# iteration, 30 prepopulation iterations.
SMALL = dict(envs=["DiscreteCarFlag-v0"], in_embed=16, heads=2, layers=1,
             context=8, history=8, num_envs=16, batch=8, buf_size=640,
             tuf=10, prepop_steps=480, max_episode_steps=20,
             updates_per_iter=1, eval_episodes=1, device="cpu")
ITERS = 30
FEW = 12  # a few iterations: past the first target swap
# The cases held against one-device runs: 30 iterations as the JAX test's,
# also with a batch that 2 ranks do not divide; a few of DTQN-bag on stored
# act-time bags and on random ones, of DRQN, whose carry is sharded, and of
# dropout, whose masks are drawn over the global batch.
CASES = {
    "dtqn": dict(),
    "batch7": dict(batch=7),
    "bag-store": dict(model="DTQN-bag", bag_size=4, bag_store=True,
                      iters_per_chunk=FEW),
    "bag-store-1": dict(model="DTQN-bag", bag_size=4, bag_store=True,
                        iters_per_chunk=1),
    "bag": dict(model="DTQN-bag", bag_size=4, iters_per_chunk=FEW),
    "drqn": dict(model="DRQN", iters_per_chunk=FEW),
    "dropout": dict(dropout=0.1, iters_per_chunk=FEW),
}
# Fields that the bag's Q-driven eviction picks: its candidates' scores tie
# or nearly tie (most often exactly, PERF.md), so once the ranks' summed
# gradient differs from the one-device sum in a last bit, an eviction can
# fall the other way.  The first iteration (before any update) holds them
# exactly ("bag-store-1").
EVICTION_PICKS = ("buffer.bag_idx", "buffer.bag_act", "bag.obs", "bag.action",
                  "bag.obs_idx")
# Float state computed by the network or the optimizer: within tolerance.
# (DRQN's act-time carry is the LSTM's output at the replicated weights.)
LEARNED = ("params", "target_params", "opt_state.mu", "opt_state.nu",
           "diagnostics.averages.buf", "carry.c", "carry.h")


def config(project, **kw):
    return ExperimentConfig(**dict(SMALL, project_name=project, **kw))


def cut_config(name, ranks):
    """The case's run cut by the time limit after one chunk (``ITERS``
    iterations unless the case says otherwise): its full checkpoint holds
    the state, in the one-device layout."""
    kw = dict(dict(iters_per_chunk=ITERS), **CASES[name])
    iters = kw["iters_per_chunk"]
    return config(f"{name}-{ranks}", dp_devices=ranks, time_limit=1e-9,
                  num_steps=2 * iters * SMALL["num_envs"], **kw)


RUNNER = dict(eval_frequency=32, num_steps=64, save_policy=True)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every run over 2 gloo ranks, in one spawn: the cases cut after their
    chunk; the runner whole, cut and resumed; a cut run that a one-device
    run resumes.  Rank 0's final logs, by name, and the directory."""
    root = tmp_path_factory.mktemp("dp")
    runs = {name: cut_config(name, 2) for name in CASES}
    runs.update({
        "whole": config("whole", dp_devices=2, **RUNNER),
        "cut": config("cut", dp_devices=2, time_limit=1e-9, **RUNNER),
        "resumed": config("cut", dp_devices=2, **RUNNER),
        "handoff": config("handoff", dp_devices=2, time_limit=1e-9,
                          **RUNNER),
    })
    cwd, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(root)
    torch.set_num_threads(2)  # the ranks take one intra-op thread each
    try:
        finals = spawn(run_ranks, 2, (list(runs.values()),), device="cpu")[0]
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)
    return root, dict(zip(runs, finals))


def saved(cfg):
    return torch.load(cfg.policy_path() + "_checkpoint.pt",
                      weights_only=True)


@pytest.mark.parametrize("name", CASES)
def test_sharded_run_matches_one_device(name, dp_runs, monkeypatch):
    root, finals = dp_runs
    monkeypatch.chdir(root)
    one = run_experiment(cut_config(name, 1))
    a, b = saved(cut_config(name, 1)), saved(cut_config(name, 2))
    assert a.keys() == b.keys()
    for key in a:
        if key in LEARNED:
            np.testing.assert_allclose(
                b[key].numpy(), a[key].numpy(),
                **(DIAG_TOL if key.startswith("diag") else PARAM_TOL),
                err_msg=key)
        elif key == "generator_device":
            assert a[key] == b[key] == "cpu"
        elif key not in EVICTION_PICKS or name == "bag-store-1":
            assert torch.equal(a[key], b[key]), key
    assert int(a["train_steps"]) >= (SMALL["tuf"] if name != "bag-store-1"
                                     else 0)
    assert int(a["nonfinite_grads"]) == 0
    for key, value in one.items():
        if key.startswith("losses/") and key != "losses/hours":
            np.testing.assert_allclose(finals[name][key], value,
                                       **DIAG_TOL, err_msg=key)


def test_runner_over_two_ranks_cut_resumed_and_handed_off(dp_runs,
                                                          monkeypatch):
    """The 2-rank runner whole, and cut by the time limit then resumed:
    the final parameters are bit-equal (a sum over 2 ranks does not depend
    on its order).  A one-device run resumes a 2-rank run's checkpoint."""
    root, finals = dp_runs
    monkeypatch.chdir(root)
    whole = config("whole", **RUNNER)
    resumed = config("cut", **RUNNER)
    a = torch.load(whole.policy_path() + "_policy.pt", weights_only=True)
    b = torch.load(resumed.policy_path() + "_policy.pt", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for cfg in (whole, resumed):
        assert ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == 64
        with open(cfg.policy_path() + "_losses.csv") as f:
            assert len(f.read().splitlines()) == 3  # header and two rows
    assert finals["resumed"]["losses/Grad_Norm"] > 0.0
    handoff = config("handoff", **RUNNER)
    assert ckpt.load_mini_checkpoint(handoff.policy_path())["step"] == 32
    out = run_experiment(handoff)
    assert np.isfinite(out["losses/TD_Error"])
    assert ckpt.load_mini_checkpoint(handoff.policy_path())["step"] == 64


def small_agent(model="DTQN", num_envs=16, **kw):
    env = make_env("DiscreteCarFlag-v0")
    env.max_episode_steps = 20
    cfg = AgentConfig(model=model, num_envs=num_envs, context_len=8,
                      history=8, inner_embed=16, num_heads=2, num_layers=1,
                      buffer_size=40 * num_envs, batch_size=8,
                      target_update_frequency=10, **kw)
    return Agent(cfg, env, device="cpu")


MODELS = {
    "DTQN": dict(),
    "DTQN-bag": dict(model="DTQN-bag", bag_size=4, bag_store=True),
    "DRQN": dict(model="DRQN"),
    "DQN": dict(model="DQN"),
}


def tensors(state):
    return {k: v for k, v in _leaves(state) if isinstance(v, torch.Tensor)}


def test_mesh_of_one_is_the_one_device_path():
    """A mesh of one rank issues no collective and changes no bit."""
    runs = []
    for mesh in (None, make_mesh(1, device="cpu")):
        agent = small_agent(dropout=0.1)
        state = agent.init_state(3)
        make_prepopulate_fn(agent, 30)(state)
        eps = EpsilonSchedule(1.0, 0.1, 100)
        if mesh is None:
            make_train_chunk_fn(agent, eps, 1, 12)(state)
        else:
            state = shard_state(agent, state, mesh)
            make_distributed_train_chunk(agent, eps, 1, 12, mesh, state)(
                state)
            assert sum(mesh.counts.values()) == 0
        runs.append((tensors(state), state.generator.get_state()))
    (a, ga), (b, gb) = runs
    assert torch.equal(ga, gb) and a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_shard_state_then_join_is_the_identity(model, ranks):
    agent = small_agent(**MODELS[model])
    state = agent.init_state(0)
    make_prepopulate_fn(agent, 30)(state)
    shards = [shard_state(agent, state,
                          make_mesh(ranks, rank=r, device="cpu"))
              for r in range(ranks)]
    assert all(s.obs.shape[0] == 16 // ranks for s in shards)
    assert all(s.buffer.obs.shape[0] * ranks == state.buffer.obs.shape[0]
               for s in shards)
    assert shards[1].params is state.params  # replicated: shared
    a, b = tensors(state), tensors(join_shards(shards))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def placements(state, specs, prefix=""):
    """{dotted field: placement} for every tensor, network and generator
    of ``state``."""
    out = {}
    for f in dataclasses.fields(state):
        value, spec = getattr(state, f.name), getattr(specs, f.name)
        name = prefix + f.name
        if dataclasses.is_dataclass(value) or isinstance(value, tuple):
            fields = (value._asdict().items() if isinstance(value, tuple)
                      else [(g.name, getattr(value, g.name))
                            for g in dataclasses.fields(value)])
            for sub, leaf in fields:
                sub_spec = getattr(spec, sub)
                if dataclasses.is_dataclass(leaf):
                    out.update(placements(leaf, sub_spec, f"{name}.{sub}."))
                elif leaf is not None:
                    out[f"{name}.{sub}"] = sub_spec
        elif value is not None:
            out[name] = spec
    return out


@pytest.mark.parametrize("model", MODELS)
def test_every_field_is_classified(model):
    agent = small_agent(**MODELS[model])
    state = agent.init_state(0)
    found = placements(state, state_shardings(agent, state))
    assert set(found.values()) <= {SHARDED, REPLICATED}
    names = {name for name, _ in _leaves(state)}
    assert names <= set(found)  # every checkpointed tensor is classified
    sharded = {k for k, v in found.items() if v == SHARDED}
    assert {"obs", "buffer.obs", "buffer.ep_len", "context.obs",
            "env_state.position"} <= sharded
    assert not sharded & {"params", "target_params", "buffer.flushed_total",
                          "generator", "env_steps", "train_steps"}
    assert ("carry.c" in sharded) == (model == "DRQN")
    assert ("buffer.bag_idx" in sharded) == (model == "DTQN-bag")


def test_mesh_divisibility_guard():
    """6 envs over 4 ranks: refused before any collective (this mesh has no
    process group, so one would fail otherwise)."""
    agent = small_agent(num_envs=6)
    mesh = make_mesh(4, device="cpu")
    state = agent.init_state(0)
    with pytest.raises(ValueError, match="must divide"):
        make_distributed_train_chunk(
            agent, EpsilonSchedule(1.0, 0.1, 100), 1, 2, mesh, state)
    with pytest.raises(ValueError, match="must divide"):
        shard_state(agent, state, mesh)


def test_one_process_needs_no_group():
    assert init_distributed() is None and init_distributed(None, 1, 0) is None
    assert process_info() == {"process_index": 0, "process_count": 1,
                              "local_devices": 1, "global_devices": 1,
                              "backend": None}


def test_the_sweep_refuses_dp_devices(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="--dp-devices"):
        run.main(["--device", "cpu", "--seeds", "1", "2", "--dp-devices", "2"])
    assert not os.listdir(tmp_path)


# ------------------------------------------------- the JAX package's mesh
def jax_setup():
    env = jax_make_env("DiscreteCarFlag-v0")
    env.max_episode_steps = 20
    cfg = JaxAgentConfig(
        model="DTQN", num_envs=16, context_len=8, history=8, inner_embed=16,
        num_heads=2, num_layers=1, buffer_size=40 * 16, batch_size=8,
        target_update_frequency=10,
    )
    return JaxAgent(cfg, env)


def test_jax_reference_sharded_chunk_and_classification():
    """The JAX package's sharded chunk on 8 fake CPU devices against its
    unsharded one, as the port's test above holds the port's; and its
    classification of the fields, which the port's must equal."""
    if len(jax.devices()) < 8:
        pytest.fail("the test harness gives JAX 8 CPU devices")
    agent = jax_setup()
    eps = JaxEpsilonSchedule(1.0, 0.1, 100)
    base = jax_prepopulate(agent, iters=30)(agent.init_state(
        jax.random.key(0)))
    copy = lambda s: jax.tree_util.tree_map(jnp.copy, s)  # noqa: E731
    single = jax_train_chunk(agent, eps, 1, ITERS)(copy(base))
    mesh = jax_mesh.make_mesh(8)
    state = jax_mesh.shard_state(agent, copy(base), mesh)
    sharded = jax_mesh.make_distributed_train_chunk(
        agent, eps, 1, ITERS, mesh, state)(state)
    for a, b in zip(jax.tree_util.tree_leaves(single.params),
                    jax.tree_util.tree_leaves(sharded.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **PARAM_TOL)
    np.testing.assert_array_equal(np.asarray(single.buffer.ep_len),
                                  np.asarray(sharded.buffer.ep_len))

    specs = jax_mesh.state_shardings(agent, base, mesh)

    def jax_placement(tree):
        kinds = {"dp" in str(s.spec) for s in jax.tree_util.tree_leaves(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))}
        assert len(kinds) == 1
        return SHARDED if kinds.pop() else REPLICATED

    port_agent = small_agent()
    port_state = port_agent.init_state(0)
    port = placements(port_state, state_shardings(port_agent, port_state))
    renamed = {"generator": "key"}
    for name, place in port.items():
        if name in ("network", "target_network"):
            continue  # views of params / target_params
        top, _, sub = renamed.get(name, name).partition(".")
        tree = getattr(specs, top)
        if sub and top == "buffer":
            tree = getattr(tree, sub)  # the buffer is classified by field
        assert jax_placement(tree) == place, name
