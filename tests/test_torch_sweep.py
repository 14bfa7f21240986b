"""The port's multi-seed sweep (``train/sweep.py``, ``models/stacked.py``)
on the CPU, at narrow widths.

- the JAX package's sweep tests (``tests/test_sweep.py``), ported: a
  two-seed run end to end, a time-limit checkpoint then resume (here also
  bit-equal to an uninterrupted sweep), CLI dispatch;
- each seed of a sweep starts from the weights ``init_state`` draws, and
  follows the single-seed run with its seed (same updates, parameters
  within atol 1e-5, same evaluations and CSV rows);
- one stacked update against ``jax.vmap(jagent.apply_update)`` on bridged
  weights and the same batches (rtol 1e-4, atol 1e-7, as the single-seed
  test), and against per-seed updates for every model and dropout;
- the ``vmap`` rules of the attention function and the embedding lookup
  against per-seed calls: one call at the folded batch, equal results;
- the operation budget: a 4-seed update dispatches at most twice the
  operations of a 1-seed update, and the same attention calls.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dtqn_tpu import replay as jax_replay
from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu_torch import replay, run
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.bridge import (
    params_from_jax,
    stacked_params_from_jax,
    stacked_params_to_jax,
)
from dtqn_tpu_torch.config import ExperimentConfig, get_args
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models.embeddings import lookup
from dtqn_tpu_torch.ops import cuda_attention as ca
from dtqn_tpu_torch.train import sweep
from dtqn_tpu_torch.train.loop import (
    make_evaluate_fn,
    make_prepopulate_fn,
    make_train_chunk_fn,
)
from dtqn_tpu_torch.train.runner import run_experiment
from dtqn_tpu_torch.train.sweep import run_sweep, sweep_path
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

ENV = "DiscreteCarFlag-v0"


def small_cfg(**kw):
    """``tests/test_sweep.py``'s configuration, on the CPU, on a shorter
    schedule: chunks of 2 iterations (16 env steps), 3 of them."""
    cfg = ExperimentConfig(
        envs=[ENV], num_steps=48, num_envs=8, in_embed=16, heads=2,
        layers=1, context=8, history=8, batch=4, buf_size=2000,
        eval_frequency=16, eval_episodes=2, prepop_steps=200,
        updates_per_iter=1, max_episode_steps=20, project_name="sweep-test",
        save_policy=True, device="cpu",
    )
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(autouse=True)
def one_thread():
    """These sizes gain nothing from intra-op threads; one keeps the tests
    from competing for the cores with the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# ------------------------------------------------ the JAX package's tests
def test_two_seed_sweep_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = small_cfg(verbose=True)
    out = run_sweep(cfg, [1, 2])
    assert set(out) == {1, 2}
    for s in (1, 2):
        assert f"{ENV}/SuccessRate" in out[s]
        assert np.isfinite(out[s]["losses/TD_Error"])
    assert "SuccessRate per seed: 1:" in capsys.readouterr().out

    # Per-seed artifacts at the paths single-seed runs use; each policy is
    # its seed's slice, loadable by a single network.
    agent = Agent(cfg.agent_config(), make_env(ENV), device="cpu")
    chunk = cfg.resolved_iters_per_chunk * cfg.num_envs
    steps = [str(chunk * i) for i in (1, 2, 3)]
    for s in (1, 2):
        p = dataclasses.replace(cfg, seed=s).policy_path()
        for suffix in ("_results.csv", "_losses.csv"):
            assert [r[1] for r in read_csv(p + suffix)[1:]] == steps
        net = ckpt.load_policy(p, agent.build_network())
        assert net.head_out.weight.shape == (3, 16)
    # Seeds evolve independently: diagnostics differ.
    assert out[1]["losses/Mean_Q_Value"] != out[2]["losses/Mean_Q_Value"]
    mini = ckpt.load_mini_checkpoint(sweep_path(cfg, [1, 2]))
    assert mini == {"step": 3 * chunk, "wandb_id": None}
    # The completion sentinel short-circuits a rerun.
    assert run_sweep(cfg, [1, 2]) == {"completed": True, "step": 3 * chunk}


def test_time_limit_checkpoint_then_resume_is_bit_equal(tmp_path,
                                                        monkeypatch, capsys):
    (tmp_path / "whole").mkdir()
    (tmp_path / "cut").mkdir()
    monkeypatch.chdir(tmp_path / "whole")
    cfg = small_cfg()
    run_sweep(cfg, [3, 4])
    whole = [torch.load(dataclasses.replace(cfg, seed=s).policy_path()
                        + "_policy.pt", weights_only=True) for s in (3, 4)]

    monkeypatch.chdir(tmp_path / "cut")
    run_sweep(small_cfg(time_limit=1e-9), [3, 4])
    ck = sweep_path(cfg, [3, 4])
    cut_at = cfg.resolved_iters_per_chunk * cfg.num_envs  # one chunk
    assert ckpt.has_checkpoint(ck)
    assert ckpt.load_mini_checkpoint(ck)["step"] == cut_at < cfg.num_steps
    assert "Reached time limit" in capsys.readouterr().out
    out = run_sweep(cfg, [3, 4])
    assert f"Resumed sweep at {cut_at} steps." in capsys.readouterr().out
    assert ckpt.load_mini_checkpoint(ck)["step"] == cfg.num_steps
    assert f"{ENV}/SuccessRate" in out[3]
    for s, ref in zip((3, 4), whole):
        got = torch.load(dataclasses.replace(cfg, seed=s).policy_path()
                         + "_policy.pt", weights_only=True)
        assert all(torch.equal(got[k], ref[k]) for k in ref), s


def test_nonfinite_gradients_fail_loudly_per_seed(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    learn = Agent.learn

    def poisoned(self, state):
        learn(self, state)
        state.nonfinite_grads[1] += 1
        return state

    monkeypatch.setattr(Agent, "learn", poisoned)
    with pytest.raises(FloatingPointError, match=r"\{1: 0, 2: \d+\}"):
        run_sweep(small_cfg(num_steps=8, eval_frequency=8), [1, 2])


@pytest.mark.parametrize("kw,item", [
    (dict(dp_devices=2), "item 14"), (dict(profile_dir="prof"), "item 14"),
    (dict(bf16=True), "item 13")])
def test_sweep_refuses_flags_not_ported(kw, item, tmp_path, monkeypatch):
    """Each flag with its ROADMAP item, under the ids of their refusals:
    ``--dp-devices`` (14.3) trains one seed's run over several ranks, and a
    sweep refuses it, as it runs on one device (the JAX sweep ignores the
    flag); ``--profile-dir`` (14.2) and ``--bf16`` (13) run a 2-seed sweep:
    the second of its two chunks traced, or the seeds in bf16."""
    monkeypatch.chdir(tmp_path)
    if "dp_devices" in kw:
        with pytest.raises(ValueError, match="--dp-devices.*one device"):
            run_sweep(small_cfg(**kw), [1, 2])
        assert not os.listdir(tmp_path)  # refused before anything is written
        return
    cfg = small_cfg(num_steps=32, **kw)
    states, init = [], Agent.init_sweep_state
    monkeypatch.setattr(Agent, "init_sweep_state",
                        lambda self, seeds: states.append(
                            init(self, seeds)) or states[-1])
    out = run_sweep(cfg, [1, 2])
    assert all(np.isfinite(out[s]["losses/TD_Error"]) for s in (1, 2))
    assert out[1]["losses/Mean_Q_Value"] != out[2]["losses/Mean_Q_Value"]
    assert len(os.listdir("prof") if cfg.profile_dir else []) == int(
        bool(cfg.profile_dir))
    (state,) = states
    assert state.params.dtype == state.opt_state.nu.dtype == torch.float32
    assert state.network.module.head_out.compute_dtype == (
        torch.bfloat16 if cfg.bf16 else None)


def test_cli_dispatch(monkeypatch):
    assert get_args(["--seeds", "1", "2", "3"]).seeds == [1, 2, 3]
    calls = []
    monkeypatch.setattr(sweep, "run_sweep",
                        lambda cfg, seeds: calls.append(seeds) or "swept")
    assert run.main(["--device", "cpu", "--seeds", "1", "2", "3"]) == "swept"
    assert calls == [[1, 2, 3]]


# ---------------------------------------------- a sweep's seed = its run
def test_initial_weights_and_generators_are_the_single_runs():
    agent = Agent(small_cfg().agent_config(), make_env(ENV), device="cpu")
    state = agent.init_sweep_state([5, 9])
    assert state.params.shape[0] == 2 and state.seed_shape == (2,)
    for i, seed in enumerate((5, 9)):
        one = agent.init_state(seed)
        assert torch.equal(state.params[i], one.params)
        assert torch.equal(state.target_params[i], one.target_params)
        weights = state.network.seed_state_dict(i)
        assert all(torch.equal(weights[k], v)
                   for k, v in one.network.state_dict().items())
        assert torch.equal(state.generator[i].get_state(),
                           one.generator.get_state())
        assert torch.equal(state.context.action.chunk(2)[i],
                           one.context.action)


def test_seed_follows_its_single_run(tmp_path, monkeypatch):
    """Prepopulation and 2 train iterations (one chunk each), then an
    evaluation: seed i of a 2-seed sweep against ``run_experiment`` with
    seed i."""
    cfg = small_cfg(num_steps=16, eval_frequency=8)
    (tmp_path / "sweep").mkdir()
    monkeypatch.chdir(tmp_path / "sweep")
    run_sweep(cfg, [1, 2])
    for s in (1, 2):
        (tmp_path / str(s)).mkdir()
        monkeypatch.chdir(tmp_path / str(s))
        one = dataclasses.replace(cfg, seed=s)
        run_experiment(one)
        for suffix in ("_results.csv", "_losses.csv"):
            mine = read_csv(one.policy_path() + suffix)
            swept = read_csv(str(tmp_path / "sweep" / os.path.relpath(
                one.policy_path(), tmp_path / str(s))) + suffix)
            assert mine[0] == swept[0] and len(mine) == len(swept) == 3
            for a, b in zip(mine[1:], swept[1:]):
                assert a[1] == b[1]  # the step; a[0] is the wall time
                np.testing.assert_allclose(
                    np.array(b[2:], float), np.array(a[2:], float),
                    rtol=1e-5, atol=1e-7)
        policy = torch.load(one.policy_path() + "_policy.pt",
                            weights_only=True)
        swept_policy = torch.load(str(tmp_path / "sweep" / os.path.relpath(
            one.policy_path(), tmp_path / str(s))) + "_policy.pt",
            weights_only=True)
        for k, v in policy.items():
            np.testing.assert_allclose(swept_policy[k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)


def capped_env(name, steps):
    env = make_env(name)
    env.max_episode_steps = steps
    return env


def test_agent_level_seed_matches_single_state():
    cfg = small_cfg().agent_config()
    agent = Agent(cfg, capped_env(ENV, 20), device="cpu")
    chunk = make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 1000), 8, 2)

    def run_state(state):
        make_prepopulate_fn(agent, 30)(state)
        return chunk(state)

    stacked = run_state(agent.init_sweep_state([1, 2]))
    assert stacked.train_steps.tolist() == [16, 16]
    evaluate = make_evaluate_fn(agent, capped_env(ENV, 20), 3)
    got = evaluate(stacked.network,
                   [torch.Generator().manual_seed(7 + i) for i in range(2)])
    for i, seed in enumerate((1, 2)):
        one = run_state(agent.init_state(seed))
        assert int(one.train_steps) == 16
        torch.testing.assert_close(stacked.params[i], one.params, rtol=0,
                                   atol=1e-5)
        assert torch.equal(stacked.buffer.obs.chunk(2)[i], one.buffer.obs)
        assert int(stacked.buffer.flushed_total[i]) == int(
            one.buffer.flushed_total)
        ref = evaluate(one.network, torch.Generator().manual_seed(7 + i))
        assert [float(x[i]) for x in got] == [float(x) for x in ref]


# ------------------------------------------------- one update vs the JAX
FULL = dict(num_envs=2, inner_embed=64, num_heads=8, num_layers=2,
            context_len=50, history=50, batch_size=32, buffer_size=1000,
            target_update_frequency=10_000)


def batch_arrays(seed, b, length):
    """A Car Flag batch of numpy arrays, as tests/test_torch_agent.py's."""
    rng = np.random.default_rng(seed)
    obs = np.stack([
        rng.uniform(-1.1, 1.1, (b, length + 1)),
        rng.uniform(-0.07, 0.07, (b, length + 1)),
        rng.choice([-1.0, 0.0, 1.0], (b, length + 1)),
    ], -1).astype(np.float32)
    act = rng.integers(0, 3, (b, length + 1)).astype(np.int32)
    return dict(
        obs=obs[:, :-1], action=act[:, :-1], next_obs=obs[:, 1:],
        next_action=act[:, 1:],
        reward=rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0],
                          (b, length)).astype(np.float32),
        done=rng.random((b, length)) < 0.05,
        ep_len=rng.integers(1, length + 1, b).astype(np.int32),
    )


def test_stacked_update_matches_jax_vmap():
    jagent = JaxAgent(JaxConfig(model="DTQN", **FULL), jax_make_env(ENV))
    keys = jnp.stack([jax.random.key(0), jax.random.key(1)])
    jstates = jax.jit(jax.vmap(jagent._init_state_impl))(keys)
    jstates = jstates.replace(buffer=jstates.buffer.replace(
        flushed_total=jnp.full((2,), 100, jnp.int32)))
    arrays = [batch_arrays(1 + i, 32, 50) for i in range(2)]
    jbatch = jax_replay.Batch(**{
        k: jnp.stack([jnp.asarray(a[k]) for a in arrays]) for k in arrays[0]})
    jnew = jax.jit(jax.vmap(jagent.apply_update))(
        jstates, jbatch, jnp.stack([jax.random.key(5), jax.random.key(6)]))

    agent = Agent(AgentConfig(model="DTQN", **FULL), make_env(ENV),
                  device="cpu")
    state = agent.init_sweep_state([0, 1])
    weights = stacked_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstates.params))
    state.network.load_stacked_state_dict(weights)
    state.target_network.load_stacked_state_dict(weights)
    state.buffer.flushed_total.fill_(100)
    agent.apply_update(state, replay.Batch(**{
        k: torch.cat([torch.tensor(a[k]) for a in arrays])
        for k in arrays[0]}))

    assert state.train_steps.tolist() == np.asarray(
        jnew.train_steps).tolist() == [1, 1]
    assert state.nonfinite_grads.tolist() == [0, 0]
    d = jnew.diagnostics
    jax_diag = np.stack([np.asarray(getattr(d, f).buf[:, 0]) for f in (
        "td_error", "grad_norm", "q_max", "q_mean", "q_min", "target_max",
        "target_mean", "target_min")], -1)
    np.testing.assert_allclose(state.diagnostics.averages.buf[:, 0].numpy(),
                               jax_diag, rtol=1e-4)
    new_params = jax.tree_util.tree_map(np.asarray, jnew.params)
    for i in range(2):
        ref = params_from_jax(jax.tree_util.tree_map(lambda x: x[i],
                                                     new_params))
        for name, value in state.network.seed_state_dict(i).items():
            np.testing.assert_allclose(value.detach().numpy(),
                                       ref[name].numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{i} {name}")
    # The bridge's stacked round trip is exact.
    back = stacked_params_to_jax(weights)
    orig = jax.tree_util.tree_map(np.asarray, jstates.params)
    orig = orig.get("params", orig)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_orig = dict(jax.tree_util.tree_leaves_with_path(orig))
    assert len(flat_back) == len(flat_orig)
    for path, value in flat_back:
        np.testing.assert_array_equal(value, flat_orig[path])


# ------------------------------------------- one update vs per-seed ones
SMALL = dict(num_envs=4, inner_embed=16, num_heads=2, num_layers=1,
             context_len=6, history=4, batch_size=4, buffer_size=400,
             target_update_frequency=1)
# (model, env, AgentConfig fields, dropout masks): every model, the bag on
# token observations, and dropout with injected and with drawn masks.
MODELS = [
    ("DTQN", ENV, {}, None), ("DTQN-bag", "gv_memory.7x7.yaml",
                              dict(bag_size=3), None),
    ("DQN", ENV, {}, None), ("DRQN", "Memory-5-v0", {}, None),
    ("ADRQN", ENV, dict(action_dim=4), None), ("DARQN", ENV, {}, None),
    ("DTQN", ENV, dict(dropout=0.1), "injected"),
    ("DTQN", ENV, dict(dropout=0.1), "drawn"),
]


def sample_stacked_and_singles(agent, seeds):
    stacked = agent.init_sweep_state(seeds)
    singles = [agent.init_state(s) for s in seeds]
    for st in (stacked, *singles):
        make_prepopulate_fn(agent, 40)(st)
    return stacked, singles


@pytest.mark.parametrize("model,env_name,kw,masks", MODELS,
                         ids=[f"{m}-{k or ''}-{d or ''}"
                              for m, _, k, d in MODELS])
def test_stacked_update_equals_per_seed_updates(model, env_name, kw, masks):
    """Two updates (the second after a target swap) of a stacked state
    against each seed's own state, on the batches each samples from its own
    ring."""
    agent = Agent(AgentConfig(model=model, **dict(SMALL, **kw)),
                  capped_env(env_name, 12), device="cpu")
    stacked, singles = sample_stacked_and_singles(agent, [3, 8])
    for step in range(2):
        if masks == "injected":
            rng = np.random.default_rng(step)
            shapes = stacked.network.module.dropout_shapes(
                4, agent.config.context_len)
            per_seed = [[[torch.tensor(rng.random(s) < 0.9) for s in shapes]
                         for _ in range(3)] for _ in singles]
            for one, m in zip(singles, per_seed):
                batch = agent.sample_batch(one.buffer, one.generator)
                agent.apply_update(one, batch, masks=m)
            batch = agent.sample_batch(stacked.buffer, stacked.generator)
            agent.apply_update(stacked, batch, masks=[
                [torch.cat(site) for site in zip(*lanes)]
                for lanes in zip(*per_seed)])
        else:
            for st in (stacked, *singles):
                agent.learn(st)
    assert stacked.train_steps.tolist() == [2, 2]
    for i, one in enumerate(singles):
        assert int(one.train_steps) == 2
        torch.testing.assert_close(stacked.params[i], one.params, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(stacked.target_params[i],
                                   one.target_params, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(stacked.opt_state.nu[i], one.opt_state.nu,
                                   rtol=1e-4, atol=1e-12)
        torch.testing.assert_close(
            stacked.diagnostics.averages.buf[i], one.diagnostics.averages.buf,
            rtol=1e-4, atol=1e-6)
        assert torch.equal(stacked.generator[i].get_state(),
                           one.generator.get_state())


def test_a_seed_that_cannot_sample_skips_alone():
    agent = Agent(AgentConfig(**SMALL), capped_env(ENV, 12), device="cpu")
    state = agent.init_sweep_state([0, 1])
    make_prepopulate_fn(agent, 40)(state)
    state.buffer.flushed_total[1] = 4  # can_sample needs > batch
    before = state.params[1].clone()
    agent.learn(state)
    assert state.train_steps.tolist() == [1, 0]
    assert state.opt_state.count.tolist() == [1, 0]
    assert state.diagnostics.averages.count.tolist() == [1, 0]
    assert torch.equal(state.params[1], before)


# ------------------------------------------------------------- vmap rules
@pytest.mark.parametrize("causal,batched_k", [(True, True), (False, False)])
def test_attention_vmap_rule_folds_the_seeds(causal, batched_k, monkeypatch):
    calls = {"attention_fwd": 0, "attention_bwd": 0}
    for name in calls:
        real = getattr(ca, name)

        def counting(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(ca, name, counting)
    gen = torch.Generator().manual_seed(0)
    s, b, lq, lk, e, h = 3, 2, 5, 5 if causal else 7, 16, 2
    q = torch.randn((s, b, lq, e), generator=gen, requires_grad=True)
    k = torch.randn((s, b, lk, e) if batched_k else (b, lk, e),
                    generator=gen, requires_grad=True)
    v = torch.randn((s, b, lk, e), generator=gen, requires_grad=True)
    dout = torch.randn((s, b, lq, e), generator=gen)
    out = torch.func.vmap(
        lambda q, k, v: ca.cuda_attention_packed(q, k, v, h, causal),
        in_dims=(0, 0 if batched_k else None, 0))(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert calls == {"attention_fwd": 1, "attention_bwd": 1}
    ref = torch.stack([ca.cuda_attention_packed(
        q[i], k[i] if batched_k else k, v[i], h, causal) for i in range(s)])
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


def test_lookup_vmap_rule_keeps_each_seeds_table():
    gen = torch.Generator().manual_seed(1)
    table = torch.randn((3, 7, 4), generator=gen, requires_grad=True)
    tokens = torch.randint(0, 7, (3, 5, 2), generator=gen, dtype=torch.int32)
    out = torch.func.vmap(lookup)(table, tokens)
    ref = torch.stack([lookup(table[i], tokens[i]) for i in range(3)])
    assert torch.equal(out, ref)
    dout = torch.randn(out.shape, generator=gen)
    (grad,) = torch.autograd.grad(out, table, dout)
    (ref_grad,) = torch.autograd.grad(ref, table, dout)
    torch.testing.assert_close(grad, ref_grad, rtol=0, atol=1e-6)


# -------------------------------------------------------- operation budget
class CountOps(TorchDispatchMode):
    """Counts the aten operations dispatched, views (which launch no kernel
    on a GPU) left out."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("env_name,kw", [
    (ENV, {}), ("gv_memory.7x7.yaml", dict(model="DTQN-bag", bag_size=3))])
def test_operation_budget(env_name, kw, monkeypatch):
    """A 4-seed update dispatches at most twice a 1-seed update's
    operations, and makes as many attention calls: each operation serves
    every seed (a loop would make 4x)."""
    agent = Agent(AgentConfig(**dict(SMALL, **kw)), capped_env(env_name, 12),
                  device="cpu")
    attention = []
    real = ca.attention_fwd
    monkeypatch.setattr(ca, "attention_fwd",
                        lambda *a: attention.append(1) or real(*a))
    counts = {}
    for name, state in (("one", agent.init_state(0)),
                        ("four", agent.init_sweep_state([0, 1, 2, 3]))):
        make_prepopulate_fn(agent, 40)(state)
        agent.learn(state)  # warm
        del attention[:]
        with CountOps() as ops:
            agent.learn(state)
        counts[name] = (ops.count, len(attention))
    assert counts["four"][0] <= 2 * counts["one"][0], counts
    assert counts["four"][1] == counts["one"][1] > 0, counts
