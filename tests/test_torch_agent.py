"""The port's learner as a whole vs the JAX package.

- clip + Adam against optax on the same flat gradients, with the gate;
- one full-width ``apply_update`` (B=32, L=50, E=64) on bridged params and
  one shared batch: loss, grad norm, Q/target stats and post-Adam params
  at rtol 1e-4 (atol 1e-7 for parameters that sit at zero), and the
  gated skip when ``can_sample`` is false;
- 100 lockstep updates at a small size with a small target-update
  frequency: the target swap lands on the same applied counts, and the
  parameters stay within atol 2e-5 (float32 drift over 100 Adam steps);
- a CPU run of prepopulation and two train iterations of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dtqn_tpu import replay as jax_replay
from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.agents.base import AdamState, clip_adam_update
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.train.loop import make_prepopulate_fn, make_train_chunk_fn
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

ENV = "DiscreteCarFlag-v0"


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_adam_matches_optax(scale):
    """optax.clip_by_global_norm (no epsilon, unlike clip_grad_norm_) and
    optax.adam's bias correction, gated like agents/base.py:533-534."""
    rng = np.random.default_rng(0)
    n, lr = 257, 3e-4
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    p_jax = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    opt_jax = tx.init(p_jax)
    p_t = torch.tensor(np.asarray(p_jax))
    opt_t = AdamState(torch.zeros(n), torch.zeros(n),
                      torch.zeros((), dtype=torch.int32))
    for step in range(6):
        g = (scale * rng.standard_normal(n)).astype(np.float32)
        apply = step != 3  # one gated-off step in the middle
        if apply:
            upd, opt_jax = tx.update(jnp.asarray(g), opt_jax, p_jax)
            p_jax = optax.apply_updates(p_jax, upd)
        gt = torch.tensor(g)
        clip_adam_update(p_t, gt, torch.linalg.vector_norm(gt), opt_t,
                         torch.tensor(apply), lr, 1.0)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_jax),
                                   rtol=1e-6, atol=1e-7)
    assert int(opt_t.count) == 5


def make_pair(**kw):
    jcfg = JaxConfig(model="DTQN", **kw)
    jagent = JaxAgent(jcfg, jax_make_env(ENV))
    jstate = jagent.init_state(jax.random.key(0))
    agent = Agent(AgentConfig(model="DTQN", **kw), make_env(ENV),
                  device="cpu")
    state = agent.init_state(0)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state.network.load_state_dict(params_from_jax(params))
    state.target_network.load_state_dict(params_from_jax(params))
    return jagent, jstate, agent, state


def set_flushed(jstate, state, n):
    state.buffer.flushed_total.fill_(n)
    return jstate.replace(
        buffer=jstate.buffer.replace(flushed_total=jnp.int32(n))
    )


def batch_arrays(seed, b, length):
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


def batches(arrays):
    jb = jax_replay.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = replay.Batch(**{k: torch.tensor(v) for k, v in arrays.items()})
    return jb, tb


def diag_values(jstate, state, slot):
    d = jstate.diagnostics
    jax_vals = [float(getattr(d, f).buf[slot]) for f in (
        "td_error", "grad_norm", "q_max", "q_mean", "q_min",
        "target_max", "target_mean", "target_min")]
    return np.array(jax_vals), state.diagnostics.averages.buf[slot].numpy()


def assert_params_close(state_dict, jparams, rtol, atol):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, value in state_dict.items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


FULL = dict(num_envs=2, inner_embed=64, num_heads=8, num_layers=2,
            context_len=50, history=50, batch_size=32, buffer_size=1000,
            target_update_frequency=10_000)


def test_apply_update_full_width_matches_jax():
    jagent, jstate, agent, state = make_pair(**FULL)
    jstate = set_flushed(jstate, state, 100)
    jb, tb = batches(batch_arrays(1, 32, 50))
    jnew = jax.jit(jagent.apply_update)(jstate, jb, jax.random.key(1))
    agent.apply_update(state, tb)

    assert int(jnew.train_steps) == int(state.train_steps) == 1
    assert int(state.nonfinite_grads) == 0
    jd, td = diag_values(jnew, state, 0)
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    assert_params_close(state.network.state_dict(), jnew.params,
                        rtol=1e-4, atol=1e-7)
    # Not a swap step: the target keeps the initial parameters.
    assert_params_close(state.target_network.state_dict(), jnew.target_params,
                        rtol=0, atol=0)


def test_apply_update_gated_skip_when_cannot_sample():
    jagent, jstate, agent, state = make_pair(**FULL)
    jstate = set_flushed(jstate, state, 32)  # can_sample needs > batch
    before = state.params.clone()
    jb, tb = batches(batch_arrays(2, 32, 50))
    jnew = jax.jit(jagent.apply_update)(jstate, jb, jax.random.key(1))
    agent.apply_update(state, tb)
    assert int(jnew.train_steps) == int(state.train_steps) == 0
    assert torch.equal(state.params, before)
    assert int(state.opt_state.count) == 0
    assert int(state.diagnostics.averages.count) == 0
    assert int(jnew.diagnostics.td_error.count) == 0


def test_lockstep_updates_and_target_swap():
    small = dict(num_envs=2, inner_embed=16, num_heads=2, num_layers=1,
                 context_len=6, history=4, batch_size=4, buffer_size=400,
                 target_update_frequency=7)
    jagent, jstate, agent, state = make_pair(**small)
    jstate = set_flushed(jstate, state, 100)
    update = jax.jit(jagent.apply_update)
    initial_target = state.target_params.clone()
    for i in range(1, 101):
        jb, tb = batches(batch_arrays(100 + i, 4, 6))
        jstate = update(jstate, jb, jax.random.key(i))
        agent.apply_update(state, tb)
        if i in (6, 7, 8, 14):
            assert_params_close(state.target_network.state_dict(),
                                jstate.target_params, rtol=0, atol=2e-5)
        if i == 6:
            assert torch.equal(state.target_params, initial_target)
        if i == 7:
            assert torch.equal(state.target_params, state.params)
    assert int(state.train_steps) == int(jstate.train_steps) == 100
    assert_params_close(state.network.state_dict(), jstate.params,
                        rtol=0, atol=2e-5)


def test_prepopulate_and_train_chunk_on_cpu():
    cfg = AgentConfig(num_envs=8, context_len=8, history=8, inner_embed=16,
                      num_heads=2, num_layers=1, batch_size=4,
                      buffer_size=4000, target_update_frequency=5)
    agent = Agent(cfg, make_env(ENV), device="cpu")
    state = agent.init_state(0)
    # CarFlag's 200-step cap flushes every env at least once.
    make_prepopulate_fn(agent, 200)(state)
    assert int(state.buffer.flushed_total) > cfg.batch_size
    assert int(state.env_steps) == 0
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 1000), 8, 2)(state)
    assert int(state.train_steps) == 16
    assert int(state.nonfinite_grads) == 0
    assert int(state.env_steps) == 16
    assert float(state.epsilon) < 1.0
    assert all(torch.isfinite(v) for v in state.diagnostics.means().values())
