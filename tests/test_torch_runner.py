"""The port's runner path on the CPU: config and CLI, CSV logs, checkpoints,
``run_experiment`` (sentinel, time-limit checkpoint, resume, enjoy mode),
the entry module and the benchmark script.  Where the JAX package has the
same piece (config, CSV logger, rendering) both get the same inputs and
must agree exactly.
"""

import csv
import dataclasses
import glob
import json
import os
import random

import numpy as np
import pytest
import torch

from dtqn_tpu.config import ExperimentConfig as JaxExperimentConfig
from dtqn_tpu.config import get_args as jax_get_args
from dtqn_tpu.envs.car_flag import CarFlag as JaxCarFlag
from dtqn_tpu.envs.car_flag import CarFlagState as JaxCarFlagState
from dtqn_tpu.utils import logging as jax_logging
from dtqn_tpu_torch import bench, run
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.config import ExperimentConfig, get_args
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.envs.car_flag import CarFlagState
from dtqn_tpu_torch.envs.minihack import minihack_available
from dtqn_tpu_torch.train import runner
from dtqn_tpu_torch.train.loop import (
    make_prepopulate_fn,
    make_train_chunk_fn,
)
from dtqn_tpu_torch.train.runner import (
    HostRunningAverage,
    build_envs,
    run_experiment,
)
from dtqn_tpu_torch.utils import checkpoint as ckpt
from dtqn_tpu_torch.utils import logging as port_logging
from dtqn_tpu_torch.utils.checkpoint import _leaves
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule
from dtqn_tpu_torch.utils.profiling import tracing, tracing_on
from dtqn_tpu_torch.utils.rng import seed_everything

RESULT_HEAD = ["Hours", "Step", "{e}/SuccessRate", "{e}/EpisodeLength",
               "{e}/Return"]
LOSS_HEAD = ["Hours", "Step", "TD Error", "Grad Norm", "Max Q Value",
             "Mean Q Value", "Min Q Value", "Max Target Value",
             "Mean Target Value", "Min Target Value"]


# ------------------------------------------------------------ config, CLI
ARGVS = [
    [],
    ["--envs", "DiscreteCarFlag-v0", "--in-embed", "64", "--num-envs", "64",
     "--verbose"],
    ["--envs", "Memory-5-v0", "--obs-embed", "4", "--a-embed", "2",
     "--context", "20", "--history", "10", "--heads", "4", "--layers", "3",
     "--batch", "16", "--seed", "7", "--eps-min", "0.3", "--save-policy"],
    ["--envs", "a/b.pomdp", "gv_memory.7x7.yaml", "--project-name", "p",
     "--bag-size", "5", "--bag-mask", "--bag-store", "--gate", "gru",
     "--identity", "--pos", "sin", "--model", "DTQN-bag"],
    ["--num-steps", "1000", "--tuf", "50", "--lr", "0.001", "--buf-size",
     "900", "--eval-frequency", "100", "--eval-episodes", "3",
     "--max-episode-steps", "30", "--discount", "0.9", "--dropout", "0.1",
     "--updates-per-iter", "2", "--iters-per-chunk", "5", "--prepop-steps",
     "77", "--time-limit", "1.5", "--slurm-job-id", "9", "--seeds", "1", "2",
     "--unroll", "8", "--outer-unroll", "2", "--attention", "pallas",
     "--dp-devices", "2", "--profile-dir", "x", "--bf16", "--wandb",
     "--render"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_and_cli_match_jax(argv, tmp_path):
    cfg, jcfg = get_args(argv), jax_get_args(argv)
    a, b = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    # The device default is the one field that differs: cuda here.
    assert a.pop("device") == "cuda" and b.pop("device") == "tpu"
    assert a == b
    assert cfg.run_name() == jcfg.run_name()
    root = str(tmp_path)
    assert cfg.policy_dir(root) == jcfg.policy_dir(root)
    assert cfg.policy_path(root) == jcfg.policy_path(root)
    assert cfg.policy_path().startswith(os.getcwd())
    assert cfg.resolved_updates_per_iter == jcfg.resolved_updates_per_iter
    assert cfg.resolved_iters_per_chunk == jcfg.resolved_iters_per_chunk
    # The port's agent config also carries the compute dtype, which the JAX
    # package keeps as a global (set_compute_dtype); the rest is equal.
    agent_cfg = dataclasses.asdict(cfg.agent_config())
    assert agent_cfg.pop("bf16") == cfg.bf16 == jcfg.bf16
    assert agent_cfg == dataclasses.asdict(jcfg.agent_config())


def test_config_device_flag_and_defaults():
    assert get_args(["--device", "cpu"]).device == "cpu"
    assert ([f.name for f in dataclasses.fields(ExperimentConfig)]
            == [f.name for f in dataclasses.fields(JaxExperimentConfig)])


# ------------------------------------------------------------------ logging
def test_csv_logger_matches_jax_byte_for_byte(tmp_path):
    envs = ["DiscreteCarFlag-v0", "Memory-5-v0"]
    rng = np.random.default_rng(0)
    rows = []
    for step in (5000, 10000):
        vals = {f"{e}/{k}": float(rng.random()) for e in envs
                for k in ("SuccessRate", "EpisodeLength", "Return")}
        vals.update({
            f"losses/{k}": float(np.float32(rng.standard_normal()))
            for k in ("TD_Error", "Grad_Norm", "Max_Q_Value", "Mean_Q_Value",
                      "Min_Q_Value", "Max_Target_Value", "Mean_Target_Value",
                      "Min_Target_Value")
        })
        vals["losses/hours"] = step / 1e6
        rows.append((vals, step))
    for name, module in (("port", port_logging), ("jax", jax_logging)):
        path = str(tmp_path / name / "sub" / "run")
        logger = module.CSVLogger(path, envs)
        for vals, step in rows:
            logger.log(vals, step=step)
        # A second logger on the same path appends under the same header.
        module.CSVLogger(path, envs).log(*rows[0])
    for suffix in ("_results.csv", "_losses.csv"):
        a = (tmp_path / "port" / "sub" / ("run" + suffix)).read_bytes()
        b = (tmp_path / "jax" / "sub" / ("run" + suffix)).read_bytes()
        assert a == b and a.count(b"\n") == 4
    assert port_logging.WANDB_GROUP_KEYS == jax_logging.WANDB_GROUP_KEYS


def test_get_logger_falls_back_to_csv_without_wandb(tmp_path, capsys):
    cfg = ExperimentConfig(disable_wandb=False)
    logger = port_logging.get_logger(str(tmp_path / "run"), cfg)
    assert isinstance(logger, port_logging.CSVLogger)
    assert "wandb not installed" in capsys.readouterr().out
    assert isinstance(
        port_logging.get_logger(str(tmp_path / "run2"), ExperimentConfig()),
        port_logging.CSVLogger)
    assert len(port_logging.timestamp().split(", ")) == 2


def test_seed_everything():
    assert seed_everything(5) == 5
    a = (random.random(), np.random.rand(), torch.rand(()).item())
    assert seed_everything(5) == 5
    assert a == (random.random(), np.random.rand(), torch.rand(()).item())
    assert os.environ["PYTHONHASHSEED"] == "5"


# -------------------------------------------------------------- checkpoints
def small_agent():
    env = make_env("DiscreteCarFlag-v0")
    env.max_episode_steps = 20
    cfg = AgentConfig(
        model="DTQN", num_envs=4, context_len=8, history=8, inner_embed=16,
        num_heads=2, num_layers=1, buffer_size=800, batch_size=4,
        target_update_frequency=10,
    )
    return env, Agent(cfg, env, device="cpu")


def trained_state(agent, seed=0):
    state = agent.init_state(seed)
    make_prepopulate_fn(agent, 60)(state)
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 1, 10)(state)
    return state


def leaves_equal(a, b):
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        assert x.dtype == y.dtype and torch.equal(x, y), name


def is_view_of(network, flat):
    lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    return all(lo <= p.data_ptr() < hi for p in network.parameters())


def test_full_checkpoint_round_trip_keeps_aliasing(tmp_path):
    _, agent = small_agent()
    state = trained_state(agent)
    assert int(state.train_steps) == 10
    path = str(tmp_path / "run")
    ckpt.save_checkpoint(path, state, extra={"mean_reward": [0.5, 0.25]})
    assert ckpt.has_checkpoint(path) and not ckpt.has_checkpoint(path + "x")
    assert os.path.exists(path + "_checkpoint.pt")

    template = agent.init_state(42)
    restored, extra = ckpt.load_checkpoint(path, template)
    assert restored is template
    leaves_equal(state, restored)
    assert extra["mean_reward"] == [0.5, 0.25]
    # The networks still read the flat vectors the optimizer writes.
    assert is_view_of(restored.network, restored.params)
    assert is_view_of(restored.target_network, restored.target_params)
    for a, b in zip(state.network.parameters(),
                    restored.network.parameters()):
        assert torch.equal(a, b)
    # Training continues bit-identically from the restored state.
    chunk = make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 1, 5)
    chunk(state)
    chunk(restored)
    leaves_equal(state, restored)
    assert int(restored.train_steps) == 15


def test_checkpoint_refuses_other_device_kind_and_other_config(tmp_path):
    env, agent = small_agent()
    state = agent.init_state(0)
    path = str(tmp_path / "run")
    ckpt.save_checkpoint(path, state)
    payload = torch.load(path + "_checkpoint.pt", weights_only=True)
    assert payload["generator_device"] == "cpu"
    assert all(v.device.type == "cpu" for v in payload.values()
               if isinstance(v, torch.Tensor))
    # Reckoned size: the tensors' bytes, and little besides.
    nbytes = sum(v.numel() * v.element_size() for v in payload.values()
                 if isinstance(v, torch.Tensor))
    size = os.path.getsize(path + "_checkpoint.pt")
    assert nbytes <= size <= nbytes + 200_000

    torch.save(dict(payload, generator_device="cuda"),
               path + "_checkpoint.pt")
    with pytest.raises(RuntimeError, match="written on 'cuda'"):
        ckpt.load_checkpoint(path, agent.init_state(1))

    ckpt.save_checkpoint(path, state)
    wider = Agent(dataclasses.replace(agent.config, inner_embed=32), env,
                  device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load_checkpoint(path, wider.init_state(0))


def test_policy_round_trip(tmp_path):
    _, agent = small_agent()
    state = trained_state(agent)
    path = str(tmp_path / "run")
    ckpt.save_policy(path, state.network)
    other = agent.init_state(9)
    assert not torch.equal(other.params, state.params)
    assert ckpt.load_policy(path, other.network) is other.network
    assert torch.equal(other.params, state.params)  # loaded through the views
    assert is_view_of(other.network, other.params)
    saved = torch.load(path + "_policy.pt", weights_only=True)
    assert list(saved) == list(state.network.state_dict())


def test_mini_checkpoint_matches_jax_format(tmp_path):
    from dtqn_tpu.utils import checkpoint as jax_ckpt

    path = str(tmp_path / "run")
    assert ckpt.load_mini_checkpoint(path) is None
    ckpt.save_mini_checkpoint(path, 1234, "wbid")
    assert ckpt.load_mini_checkpoint(path) == {"step": 1234,
                                               "wandb_id": "wbid"}
    assert jax_ckpt.load_mini_checkpoint(path) == {"step": 1234,
                                                   "wandb_id": "wbid"}
    jax_ckpt.save_mini_checkpoint(path + "j", 5, None)
    assert ((tmp_path / "runj_mini_checkpoint.json").read_bytes()
            == json.dumps({"step": 5, "wandb_id": None}).encode())
    assert ckpt.load_mini_checkpoint(path + "j") == {"step": 5,
                                                     "wandb_id": None}


# ------------------------------------------------------------------- runner
def runner_config(**kw):
    cfg = ExperimentConfig(
        envs=["DiscreteCarFlag-v0"], device="cpu", num_steps=160, num_envs=8,
        in_embed=16, heads=2, layers=2, context=8, history=8, batch=4,
        buf_size=2000, eval_frequency=80, eval_episodes=2, prepop_steps=400,
        updates_per_iter=2, max_episode_steps=20, tuf=10,
        project_name="runner-test", save_policy=True,
    )
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def check_csvs(cfg, rows):
    env = cfg.envs[0]
    results = read_csv(cfg.policy_path() + "_results.csv")
    losses = read_csv(cfg.policy_path() + "_losses.csv")
    assert results[0] == [h.format(e=env) for h in RESULT_HEAD]
    assert losses[0] == LOSS_HEAD
    assert len(results) == len(losses) == rows + 1
    for r, l in zip(results[1:], losses[1:]):
        assert r[1] == l[1] and all(np.isfinite(float(x)) for x in r + l)
        assert 0.0 <= float(r[2]) <= 1.0
        assert 1.0 <= float(r[3]) <= cfg.max_episode_steps
    return results, losses


@pytest.mark.parametrize("env_name", ["DiscreteCarFlag-v0", "Memory-5-v0"])
def test_run_writes_logs_policy_and_sentinel_then_short_circuits(
        env_name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = runner_config(envs=[env_name], verbose=True)
    out = run_experiment(cfg)
    assert f"{env_name}/SuccessRate" in out and "losses/TD_Error" in out
    results, _ = check_csvs(cfg, rows=2)
    assert [r[1] for r in results[1:]] == ["80", "160"]
    assert os.path.exists(cfg.policy_path() + "_policy.pt")
    assert not ckpt.has_checkpoint(cfg.policy_path())
    assert ckpt.load_mini_checkpoint(cfg.policy_path()) == {
        "step": 160, "wandb_id": None}
    printed = capsys.readouterr().out
    assert "Creating DTQN with" in printed and "Steps: 160" in printed

    out2 = run_experiment(cfg)
    assert out2 == {"completed": True, "step": 160}
    assert "Found completed run (160 steps)" in capsys.readouterr().out
    check_csvs(cfg, rows=2)


def cut_and_resumed_equals_whole(tmp_path, monkeypatch, capsys, **kw):
    """A run cut by the time limit after its first chunk and resumed ends
    with the uninterrupted run's logs and parameters, bit for bit."""
    (tmp_path / "whole").mkdir()
    (tmp_path / "cut").mkdir()
    monkeypatch.chdir(tmp_path / "whole")
    run_experiment(runner_config(num_steps=240, **kw))
    whole, whole_losses = check_csvs(runner_config(num_steps=240, **kw),
                                     rows=3)
    whole_policy = torch.load(
        runner_config(**kw).policy_path() + "_policy.pt", weights_only=True)

    monkeypatch.chdir(tmp_path / "cut")
    cfg = runner_config(num_steps=240, time_limit=1e-9, **kw)
    run_experiment(cfg)  # hits the time limit after the first chunk
    assert "Reached time limit. Saving checkpoint at 80" in (
        capsys.readouterr().out)
    assert ckpt.has_checkpoint(cfg.policy_path())
    assert ckpt.load_mini_checkpoint(cfg.policy_path())["step"] == 80
    assert not os.path.exists(cfg.policy_path() + "_policy.pt")
    with open(cfg.policy_path() + "_checkpoint_extra.json") as f:
        extra = json.load(f)
    assert [len(v) for v in extra.values()] == [1, 1, 1]
    check_csvs(cfg, rows=1)

    payload = torch.load(cfg.policy_path() + "_checkpoint.pt",
                         weights_only=True)
    cfg2 = runner_config(num_steps=240, **kw)
    out = run_experiment(cfg2)  # resumes, then runs to completion
    assert "Resumed from checkpoint at 80 steps." in capsys.readouterr().out
    assert f"{cfg2.envs[0]}/SuccessRate" in out
    assert ckpt.load_mini_checkpoint(cfg2.policy_path())["step"] == 240
    cut, cut_losses = check_csvs(cfg2, rows=3)
    # Everything but the wall time repeats: evaluation and the losses.
    assert [r[1:] for r in cut] == [r[1:] for r in whole]
    assert [r[1:] for r in cut_losses] == [r[1:] for r in whole_losses]
    cut_policy = torch.load(cfg2.policy_path() + "_policy.pt",
                            weights_only=True)
    assert list(cut_policy) == list(whole_policy)
    for name in whole_policy:
        assert torch.equal(cut_policy[name], whole_policy[name]), name
    return payload


def test_time_limit_checkpoint_then_resume_is_bit_equal(tmp_path,
                                                        monkeypatch, capsys):
    payload = cut_and_resumed_equals_whole(tmp_path, monkeypatch, capsys)
    assert not any(k.startswith("carry") for k in payload)


@pytest.mark.parametrize("model,env_name", [
    ("DRQN", "Memory-5-v0"), ("ADRQN", "POMDP-hallway-episodic-v0"),
    ("DARQN", "DiscreteCarFlag-v0"), ("DQN", "POMDP-heavenhell_3-episodic-v0"),
])
def test_baseline_cut_and_resumed_run_is_bit_equal(model, env_name, tmp_path,
                                                   monkeypatch, capsys):
    """The recurrent models' act-time carry rides the full checkpoint, so a
    resumed run acts, and learns, as the uninterrupted one."""
    # A 25-step cap: the cut, 60 iterations in (50 of prepopulation), falls
    # inside episodes that did not end early.
    payload = cut_and_resumed_equals_whole(
        tmp_path, monkeypatch, capsys, model=model, envs=[env_name],
        max_episode_steps=25)
    recurrent = model != "DQN"
    assert ("carry.c" in payload) == ("carry.h" in payload) == recurrent
    if recurrent:
        assert payload["carry.h"].shape == (8, 16)
        assert payload["carry.h"].abs().sum() > 0


def test_evaluation_does_not_disturb_training(tmp_path, monkeypatch):
    """More evaluation episodes change what is logged, not what is learned:
    the train stream gives evaluation one seed per round and no more."""
    policies = []
    for episodes in (1, 5):
        (tmp_path / str(episodes)).mkdir()
        monkeypatch.chdir(tmp_path / str(episodes))
        cfg = runner_config(eval_episodes=episodes)
        run_experiment(cfg)
        policies.append(torch.load(cfg.policy_path() + "_policy.pt",
                                   weights_only=True))
    for name in policies[0]:
        assert torch.equal(policies[0][name], policies[1][name]), name


def test_nonfinite_gradients_fail_loudly(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    learn = Agent.learn

    def poisoned(self, state):
        learn(self, state)
        state.nonfinite_grads = state.nonfinite_grads + 1
        return state

    monkeypatch.setattr(Agent, "learn", poisoned)
    with pytest.raises(FloatingPointError, match="non-finite gradient"):
        run_experiment(runner_config())


def test_enjoy_mode_and_render_frame(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = runner_config(num_steps=80)
    run_experiment(cfg)
    out = run_experiment(runner_config(num_steps=80, render=True))
    assert 0.0 <= out["success_rate"] <= 1.0 and "return" in out
    assert "[enjoy] SuccessRate=" in capsys.readouterr().out
    pytest.importorskip("PIL")
    from PIL import Image

    assert out["render_path"] == cfg.policy_path() + "_enjoy.png"
    strip = np.asarray(Image.open(out["render_path"]))
    assert strip.shape[1:] == (400, 3) and strip.shape[0] % 80 == 0
    assert 2 * 80 <= strip.shape[0] <= 4 * 80  # 20-step cap: 21 frames at most


def test_enjoy_mode_steps_the_recurrent_carry(tmp_path, monkeypatch):
    """The evaluation and the rendered episode start every rollout from a
    zero carry and step it as they act."""
    monkeypatch.chdir(tmp_path)
    run_experiment(runner_config(num_steps=80, model="DARQN"))
    carries = []
    greedy = Agent.greedy_actions

    def recording(self, network, context, bag=None, carry=None, obs=None):
        carries.append(carry)
        return greedy(self, network, context, bag, carry, obs)

    monkeypatch.setattr(Agent, "greedy_actions", recording)
    out = run_experiment(runner_config(num_steps=80, model="DARQN",
                                       render=True))
    assert os.path.exists(out["render_path"])
    assert all(c is not None for c in carries)
    starts = [i for i, c in enumerate(carries) if not c.h.any()]
    # One zero carry opens the evaluation, one the rendered episode.
    assert starts[0] == 0 and len(starts) == 2
    assert carries[starts[1]].h.shape == (1, 16)
    assert carries[-1].h.abs().sum() > 0


def test_render_frame_matches_jax():
    env, jenv = make_env("DiscreteCarFlag-v0"), JaxCarFlag()
    for pos, heaven in ((0.0, 1.0), (0.5, -1.0), (-1.1, 1.0), (1.1, -1.0)):
        frame = env.render_frame(CarFlagState(
            position=torch.tensor(pos), velocity=torch.tensor(0.0),
            heaven=torch.tensor(heaven), t=torch.tensor(0)))
        want = jenv.render_frame(JaxCarFlagState(
            position=np.float32(pos), velocity=np.float32(0.0),
            heaven=np.float32(heaven), t=np.int32(0)))
        assert frame.dtype == np.uint8 and frame.shape == (80, 400, 3)
        np.testing.assert_array_equal(frame, want)


def test_host_running_average_and_build_envs():
    avg = HostRunningAverage(3, [1.0, 2.0])
    assert avg.mean() == 1.5
    for v in (3.0, 4.0):
        avg.add(v)
    assert avg.to_list() == [2.0, 3.0, 4.0] and avg.mean() == 3.0
    assert HostRunningAverage(3).mean() == 0.0
    env, evals = build_envs(runner_config(envs=["Memory-5-v0"]))
    assert env.name == evals[0].name == "Memory-5-v0" and env is not evals[0]
    env, evals = build_envs(runner_config(
        envs=["gv_memory.7x7.yaml", "gv_memory.5x5.yaml"]))
    assert env.name == "gv_memory.7x7.yaml+gv_memory.5x5.yaml"
    assert [m.pad for m in env.envs] == [e.pad for e in evals] == [7, 7]
    assert [e.name for e in evals] == ["gv_memory.7x7.yaml",
                                       "gv_memory.5x5.yaml"]
    with pytest.raises(ValueError, match="share observation/action"):
        build_envs(runner_config(envs=["Memory-5-v0", "DiscreteCarFlag-v0"]))


# The runner's flags that were refused: ``--dp-devices`` (two ranks, one
# process each), ``--bf16`` and ``--profile-dir``, ported since, run under
# the ids their refusals had (``item`` None).
NOT_PORTED = [
    (dict(dp_devices=2), None), (dict(bf16=True), None),
    (dict(profile_dir="prof"), None),
]


@pytest.mark.parametrize("kw,item", NOT_PORTED,
                         ids=[str(list(kw.values())[0]) + "-" + list(kw)[0]
                              for kw, _ in NOT_PORTED])
def test_not_ported_flags_raise(kw, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            run_experiment(runner_config(**kw))
        assert not os.listdir(tmp_path)  # refused before anything is written
        return
    # Two chunks of one iteration of 4 envs: with --profile-dir the second
    # is traced (the first warms up, as in the JAX runner).
    cfg = runner_config(num_steps=8, num_envs=4, layers=1, batch=2,
                        eval_frequency=4, eval_episodes=1, prepop_steps=100,
                        updates_per_iter=1, max_episode_steps=10, **kw)
    calls = []
    real = runner.trace_chunks
    monkeypatch.setattr(runner, "trace_chunks", lambda d, *rest: calls.append(
        d) or real(d, *rest))
    out = run_experiment(cfg)
    assert out["losses/Grad_Norm"] > 0.0 and all(
        np.isfinite(v) for v in out.values())
    check_csvs(cfg, rows=2)
    if cfg.bf16:
        net = ckpt.load_policy(cfg.policy_path(), Agent(
            cfg.agent_config(), make_env(cfg.envs[0]),
            device="cpu").build_network())
        assert net.head_out.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in net.parameters())
    traces = os.listdir("prof") if cfg.profile_dir else []
    # Over two ranks the chunks run in the ranks' own processes.
    assert calls == ([] if cfg.dp_devices > 1 else
                     [None, "prof"] if cfg.profile_dir else [None, None])
    assert len(traces) == int(bool(cfg.profile_dir))
    if traces:
        with open(os.path.join("prof", traces[0])) as f:
            events = json.load(f)["traceEvents"]
        # One chunk: its env steps and updates (host operations on the CPU),
        # in the phases' spans: --profile-dir switches tracing on for the
        # run, and back off after it.
        names = {e.get("name", "") for e in events}
        assert any("aten::" in n for n in names)
        assert {"dtqn.act", "dtqn.env", "dtqn.sample", "dtqn.update"} <= names
        assert not tracing()


def test_profiling_helpers(tmp_path):
    """``trace_chunks`` writes one Chrome trace holding what ran inside it,
    a ``phase``'s span included while tracing, and nothing without a
    directory; a chunk with no phases' marks (a CPU body) adds no phases
    file."""
    from dtqn_tpu_torch.utils.profiling import phase, trace_chunks

    with trace_chunks(None, "cpu"):
        torch.ones(3).sum()
    out = tmp_path / "prof"
    with trace_chunks(str(out), "cpu", chunk=lambda s: s):
        with tracing_on(), phase("update"):
            torch.ones(3).sum()
    (trace,) = os.listdir(out)
    with open(out / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "dtqn.update" in names and "aten::sum" in names


# DTQN's variants, the image maze and several domains: each trains and
# evaluates through the runner (cases of what was refused before they were
# ported, under the same ids).
VARIANT_FLAGS = [
    dict(gate="gru"), dict(identity=True), dict(pos="sin"), dict(pos="none"),
    dict(dropout=0.1), dict(envs=["gv_memory.7x7.yaml", "gv_memory.5x5.yaml"]),
    dict(envs=["ImageMaze-9-v0"]),
]


@pytest.mark.parametrize("kw", VARIANT_FLAGS,
                         ids=[str(list(kw.values())[0]) + "-" + list(kw)[0]
                              for kw in VARIANT_FLAGS])
def test_variant_flags_train_and_evaluate(kw, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # Two chunks of two iterations of 4 envs, at context 4: the CNN and the
    # dropout forwards cost most on the CPU.
    cfg = runner_config(num_steps=16, num_envs=4, context=4, history=4,
                        batch=2, eval_frequency=8, eval_episodes=1,
                        prepop_steps=100, updates_per_iter=1,
                        max_episode_steps=10, **kw)
    out = run_experiment(cfg)
    assert out["losses/Grad_Norm"] > 0.0  # the updates were applied
    results = read_csv(cfg.policy_path() + "_results.csv")
    head = ["Hours", "Step"]
    for env in cfg.envs:
        head += [f"{env}/SuccessRate", f"{env}/EpisodeLength",
                 f"{env}/Return"]
    assert results[0] == head
    assert [r[1] for r in results[1:]] == ["8", "16"]
    for row in results[1:]:
        assert all(np.isfinite(float(x)) for x in row)
        for i in range(len(cfg.envs)):
            assert 0.0 <= float(row[2 + 3 * i]) <= 1.0
            assert 1.0 <= float(row[3 + 3 * i]) <= cfg.max_episode_steps
    assert os.path.exists(cfg.policy_path() + "_policy.pt")
    assert run_experiment(cfg) == {"completed": True, "step": 16}


def test_agent_refuses_bag_fields():
    """Where the JAX factory refuses them: ``bag_mask`` tells empty slots by
    the padding sentinel, which a continuous observation can equal."""
    from dtqn_tpu.agents import Agent as JaxAgent
    from dtqn_tpu.agents import AgentConfig as JaxConfig
    from dtqn_tpu.envs import make_env as jax_make_env

    env = make_env("DiscreteCarFlag-v0")
    small = dict(inner_embed=16, num_heads=2, context_len=4, history=4)
    for kw in (dict(bag_mask=True), dict(bag_size=2, bag_mask=True)):
        with pytest.raises(ValueError, match="discrete-observation env"):
            JaxAgent(JaxConfig(**small, **kw),
                     jax_make_env("DiscreteCarFlag-v0"))
        with pytest.raises(ValueError, match="discrete-observation env"):
            Agent(AgentConfig(**small, **kw), env, device="cpu").init_state(0)
    # A bag belongs to DTQN: the other models take none, as in the JAX
    # package.
    assert not JaxAgent(JaxConfig(model="DRQN", bag_size=2),
                        jax_make_env("DiscreteCarFlag-v0")).use_bag
    assert not Agent(AgentConfig(model="DRQN", bag_size=2), env,
                     device="cpu").use_bag
    # Without the mask a continuous env takes a bag, as in the JAX package.
    agent = Agent(AgentConfig(bag_size=2, bag_store=True, **small), env,
                  device="cpu")
    assert agent.use_bag and agent.store_act_bags
    assert agent.init_state(0).buffer.bag_idx.shape[2] == 2


# ------------------------------------------------------------ entry modules
CLI = ["--device", "cpu", "--in-embed", "16", "--heads", "2", "--context", "4",
       "--history", "4", "--num-envs", "4", "--batch", "4", "--buf-size",
       "2000", "--prepop-steps", "400", "--eval-frequency", "40",
       "--num-steps", "80", "--save-policy"]


def test_run_module_main(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = run.main(["--envs", "DiscreteCarFlag-v0", "--seeds", "3", *CLI])
    assert "DiscreteCarFlag-v0/Return" in out
    cfg = get_args(["--envs", "DiscreteCarFlag-v0", "--seed", "3", *CLI])
    assert cfg.run_name().endswith("_seed=3")
    check_csvs(dataclasses.replace(cfg, max_episode_steps=200), rows=2)
    assert os.path.exists(cfg.policy_path() + "_policy.pt")
    assert run.main(["--envs", "DiscreteCarFlag-v0", "--seed", "3",
                     *CLI]) == {"completed": True, "step": 80}
    # Several seeds go to the sweep (train/sweep.py).
    from dtqn_tpu_torch.train import sweep

    calls = []
    monkeypatch.setattr(sweep, "run_sweep",
                        lambda cfg, seeds: calls.append((cfg, seeds)))
    run.main(["--seeds", "1", "2", *CLI])
    assert [seeds for _, seeds in calls] == [[1, 2]]
    assert calls[0][0].device == "cpu"
    # MiniHack goes to the host loop (train/host_loop.py): an unknown name
    # raises KeyError, a known one ImportError naming minihack where it is
    # not installed, and one run over several ranks ValueError; nothing is
    # written.
    with pytest.raises(KeyError, match="MH-Room-5x5-v0"):
        run.main(["--envs", "MH-Room-5x5-v0", *CLI])
    if not minihack_available():
        with pytest.raises(ImportError, match="minihack"):
            run.main(["--envs", "MH-Room-5-v0", *CLI])
    with pytest.raises(ValueError, match="dp-devices"):
        run.main(["--envs", "MH-Room-5-v0", "--dp-devices", "2", *CLI])
    assert not glob.glob(os.path.join("policies", "*", "MH-*"))


def test_bench_prints_one_json_line(monkeypatch, capsys):
    # The script at a small size: 8 envs and a short prepopulation.
    monkeypatch.setattr(bench, "NUM_ENVS", 8)
    monkeypatch.setattr(bench, "PREPOP_STEPS", 8_000)
    line = bench.main(["--device", "cpu", "--iters", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert line["metric"] == "carflag_dtqn_torch_env_steps_per_s_1to1_updates"
    assert line["unit"] == "env-steps/s (== learner updates/s)"
    assert line["device"] == "cpu" and line["value"] > 0
    assert "vs_baseline" not in line


@pytest.mark.parametrize("flags", [["--seeds", "2"], ["--bf16"]])
def test_bench_extras_are_not_ported(flags, monkeypatch, capsys):
    """The JAX script's extra modes, both ported since: ``--seeds`` (the
    stacked sweep) and ``--bf16``, each at 8 envs here, under the ids their
    refusals had."""
    monkeypatch.setattr(bench, "NUM_ENVS", 8)
    monkeypatch.setattr(bench, "PREPOP_STEPS", 8_000)
    # One intra-op thread: the spare cores serve the other test processes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        line = bench.main(["--device", "cpu", "--iters", "1", *flags])
    finally:
        torch.set_num_threads(threads)
    assert json.loads(capsys.readouterr().out.strip()) == line
    suffix = "_x2seeds" if "--seeds" in flags else "_bf16"
    assert line["metric"] == (
        "carflag_dtqn_torch_env_steps_per_s_1to1_updates" + suffix)
    assert line["device"] == "cpu" and line["value"] > 0
