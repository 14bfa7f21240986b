"""The port stands alone: no module of ``dtqn_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and entry
points refuse to fall back to the CPU silently."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dtqn_tpu")


def port_sources():
    root = os.path.join(REPO, "dtqn_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "_build"]  # built, git-ignored
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    paths = port_sources()
    names = {os.path.relpath(p, REPO) for p in paths}
    # The scan really walks the package: every slice's modules are in.
    assert names >= {
        "chip_smoke.py", "dtqn_tpu_torch/run.py", "dtqn_tpu_torch/bench.py",
        "dtqn_tpu_torch/config.py", "dtqn_tpu_torch/bridge.py",
        "dtqn_tpu_torch/train/runner.py", "dtqn_tpu_torch/train/loop.py",
        "dtqn_tpu_torch/envs/memory_cards.py",
        "dtqn_tpu_torch/utils/checkpoint.py",
        "dtqn_tpu_torch/utils/logging.py", "dtqn_tpu_torch/utils/rng.py",
        "dtqn_tpu_torch/ops/cuda_attention.py",
        "dtqn_tpu_torch/replay/bag.py", "dtqn_tpu_torch/envs/gridverse.py",
        "dtqn_tpu_torch/envs/pomdp.py", "dtqn_tpu_torch/envs/pomdp_parser.py",
        "dtqn_tpu_torch/models/recurrent.py",
        "dtqn_tpu_torch/models/dropout.py",
        "dtqn_tpu_torch/envs/image_maze.py", "dtqn_tpu_torch/envs/multi.py",
        "dtqn_tpu_torch/models/stacked.py", "dtqn_tpu_torch/train/sweep.py",
        "dtqn_tpu_torch/utils/profiling.py",
        "dtqn_tpu_torch/envs/host.py", "dtqn_tpu_torch/envs/minihack.py",
        "dtqn_tpu_torch/train/host_loop.py",
        "dtqn_tpu_torch/sweep_checkpoint.py",
        "dtqn_tpu_torch/utils/graphs.py", "dtqn_tpu_torch/utils/tree.py",
        "dtqn_tpu_torch/compare_curves.py",
    }
    assert len(paths) > 30
    offenders = {
        os.path.relpath(p, REPO): root
        for p in paths for root in imported_roots(p) if root in FORBIDDEN
    }
    assert not offenders


def test_pomdp_parser_loads_the_native_library_by_path():
    """The port reads ``native/libpomdp_parser.so`` where it lies, through
    ctypes, and never builds it: the parser imports no process launcher
    (and no torch: it does not touch the device)."""
    from dtqn_tpu_torch.envs import pomdp_parser

    assert pomdp_parser._NATIVE_PATH == os.path.join(
        REPO, "native", "libpomdp_parser.so")
    path = os.path.join(REPO, "dtqn_tpu_torch", "envs", "pomdp_parser.py")
    assert set(imported_roots(path)) <= {
        "__future__", "ctypes", "os", "dataclasses", "typing", "numpy",
        "dtqn_tpu_torch",
    }


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = make_env("DiscreteCarFlag-v0")
    cfg = AgentConfig(num_envs=2, inner_embed=16, num_heads=2,
                      context_len=4, history=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Agent(cfg, env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Agent(cfg, env, device="cuda")
    assert Agent(cfg, env, device="cpu").device.type == "cpu"


def test_runner_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                           tmp_path):
    from dtqn_tpu_torch import bench, run
    from dtqn_tpu_torch.config import ExperimentConfig, get_args
    from dtqn_tpu_torch.train.runner import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert ExperimentConfig().device == "cuda" == get_args([]).device
    small = ["--in-embed", "16", "--heads", "2", "--context", "4",
             "--num-envs", "2"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment(get_args(small))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(small + ["--device", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--iters", "1", "--device", "cuda:0"])
    # The multi-seed sweep too.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(small + ["--seeds", "1", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--seeds", "2"])
    # The flagless bench raises before its variants' processes start.
    monkeypatch.setattr(bench.subprocess, "Popen", lambda *a, **k: pytest.fail(
        "the bench started a process"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    # The host loop (MiniHack's runner) too, before any env steps.
    from dtqn_tpu_torch.envs.host import HostEnvironment
    from dtqn_tpu_torch.train.host_loop import run_host_experiment

    class Untouched(HostEnvironment):
        def reset(self):
            pytest.fail("the host loop reset an env")

        def step(self, action):
            pytest.fail("the host loop stepped an env")

    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_host_experiment(get_args(small + ["--envs", "MH-Room-5-v0"]),
                            env_factory=lambda name: Untouched())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(small + ["--envs", "MH-Room-5-v0"])
    assert not os.listdir(tmp_path)  # nothing ran, nothing was written


def test_evaluate_runs_where_the_agent_is(monkeypatch):
    """``make_evaluate_fn`` has no device of its own: it evaluates on the
    agent's, and an agent is on the CPU only when the caller asked."""
    from dtqn_tpu_torch.agents import Agent, AgentConfig
    from dtqn_tpu_torch.envs import make_env
    from dtqn_tpu_torch.train.loop import make_evaluate_fn

    env = make_env("DiscreteCarFlag-v0")
    env.max_episode_steps = 5
    cfg = AgentConfig(num_envs=2, inner_embed=16, num_heads=2,
                      context_len=4, history=4)
    agent = Agent(cfg, env, device="cpu")
    network = agent.build_network()
    out = make_evaluate_fn(agent, env, 2)(network, torch.Generator())
    assert all(x.device.type == "cpu" for x in out)
    # Told that it sits on the card, it asks the card for every tensor and
    # does not carry on on the CPU.
    monkeypatch.setattr(agent, "device", torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        make_evaluate_fn(agent, env, 2)(network, torch.Generator())


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """A CUDA tensor launches the kernel or raises: with no nvcc the build
    raises instead of running the plain version."""
    from dtqn_tpu_torch.ops import cuda_attention, nvcc

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(cuda_attention, "_lib", None)
    monkeypatch.setattr(nvcc.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_attention, "_BUILD_DIR",
                        cuda_attention._BUILD_DIR / "absent")
    monkeypatch.setattr(cuda_attention, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(cuda_attention, "plain_attention_fwd",
                        lambda *a: pytest.fail("plain path taken"))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    q = torch.zeros(1, 4, 8).as_subclass(FakeCuda)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_attention.attention_fwd(q, q, q, 2, True)
