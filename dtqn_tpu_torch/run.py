"""CLI entry point: train a Q-network agent on one GPU.

Flag-compatible with the reference CLI (run.py:16-184) and the JAX
package's ``run.py``.  Examples:

    python -m dtqn_tpu_torch.run --envs DiscreteCarFlag-v0 \
        --num-steps 50000 --in-embed 64 --num-envs 64 --verbose

    python -m dtqn_tpu_torch.run --model DRQN --envs Memory-5-v0
    python -m dtqn_tpu_torch.run --envs POMDP-hallway-episodic-v0 \
        --in-embed 64
    python -m dtqn_tpu_torch.run --envs data/hallway.pomdp

    # Seeds 1-5 at once (the multi-seed sweep, train/sweep.py):
    python -m dtqn_tpu_torch.run --envs DiscreteCarFlag-v0 --in-embed 64 \
        --seeds 1 2 3 4 5

    # On the CPU (the default is the GPU, and fails when there is none):
    python -m dtqn_tpu_torch.run --device cpu --envs Memory-5-v0 \
        --num-steps 2000 --verbose

    # One run sharded over 2 ranks (processes started here; under torchrun
    # each process is one rank of the launcher's group):
    python -m dtqn_tpu_torch.run --envs DiscreteCarFlag-v0 --in-embed 64 \
        --num-envs 64 --dp-devices 2
    torchrun --nproc-per-node 2 -m dtqn_tpu_torch.run --dp-devices 2 ...

    # MiniHack (needs the minihack package): the host loop
    # (train/host_loop.py), host envs stepped between device calls:
    python -m dtqn_tpu_torch.run --envs MH-Room-5-v0 --verbose
"""

from dtqn_tpu_torch.config import get_args


def main(argv=None) -> dict:
    config = get_args(argv)
    if any(n.startswith("MH-") for n in config.envs):
        # MiniHack is C-backed host code: the host loop.
        from dtqn_tpu_torch.train.host_loop import run_host_experiment

        if config.seeds:
            config.seed = config.seeds[0]
        return run_host_experiment(config)
    if len(config.seeds) > 1:
        from dtqn_tpu_torch.train.sweep import run_sweep

        return run_sweep(config, config.seeds)
    from dtqn_tpu_torch.train.runner import run_experiment

    if config.seeds:
        config.seed = config.seeds[0]
    return run_experiment(config)


if __name__ == "__main__":
    main()
