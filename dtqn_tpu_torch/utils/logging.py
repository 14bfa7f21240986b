"""Experiment logging: CSV with wandb-compatible schema, optional wandb
(``dtqn_tpu/utils/logging.py``).

As the reference's utils/logging_utils.py:31-136: the CSV logger writes
``<path>_results.csv`` and ``<path>_losses.csv`` with the exact reference
headers and exposes the same ``log(dict, step)`` call signature as wandb,
so either backend is interchangeable.  wandb is a soft dependency; the
group name derives from the same 11 config keys
(logging_utils.py:120-132).
"""

from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Dict, List

WANDB_GROUP_KEYS = [
    "model",
    "obs_embed",
    "a_embed",
    "in_embed",
    "context",
    "layers",
    "bag_size",
    "gate",
    "identity",
    "history",
    "pos",
]


def timestamp() -> str:
    return datetime.now().strftime("%B %d, %H:%M:%S")


class CSVLogger:
    """CSV logger matching the reference schema (logging_utils.py:42-109)."""

    def __init__(self, path: str, envs: List[str]):
        self.results_path = path + "_results.csv"
        self.losses_path = path + "_losses.csv"
        self.envs = envs
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(self.results_path):
            head = ["Hours", "Step"]
            for env in envs:
                head += [
                    f"{env}/SuccessRate",
                    f"{env}/EpisodeLength",
                    f"{env}/Return",
                ]
            with open(self.results_path, "w", newline="") as f:
                csv.writer(f).writerow(head)
        if not os.path.exists(self.losses_path):
            with open(self.losses_path, "w", newline="") as f:
                csv.writer(f).writerow(
                    [
                        "Hours",
                        "Step",
                        "TD Error",
                        "Grad Norm",
                        "Max Q Value",
                        "Mean Q Value",
                        "Min Q Value",
                        "Max Target Value",
                        "Mean Target Value",
                        "Min Target Value",
                    ]
                )

    def log(self, results: Dict[str, float], step: int) -> None:
        row = [results["losses/hours"], step]
        for env in self.envs:
            row += [
                results[f"{env}/SuccessRate"],
                results[f"{env}/EpisodeLength"],
                results[f"{env}/Return"],
            ]
        with open(self.results_path, "a", newline="") as f:
            csv.writer(f).writerow(row)
        with open(self.losses_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [
                    results["losses/hours"],
                    step,
                    results["losses/TD_Error"],
                    results["losses/Grad_Norm"],
                    results["losses/Max_Q_Value"],
                    results["losses/Mean_Q_Value"],
                    results["losses/Min_Q_Value"],
                    results["losses/Max_Target_Value"],
                    results["losses/Mean_Target_Value"],
                    results["losses/Min_Target_Value"],
                ]
            )


def get_logger(policy_path: str, config, wandb_kwargs=None):
    """wandb when available and enabled, else CSV (logging_utils.py:112-136)."""
    if not config.disable_wandb:
        try:
            import wandb

            cfg_dict = {
                k: getattr(config, k)
                for k in vars(config)
                if not k.startswith("_")
            }
            wandb.init(
                project=config.project_name,
                group="_".join(
                    f"{k}={cfg_dict[k]}"
                    for k in WANDB_GROUP_KEYS
                    if k in cfg_dict
                ),
                config=cfg_dict,
                **(wandb_kwargs or {}),
            )
            return wandb
        except ImportError:
            print("WARNING: wandb not installed; falling back to CSV logging")
    return CSVLogger(policy_path, config.envs)
