"""The comparison that decides ``correct``.

Training from the same seeds, weights and draws is chaotic: on the CPU at
the cells' widths the program's and the plain reference's TD losses, equal
to rounding for the first updates, drift apart by about e every dozen
updates (1e-7 at update 10, 3e-4 at 64, 0.06 at 200, order 1 by 300).  So
the comparison is made where the two still agree to rounding, in two
stages, each through the chunk's own object:

- the start: the program's first iteration (on the card its chunk's
  capture, which runs the iteration for real) against the reference run
  from the seed through prepopulation and that iteration;
- the replay: the program's next iteration, one replay of the captured
  graph, against the reference continued from the program's learned state
  after the start (weights, target, Adam's moments and count, bags; its
  envs, contexts, replay and generators are its own, which the start
  found equal to the program's);
- the late stage: one more iteration through the same object after the
  window, where epsilon has annealed so that some envs act greedily, at
  the iteration whose updates reach the next multiple of the target
  period, against the reference continued from the program's whole state
  before it (its envs, contexts, replay, counters and generators too: the
  window's chaotic updates cannot be followed).  It covers the act
  forward and the greedy actions, which the earlier stages take at
  epsilon about 1, and the target swap, which comes every
  ``target_update`` updates.

Readings (each held against its limit in ``perfbench/limits/<cell>.json``;
a limit of null there reads the number and notes it, and compares it not):

- ``start_mismatch`` / ``replay_mismatch``: elements that differ, exactly,
  over the envs, the current observations, the contexts, the replay ring,
  the bags' fill and the counters (env steps, applied updates, epsilon,
  non-finite steps, Adam's count).  Limit 0.
- ``start_loss_gap`` / ``loss_gap``: over the stage's first ``FIRST``
  updates' TD losses (the program's diagnostics ring), each |loss -
  reference loss| over the larger of the reference's loss and its median
  over the stage; the median of those ``FIRST`` gaps, the worst over
  seeds.  The median, not the worst update: now and then one update
  parts the two sides by far more than rounding (a gradient norm by up
  to 1.5e-3 on the card) while the updates before it agree to rounding,
  as one discrete choice that rounding tips would (a Double DQN argmax
  between two actions whose Q values tie to rounding, say).  A fault, or
  a lower precision, moves every update from the first; such an event
  moves none before its own, so the median passes one that falls on the
  last of the three (the worst update goes to the run's notes).
- ``start_gnorm_gap`` / ``gnorm_gap``: the same of each update's global
  gradient norm, as the clip gets it.
- ``moment_gap``: after the replay, the median leaf's gap between the
  norms of Adam's first moment (the clipped gradients as the optimizer
  holds them), | |m| - |m_ref| |, over the larger of |m_ref| and the
  median leaf's |m_ref|.  The median, not the worst leaf: the replay's 64
  updates reach the chaotic drift, and a few small leaves then read it
  (the worst leaf goes to the run's notes).
- ``param_change_gap``: the same of each leaf's change over the replay.
- ``late_mismatch``, ``late_loss_gap``, ``late_gnorm_gap``: the same
  over the late stage.  A greedy action that differs from the
  reference's argmax shows in the exact part (its env, context and replay
  rows), as a random one that differs from the reference's draw does.
- ``target_gap``: after the late stage, the median leaf's gap between
  the norms of the target weights' change over it (the swap's), over the
  larger of the reference leaf's and the median leaf's, among the leaves
  whose target the reference moved (``target_gap`` says why).  The swap
  comes at the stage's 16th, 32nd, 48th or 64th update (10 000 k mod
  64), and the updates before it drift as the replay's do, so the median
  leaf, as there.  A target that never takes the weights reads 1.
- ``evict_regret`` (bag cells): at the replay's env step, the worst
  shortfall of the program's evict choice by the reference's scores: the
  best candidate's score less that of the candidate the program's bag
  holds, relative.  Not whether the two bags are equal: at these weights
  candidates often score within rounding of each other, and the two
  sides then pick different ones of them.

Leaves whose gradient is nought to rounding in the reference (its |m_ref|
under ``NEGLIGIBLE`` of the median leaf's, as a key bias under the
softmax) move under Adam by round-off alone: they are left out of the two
per-leaf gaps, by that rule and not by name.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

FIRST = 3  # updates compared per stage
NEGLIGIBLE = 1e-3
EXACT_PREFIXES = ("env.", "obs", "context.", "replay.", "bag.pos",
                  "env_steps", "train_steps", "epsilon", "nonfinite",
                  "adam_count")


def _exact_keys(obs: Dict[str, torch.Tensor]) -> List[str]:
    return sorted(k for k in obs if k.startswith(EXACT_PREFIXES))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              counted: List[str]) -> torch.Tensor:
    """Each leaf's | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|, over ``counted`` leaves: [S, leaves]."""
    p = torch.stack([prog[k].flatten(1).norm(dim=1) for k in counted], 1)
    r = torch.stack([ref[k].flatten(1).norm(dim=1) for k in counted], 1)
    scale = torch.maximum(r, r.median(dim=1, keepdim=True).values)
    return (p - r).abs() / scale


def median_leaf(gaps: torch.Tensor, counted: List[str], what: str,
                notes: List[str]) -> float:
    """The median leaf's gap, the worst over seeds; the worst leaf goes to
    ``notes``."""
    worst = int(gaps.max(dim=0).values.argmax())
    notes.append(f"{what}: worst leaf {counted[worst]} "
                 f"{float(gaps[:, worst].max())!r}")
    return float(gaps.median(dim=1).values.max())


def moving_leaves(mu_ref: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient (Adam's first moment) is at least
    ``NEGLIGIBLE`` of the median leaf's, on every seed."""
    names = sorted(mu_ref)
    norms = torch.stack([mu_ref[k].flatten(1).norm(dim=1) for k in names], 1)
    floor = NEGLIGIBLE * norms.median(dim=1, keepdim=True).values
    keep = (norms >= floor).all(dim=0)
    return [k for k, ok in zip(names, keep.tolist()) if ok]


def evict_regret(prog: Dict[str, torch.Tensor], last_evict: Dict[str,
                 torch.Tensor], done: torch.Tensor) -> float:
    """The worst shortfall of the program's evict choice at the replay's
    env step: over the envs that chose (a full bag, the evictee not
    accepted, the episode not over), the reference's best candidate score
    less its score of the candidate the program's bag holds, over the
    larger of that best and the median env's.  Inf where the program's bag
    is none of the candidates."""
    check = (last_evict["need"] & ~done).cpu()
    if not bool(check.any()):
        return 0.0
    match = torch.ones(last_evict["scores"].shape, dtype=torch.bool)
    for k in ("obs", "action", "obs_idx"):
        cand = last_evict[k].cpu()  # [N, C, size, ...]
        same = cand == prog[f"bag.{k}"][:, None]
        match &= same.reshape(*same.shape[:2], -1).all(-1)
    scores = last_evict["scores"].cpu().to(torch.float64)
    chosen = torch.where(match, scores, torch.full_like(scores,
                                                        -float("inf")))
    best = scores.max(-1).values
    scale = torch.clamp_min(best.abs(), best.abs().median())
    regret = (best - chosen.max(-1).values) / scale
    return float(regret[check].max())


def exact_mismatch(prog, ref) -> Tuple[float, List[str]]:
    """Elements that differ over the exact part, and where."""
    differ, mismatch = [], 0
    for k in _exact_keys(ref):
        if k not in prog or prog[k].shape != ref[k].shape:
            differ.append(f"{k} (missing or reshaped)")
            mismatch += ref[k].numel()
            continue
        n = int((prog[k] != ref[k]).sum())
        if n:
            differ.append(f"{k} ({n})")
            mismatch += n
    return float(mismatch), differ


def update_gaps(prog, ref, key: str, updates: int) -> torch.Tensor:
    """Relative gaps of ``key`` over the last ``updates`` updates, scaled
    by the stage's median: [S, updates]; a missing or non-finite value is a
    full miss."""
    p, r = prog[key][:, -updates:], ref[key][:, -updates:]
    scale = torch.clamp_min(r.abs(), r.abs().median(dim=1,
                                                    keepdim=True).values)
    return torch.nan_to_num((p - r).abs() / scale, nan=float("inf"))


def first_updates_gap(prog, ref, key: str, updates: int,
                      notes: List[str], what: str) -> float:
    """The median gap over the stage's first ``FIRST`` updates, the worst
    over seeds; the worst single update goes to ``notes``."""
    gaps = update_gaps(prog, ref, key, updates)[:, :FIRST]
    notes.append(f"{what}: worst of the first {FIRST} updates "
                 f"{float(gaps.max())!r}")
    return float(gaps.median(dim=1).values.max())


def start_readings(prog, ref, updates: int) -> Tuple[Dict[str, float],
                                                     List[str]]:
    mismatch, differ = exact_mismatch(prog, ref)
    notes = [f"start: {d}" for d in differ]
    return {"start_mismatch": mismatch,
            "start_loss_gap": first_updates_gap(prog, ref, "losses", updates,
                                                notes, "start: loss gap"),
            "start_gnorm_gap": first_updates_gap(prog, ref, "gnorms", updates,
                                                 notes, "start: gnorm gap")}, \
        notes


def replay_readings(prog, ref, before, updates: int, last_evict=None,
                    done=None) -> Tuple[Dict[str, float], List[str]]:
    """``before``: the learned state both continued from; ``last_evict``
    and ``done``: the reference's evict at the replay's env step, and the
    episodes that ended there (bag cells)."""
    mismatch, differ = exact_mismatch(prog, ref)
    notes = [f"replay: {d}" for d in differ]
    out = {"replay_mismatch": mismatch,
           "loss_gap": first_updates_gap(prog, ref, "losses", updates, notes,
                                         "replay: loss gap"),
           "gnorm_gap": first_updates_gap(prog, ref, "gnorms", updates, notes,
                                          "replay: gnorm gap")}
    notes.append("replay: loss gap at the last update "
                 f"{float(update_gaps(prog, ref, 'losses', updates)[:, -1].max())!r}")
    names = sorted(k[len("params."):] for k in ref if k.startswith("params."))
    mu_ref = {k: ref[f"mu.{k}"] for k in names}
    counted = moving_leaves(mu_ref)
    out["moment_gap"] = median_leaf(
        leaf_gaps({k: prog[f"mu.{k}"] for k in names}, mu_ref, counted),
        counted, "replay: moment gap", notes)
    out["param_change_gap"] = median_leaf(leaf_gaps(
        {k: prog[f"params.{k}"] - before[f"params.{k}"] for k in names},
        {k: ref[f"params.{k}"] - before[f"params.{k}"] for k in names},
        counted), counted, "replay: change gap", notes)
    if last_evict is not None:
        out["evict_regret"] = evict_regret(prog, last_evict, done)
    return out, notes


def target_gap(prog, ref, before, notes: List[str]) -> float:
    """The median leaf's gap of the target's change over the late stage,
    the worst over seeds, over the leaves whose target the reference
    moved: a seed whose units have all died trains only its output bias,
    so that most of its leaves, and of its target's, stay where the last
    swap left them.  A seed whose target the reference left unmoved (no
    swap) has to be left unmoved, exactly."""
    names = sorted(k for k in ref if k.startswith("target."))

    def norms(side):
        return torch.stack([(side[k] - before[k]).flatten(1).norm(dim=1)
                            for k in names], 1)

    p, r = norms(prog), norms(ref)
    worst, moved_counts, per_seed = 0.0, [], []
    for s in range(r.shape[0]):
        moved = r[s] > 0
        moved_counts.append(int(moved.sum()))
        if not bool(moved.any()):
            if bool((p[s] != 0).any()):
                return float("inf")
            continue
        rs = r[s][moved]
        gaps = torch.nan_to_num((p[s][moved] - rs).abs()
                                / torch.clamp_min(rs, rs.median()),
                                nan=float("inf"))
        worst = max(worst, float(gaps.median()))
        per_seed.append(f"{float(gaps.median()):.3g} "
                        f"(worst {float(gaps.max()):.3g})")
    notes.append(f"late: target leaves the reference moved {moved_counts} "
                 f"of {len(names)}; median leaf gap by seed {per_seed}")
    return worst


def late_readings(prog, ref, before, updates: int, greedy: int
                  ) -> Tuple[Dict[str, float], List[str]]:
    """``before``: the program's whole state the late stage started from;
    ``greedy``: how many envs acted greedily in it (the reference's
    draws)."""
    mismatch, differ = exact_mismatch(prog, ref)
    notes = [f"late: {d}" for d in differ]
    notes.append(f"late: {greedy} greedy actions; train steps "
                 f"{ref['train_steps'].tolist()}")
    out = {"late_mismatch": mismatch,
           "late_loss_gap": first_updates_gap(prog, ref, "losses", updates,
                                              notes, "late: loss gap"),
           "late_gnorm_gap": first_updates_gap(prog, ref, "gnorms", updates,
                                               notes, "late: gnorm gap"),
           "target_gap": target_gap(prog, ref, before, notes)}
    return out, notes


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> bool:
    """Every number at or under its limit, and no limit without its
    number or number without its limit.  A limit of ``None`` (``null`` in
    the limits file) names a number that the cell reads but does not
    compare: no limit separates its sound readings from a fault's there."""
    if set(values) != set(limits):
        return False
    return all(values[k] <= limits[k] for k in values
               if limits[k] is not None)


def checks(values: Dict[str, float], limits: Dict[str, Optional[float]]
           ) -> Tuple[Dict[str, dict], List[str]]:
    """The compared numbers, each beside its limit, and a note for each
    number read but not compared."""
    return ({k: {"value": values[k], "limit": limits.get(k)}
             for k in sorted(values) if limits.get(k, 0) is not None},
            [f"not compared: {k} {values[k]!r}" for k in sorted(values)
             if k in limits and limits[k] is None])
