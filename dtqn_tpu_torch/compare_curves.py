"""Two runs' evaluation curves side by side, by windows of env steps.

    python -m dtqn_tpu_torch.compare_curves RUN_RESULTS.csv REF_RESULTS.csv
        [--window 100000] [--upto STEP] [--last 20]

Each file is a run's ``*_results.csv`` (``utils/logging.py``'s columns:
Hours, Step, then ``{env}/SuccessRate``, ``{env}/EpisodeLength`` and
``{env}/Return``, one row per evaluation), of the port or of the JAX
package.  For both it prints one JSON line per window of ``--window`` env
steps up to ``--upto`` (default: the first file's last step): the rows in
the window and their mean return, episode length and success rate; then
the same means over each file's last ``--last`` rows up to ``--upto``.
One seed against one seed is evidence, not a test: seeded runs of the two
frameworks draw differently.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List, Optional, Sequence

METRICS = ("Return", "EpisodeLength", "SuccessRate")


def load(path: str) -> List[Dict[str, float]]:
    """Rows of a results CSV: {"Step", "Return", "EpisodeLength",
    "SuccessRate"} (the first env's columns)."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise ValueError(f"{path} holds no evaluation")
    env = next(k for k in rows[0] if k.endswith("/Return")).split("/")[0]
    return [{"Step": int(float(r["Step"])),
             **{m: float(r[f"{env}/{m}"]) for m in METRICS}} for r in rows]


def means(rows: Sequence[Dict[str, float]]) -> Dict[str, float]:
    n = len(rows)
    return {"rows": n, **{m: (sum(r[m] for r in rows) / n if n else None)
                          for m in METRICS}}


def compare(run: List[Dict[str, float]], ref: List[Dict[str, float]],
            window: int, upto: Optional[int] = None, last: int = 20):
    """[(label, run means, ref means)]: each window, then the last rows."""
    upto = run[-1]["Step"] if upto is None else upto
    out = []
    for lo in range(0, upto, window):
        hi = min(lo + window, upto)
        out.append((f"({lo}, {hi}]",
                    *(means([r for r in rows if lo < r["Step"] <= hi])
                      for rows in (run, ref))))
    out.append((f"last {last} up to {upto}",
                *(means([r for r in rows if r["Step"] <= upto][-last:])
                  for rows in (run, ref))))
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run")
    p.add_argument("reference")
    p.add_argument("--window", type=int, default=100_000)
    p.add_argument("--upto", type=int, default=None)
    p.add_argument("--last", type=int, default=20)
    args = p.parse_args(argv)
    out = compare(load(args.run), load(args.reference), args.window,
                  args.upto, args.last)
    for label, run, ref in out:
        print(json.dumps({"steps": label, "run": run, "reference": ref}))
    return out


if __name__ == "__main__":
    main()
