"""What every configuration's work counts share: the card's peaks, the
unmasked pairs of an attention, and the least time of one attention
launch.  A configuration's own counts (its model FLOPs an iteration and
its attention launches) sit in the ``"work"`` module its file names.

``bound_ms`` is the least time of one attention launch on an H100 SXM:
its inputs read and its outputs written once over HBM, or its products
over the configuration's rate, whichever is larger, from the launch's own
heads, query-key width and value width.  The forward reads Q, K, V and
writes O, with two products over the unmasked pairs (Q K^T at the
query-key width, P V at the value width); the backward reads Q, K, V and
dO and writes dQ, dK, dV, with five products, as the recompute backward
does (Q K^T, dS K and dS^T Q at the query-key width, dO V^T and P^T dO
at the value width).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``peaks.json``),
    matched by the longest name that ``kind`` contains."""
    table = json.loads((HERE / "peaks.json").read_text())["cards"]
    hits = [k for k in table if k in kind]
    if not hits:
        raise KeyError(f"no peaks for {kind!r}: {sorted(table)}")
    return table[max(hits, key=len)]


def causal_pairs(lq: int, lk: int, causal: bool) -> int:
    return lq * (lq + 1) // 2 if causal else lq * lk


class Application(NamedTuple):
    """Launches of one attention shape in an iteration."""

    kind: str  # "attention_fwd" or "attention_bwd"
    batch: int
    lq: int
    lk: int
    causal: bool
    count: int  # per iteration
    heads: int
    dk: int  # query-key width of a head
    dv: int  # value width of a head


def bound_ms(a: Application, bytes_per_s: float, flops_per_s: float,
             size: int = 4) -> float:
    """Least time of one launch of ``a``: max(bytes / HBM rate, FLOPs /
    rate)."""
    pairs = causal_pairs(a.lq, a.lk, a.causal)
    if a.kind == "attention_fwd":  # reads q, k, v; writes out
        widths = a.lq * (a.dk + a.dv) + a.lk * (a.dk + a.dv)
        products = a.dk + a.dv
    else:  # reads q, k, v, dout; writes dq, dk, dv
        widths = a.lq * (2 * a.dk + a.dv) + a.lk * 2 * (a.dk + a.dv)
        products = 3 * a.dk + 2 * a.dv
    nbytes = size * a.batch * a.heads * widths
    flops = 2 * a.batch * a.heads * products * pairs
    return 1e3 * max(nbytes / bytes_per_s, flops / flops_per_s)
