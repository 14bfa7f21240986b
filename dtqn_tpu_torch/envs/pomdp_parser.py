"""Cassandra ``.pomdp`` file parser (``dtqn_tpu/envs/pomdp_parser.py``).

Parses a Cassandra-format file into dense (T, O, R, start) arrays for
``dtqn_tpu_torch.envs.pomdp.TabularPOMDP``: the reference reaches classic
POMDPs through gym-pomdps and rl-parsers (its README.md:102-103).

Grammar (the subset the classic benchmark files use):
  - ``discount: f``, ``values: reward|cost``
  - ``states|actions|observations: N | name...``
  - ``start: uniform | p... | <state-name>``
  - ``T: a : s : s' p`` / ``T: a : s`` + row / ``T: a`` + matrix |
    ``identity`` | ``uniform``
  - ``O: a : s' : o p`` / ``O: a : s'`` + row / ``O: a`` + matrix |
    ``uniform``
  - ``R: a : s : s' : o v`` (o/s' may be ``*``)
  - ``*`` wildcards for action/state fields, ``#`` comments

The C++ parser (``native/pomdp_parser.cc``, built by ``make -C native``
into ``native/libpomdp_parser.so``) parses the same grammar into the same
arrays; it is loaded by path through ctypes and never rebuilt here.  The
Python parser serves when the library is absent or does not load on this
system; ``native_parser_loads()`` says which.  Plain numpy and ctypes: no
part of this module touches the device.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class ParsedPOMDP:
    discount: float
    states: List[str]
    actions: List[str]
    observations: List[str]
    start: np.ndarray  # [S]
    T: np.ndarray  # [S, A, S]
    O: np.ndarray  # [A, S', O]
    R: np.ndarray  # [S, A, S']  (expected over observations)


def _names(tokens: Sequence[str], prefix: str) -> List[str]:
    if len(tokens) == 1 and tokens[0].isdigit():
        return [f"{prefix}{i}" for i in range(int(tokens[0]))]
    return list(tokens)


class _Parser:
    def __init__(self, text: str):
        # Strip comments, drop blanks, keep logical lines.
        self.lines: List[str] = []
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if line:
                self.lines.append(line)
        self.i = 0
        self.discount = 0.95
        self.cost = False
        self.states: List[str] = []
        self.actions: List[str] = []
        self.observations: List[str] = []
        self.start: Optional[np.ndarray] = None
        self.T = self.O = self.R = None

    def _idx(self, names: List[str], tok: str) -> List[int]:
        if tok == "*":
            return list(range(len(names)))
        if tok.lstrip("-").isdigit():
            return [int(tok)]
        return [names.index(tok)]

    def _ensure_arrays(self):
        if self.T is None:
            s, a, o = len(self.states), len(self.actions), len(self.observations)
            self.T = np.zeros((s, a, s), np.float64)
            self.O = np.zeros((a, s, o), np.float64)
            self.R = np.zeros((s, a, s), np.float64)

    def _floats(self, line: str) -> List[float]:
        return [float(x) for x in line.split()]

    def parse(self) -> ParsedPOMDP:
        while self.i < len(self.lines):
            line = self.lines[self.i]
            self.i += 1
            key, _, rest = line.partition(":")
            key = key.strip()
            rest = rest.strip()
            if key == "discount":
                self.discount = float(rest)
            elif key == "values":
                self.cost = rest == "cost"
            elif key == "states":
                self.states = _names(rest.split(), "s")
            elif key == "actions":
                self.actions = _names(rest.split(), "a")
            elif key == "observations":
                self.observations = _names(rest.split(), "o")
            elif key == "start":
                self._ensure_arrays()
                if not rest:
                    rest = self.lines[self.i]
                    self.i += 1
                if rest == "uniform":
                    self.start = np.full(
                        len(self.states), 1.0 / len(self.states)
                    )
                else:
                    toks = rest.split()
                    try:
                        self.start = np.asarray(
                            [float(t) for t in toks], np.float64
                        )
                    except ValueError:
                        self.start = np.zeros(len(self.states))
                        for t in toks:
                            for s in self._idx(self.states, t):
                                self.start[s] = 1.0
                        self.start /= self.start.sum()
            elif key == "T":
                self._ensure_arrays()
                self._parse_T(rest)
            elif key == "O":
                self._ensure_arrays()
                self._parse_O(rest)
            elif key == "R":
                self._ensure_arrays()
                self._parse_R(rest)
            # Unknown keys are ignored (e.g. "E:" extensions).

        if self.start is None:
            self._ensure_arrays()
            self.start = np.full(len(self.states), 1.0 / len(self.states))
        sign = -1.0 if self.cost else 1.0
        return ParsedPOMDP(
            discount=self.discount,
            states=self.states,
            actions=self.actions,
            observations=self.observations,
            start=self.start.astype(np.float32),
            T=self.T.astype(np.float32),
            O=self.O.astype(np.float32),
            R=(sign * self.R).astype(np.float32),
        )

    def _parse_T(self, rest: str):
        parts = [p.strip() for p in rest.split(":")]
        acts = self._idx(self.actions, parts[0])
        n = len(self.states)
        if len(parts) == 3:
            tok, prob = parts[2].split() if " " in parts[2] else (parts[2], None)
            if prob is None:
                prob = self.lines[self.i]
                self.i += 1
            for a in acts:
                for s in self._idx(self.states, parts[1]):
                    for s2 in self._idx(self.states, tok):
                        self.T[s, a, s2] = float(prob)
        elif len(parts) == 2:
            row = self._floats(self.lines[self.i])
            self.i += 1
            for a in acts:
                for s in self._idx(self.states, parts[1]):
                    self.T[s, a, :] = row
        else:
            spec = self.lines[self.i]
            self.i += 1
            if spec == "identity":
                for a in acts:
                    self.T[:, a, :] = np.eye(n)
            elif spec == "uniform":
                for a in acts:
                    self.T[:, a, :] = 1.0 / n
            else:
                rows = [self._floats(spec)]
                for _ in range(n - 1):
                    rows.append(self._floats(self.lines[self.i]))
                    self.i += 1
                for a in acts:
                    self.T[:, a, :] = rows

    def _parse_O(self, rest: str):
        parts = [p.strip() for p in rest.split(":")]
        acts = self._idx(self.actions, parts[0])
        n, m = len(self.states), len(self.observations)
        if len(parts) == 3:
            tok, prob = parts[2].split() if " " in parts[2] else (parts[2], None)
            if prob is None:
                prob = self.lines[self.i]
                self.i += 1
            for a in acts:
                for s2 in self._idx(self.states, parts[1]):
                    for o in self._idx(self.observations, tok):
                        self.O[a, s2, o] = float(prob)
        elif len(parts) == 2:
            row = self._floats(self.lines[self.i])
            self.i += 1
            for a in acts:
                for s2 in self._idx(self.states, parts[1]):
                    self.O[a, s2, :] = row
        else:
            spec = self.lines[self.i]
            self.i += 1
            if spec == "uniform":
                for a in acts:
                    self.O[a, :, :] = 1.0 / m
            else:
                rows = [self._floats(spec)]
                for _ in range(n - 1):
                    rows.append(self._floats(self.lines[self.i]))
                    self.i += 1
                for a in acts:
                    self.O[a, :, :] = rows

    def _parse_R(self, rest: str):
        # R: a : s : s' : o v  — we fold the obs dimension into an expected
        # reward R[s, a, s'] (observation-dependent rewards are rare in the
        # classic files and always '*' there).
        parts = [p.strip() for p in rest.split(":")]
        acts = self._idx(self.actions, parts[0])
        last = parts[3].split()
        if len(last) == 2:
            obs_tok, val = last
        else:
            obs_tok, val = last[0], self.lines[self.i]
            self.i += 1
        del obs_tok  # expected-reward fold: value independent of obs
        for a in acts:
            for s in self._idx(self.states, parts[1]):
                for s2 in self._idx(self.states, parts[2]):
                    self.R[s, a, s2] = float(val)


def parse_pomdp_text(text: str) -> ParsedPOMDP:
    """Parse Cassandra-format text (pure Python)."""
    return _Parser(text).parse()


_NATIVE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libpomdp_parser.so",
)


def _load_native():
    if not os.path.exists(_NATIVE_PATH):
        return None
    try:
        lib = ctypes.CDLL(_NATIVE_PATH)
    except OSError:  # built for another system: the Python parser serves
        return None
    lib.pomdp_parse.restype = ctypes.c_void_p
    lib.pomdp_parse.argtypes = [ctypes.c_char_p]
    lib.pomdp_dims.restype = None
    lib.pomdp_dims.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.pomdp_fill.restype = ctypes.c_double
    lib.pomdp_fill.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_float)
    ] * 4
    lib.pomdp_free.restype = None
    lib.pomdp_free.argtypes = [ctypes.c_void_p]
    return lib


_native_lib = None


def native_parser_loads() -> bool:
    """Whether ``native/libpomdp_parser.so`` loads here, so that
    ``parse_pomdp_file`` uses it."""
    global _native_lib
    if _native_lib is None:
        _native_lib = _load_native()
    return _native_lib is not None


def parse_pomdp_text_native(text: str) -> Optional[ParsedPOMDP]:
    """Parse via the C++ library; None when the library does not load."""
    if not native_parser_loads():
        return None
    handle = _native_lib.pomdp_parse(text.encode())
    if not handle:
        raise ValueError("native .pomdp parse failed")
    try:
        dims = (ctypes.c_int * 3)()
        _native_lib.pomdp_dims(handle, dims)
        s, a, o = dims[0], dims[1], dims[2]
        T = np.zeros((s, a, s), np.float32)
        O = np.zeros((a, s, o), np.float32)
        R = np.zeros((s, a, s), np.float32)
        start = np.zeros((s,), np.float32)
        discount = _native_lib.pomdp_fill(
            handle,
            T.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            O.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            R.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            start.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return ParsedPOMDP(
            discount=float(discount),
            states=[f"s{i}" for i in range(s)],
            actions=[f"a{i}" for i in range(a)],
            observations=[f"o{i}" for i in range(o)],
            start=start,
            T=T,
            O=O,
            R=R,
        )
    finally:
        _native_lib.pomdp_free(handle)


def parse_pomdp_file(path: str, prefer_native: bool = True) -> ParsedPOMDP:
    with open(path) as f:
        text = f.read()
    if prefer_native:
        parsed = parse_pomdp_text_native(text)
        if parsed is not None:
            return parsed
    return parse_pomdp_text(text)


def absorbing_states(parsed: ParsedPOMDP) -> np.ndarray:
    """Detect absorbing zero-reward states -> episodic terminal flags.

    The Cassandra format has no explicit terminal marker; gym-pomdps'
    "-episodic" variants derive done-ness from reset/absorbing structure.
    A state is treated as terminal when every action self-loops with
    probability 1 and yields zero reward (nothing further can happen).
    Continuing domains (e.g. tiger) have none; episodes then end by
    TimeLimit, matching the reference's gym TimeLimit wrapper.
    """
    S = len(parsed.states)
    self_loop = np.array(
        [all(parsed.T[s, a, s] >= 1.0 - 1e-9 for a in range(len(parsed.actions)))
         for s in range(S)]
    )
    no_reward = np.abs(parsed.R).sum(axis=(1, 2)) < 1e-12
    return self_loop & no_reward


def make_tabular_env(
    parsed: ParsedPOMDP,
    *,
    name: str = "POMDP-file-v0",
    max_episode_steps: int = 100,
    terminal_states: Optional[Sequence[int]] = None,
):
    """Wrap a parsed POMDP as a TabularPOMDP environment.

    ``terminal_states=None`` auto-detects absorbing zero-reward states.
    """
    from dtqn_tpu_torch.envs.pomdp import TabularPOMDP

    if terminal_states is None:
        terminal = absorbing_states(parsed)
    else:
        terminal = np.zeros((len(parsed.states),), bool)
        for s in terminal_states:
            terminal[s] = True
    init_obs = parsed.O[0]
    return TabularPOMDP(
        name=name,
        T=parsed.T,
        O=parsed.O,
        R=parsed.R,
        start=parsed.start,
        terminal=terminal,
        init_obs=init_obs,
        max_episode_steps=max_episode_steps,
    )


# --------------------------------------------------------------- writer
def _fmt32(p: float) -> str:
    """Shortest decimal that round-trips float32 (exact re-parse)."""
    return np.format_float_positional(np.float32(p), unique=True, trim="0")


def pomdp_to_cassandra(
    T: np.ndarray,
    O: np.ndarray,
    R: np.ndarray,
    start: np.ndarray,
    discount: float = 0.95,
    header: str = "",
) -> str:
    """Serialize (T [S,A,S], O [A,S,O], R [S,A,S]) to Cassandra .pomdp text.

    Complements the parser: sparse one-entry-per-line form, float32-exact
    round trip (``parse_pomdp_text(pomdp_to_cassandra(...))`` reproduces
    the arrays bit-for-bit).  The JAX package wrote `data/hallway.pomdp`
    from its reconstruction with it (tools/export_pomdp.py).
    """
    S, A, _ = T.shape
    n_obs = O.shape[2]
    out = []
    if header:
        out += [f"# {line}" for line in header.splitlines()]
    out += [
        "discount: " + _fmt32(discount),
        "values: reward",
        f"states: {S}",
        f"actions: {A}",
        f"observations: {n_obs}",
        "start:",
        " ".join(_fmt32(p) for p in start),
        "",
    ]
    for a in range(A):
        for s in range(S):
            for s2 in np.nonzero(T[s, a])[0]:
                out.append(f"T: {a} : {s} : {int(s2)} {_fmt32(T[s, a, s2])}")
    out.append("")
    for a in range(A):
        for s2 in range(S):
            for o in np.nonzero(O[a, s2])[0]:
                out.append(f"O: {a} : {s2} : {int(o)} {_fmt32(O[a, s2, o])}")
    out.append("")
    for s in range(S):
        for a in range(A):
            for s2 in np.nonzero(R[s, a])[0]:
                out.append(
                    f"R: {a} : {s} : {int(s2)} : * {_fmt32(R[s, a, s2])}"
                )
    out.append("")
    return "\n".join(out)
