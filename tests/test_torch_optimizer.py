"""The learner's step after the gradient (``agents/base.py``:
``optimizer_step``) on the CPU, at narrow widths.

- A CPU tensor takes the plain chain, which leaves the parameters, moments,
  target, counters, norm and gate bit for bit as the inline sequence that
  ``apply_update`` ran before the step was fused: one seed's cases (the
  norm below and above the clip, gated off, a non-finite gradient, a
  target swap) and five stacked seeds that mix them.
- The kernels' split of a row (blocks a row from ``ops/cuda_optimizer.py``;
  the head before the first 16-byte boundary and the tail as
  ``csrc/optimizer.cu`` takes them, mirrored here) covers every element
  once, and the partial sums' layout every (seed, block) once.
- The launch counts are tracked through graph replays, and a CPU step
  launches nothing; a CUDA tensor launches the kernels or raises.

On the card ``chip_smoke.py`` phase 24 holds the kernels against the
chain.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dtqn_tpu_torch.agents import base
from dtqn_tpu_torch.agents.base import AdamState, clip_adam_update
from dtqn_tpu_torch.ops import cuda_optimizer as co
from dtqn_tpu_torch.ops import nvcc
from dtqn_tpu_torch.utils import graphs

LR, MAX_NORM, TARGET_EVERY = 3e-4, 1.0, 10_000


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's processes share the cores: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class Learner:
    """The fields of an ``AgentState`` that the step reads and writes."""

    params: torch.Tensor
    target_params: torch.Tensor
    opt_state: AdamState
    train_steps: torch.Tensor
    nonfinite_grads: torch.Tensor

    @property
    def seed_shape(self):
        return self.train_steps.shape


# (gradient scale, ok, a non-finite gradient, train_steps) per case; the
# norm of 37 draws at scale 0.05 is ~0.3, at 0.5 ~3.
CASES = {
    "below": (0.05, True, False, 12),
    "above": (0.5, True, False, 12),
    "gated": (0.5, False, False, 12),
    "nonfinite": (0.5, True, True, 12),
    "swap": (0.5, True, False, TARGET_EVERY - 1),
}
P = 37  # odd, as the Car Flag network's


def make(cases, seed=0):
    """A learner and its gradients for one case ([P]) or one seed a case
    ([S, P])."""
    rng = np.random.default_rng(seed)
    shape = (P,) if len(cases) == 1 else (len(cases), P)
    seeds = shape[:-1]

    def draw(scale):
        return torch.tensor((scale * rng.standard_normal(shape)).astype(
            np.float32))

    scales = torch.tensor([CASES[c][0] for c in cases]).reshape(
        seeds + (1,))
    grads = draw(1.0) * scales
    for i, c in enumerate(cases):
        if CASES[c][2]:
            grads.view(-1, P)[i, 3] = float("inf")
    learner = Learner(
        params=draw(0.1), target_params=draw(0.1),
        opt_state=AdamState(draw(0.01), draw(0.01).abs(),
                            torch.full(seeds, 7, dtype=torch.int32)),
        train_steps=torch.tensor([CASES[c][3] for c in cases],
                                 dtype=torch.int32).reshape(seeds),
        nonfinite_grads=torch.full(seeds, 2, dtype=torch.int32),
    )
    ok = torch.tensor([CASES[c][1] for c in cases]).reshape(seeds)
    return learner, grads, ok


def inline_chain(state, flat_grads, ok):
    """The sequence ``apply_update`` ran after its gradient before the step
    was fused, as it stood."""
    seeds = state.seed_shape
    with torch.no_grad():
        gnorm = torch.linalg.vector_norm(flat_grads,
                                         dim=-1 if seeds else None)
        finite = torch.isfinite(gnorm)
        apply = ok & finite  # apply only when sampling was legal
        clip_adam_update(
            state.params, flat_grads, gnorm, state.opt_state, apply,
            LR, MAX_NORM,
        )
        state.train_steps = state.train_steps + apply.to(torch.int32)
        swap = apply & (
            state.train_steps % TARGET_EVERY == 0
        )
        state.target_params.copy_(torch.where(
            swap[..., None] if seeds else swap, state.params,
            state.target_params))
        state.nonfinite_grads = state.nonfinite_grads + (
            ok & ~finite
        ).to(torch.int32)
    return gnorm, apply


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def learner_tensors(state):
    return {"params": state.params, "target": state.target_params,
            "mu": state.opt_state.mu, "nu": state.opt_state.nu,
            "count": state.opt_state.count,
            "train_steps": state.train_steps,
            "nonfinite_grads": state.nonfinite_grads}


@pytest.mark.parametrize("cases", [[c] for c in CASES] + [list(CASES)],
                         ids=list(CASES) + ["stacked"])
def test_cpu_route_equals_the_inline_chain(cases):
    ours, grads, ok = make(cases)
    theirs, _, _ = make(cases)
    before, _, _ = make(cases)
    gnorm, apply = base.optimizer_step(ours, grads, ok, LR, MAX_NORM,
                                       TARGET_EVERY)
    want_gnorm, want_apply = inline_chain(theirs, grads, ok)
    assert torch.equal(bits(gnorm), bits(want_gnorm))
    assert torch.equal(apply, want_apply)
    for name, t in learner_tensors(ours).items():
        want = learner_tensors(theirs)[name]
        assert t.shape == want.shape and t.dtype == want.dtype, name
        assert torch.equal(bits(t), bits(want)), name
    # The cases do what they are named for.
    rows = lambda t: t.reshape(-1, P)  # noqa: E731
    for i, c in enumerate(cases):
        moved = not torch.equal(rows(ours.params)[i], rows(before.params)[i])
        assert moved == (c not in ("gated", "nonfinite")), c
        swapped = torch.equal(rows(ours.target_params)[i],
                              rows(ours.params)[i])
        assert swapped == (c == "swap"), c
        assert int(ours.nonfinite_grads.reshape(-1)[i]) == (
            3 if c == "nonfinite" else 2), c
    norms = gnorm.reshape(-1)
    assert any(float(n) < MAX_NORM for n in norms) == ("below" in cases)


def head_length(row_start, p):
    """Elements of a row before its first 16-byte boundary, the row's
    first element lying ``row_start`` floats past one: ``head_length`` of
    csrc/optimizer.cu, which computes it on the card from the row's
    address.  A copy of the kernels' split, which it does not drive: on the
    card ``chip_smoke.py`` phase 24 holds the kernels bit-equal to the chain
    at odd and even P."""
    return min(-row_start % co.GROUP, p)


def block_ranges(p, head, block):
    """The [start, stop) element ranges of a row of ``p`` that ``block``
    covers, as the kernels split it: block 0 the head's elements, every
    block THREADS groups of GROUP after the head, the last block the tail
    that the groups leave."""
    blocks = co.blocks_per_row(p)
    groups = (p - head) // co.GROUP
    ranges = []
    if block == 0 and head:
        ranges.append((0, head))
    first, last = block * co.THREADS, min((block + 1) * co.THREADS, groups)
    if last > first:
        ranges.append((head + co.GROUP * first, head + co.GROUP * last))
    tail = head + co.GROUP * groups
    if block == blocks - 1 and tail < p:
        ranges.append((tail, p))
    return ranges


@pytest.mark.parametrize("seeds", [1, 5])
@pytest.mark.parametrize("p", [1, 4095, 107_779, 509_142])
def test_block_ranges_cover_every_element_once(p, seeds):
    blocks = co.blocks_per_row(p)
    assert (blocks - 1) * co.BLOCK_ELEMS < p <= blocks * co.BLOCK_ELEMS
    # Every head a row can have: row s starts s * P floats past its
    # vector's base, which lies on 16 bytes.
    for head in {head_length(s * p, p) for s in range(co.GROUP)}:
        covered = np.zeros(p, dtype=np.int64)
        for b in range(blocks):
            for start, stop in block_ranges(p, head, b):
                assert 0 <= start < stop <= p
                covered[start:stop] += 1
        assert (covered == 1).all(), (p, head)
    partials = sorted(s * blocks + b for s in range(seeds)
                      for b in range(blocks))
    assert partials == list(range(seeds * blocks))


class StandInGraph:
    def replay(self):
        pass


def test_tracked_counters_hold_the_optimizer_counts():
    assert graphs.TRACKED_COUNTERS["optimizer_launch_counts"] is \
        co.launch_counts
    assert set(co.launch_counts) == {"adam_sumsq", "adam_apply"}
    start = dict(co.launch_counts)
    state, grads, ok = make(list(CASES))
    base.optimizer_step(state, grads, ok, LR, MAX_NORM, TARGET_EVERY)
    assert co.launch_counts == start  # the plain chain launches nothing
    with graphs.counting_capture() as gains:
        co.launch_counts["adam_sumsq"] += 1
        co.launch_counts["adam_apply"] += 1
    assert co.launch_counts == start
    graph = graphs.CountedGraph(StandInGraph(), gains)
    graph.replay()
    graph.replay()
    assert co.launch_counts == {k: n + 2 for k, n in start.items()}
    co.launch_counts.update(start)


def test_cuda_tensor_never_takes_the_plain_chain(monkeypatch):
    """A CUDA tensor launches the kernels or raises: with no nvcc the build
    raises instead of running the chain."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(co, "_lib", None)
    monkeypatch.setattr(nvcc.shutil, "which", lambda _: None)
    monkeypatch.setattr(co, "_BUILD_DIR", co._BUILD_DIR / "absent")
    monkeypatch.setattr(base, "gated_adam_step",
                        lambda *a: pytest.fail("plain chain taken"))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    state, grads, ok = make(list(CASES))
    fake = lambda t: t.as_subclass(FakeCuda)  # noqa: E731
    state = Learner(fake(state.params), fake(state.target_params),
                    AdamState(*(fake(t) for t in dataclasses.astuple(
                        state.opt_state))),
                    fake(state.train_steps), fake(state.nonfinite_grads))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        base.optimizer_step(state, fake(grads), fake(ok), LR, MAX_NORM,
                            TARGET_EVERY)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    state, grads, ok = make(list(CASES))
    opt = state.opt_state
    args = [state.params, grads, opt.mu, opt.nu, opt.count, ok,
            state.train_steps, state.nonfinite_grads, state.target_params]
    # A contiguous view whose base is 4 bytes past 16: the kernels' rows
    # would not share their head.
    shifted = torch.empty(grads.numel() + 1)[1:].view(grads.shape)
    shifted.copy_(grads)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for i, bad in ((1, grads.double()), (2, opt.mu.t().contiguous().t()),
                   (1, grads[:, :-1]), (4, opt.count.long()),
                   (5, ok.int()), (6, state.train_steps[:-1]),
                   (1, shifted)):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            co.clip_adam_apply(*wrong, LR, MAX_NORM, TARGET_EVERY,
                               base.ADAM_B1, base.ADAM_B2, base.ADAM_EPS)
