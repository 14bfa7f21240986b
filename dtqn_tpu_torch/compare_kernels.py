"""This checkout's attention kernels against another checkout's, on one GPU.

    python -m dtqn_tpu_torch.compare_kernels --other DIR

DIR holds another checkout of the port (``dtqn_tpu_torch/`` beside a
``chip_smoke.py``), for example the parent commit unpacked with ``git
archive``.  Both kernel libraries are built, each from its own
``csrc/attention.cu``.  Then, in float32, at every shape of
``chip_smoke.PARITY_CASES``, both launch on the same inputs and their
outputs (the forward's, and dq, dk, dv) must be bit-equal; then both are
timed at the driven shapes in turns (other, this, this, other; device time
of CUDA graphs of launches).  Prints the card's name and power limit, one
JSON line per timed shape, and last ``{"ok": true, ...}``; exits non-zero
on a difference.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

# (B, Lk, D, causal) at Lq = 50, H = 8: the flagless update and act
# batches, the in_embed-128 update and evict batches, and the bags of 25
# and 10.
TIMED = [(32, 50, 8, True), (64, 50, 8, True), (32, 50, 16, True),
         (1664, 50, 16, True), (32, 25, 16, False), (1664, 25, 16, False),
         (32, 10, 8, False)]


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", required=True,
                   help="root of the other checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: the kernels run on a GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from dtqn_tpu_torch.ops import cuda_attention as this

    other = _load("other_cuda_attention", os.path.join(
        args.other, "dtqn_tpu_torch", "ops", "cuda_attention.py"))
    print(smoke.card_line(), flush=True)
    this.build()
    other.build()

    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, lq, lk, h, causal, e in smoke.PARITY_CASES:
        q, dout = (smoke.rand(gen, b, lq, e) for _ in range(2))
        k, v = (smoke.rand(gen, b, lk, e) for _ in range(2))
        got = (this.attention_fwd(q, k, v, h, causal),
               *this.attention_bwd(q, k, v, dout, h, causal))
        want = (other.attention_fwd(q, k, v, h, causal),
                *other.attention_bwd(q, k, v, dout, h, causal))
        torch.cuda.synchronize()
        if not all(torch.equal(a, r) for a, r in zip(got, want)):
            raise SystemExit(f"float32 results differ from the other "
                             f"checkout's at B={b} Lq={lq} Lk={lk} H={h} "
                             f"E={e} causal={causal}")
    out = {"bit_equal_shapes": len(smoke.PARITY_CASES), "timed": {}}
    for b, lk, d, causal in TIMED:
        q, dout = (smoke.rand(gen, b, 50, 8 * d) for _ in range(2))
        k, v = (smoke.rand(gen, b, lk, 8 * d) for _ in range(2))
        calls = 20 if b > 1000 else 100
        for kind in ("attention_fwd", "attention_bwd"):
            def timed(module, kind=kind):
                if kind == "attention_fwd":
                    return smoke.graph_ms(lambda: module.attention_fwd(
                        q, k, v, 8, causal), calls)
                return smoke.graph_ms(lambda: module.attention_bwd(
                    q, k, v, dout, 8, causal), calls)

            turns = [timed(m) for m in (other, this, this, other)]
            shape = (f"{kind} B={b} Lq=50 Lk={lk} H=8 D={d} "
                     f"{'causal' if causal else 'non-causal'} f32")
            line = {"shape": shape, "other_ms": (turns[0] + turns[3]) / 2,
                    "this_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}
            line["ratio"] = line["this_ms"] / line["other_ms"]
            out["timed"][shape] = line
            print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "bit_equal_shapes": out["bit_equal_shapes"],
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return out


if __name__ == "__main__":
    main()
