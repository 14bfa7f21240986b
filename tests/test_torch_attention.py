"""Port attention vs the JAX package: the autograd.Function (plain path on
the CPU) against ``pallas_attention_packed`` (interpret mode) and
``_xla_attention``.  Forward atol 2e-5, gradients atol 5e-5: float32 sums
taken in another order, well inside what a wrong mask or scale would give.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu.ops.attention import _xla_attention
from dtqn_tpu.ops.pallas_attention import pallas_attention_packed
from dtqn_tpu_torch.ops import cuda_attention
from dtqn_tpu_torch.ops.attention import (
    dot_product_attention,
    plain_attention_packed,
)
from dtqn_tpu_torch.ops.cuda_attention import cuda_attention_packed

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def arrays(seed, b, lq, lk, e):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, lq, e), (b, lk, e), (b, lk, e), (b, lq, e))]


def xla_packed(q, k, v, heads, causal, kv_mask=None):
    b, lq, e = q.shape
    lk = k.shape[1]
    d = e // heads
    out = _xla_attention(q.reshape(b, lq, heads, d), k.reshape(b, lk, heads, d),
                         v.reshape(b, lk, heads, d), causal=causal,
                         kv_mask=kv_mask)
    return out.reshape(b, lq, e)


def jax_grads(fn, q, k, v, g, heads, causal):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, heads, causal) * g)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def torch_out_and_grads(fn, q, k, v, g, heads, causal):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(qt, kt, vt, heads, causal)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


CASES = [
    # (b, lq, lk, heads, d, causal)
    pytest.param(3, 50, 50, 4, 16, True, id="causal-50"),
    pytest.param(3, 50, 50, 4, 16, False, id="full-50"),
    pytest.param(3, 50, 10, 4, 16, False, id="cross-lk10"),
    pytest.param(2, 7, 3, 4, 16, False, id="unaligned-7x3"),
    pytest.param(2, 1, 50, 4, 16, False, id="unaligned-1x50"),
    pytest.param(2, 50, 50, 8, 8, True, id="main-path-h8-d8"),
    pytest.param(2, 12, 12, 8, 8, False, id="main-heads-full"),
    # The bag cross-attention: context queries over bag keys.
    pytest.param(3, 50, 25, 8, 16, False, id="bag-gridverse-lk25-d16"),
    pytest.param(3, 50, 10, 8, 8, False, id="bag-carflag-lk10-d8"),
    pytest.param(8, 6, 3, 2, 8, False, id="bag-small-lk3"),
    # Head width 16 at the staged <16, 2>'s edges.
    pytest.param(3, 33, 33, 4, 16, True, id="staged-causal-33"),
    pytest.param(2, 64, 64, 4, 16, True, id="staged-causal-64"),
]


@pytest.mark.parametrize("b,lq,lk,heads,d,causal", CASES)
def test_matches_pallas_and_xla(b, lq, lk, heads, d, causal):
    q, k, v, g = arrays(lq * 100 + lk, b, lq, lk, heads * d)
    out, grads = torch_out_and_grads(cuda_attention_packed, q, k, v, g,
                                     heads, causal)
    ref_pallas = pallas_attention_packed(q, k, v, heads, causal)
    ref_xla = xla_packed(q, k, v, heads, causal)
    np.testing.assert_allclose(out, np.asarray(ref_pallas), atol=FWD_ATOL)
    np.testing.assert_allclose(out, np.asarray(ref_xla), atol=FWD_ATOL)
    for fn in (pallas_attention_packed, xla_packed):
        for ours, ref in zip(grads, jax_grads(fn, q, k, v, g, heads, causal)):
            np.testing.assert_allclose(ours, np.asarray(ref), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_reference_matches_kernel_math(causal):
    """The XLA-path mirror (autograd) and the kernels' plain math agree,
    forward and backward."""
    q, k, v, g = arrays(7, 2, 20, 20, 32)
    out_a, grads_a = torch_out_and_grads(plain_attention_packed, q, k, v, g,
                                         4, causal)
    out_b, grads_b = torch_out_and_grads(cuda_attention_packed, q, k, v, g,
                                         4, causal)
    np.testing.assert_allclose(out_a, out_b, atol=FWD_ATOL)
    for a, b in zip(grads_a, grads_b):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL)


def test_causal_needs_equal_lengths():
    q, k, v, _ = arrays(0, 1, 7, 3, 16)
    with pytest.raises(ValueError, match="Lq == Lk"):
        cuda_attention_packed(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), 2, True)


def test_dispatch_cpu_runs_plain_and_counts_nothing():
    q, k, v, _ = arrays(1, 2, 5, 5, 16)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    cuda_attention.reset_launch_counts()
    out = dot_product_attention(qt, kt, vt, num_heads=2, causal=True)
    ref = cuda_attention.plain_attention_fwd(qt, kt, vt, 2, True)
    assert torch.equal(out, ref)
    assert cuda_attention.launch_counts == {
        "attention_fwd": 0, "attention_bwd": 0,
        "attention_fwd_bf16": 0, "attention_bwd_bf16": 0}
    # A key mask takes the masked softmax in stock ops: all keys shown, it
    # agrees with the unmasked call, and it counts nothing either.
    shown = dot_product_attention(qt, kt, vt, num_heads=2,
                                  kv_mask=torch.ones(2, 5, dtype=torch.bool))
    np.testing.assert_allclose(
        shown.numpy(),
        dot_product_attention(qt, kt, vt, num_heads=2).numpy(),
        atol=FWD_ATOL)
    assert cuda_attention.launch_counts == {
        "attention_fwd": 0, "attention_bwd": 0,
        "attention_fwd_bf16": 0, "attention_bwd_bf16": 0}


@pytest.mark.parametrize("lq,lk,heads,d", [(50, 25, 8, 16), (6, 3, 2, 8)])
def test_kv_mask_matches_xla(lq, lk, heads, d):
    """``kv_mask`` against ``_xla_attention``'s: hidden keys, and one row
    with every key hidden (a uniform softmax over ``finfo.min`` scores)."""
    b = 4
    q, k, v, g = arrays(lq + lk, b, lq, lk, heads * d)
    mask = np.random.default_rng(0).random((b, lk)) < 0.6
    mask[0] = True
    mask[1] = False
    assert mask[2:].any() and not mask[2:].all()

    def port(qt, kt, vt, heads, causal):
        return dot_product_attention(qt, kt, vt, num_heads=heads,
                                     causal=causal,
                                     kv_mask=torch.tensor(mask))

    def ref(q, k, v, heads, causal):
        return xla_packed(q, k, v, heads, causal, kv_mask=jnp.asarray(mask))

    out, grads = torch_out_and_grads(port, q, k, v, g, heads, False)
    np.testing.assert_allclose(out, np.asarray(ref(q, k, v, heads, False)),
                               atol=FWD_ATOL)
    for ours, want in zip(grads, jax_grads(ref, q, k, v, g, heads, False)):
        np.testing.assert_allclose(ours, np.asarray(want), atol=GRAD_ATOL)
    # A hidden key's value gets no gradient where some key is shown.
    hidden = ~mask[2:]
    assert (grads[2][2:][hidden] == 0).all()


def test_kernel_limits_are_checked():
    """The CUDA-side checks raise before any launch (run here on CPU
    tensors through the same check functions)."""
    with pytest.raises(ValueError, match="heads"):
        cuda_attention.check_shapes(torch.zeros(1, 4, 10),
                                    torch.zeros(1, 4, 10),
                                    torch.zeros(1, 4, 10), 3, False)
    # The streamed backward keeps 3 floats a query row in shared memory.
    lq = cuda_attention.MAX_SMEM_BYTES // 12 + 1
    with pytest.raises(ValueError, match="shared"):
        cuda_attention.launch_config("attention_bwd", lq, lq, 64)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_attention.launch_config("attention_fwd", 4, 4, 65)
    t = torch.zeros(1, 256, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_attention._check_cuda((t.double(),), 1, 4, 4)
    # One dtype for every tensor: no instance takes a mix.
    with pytest.raises(TypeError, match="one dtype"):
        cuda_attention._check_cuda((t, t.bfloat16()), 1, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention._check_cuda((t.transpose(1, 2),), 1, 4, 4)


def chip_parity_cases():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [(b, lq, lk, heads, e // heads, causal)
            for b, lq, lk, heads, causal, e in module.PARITY_CASES]


def test_parity_shapes_map_to_instances():
    """Every shape of the CPU and the card's parity lists maps to a built
    instance, and the card's list reaches every instance."""
    cpu = [tuple(p.values) for p in CASES]
    reached = set()
    for source, cases in (("cpu", cpu), ("chip", chip_parity_cases())):
        for _, lq, lk, _, d, _ in cases:
            for kind in ("attention_fwd", "attention_bwd"):
                cfg = cuda_attention.launch_config(kind, lq, lk, d)
                pair = (cfg.head_dim_pad, cfg.keys_per_lane)
                assert pair in cuda_attention.INSTANCES, (source, lq, lk, d)
                if source == "chip":
                    reached.add(pair)
    assert reached == set(cuda_attention.INSTANCES)


def test_instances_match_the_kernel_source():
    src = open(os.path.join(REPO, "dtqn_tpu_torch", "csrc",
                            "attention.cu")).read()
    macro = re.search(r"#define DTQN_INSTANCES\(X\)(.*?)\n\n", src, re.S)
    pairs = re.findall(r"X\((\d+), (\d+)\)", macro.group(1))
    assert tuple((int(d), int(k)) for d, k in pairs) == \
        cuda_attention.INSTANCES
    # Every instance is built in each element type, by the code the entry
    # points take: DTYPES[code].
    macro = re.search(r"#define DTQN_DTYPES\(X\)(.*?)\n", src)
    codes = re.findall(r"X\((\d+), (\w+)\)", macro.group(1))
    c_types = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16}
    assert tuple(c_types[t] for _, t in codes) == cuda_attention.DTYPES
    assert [int(c) for c, _ in codes] == list(range(len(codes)))


@pytest.mark.parametrize("lq,lk,d,fwd,bwd", [
    # the main path: keys in registers, two a lane
    (50, 50, 8, (8, 2, 4, 8, 0), (8, 2, 8, 50, 4 * 2 * 8 * 50 * 8)),
    (1, 32, 8, (8, 1, 1, 2, 0), (8, 1, 1, 1, 4 * 2 * 1 * 32 * 8)),
    (20, 20, 16, (16, 2, 8, 20, 4 * 20 * (20 + 2 * 20)),
     (16, 2, 8, 20, 4 * (20 * (2 * 20 + 2 * 20) + 2 * 20 * 20))),
    # streamed: K and V re-read per row, row statistics in shared memory
    (50, 65, 8, (8, 0, 4, 8, 0), (8, 0, 8, 50, 4 * 3 * 50)),
    (100, 100, 32, (32, 0, 4, 8, 0), (32, 0, 8, 100, 4 * 3 * 100)),
    (7, 65, 64, (64, 0, 4, 8, 0), (64, 0, 2, 7, 4 * 3 * 7)),
    (30, 30, 4, (8, 1, 4, 8, 0), (8, 1, 8, 30, 4 * 2 * 8 * 30 * 8)),
    (40, 40, 12, (16, 2, 8, 40, 4 * 20 * (40 + 2 * 40)),
     (16, 2, 8, 40, 4 * (20 * (2 * 40 + 2 * 40) + 2 * 40 * 40))),
    # the bag cross-attention (non-causal): gv_memory at in_embed 128 with
    # bag 25 (staged), and Car Flag at in_embed 64 with bag 10 (registers)
    (50, 25, 16, (16, 2, 8, 50, 4 * 20 * (50 + 2 * 25)),
     (16, 2, 8, 50, 4 * (20 * (2 * 50 + 2 * 25) + 2 * 50 * 25))),
    (50, 10, 8, (8, 1, 4, 8, 0), (8, 1, 8, 50, 4 * 2 * 8 * 10 * 8)),
    # staged, head width 16 at Lk up to 64: head rows padded to 20 floats
    (50, 50, 16, (16, 2, 8, 50, 4 * 20 * (50 + 2 * 50)),
     (16, 2, 8, 50, 4 * (20 * (2 * 50 + 2 * 50) + 2 * 50 * 50))),
    (50, 64, 16, (16, 2, 8, 50, 4 * 20 * (50 + 2 * 64)),
     (16, 2, 8, 50, 4 * (20 * (2 * 50 + 2 * 64) + 2 * 50 * 64))),
    (50, 33, 16, (16, 2, 8, 50, 4 * 20 * (50 + 2 * 33)),
     (16, 2, 8, 50, 4 * (20 * (2 * 50 + 2 * 33) + 2 * 50 * 33))),
    (50, 65, 16, (16, 0, 4, 8, 0), (16, 0, 8, 50, 4 * 3 * 50)),
    # a forward tile of 64 rows; a backward whose tiles outgrow 227 KB
    (420, 50, 16, (16, 2, 8, 64, 4 * 20 * (64 + 2 * 50)),
     (16, 0, 8, 420, 4 * 3 * 420)),
])
def test_launch_config_layout(lq, lk, d, fwd, bwd):
    """Instance, warps, rows per block and shared bytes of each layout:
    the register backward's [2][warps][Lk][D] partials, the streamed
    backward's [3][Lq] row statistics, no shared memory forward; the staged
    forward's query tile and K and V rows, the staged backward's Q, dO, K
    and V rows and its [Lq, Lk] tiles of P and dS."""
    assert tuple(cuda_attention.launch_config("attention_fwd", lq, lk,
                                              d)) == fwd
    assert tuple(cuda_attention.launch_config("attention_bwd", lq, lk,
                                              d)) == bwd


def test_launch_config_asked_for_the_streamed_form():
    """``streamed`` asks for the streamed form, with its layout, at shapes
    that pick another: the staged one and the register ones."""
    for lq, lk, d, fwd, bwd in (
            (50, 50, 16, (16, 0, 4, 8, 0), (16, 0, 8, 50, 4 * 3 * 50)),
            (50, 10, 8, (8, 0, 4, 8, 0), (8, 0, 8, 50, 4 * 3 * 50)),
            (1, 32, 8, (8, 0, 1, 2, 0), (8, 0, 1, 1, 4 * 3 * 1))):
        for kind, want in (("attention_fwd", fwd), ("attention_bwd", bwd)):
            assert cuda_attention.launch_config(kind, lq, lk,
                                                d).keys_per_lane > 0
            assert tuple(cuda_attention.launch_config(
                kind, lq, lk, d, streamed=True)) == want


def test_launch_config_takes_what_the_score_matrix_layout_took():
    """Every shape that fit the earlier kernels' shared memory (the head's
    Q, K, V and [Lq, Lk] scores; backward also dO, dS and a row sum) still
    launches."""
    limit = cuda_attention.MAX_SMEM_BYTES
    lengths = (1, 2, 31, 32, 33, 64, 65, 100, 160, 400, 1000, 3000, 11000)
    for d in (1, 3, 8, 16, 33, 64):
        for lq in lengths:
            for lk in lengths:
                if 4 * ((lq + 2 * lk) * d + lq * lk) <= limit:
                    cuda_attention.launch_config("attention_fwd", lq, lk, d)
                if 4 * ((2 * lq + 2 * lk) * d + 2 * lq * lk + lq) <= limit:
                    cuda_attention.launch_config("attention_bwd", lq, lk, d)


def test_shape_past_the_limits_raises_before_any_launch(monkeypatch):
    monkeypatch.setattr(cuda_attention, "build",
                        lambda: pytest.fail("reached the build"))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    long_rows = torch.zeros(1, 20_000, 1).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="shared"):
        cuda_attention.attention_bwd(long_rows, long_rows, long_rows,
                                     long_rows, 1, True)
    wide = torch.zeros(1, 4, 65).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_attention.attention_fwd(wide, wide, wide, 1, False)


def test_ptxas_usage_reads_registers_and_spills():
    """Each instance by element type, head width and keys per lane."""
    lines = ["ptxas info    : 0 bytes gmem"]
    for mangled, spills, regs in (
            ("If", (8, 4), 96), ("I13__nv_bfloat16", (0, 0), 80)):
        name = (f"_ZN12_GLOBAL__N_120attention_bwd_kernel{mangled}Li8ELi2EEEv"
                "PKT_S3_")
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            f"    0 bytes stack frame, {spills[0]} bytes spill stores, "
            f"{spills[1]} bytes spill loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers, 400 "
            "bytes cmem[0]",
        ]
    assert cuda_attention.ptxas_usage("\n".join(lines)) == [
        {"kernel": "attention_bwd_kernel<bfloat16,8,2>", "spill_stores": 0,
         "spill_loads": 0, "registers": 80},
        {"kernel": "attention_bwd_kernel<float32,8,2>", "spill_stores": 8,
         "spill_loads": 4, "registers": 96},
    ]
