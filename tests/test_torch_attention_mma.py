"""The tensor-core form of the bf16 attention kernels (``attention_fwd_mma``
/ ``attention_bwd_mma`` in ``dtqn_tpu_torch/csrc/attention.cu``), on the CPU.

The kernels run only on the card.  Here an emulation of their numerics in
plain torch (products of bf16 values, exact in float32, summed in float32;
P and dS split into hi = bf16(x) and lo = bf16(x - hi), both multiplied)
is held against ``pallas_attention_packed`` on the same bf16 inputs in
interpret mode, within 1 bf16 ulp plus the float32 tolerance (2e-5
forward, 5e-5 gradients), as ``chip_smoke.py`` holds the kernels on the
card.  A cancellation input shows why P is split: rounded once to bf16 it
is past that tolerance.  Then the routing of ``launch_config`` and the
instance lists against the kernel source.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtqn_tpu.ops.pallas_attention import pallas_attention_packed
from dtqn_tpu_torch.ops import cuda_attention as ca

BF16 = torch.bfloat16
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's processes share the cores: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def excess_over_ulp(got, ref, atol):
    """The largest |got - ref| past 1 bf16 ulp of ref plus atol."""
    got, ref = f32(got), f32(ref)
    m, e = np.frexp(np.asarray(ref, np.float64))
    ulp = np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))
    return float((np.abs(got - ref) - ulp - atol).max())


# ------------------------------------------------- the kernels' numerics
def split(x):
    """float32 x as the kernels' two bf16 operands, hi and lo (float32)."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def heads_of(x, heads):
    b, length, e = x.shape
    return x.float().reshape(b, length, heads, e // heads).transpose(1, 2)


def packed(x):
    b, h, length, d = x.shape
    return x.transpose(1, 2).reshape(b, length, h * d).to(BF16)


def probs(qh, kh, causal):
    """Scores as the mma gives them (bf16 products, float32 sums), scaled
    after the product, masked to -1e30, softmax times the reciprocal of
    the row sum."""
    d = qh.shape[-1]
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / d ** 0.5)
    lq, lk = s.shape[-2:]
    keep = torch.ones(lq, lk, dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p * (1.0 / p.sum(-1, keepdim=True)), keep


def mma_fwd(q, k, v, heads, causal, split_p=True):
    """The forward's numerics; ``split_p=False`` rounds P once to bf16."""
    p, _ = probs(heads_of(q, heads), heads_of(k, heads), causal)
    vh = heads_of(v, heads)
    if not split_p:
        return packed(p.to(BF16).float() @ vh)
    hi, lo = split(p)
    return packed(hi @ vh + lo @ vh)


def mma_bwd(q, k, v, dout, heads, causal):
    """The backward's numerics: dP = dO V^T exact products, dS from P and
    dP in float32, then P and dS split for dV, dQ and dK."""
    qh, kh, vh, gh = (heads_of(x, heads) for x in (q, k, v, dout))
    d = qh.shape[-1]
    p, keep = probs(qh, kh, causal)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = torch.where(keep, ds, torch.zeros_like(ds)) * (1.0 / d ** 0.5)
    p_hi, p_lo = split(p)
    ds_hi, ds_lo = split(ds)
    dq = ds_hi @ kh + ds_lo @ kh
    dk = ds_hi.transpose(-1, -2) @ qh + ds_lo.transpose(-1, -2) @ qh
    dv = p_hi.transpose(-1, -2) @ gh + p_lo.transpose(-1, -2) @ gh
    return tuple(packed(x) for x in (dq, dk, dv))


def bf16_inputs(seed, b, lq, lk, e):
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((b, lq, e)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, lk, e)).astype(np.float32)
            for _ in range(2))
    return [torch.tensor(x).to(BF16) for x in (q, k, v, dout)]


def pallas(q, k, v, dout, heads, causal):
    """``pallas_attention_packed`` on the same bf16 values (interpret mode
    on the CPU): its output and its (dq, dk, dv)."""
    jq, jk, jv, jg = (jnp.asarray(f32(x)).astype(jnp.bfloat16)
                      for x in (q, k, v, dout))
    out, vjp = jax.vjp(
        lambda a, b_, c: pallas_attention_packed(a, b_, c, heads, causal),
        jq, jk, jv)
    return out, vjp(jg)


SHAPES = [
    # (lq, lk, causal): the driven causal self-attention at L = 50 and two
    # shorter ones (partial last tiles), full attention, and the bags of 25
    # and 10.
    pytest.param(50, 50, True, id="causal-50"),
    pytest.param(25, 25, True, id="causal-25"),
    pytest.param(10, 10, True, id="causal-10"),
    pytest.param(50, 50, False, id="full-50"),
    pytest.param(50, 25, False, id="bag-lk25"),
    pytest.param(50, 10, False, id="bag-lk10"),
]


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("lq,lk,causal", SHAPES)
def test_mma_numerics_match_pallas_in_bf16(lq, lk, causal, d):
    """The emulated kernels against ``pallas_attention_packed`` on bf16
    inputs: forward and every gradient within 1 ulp + the tolerance."""
    heads = 2
    q, k, v, dout = bf16_inputs(lq * 100 + lk + d, 2, lq, lk, heads * d)
    ref, ref_grads = pallas(q, k, v, dout, heads, causal)
    assert excess_over_ulp(mma_fwd(q, k, v, heads, causal), ref,
                           FWD_ATOL) <= 0
    for got, want in zip(mma_bwd(q, k, v, dout, heads, causal), ref_grads):
        assert excess_over_ulp(got, want, GRAD_ATOL) <= 0


@pytest.mark.parametrize("d", [8, 16])
def test_split_p_survives_cancellation(d):
    """V shifted by the float32 output of the last query, per batch row and
    head: that query's output is ~0 while sum_j p_j |v_j| is not.  With P
    rounded once to bf16 the output there is past 1 ulp + 2e-5; with P
    split into hi and lo it is within, and so are the gradients."""
    heads, lq = 2, 50
    q, k, v, dout = bf16_inputs(d, 2, lq, lq, heads * d)
    o = ca.plain_attention_fwd(q.float(), k.float(), v.float(), heads, True)
    v = (v.float() - o[:, lq - 1:]).to(BF16)
    ref, ref_grads = pallas(q, k, v, dout, heads, True)
    row = np.asarray(ref)[:, lq - 1]
    assert np.abs(f32(row)).max() < 1e-2  # the row cancels
    once = mma_fwd(q, k, v, heads, True, split_p=False)[:, lq - 1]
    twice = mma_fwd(q, k, v, heads, True)
    assert excess_over_ulp(once, row, FWD_ATOL) > 0
    assert excess_over_ulp(twice[:, lq - 1], row, FWD_ATOL) <= 0
    assert excess_over_ulp(twice, ref, FWD_ATOL) <= 0
    for got, want in zip(mma_bwd(q, k, v, dout, heads, True), ref_grads):
        assert excess_over_ulp(got, want, GRAD_ATOL) <= 0


# --------------------------------------------------------------- routing
KINDS = ("attention_fwd", "attention_bwd")
# (lq, lk, d): every bf16 shape of the driven paths (L = 50; bags of 25
# and 10; head widths 8 and 16) and the edges Lk = 1, 64; Lq = 1, 64.
MMA_SHAPES = [(50, 50, 8), (50, 50, 16), (50, 25, 16), (50, 10, 8),
              (1, 1, 8), (64, 64, 16), (64, 64, 8), (7, 3, 16), (1, 50, 8)]


@pytest.mark.parametrize("lq,lk,d", MMA_SHAPES)
def test_bf16_routes_to_the_tensor_cores(lq, lk, d):
    """bf16 at head width 8 or 16 with Lk <= 64 and Lq <= 64 takes the
    tensor-core form; ``lanes`` asks for the keys-on-lanes instance, which
    is the float32 call's; float32 never takes it."""
    for kind in KINDS:
        cfg = ca.launch_config(kind, lq, lk, d, BF16)
        assert cfg.keys_per_lane == ca.MMA_FORM and cfg.head_dim_pad == d
        assert (cfg.head_dim_pad, cfg.keys_per_lane) in ca.instances(BF16)
        assert ca.form_name(cfg) == f"mma <{d}>"
        lanes = ca.launch_config(kind, lq, lk, d, BF16, lanes=True)
        f32_cfg = ca.launch_config(kind, lq, lk, d, torch.float32)
        assert lanes == f32_cfg == ca.launch_config(kind, lq, lk, d)
        assert f32_cfg.keys_per_lane != ca.MMA_FORM


@pytest.mark.parametrize("kind,lq,lk,d", [
    ("attention_fwd", 50, 65, 8), ("attention_bwd", 50, 65, 16),
    ("attention_fwd", 50, 50, 32), ("attention_bwd", 50, 50, 32),
    ("attention_fwd", 20, 20, 4), ("attention_bwd", 40, 40, 12),
    ("attention_bwd", 65, 65, 16), ("attention_bwd", 100, 33, 8),
])
def test_bf16_keeps_the_lanes_instances_elsewhere(kind, lq, lk, d):
    """Past Lk = 64, at other head widths and in the backward past
    Lq = 64, bf16 keeps the keys-on-lanes instance that float32 takes."""
    cfg = ca.launch_config(kind, lq, lk, d, BF16)
    assert cfg == ca.launch_config(kind, lq, lk, d, torch.float32)
    assert cfg.keys_per_lane != ca.MMA_FORM
    assert not ca.takes_mma(kind, lq, lk, d, BF16)


def test_forward_past_64_rows_tiles_the_queries():
    """The forward takes any Lq (tiles of 64 query rows, 4 warps each);
    the backward only Lq <= 64."""
    cfg = ca.launch_config("attention_fwd", 130, 64, 16, BF16)
    assert cfg == (16, ca.MMA_FORM, 4, 64, 2 * 24 * (64 + 2 * 64))
    assert ca.launch_config("attention_bwd", 130, 64, 16,
                            BF16).keys_per_lane == 2


def test_float32_configuration_is_unchanged():
    """Every float32 shape of the earlier slices launches what it launched:
    the dtype argument changes nothing in float32."""
    lengths = (1, 10, 25, 33, 50, 64, 65, 100)
    for d in (1, 4, 8, 12, 16, 32, 64):
        for lq in lengths:
            for lk in lengths:
                for kind in KINDS:
                    cfg = ca.launch_config(kind, lq, lk, d, torch.float32)
                    assert cfg == ca.launch_config(kind, lq, lk, d)
                    assert (cfg.head_dim_pad,
                            cfg.keys_per_lane) in ca.INSTANCES


@pytest.mark.parametrize("lq,lk,d,fwd,bwd", [
    # staged rows of 8 bf16 (16 bytes) at D = 8, 24 (48 bytes) at D = 16;
    # the backward's P and dS tiles [4][Lq16][Lk16 + 8] bf16
    (50, 50, 8, (8, -1, 4, 50, 2 * 8 * (64 + 2 * 64)),
     (8, -1, 4, 50, 2 * (2 * 8 * (64 + 64) + 4 * 64 * 72))),
    (50, 50, 16, (16, -1, 4, 50, 2 * 24 * (64 + 2 * 64)),
     (16, -1, 4, 50, 2 * (2 * 24 * (64 + 64) + 4 * 64 * 72))),
    (50, 25, 16, (16, -1, 4, 50, 2 * 24 * (64 + 2 * 32)),
     (16, -1, 4, 50, 2 * (2 * 24 * (64 + 32) + 4 * 64 * 40))),
    (50, 10, 8, (8, -1, 4, 50, 2 * 8 * (64 + 2 * 16)),
     (8, -1, 4, 50, 2 * (2 * 8 * (64 + 16) + 4 * 64 * 24))),
    (7, 64, 16, (16, -1, 1, 7, 2 * 24 * (16 + 2 * 64)),
     (16, -1, 4, 7, 2 * (2 * 24 * (16 + 64) + 4 * 16 * 72))),
])
def test_mma_launch_config_layout(lq, lk, d, fwd, bwd):
    """Warps (one per 16 query rows forward; per 16 rows or keys, whichever
    is more, backward), rows per block and shared bytes of the form; the
    largest, D = 16 at Lq = Lk = 64, fits 48 KB without opting in."""
    assert tuple(ca.launch_config("attention_fwd", lq, lk, d, BF16)) == fwd
    assert tuple(ca.launch_config("attention_bwd", lq, lk, d, BF16)) == bwd
    assert ca.launch_config("attention_bwd", 64, 64, 16,
                            BF16).smem_bytes == 48 * 1024


def test_a_bf16_call_never_reaches_a_float32_instance():
    """The tensor-core form exists in bf16 only, and no dtype outside
    ``DTYPES`` gets a configuration."""
    assert ca.instances(torch.float32) == ca.INSTANCES
    assert set(ca.instances(BF16)) - set(ca.INSTANCES) == {
        (d, ca.MMA_FORM) for d in ca.MMA_INSTANCES}
    with pytest.raises(TypeError, match="no attention instance"):
        ca.launch_config("attention_fwd", 50, 50, 8, torch.float16)


def test_mma_instances_match_the_kernel_source():
    """``MMA_INSTANCES`` and ``MMA_FORM`` are the source's
    ``DTQN_MMA_INSTANCES`` and ``kMmaForm``, and the entry points pick
    the tensor-core kernels for the bf16 code only."""
    src = open(os.path.join(REPO, "dtqn_tpu_torch", "csrc",
                            "attention.cu")).read()
    macro = re.search(r"#define DTQN_MMA_INSTANCES\(X\)(.*?)\n", src)
    widths = re.findall(r"X\((\d+)\)", macro.group(1))
    assert tuple(int(d) for d in widths) == ca.MMA_INSTANCES
    form = re.search(r"constexpr int kMmaForm = (-?\d+);", src)
    assert int(form.group(1)) == ca.MMA_FORM
    assert re.search(r"std::is_same<T, __nv_bfloat16>::value\) \{\s*"
                     r"#define DTQN_PICK\(D\)\s*\\\s*if \(dp == D && kpl == "
                     r"kMmaForm\) return attention_fwd_mma<D>;", src)
    assert re.search(r"kMmaForm\) return attention_bwd_mma<D>;", src)


def test_ptxas_usage_names_the_tensor_core_instances():
    lines = []
    for name, regs in (("_ZN12_GLOBAL__N_117attention_fwd_mmaILi16EEEvPK13"
                        "__nv_bfloat16S3_S3_PS1_NS_4DimsE", 72),
                       ("_ZN12_GLOBAL__N_117attention_bwd_mmaILi8EEEvPK13"
                        "__nv_bfloat16S3_S3_S3_PS1_S4_S4_NS_4DimsE", 110)):
        lines += [
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
            f"ptxas info    : Function properties for {name}",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            f"ptxas info    : Used {regs} registers, used 1 barriers",
        ]
    assert ca.ptxas_usage("\n".join(lines)) == [
        {"kernel": "attention_bwd_mma<8>", "spill_stores": 0,
         "spill_loads": 0, "registers": 110},
        {"kernel": "attention_fwd_mma<16>", "spill_stores": 0,
         "spill_loads": 0, "registers": 72},
    ]


def chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_bf16_cases_reach_every_bf16_instance():
    """``chip_smoke.py``'s bf16 parity reaches every bf16 instance (the
    picked one at each shape and, where that is the tensor-core form, the
    keys-on-lanes one it replaced); every bf16 timing and cancellation
    shape is a driven one and takes the tensor-core form."""
    smoke = chip_smoke()
    reached = set()
    for _, lq, lk, heads, causal, e in smoke.BF16_PARITY_CASES:
        for kind in KINDS:
            for lanes in (False, True):
                cfg = ca.launch_config(kind, lq, lk, e // heads, BF16,
                                       lanes=lanes)
                reached.add((cfg.head_dim_pad, cfg.keys_per_lane))
    assert reached == set(ca.instances(BF16))
    held = {(lq, lk, e // heads, causal)
            for _, lq, lk, heads, causal, e in smoke.BF16_PARITY_CASES}
    for shape in smoke.BF16_TIMING_SHAPES:
        lk, d = shape.get("lk", 50), shape.get("d", 8)
        assert (50, lk, d, shape.get("causal", True)) in held
        assert all(ca.takes_mma(kind, 50, lk, d, BF16) for kind in KINDS)
    for _, lq, lk, heads, causal, e in smoke.BF16_CANCELLATION_CASES:
        assert all(ca.takes_mma(kind, lq, lk, e // heads, BF16)
                   for kind in KINDS)
