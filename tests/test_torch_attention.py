"""Port attention vs the JAX package: the autograd.Function (plain path on
the CPU) against ``pallas_attention_packed`` (interpret mode) and
``_xla_attention``.  Forward atol 2e-5, gradients atol 5e-5: float32 sums
taken in another order, well inside what a wrong mask or scale would give.
"""

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


def arrays(seed, b, lq, lk, e):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, lq, e), (b, lk, e), (b, lk, e), (b, lq, e))]


def xla_packed(q, k, v, heads, causal):
    b, lq, e = q.shape
    lk = k.shape[1]
    d = e // heads
    out = _xla_attention(q.reshape(b, lq, heads, d), k.reshape(b, lk, heads, d),
                         v.reshape(b, lk, heads, d), causal=causal)
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
    assert cuda_attention.launch_counts == {"attention_fwd": 0,
                                            "attention_bwd": 0}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(qt, kt, vt, num_heads=2,
                              kv_mask=torch.ones(2, 5, dtype=torch.bool))


def test_kernel_limits_are_checked():
    """The CUDA-side checks raise before any launch (run here on CPU
    tensors through the same check functions)."""
    with pytest.raises(ValueError, match="heads"):
        cuda_attention.check_shapes(torch.zeros(1, 4, 10),
                                    torch.zeros(1, 4, 10),
                                    torch.zeros(1, 4, 10), 3, False)
    big = cuda_attention.bwd_smem_bytes(256, 256, 64)
    assert big > cuda_attention.MAX_SMEM_BYTES
    t = torch.zeros(1, 256, 64)
    with pytest.raises(ValueError, match="shared"):
        cuda_attention._check_cuda((t, t, t), 1, 256, 256, 64, big)
    with pytest.raises(TypeError, match="float32"):
        cuda_attention._check_cuda((t.double(),), 1, 4, 4, 8, 0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention._check_cuda((t.transpose(1, 2),), 1, 4, 4, 8, 0)
