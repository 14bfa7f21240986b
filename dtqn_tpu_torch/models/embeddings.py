"""Observation / action embedders (``dtqn_tpu/models/embeddings.py``).

The discrete-obs token Embedding -> flatten -> Linear
(representations.py:26-52), the continuous-obs Linear
(representations.py:64-75), the image CNN (representations.py:77-130) and
the action Embedding (representations.py:146-155).

With a compute dtype (bfloat16) each layer computes as flax's does with
``dtype=compute_dtype()``: an embedding looks up its table rounded to that
dtype, a convolution and a Linear cast their input, weight and bias to it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dtqn_tpu_torch.envs.core import ObsKind
from dtqn_tpu_torch.models.init import in_compute_dtype, make_dense, normal_


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` with a table gradient that repeats bit for bit.

    The stock embedding backward on a CUDA device sums the rows of equal
    tokens with atomic adds, in an order that changes from launch to launch,
    so two runs from the same state drift apart in the last bits and a
    resumed run no longer equals the uninterrupted one.  Here the gradient
    is one matrix product, ``one_hot(tokens)^T @ grad``, whose order of
    summation is fixed; the one-hot matrix exists only in the backward.

    Under ``torch.func.vmap`` (one table per seed) the ``vmap`` rule stacks
    the tables into one of S*V rows, offsets each seed's tokens by its
    block, and makes one lookup.

    The product runs in the gradient's dtype: in bfloat16 it sums each
    row's products in float32 and rounds once, where the JAX package's
    scatter-add of the bf16 table's gradient rounds after each add.
    """

    @staticmethod
    def forward(table, tokens):
        return F.embedding(tokens, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, tokens = inputs
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, grad):
        (tokens,) = ctx.saved_tensors
        # Scattered ones, not ``F.one_hot``, which reads the tokens' range
        # back to the host on the CPU.
        flat = tokens.reshape(-1, 1).to(torch.int64)
        hot = torch.zeros((flat.shape[0], ctx.rows), dtype=grad.dtype,
                          device=grad.device).scatter_(1, flat, 1)
        return hot.t() @ grad.reshape(-1, grad.shape[-1]), None

    @staticmethod
    def vmap(info, in_dims, table, tokens):
        s = info.batch_size
        table, tokens = (x.expand(s, *x.shape) if dim is None
                         else x.movedim(dim, 0)
                         for x, dim in zip((table, tokens), in_dims))
        rows = table.shape[1]
        start = torch.arange(0, s * rows, rows, device=tokens.device,
                             dtype=tokens.dtype)
        offset = tokens + start.reshape(-1, *(1,) * (tokens.dim() - 1))
        return _Lookup.apply(table.reshape(s * rows, -1), offset), 0


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, F] at int ``tokens`` [...] -> [..., F]."""
    return _Lookup.apply(table, tokens)


class DiscreteObsEmbedding(nn.Module):
    """Per-dimension token embedding for (Multi)Discrete observations."""

    def __init__(self, vocab_size: int, obs_dim: int, embed_per_obs_dim: int,
                 features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = nn.Embedding(vocab_size, embed_per_obs_dim)
        normal_(self.embedding.weight, generator)
        self.dense_0 = make_dense(obs_dim * embed_per_obs_dim, features,
                                  generator, compute_dtype=compute_dtype)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        # obs: [..., obs_dim] int32 tokens (mask token == vocab_size - 1),
        # looked up as they are: no widening copy per call.
        tok = lookup(in_compute_dtype(self.embedding.weight,
                                      self.compute_dtype), obs)
        return self.dense_0(tok.flatten(-2))


class ContinuousObsEmbedding(nn.Module):
    """Linear projection for Box observations."""

    def __init__(self, obs_dim: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense_0 = make_dense(obs_dim, features, generator,
                                  compute_dtype=compute_dtype)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.dense_0(obs.to(torch.float32))


class Conv3x3(nn.Module):
    """A 3x3 convolution with padding 1 (flax's ``padding=1`` pads both
    sides) of an NHWC batch, as one GEMM over the patches of a strided view
    (``Tensor.unfold``): NHWC in, NHWC out.

    Its backward is GEMMs and ``unfold``'s backward, which gathers each
    input element's sum, so gradients repeat bit for bit on the card, where
    cuDNN's weight-gradient algorithms may sum with atomics; and the GEMMs
    follow PyTorch's float32 matmul precision (TF32 off unless the caller
    turns it on), where a cuDNN convolution would take TF32 by default.
    (``F.unfold`` would launch one im2col kernel per image on the card.)
    The weight is torch's OIHW, N(0, 0.02); the bias zero.  With a compute
    dtype the image, weight and bias are cast to it (flax's ``nn.Conv``
    with ``dtype``): the patches and the GEMM are in that dtype, and the
    bias is added to the rounded product, as flax adds it.
    """

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, 3, 3))
        normal_(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        # [N, OH, OW, C, 3, 3]: each output pixel's patch in (C, kh, kw)
        # order, as the OIHW weight flattens.
        patches = F.pad(in_compute_dtype(x, cd), (0, 0, 1, 1, 1, 1)).unfold(
            1, 3, self.stride).unfold(2, 3, self.stride)
        n, oh, ow = patches.shape[:3]
        weight = self.weight.reshape(self.weight.shape[0], -1)
        if cd is None:
            out = F.linear(patches.reshape(n * oh * ow, -1), weight,
                           self.bias)
        else:  # flax rounds the convolution, then adds the bias
            out = F.linear(patches.reshape(n * oh * ow, -1),
                           weight.to(cd)) + self.bias.to(cd)
        return out.reshape(n, oh, ow, -1)


CNN_CHANNELS, CNN_STRIDES = (64, 64, 64, 128, 128), (2, 1, 2, 1, 2)


class ImageObsEmbedding(nn.Module):
    """5-layer CNN for [C, H, W] uint8 images (representations.py:77-130):
    3x3 convolutions of 64/64/64/128/128 channels at strides 2/1/2/1/2, each
    followed by ReLU, then a Linear from the flattened features.  They are
    flattened in flax's NHWC order, so a Dense kernel from the JAX package
    reads the features it was trained on."""

    def __init__(self, obs_shape: Tuple[int, int, int], features: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, h, w = obs_shape
        self.obs_shape = (c, h, w)
        self.features = features
        for i, (out_ch, stride) in enumerate(zip(CNN_CHANNELS, CNN_STRIDES)):
            setattr(self, f"conv_{i}",
                    Conv3x3(c, out_ch, stride, generator, compute_dtype))
            c, h, w = out_ch, (h - 1) // stride + 1, (w - 1) // stride + 1
        self.dense_0 = make_dense(c * h * w, features, generator,
                                  compute_dtype=compute_dtype)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        prefix = obs.shape[:-3]
        x = obs.reshape(-1, *self.obs_shape).to(torch.float32)
        x = x.permute(0, 2, 3, 1)  # CHW -> HWC
        for i in range(len(CNN_CHANNELS)):
            x = torch.relu(getattr(self, f"conv_{i}")(x))
        x = self.dense_0(x.reshape(x.shape[0], -1))
        return x.reshape(*prefix, self.features)


class ActionEmbedding(nn.Module):
    """Embed(num_actions, action_dim): [...] int -> [..., action_dim],
    looked up through ``lookup`` so that its table gradient repeats bit for
    bit (ADRQN trains it on every step)."""

    def __init__(self, num_actions: int, action_dim: int,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embedding = nn.Embedding(num_actions, action_dim)
        normal_(self.embedding.weight, generator)

    def forward(self, actions: torch.Tensor) -> torch.Tensor:
        return lookup(in_compute_dtype(self.embedding.weight,
                                       self.compute_dtype), actions)


def make_obs_embedding(
    *,
    features: int,
    obs_kind: ObsKind,
    obs_shape: Sequence[int],
    vocab_size: int = 0,
    embed_per_obs_dim: int = 8,
    generator: Optional[torch.Generator] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """The obs embedder for the env's observation kind (dtqn.py:71-94)."""
    if obs_kind == ObsKind.IMAGE:
        return ImageObsEmbedding(tuple(obs_shape), features, generator,
                                 compute_dtype)
    if obs_kind == ObsKind.DISCRETE:
        return DiscreteObsEmbedding(
            vocab_size, int(obs_shape[0]), embed_per_obs_dim, features,
            generator, compute_dtype,
        )
    return ContinuousObsEmbedding(int(obs_shape[0]), features, generator,
                                  compute_dtype)
