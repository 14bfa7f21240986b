"""Plain DTQN and DTQN-bag forward (Esslinger et al., arXiv:2206.01078;
kevslinger/DTQN ``dtqn/networks/dtqn.py``), float32, for S seeds at once.

Each parameter is [S, *shape]; inputs are [S, B, ...].  The network: the
observation embedding (a Linear of the observation, or for token
observations an embedding of each token, flattened, then a Linear), plus a
learned position per step; ``num_layers`` post-LN layers, each causal
multi-head self-attention whose output goes through a ReLU, a residual add
and a LayerNorm (eps 1e-6), then a 4x ReLU MLP whose output goes through a
ReLU, a residual add and a LayerNorm; with a bag, multi-head attention of
every step over the embedded bag (no mask: empty slots hold the padding
observation), concatenated to the step's features; then a ReLU MLP head
with one Q per action.  No action embedding (``action_dim`` 0).

Every matrix product goes through ``Precision.mm``: float32 (the
configurations' precision), or the control's TF32.

A configuration names this file as its ``"reference"``: the harness and
the shared learner take ``param_spec``, ``Net`` and ``TINY`` from it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.reference.precision import Precision

LN_EPS = 1e-6

# A CPU test's size: the most each key takes (a configuration's smaller
# value stays, so a cell without a bag keeps none).  Every width cut, the
# same code paths; epsilon anneals and the target swaps within a few
# iterations, so that the late stage has greedy actions and a swap.
TINY = dict(inner_embed=16, num_heads=2, num_layers=1, context_len=8,
            history=8, batch_size=4, buffer_size=4000, num_envs=4,
            prepop_steps=1700, eps_duration=40, target_update=12, bag_size=3)


def param_spec(cfg: dict, env) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, named as the layers of the
    published model are; init is "normal" (N(0, 0.02)), "zeros" or
    "ones"."""
    f, heads = cfg["inner_embed"], cfg["num_heads"]
    if f % heads:
        raise ValueError("inner_embed must divide num_heads")
    spec = []

    def dense(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in), "normal"))
        spec.append((f"{name}.bias", (n_out,), "zeros"))

    if env.obs_dtype == torch.int32:
        vocab = int(env.obs_mask) + 1
        spec.append(("obs_embedding.embedding.weight",
                     (vocab, cfg["embed_per_obs_dim"]), "normal"))
        dense("obs_embedding.dense_0",
              env.obs_shape[0] * cfg["embed_per_obs_dim"], f)
    else:
        dense("obs_embedding.dense_0", env.obs_shape[0], f)
    spec.append(("position.embedding", (1, cfg["context_len"], f), "zeros"))
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}"
        dense(f"{p}.attention.qkv", f, 3 * f)
        dense(f"{p}.attention.out", f, f)
        dense(f"{p}.ffn.dense_0", f, 4 * f)
        dense(f"{p}.ffn.dense_1", 4 * f, f)
        for ln in ("layernorm1", "layernorm2"):
            spec.append((f"{p}.{ln}.weight", (f,), "ones"))
            spec.append((f"{p}.{ln}.bias", (f,), "zeros"))
    if cfg["bag_size"]:
        for part in ("query", "key", "value", "out"):
            dense(f"bag_attention.{part}", f, f)
    dense("head_hidden", 2 * f if cfg["bag_size"] else f, f)
    dense("head_out", f, env.num_actions)
    return spec


class Net:
    """The forward of ``cfg``'s network on ``env``'s observations, its
    products in ``prec``'s precision."""

    def __init__(self, cfg: dict, env, prec: Precision):
        self.cfg, self.env, self.prec = cfg, env, prec

    def linear(self, x: torch.Tensor, p: Dict[str, torch.Tensor], name: str):
        """x [S, ..., in] -> [S, ..., out]."""
        w, b = p[name + ".weight"], p[name + ".bias"]
        s = x.shape[0]
        y = self.prec.mm(x.reshape(s, -1, x.shape[-1]), w.transpose(1, 2))
        return (y + b[:, None, :]).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def layer_norm(x, p, name):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return ((x - mean) / torch.sqrt(var + LN_EPS)
                * p[name + ".weight"].reshape(shape)
                + p[name + ".bias"].reshape(shape))

    def attention(self, q, k, v, causal: bool):
        """Packed [S, B, L, F] -> [S, B, Lq, F]."""
        heads = self.cfg["num_heads"]
        s, b, lq, f = q.shape
        lk = k.shape[2]
        d = f // heads

        def split(x, n):
            return x.reshape(s * b, n, heads, d).transpose(1, 2)

        qh, kh, vh = split(q, lq), split(k, lk), split(v, lk)
        scores = self.prec.mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        if causal:
            keep = torch.ones(lq, lk, dtype=torch.bool,
                              device=q.device).tril()
            scores = scores.masked_fill(~keep, float("-inf"))
        out = self.prec.mm(torch.softmax(scores, dim=-1), vh)
        return out.transpose(1, 2).reshape(s, b, lq, f)

    def embed(self, obs, p):
        if "obs_embedding.embedding.weight" in p:
            table = p["obs_embedding.embedding.weight"]  # [S, V, e]
            s = table.shape[0]
            seed = torch.arange(s, device=obs.device).reshape(
                s, *(1,) * (obs.dim() - 1))
            tok = table[seed, obs.long()]  # [S, ..., obs_dim, e]
            return self.linear(tok.flatten(-2), p, "obs_embedding.dense_0")
        return self.linear(obs.to(torch.float32), p, "obs_embedding.dense_0")

    def __call__(self, p, obs, bag_obs=None):
        """obs [S, B, L, ...] (and bag_obs [S, B, n, ...]) -> Q [S, B, L,
        A]."""
        cfg = self.cfg
        length = obs.shape[2]
        x = self.embed(obs, p) + p["position.embedding"][:, :, :length]
        for i in range(cfg["num_layers"]):
            n = f"layers.{i}"
            q, k, v = self.linear(x, p, f"{n}.attention.qkv").chunk(3, dim=-1)
            a = self.linear(self.attention(q, k, v, causal=True), p,
                            f"{n}.attention.out")
            x = self.layer_norm(x + torch.relu(a), p, f"{n}.layernorm1")
            y = self.linear(torch.relu(self.linear(x, p, f"{n}.ffn.dense_0")),
                            p, f"{n}.ffn.dense_1")
            x = self.layer_norm(x + torch.relu(y), p, f"{n}.layernorm2")
        if cfg["bag_size"]:
            bag = self.embed(bag_obs, p)
            a = self.attention(self.linear(x, p, "bag_attention.query"),
                               self.linear(bag, p, "bag_attention.key"),
                               self.linear(bag, p, "bag_attention.value"),
                               causal=False)
            x = torch.cat([x, self.linear(a, p, "bag_attention.out")], dim=-1)
        return self.linear(torch.relu(self.linear(x, p, "head_hidden")), p,
                           "head_out")
