"""Parameter bridge between ``dtqn_tpu``'s flax tree and the port's modules.

``params_from_jax`` maps a DTQN parameter tree (nested dicts of numpy
arrays, as ``flax.serialization.msgpack_restore`` or ``jax.device_get``
give it) to a ``state_dict`` of ``dtqn_tpu_torch.models.DTQN``:

    ContinuousObsEmbedding_0/Dense_0   -> obs_embedding.dense_0
    ImageObsEmbedding_0/Conv_{i}, Dense_0 -> obs_embedding.conv_{i}, dense_0
    DiscreteObsEmbedding_0/Embed_0     -> obs_embedding.embedding.weight
    DiscreteObsEmbedding_0/Dense_0     -> obs_embedding.dense_0
    action_embed/Embed_0/embedding     -> action_embed.embedding.weight
    position/embedding [1, L, F]       -> position.embedding
    layer_{i}/attention/qkv, out       -> layers.{i}.attention.qkv, out
    layer_{i}/ffn/Dense_0, Dense_1     -> layers.{i}.ffn.dense_0, dense_1
    layer_{i}/layernorm{1,2}           -> layers.{i}.layernorm{1,2}
    layer_{i}/GRUGate_{0,1}/{w,u}_{z,r,g}
                                       -> layers.{i}.{attn,mlp}_gate.{w,u}_...
    bag_attention/query, key, value, out -> bag_attention.query, ...
    head_hidden, head_out              -> head_hidden, head_out

and a DQN / DRQN / ADRQN / DARQN tree (``dtqn_tpu/models/recurrent.py``):

    QHead_0/Dense_1 (hidden), Dense_0 (output) -> q_head.hidden, q_head.out
    lstm/cell/{ii,if,ig,io}            -> lstm.cell.input_proj (fused)
    lstm/cell/{hi,hf,hg,ho}            -> lstm.cell.hidden_proj (fused)
    core/cell/..., core/attention/{W,linear,linear2}
                                       -> core.cell..., core.attention...

A Dense ``kernel [in, out]`` becomes a Linear ``weight [out, in]``, a Conv
``kernel`` HWIO torch's OIHW; LayerNorm ``scale`` becomes ``weight``.  A
layer's first GRU gate (flax's ``GRUGate_0``) gates the attention, its
second the FFN.  The older separate
query/key/value projections are fused into ``qkv`` in q, k, v order, as
``tools/convert_policy_qkv.py`` does; the bag cross-attention keeps its
three projections, in both packages.  An LSTM cell's four input kernels
(no bias) are stacked in i, f, g, o order into one ``input_proj`` and its
four hidden kernels and biases into one ``hidden_proj``; flax's QHead
names its output layer ``Dense_0`` and its hidden one ``Dense_1``.  Reading a msgpack file is the
caller's job, which keeps this package free of flax.
``params_to_jax`` is the inverse (self-attention always in the fused
layout).  ``stacked_params_from_jax`` / ``stacked_params_to_jax`` do the
same for trees stacked along a leading seed axis (the JAX sweep's state).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

_MODULES = {
    "ContinuousObsEmbedding_0": "obs_embedding",
    "DiscreteObsEmbedding_0": "obs_embedding",
    "ImageObsEmbedding_0": "obs_embedding",
    "Dense_0": "dense_0",
    "Dense_1": "dense_1",
    "Embed_0": "embedding",
    "GRUGate_0": "attn_gate",
    "GRUGate_1": "mlp_gate",
    **{f"Conv_{i}": f"conv_{i}" for i in range(5)},
}
# HWIO (flax) -> OIHW (torch), and back.
_CONV_TO_TORCH, _CONV_TO_JAX = (3, 2, 0, 1), (2, 3, 1, 0)
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "embedding": "weight"}


def _fuse_qkv(tree: Mapping, name: str = "") -> Dict:
    """Separate query/key/value Dense layers of a self-attention -> one
    fused ``qkv``."""
    if not isinstance(tree, Mapping):
        return tree
    out = {k: _fuse_qkv(v, k) for k, v in tree.items()}
    if (name != "bag_attention" and {"query", "key", "value"} <= set(out)
            and "qkv" not in out):
        parts = [out.pop(name) for name in ("query", "key", "value")]
        out["qkv"] = {
            leaf: np.concatenate([p[leaf] for p in parts], axis=-1)
            for leaf in ("kernel", "bias")
        }
    return out


_GATES = ("i", "f", "g", "o")
_LSTM_KEYS = {p + g for p in ("i", "h") for g in _GATES}
_QHEAD = {"Dense_1": "hidden", "Dense_0": "out"}


def _fuse_recurrent(tree: Mapping) -> Dict:
    """The 8 gate Dense layers of an LSTM cell -> ``input_proj`` and
    ``hidden_proj``; ``QHead_0`` -> ``q_head`` with ``hidden`` / ``out``."""
    if not isinstance(tree, Mapping):
        return tree
    out = {k: _fuse_recurrent(v) for k, v in tree.items()}
    if set(out) == _LSTM_KEYS:
        out = {
            "input_proj": {"kernel": np.concatenate(
                [out["i" + g]["kernel"] for g in _GATES], axis=-1)},
            "hidden_proj": {leaf: np.concatenate(
                [out["h" + g][leaf] for g in _GATES], axis=-1)
                for leaf in ("kernel", "bias")},
        }
    if "QHead_0" in out:
        head = out.pop("QHead_0")
        out["q_head"] = {_QHEAD[k]: v for k, v in head.items()}
    return out


def _split_recurrent(tree: Dict) -> Dict:
    """The inverse of ``_fuse_recurrent``, in place."""
    for val in tree.values():
        if isinstance(val, dict):
            _split_recurrent(val)
    if {"input_proj", "hidden_proj"} <= set(tree):
        inputs = np.split(tree.pop("input_proj")["kernel"], 4, axis=-1)
        hidden = {leaf: np.split(v, 4, axis=-1)
                  for leaf, v in tree.pop("hidden_proj").items()}
        for n, g in enumerate(_GATES):
            tree["i" + g] = {"kernel": np.ascontiguousarray(inputs[n])}
            tree["h" + g] = {leaf: np.ascontiguousarray(v[n])
                             for leaf, v in hidden.items()}
    if "q_head" in tree:
        head = tree.pop("q_head")
        tree["QHead_0"] = {k: head[v] for k, v in _QHEAD.items()}
    return tree


def _torch_name(path) -> str:
    *mods, leaf = path
    names = []
    for m in mods:
        if m.startswith("layer_"):
            names += ["layers", m[len("layer_"):]]
        else:
            names.append(_MODULES.get(m, m))
    if mods == ["position"] and leaf == "embedding":
        return "position.embedding"
    if leaf not in _LEAVES:
        raise KeyError(f"unknown parameter leaf {'/'.join(path)!r}")
    names.append(_LEAVES[leaf])
    return ".".join(n for n in names if n)


def params_from_jax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """flax parameter tree (numpy leaves) -> torch ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = OrderedDict()

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (key,))
                continue
            arr = np.asarray(val, dtype=np.float32)
            if key == "kernel":
                arr = (arr.transpose(_CONV_TO_TORCH) if arr.ndim == 4
                       else arr.T)
            state[_torch_name(path + (key,))] = torch.tensor(arr)

    walk(_fuse_recurrent(_fuse_qkv(tree)), ())
    return state


_JAX_MODULES = {torch_name: jax_name for jax_name, torch_name
                in _MODULES.items() if torch_name != "obs_embedding"}


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """torch ``state_dict`` -> flax parameter tree (numpy leaves)."""
    tree: Dict = {}
    # Only the discrete obs embedder holds a token table, and only the
    # image one convolutions.
    if "obs_embedding.embedding.weight" in state_dict:
        obs_module = "DiscreteObsEmbedding_0"
    elif "obs_embedding.conv_0.weight" in state_dict:
        obs_module = "ImageObsEmbedding_0"
    else:
        obs_module = "ContinuousObsEmbedding_0"
    jax_modules = dict(_JAX_MODULES, obs_embedding=obs_module)
    for name, tensor in state_dict.items():
        arr = tensor.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        *mods, leaf = parts
        if mods == ["position"]:
            path, arr_leaf = ["position"], "embedding"
        elif mods[-1] == "embedding":  # an Embed table, not transposed
            path = [jax_modules.get(m, m) for m in mods]
            arr_leaf = "embedding"
        else:
            path = [jax_modules.get(m, m) for m in mods]
            is_norm = path[-1].startswith("layernorm")
            if leaf == "weight":
                arr_leaf = "scale" if is_norm else "kernel"
                if arr.ndim == 4:
                    arr = arr.transpose(_CONV_TO_JAX)
                elif not is_norm:
                    arr = arr.T
            else:
                arr_leaf = leaf
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[arr_leaf] = np.ascontiguousarray(arr)
    return _split_recurrent(tree)


def stacked_params_from_jax(tree: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A flax tree stacked along a leading seed axis (as
    ``jax.vmap(agent._init_state_impl)`` gives it) -> [S, *shape] weights
    by parameter name, for ``StackedNetwork.load_stacked_state_dict``:
    each seed's slice through ``params_from_jax``, stacked."""
    def first_leaf(node):
        val = next(iter(node.values()))
        return first_leaf(val) if isinstance(val, Mapping) else val

    seeds = np.asarray(first_leaf(tree)).shape[0]

    def seed_slice(node, i):
        return {k: seed_slice(v, i) if isinstance(v, Mapping)
                else np.asarray(v)[i] for k, v in node.items()}

    per_seed = [params_from_jax(seed_slice(tree, i)) for i in range(seeds)]
    return OrderedDict((k, torch.stack([p[k] for p in per_seed]))
                       for k in per_seed[0])


def stacked_params_to_jax(weights: Mapping[str, torch.Tensor]) -> Dict:
    """[S, *shape] weights by parameter name -> a flax tree stacked along
    a leading seed axis (the inverse of ``stacked_params_from_jax``)."""
    seeds = next(iter(weights.values())).shape[0]
    per_seed = [params_to_jax({k: v[i] for k, v in weights.items()})
                for i in range(seeds)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)

    return stack(per_seed)
