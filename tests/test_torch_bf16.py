"""bfloat16 compute in the port against the JAX package's ``--bf16`` mode,
on the CPU, on the same numpy inputs and (through ``bridge.py``) the same
parameters.

The JAX side runs with ``set_compute_dtype("bfloat16")`` and the Pallas
attention in interpret mode (the port's unmasked attention follows the
Pallas kernels' semantics: float32 inside, the input's dtype out), op by
op: every flax layer rounds its result to bf16, and so does the port's.
Tolerances, each with its reason:

- the Dense, Embed, Conv and action-embedding layers and the whole
  networks' Q: bit-equal (atol 0; the port rounds where flax rounds, the
  Dense and Conv products before their bias), and besides, for the whole
  networks, the RMS error against JAX's bf16 Q at most half of JAX's own
  bf16-vs-f32 RMS error and within ``tests/test_bf16.py``'s atol 0.05 /
  rtol 0.1;
- the attention against ``pallas_attention_packed``: 1 bf16 ulp of the
  reference plus the float32 tolerance of ``tests/test_torch_attention.py``
  (2e-5 forward, 5e-5 gradients): a sum in another order can flip one
  rounding;
- the stock-op attention (``kv_mask``, ``attention_probs``) against
  ``_xla_attention``: 1 bf16 ulp (jnp's softmax rounds after each step,
  and so does the port's);
- one update's gradients: relative error (norm of the difference over the
  norm) per parameter at most 1e-5 for the weights, the positions and the
  LayerNorms (measured: 0 to 2e-7), and 2e-2 for the biases and the token
  table (measured: up to 9.4e-3): those are sums over the batch, which
  JAX takes in bf16 (the table's by a bf16 scatter-add) and the port in
  float32, rounded once; bf16 itself moves each gradient by 2e-3 to 9e-2
  against float32;
- a stacked 2-seed update against the per-seed updates: rtol 1e-5, as
  ``tests/test_torch_sweep.py`` holds float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from dtqn_tpu.agents import Agent as JaxAgent
from dtqn_tpu.agents import AgentConfig as JaxConfig
from dtqn_tpu.envs import make_env as jax_make_env
from dtqn_tpu.models import build_network as jax_build_network
from dtqn_tpu.models.embeddings import ActionEmbedding as JaxActionEmbedding
from dtqn_tpu.models.embeddings import (
    DiscreteObsEmbedding as JaxDiscreteObsEmbedding,
)
from dtqn_tpu.models.init import set_compute_dtype
from dtqn_tpu.ops.attention import _xla_attention
from dtqn_tpu.ops.attention import attention_probs as jax_attention_probs
from dtqn_tpu.ops.attention import set_attention_impl
from dtqn_tpu.ops.pallas_attention import pallas_attention_packed
from dtqn_tpu_torch import replay
from dtqn_tpu_torch.agents import Agent, AgentConfig
from dtqn_tpu_torch.agents import base as agent_base
from dtqn_tpu_torch.bridge import params_from_jax
from dtqn_tpu_torch.envs import make_env
from dtqn_tpu_torch.models import build_network
from dtqn_tpu_torch.models.embeddings import (
    ActionEmbedding,
    Conv3x3,
    DiscreteObsEmbedding,
)
from dtqn_tpu_torch.models.gates import GRUGate
from dtqn_tpu_torch.models.init import Dense
from dtqn_tpu_torch.models.recurrent import LSTM
from dtqn_tpu_torch.ops import cuda_attention
from dtqn_tpu_torch.ops.attention import attention_probs, plain_attention_packed
from dtqn_tpu_torch.train.loop import make_prepopulate_fn, make_train_chunk_fn
from dtqn_tpu_torch.utils.epsilon import EpsilonSchedule

BF16 = torch.bfloat16
FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The suite's processes share the cores: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_bf16():
    """The JAX package in its --bf16 mode with the Pallas attention
    (interpret mode on the CPU); float32 and XLA again afterwards."""
    set_compute_dtype("bfloat16")
    set_attention_impl("pallas")
    yield
    set_compute_dtype("float32")
    set_attention_impl("xla")


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.detach().float().numpy()


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at each value of ``x`` (0 at 0)."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8))


def assert_within_ulp(got, ref, atol):
    got, ref = f32(got), f32(ref)
    excess = np.abs(got - ref) - bf16_ulp(ref) - atol
    assert excess.max() <= 0, f"{excess.max()} past 1 ulp + {atol}"


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def perturbed(params, seed):
    """Parameters moved off their init (zero biases, unit LayerNorms), so
    that every rounding of the bias adds and the norms is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


# -------------------------------------------------------------- the layers
def test_dense_matches_flax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    w = (0.3 * rng.standard_normal((64, 192))).astype(np.float32)
    b = (0.3 * rng.standard_normal(192)).astype(np.float32)
    ref = fnn.Dense(192, dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w, "bias": b}}, x)
    layer = Dense(64, 192, compute_dtype=BF16)
    layer.load_state_dict({"weight": torch.tensor(w.T),
                           "bias": torch.tensor(b)})
    out = layer(torch.tensor(x))
    assert out.dtype == BF16 and layer.weight.dtype == torch.float32
    np.testing.assert_array_equal(f32(out), f32(ref))


def test_embeddings_match_flax_bit_for_bit(jax_bf16):
    """The token table rounded to bf16 and looked up, then the bf16 Dense;
    the action table likewise."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 5, (3, 6, 4)).astype(np.int32)
    jemb = JaxDiscreteObsEmbedding(vocab_size=5, obs_dim=4,
                                   embed_per_obs_dim=8, features=24)
    params = perturbed(jemb.init(jax.random.key(0), tokens), 2)
    emb = DiscreteObsEmbedding(5, 4, 8, 24, compute_dtype=BF16)
    emb.load_state_dict({
        "embedding.weight": torch.tensor(params["params"]["Embed_0"]
                                         ["embedding"]),
        "dense_0.weight": torch.tensor(params["params"]["Dense_0"]
                                       ["kernel"].T),
        "dense_0.bias": torch.tensor(params["params"]["Dense_0"]["bias"]),
    })
    out = emb(torch.tensor(tokens))
    assert out.dtype == BF16
    np.testing.assert_array_equal(f32(out), f32(jemb.apply(params, tokens)))

    actions = rng.integers(0, 3, (3, 6)).astype(np.int32)
    jact = JaxActionEmbedding(num_actions=3, action_dim=4)
    aparams = perturbed(jact.init(jax.random.key(1), actions), 3)
    act = ActionEmbedding(3, 4, compute_dtype=BF16)
    act.embedding.weight.data = torch.tensor(
        aparams["params"]["Embed_0"]["embedding"])
    out = act(torch.tensor(actions))
    assert out.dtype == BF16
    np.testing.assert_array_equal(f32(out),
                                  f32(jact.apply(aparams, actions)))


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_flax_bit_for_bit(stride):
    """flax's bf16 ``nn.Conv`` (padding 1) against the unfold + GEMM one,
    both rounding the product before the bias add."""
    rng = np.random.default_rng(stride)
    x = rng.uniform(0, 255, (2, 9, 9, 3)).astype(np.float32)
    w = (0.05 * rng.standard_normal((3, 3, 3, 16))).astype(np.float32)
    b = (0.3 * rng.standard_normal(16)).astype(np.float32)
    ref = fnn.Conv(16, (3, 3), strides=(stride, stride), padding=1,
                   dtype=jnp.bfloat16, param_dtype=jnp.float32).apply(
        {"params": {"kernel": w, "bias": b}}, x)
    conv = Conv3x3(3, 16, stride, compute_dtype=BF16)
    conv.load_state_dict({"weight": torch.tensor(w.transpose(3, 2, 0, 1)),
                          "bias": torch.tensor(b)})
    out = conv(torch.tensor(x))
    assert out.dtype == BF16
    np.testing.assert_array_equal(f32(out), f32(ref))


ATTENTION = [
    pytest.param(2, 10, 10, 4, 8, True, id="causal-d8"),
    pytest.param(2, 10, 5, 4, 16, False, id="bag-d16"),
]


@pytest.mark.parametrize("b,lq,lk,heads,d,causal", ATTENTION)
def test_plain_attention_matches_pallas_in_bf16(b, lq, lk, heads, d, causal):
    """The kernels' plain versions on bf16 inputs (float32 inside, rounded
    once) against ``pallas_attention_packed`` on the same bf16 inputs,
    forward and backward."""
    rng = np.random.default_rng(b * lq + lk)
    e = heads * d
    q, dout = (rng.standard_normal((b, lq, e)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, lk, e)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, k, v, dout))
    ref, vjp = jax.vjp(
        lambda a, b_, c: pallas_attention_packed(a, b_, c, heads, causal),
        jq, jk, jv)
    ref_grads = vjp(jg)
    tq, tk, tv = (torch.tensor(x).to(BF16).requires_grad_(True)
                  for x in (q, k, v))
    out = cuda_attention.cuda_attention_packed(tq, tk, tv, heads, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.tensor(dout).to(BF16))
    assert out.dtype == BF16 and all(g.dtype == BF16 for g in grads)
    assert_within_ulp(out, ref, FWD_ATOL)
    for got, want in zip(grads, ref_grads):
        assert_within_ulp(got, want, GRAD_ATOL)


def test_stock_op_attention_matches_xla_in_bf16():
    """``plain_attention_packed`` with a key mask and ``attention_probs``
    compute their scores, mask and softmax in bf16, as ``_xla_attention``
    and ``attention_probs`` do."""
    rng = np.random.default_rng(5)
    b, lq, lk, heads, d = 3, 6, 5, 2, 8
    q = rng.standard_normal((b, lq, heads * d)).astype(np.float32)
    k, v = (rng.standard_normal((b, lk, heads * d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, lk)) < 0.7
    mask[:, 0] = True
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = _xla_attention(jq.reshape(b, lq, heads, d),
                         jk.reshape(b, lk, heads, d),
                         jv.reshape(b, lk, heads, d), causal=False,
                         kv_mask=jnp.asarray(mask)).reshape(b, lq, -1)
    tq, tk, tv = (torch.tensor(x).to(BF16) for x in (q, k, v))
    out = plain_attention_packed(tq, tk, tv, heads,
                                 kv_mask=torch.tensor(mask))
    assert out.dtype == BF16
    assert_within_ulp(out, ref, 0.0)
    lq = lk
    probs = attention_probs(tq[:, :lq], tk, num_heads=heads, causal=True)
    ref = jax_attention_probs(jq[:, :lq], jk, num_heads=heads, causal=True)
    assert probs.dtype == BF16
    assert_within_ulp(probs, ref, 0.0)


# ---------------------------------------------------------- whole networks
B, L = 3, 6
NETWORKS = [
    # (model, env, network options, carries a bag)
    ("DTQN", "DiscreteCarFlag-v0", dict(inner_embed=16, num_heads=2), False),
    ("DTQN", "gv_memory.7x7.yaml", dict(inner_embed=16, num_heads=2,
                                        bag_size=3), True),
    ("DTQN", "DiscreteCarFlag-v0", dict(inner_embed=16, num_heads=2,
                                        gate="gru", identity=True), False),
    ("DRQN", "Memory-5-v0", dict(inner_embed=16), False),
    ("DTQN", "ImageMaze-9-v0", dict(inner_embed=16, num_heads=2), False),
]


def network_inputs(env, seed, bag):
    rng = np.random.default_rng(seed)
    shape = tuple(env.obs_shape)
    if env.is_discrete:
        def obs(n):
            return rng.integers(0, int(env.obs_vocab_size) - 1,
                                (B, n, *shape)).astype(np.int32)
    elif len(shape) == 3:
        def obs(n):
            return rng.integers(0, 256, (B, n, *shape)).astype(np.uint8)
    else:
        def obs(n):
            return rng.uniform(-1.1, 1.1, (B, n, *shape)).astype(np.float32)
    args = [obs(L), rng.integers(0, env.num_actions, (B, L)).astype(np.int32)]
    if bag:
        args += [obs(bag), rng.integers(0, env.num_actions,
                                        (B, bag)).astype(np.int32)]
    return args


def jax_q(jnet, params, args, dtype):
    """Q of the JAX network computed in ``dtype``, op by op.  Not under
    ``jit``: there XLA's CPU backend may drop the bf16 rounding between two
    fused operations (excess precision), which makes the jitted bf16 Q
    another function, one that no op-by-op framework reproduces."""
    set_compute_dtype(dtype)
    q = jnet.apply(params, *args)
    return f32(q[0] if isinstance(q, tuple) else q)


@pytest.mark.parametrize(
    "model,env_name,kw,bag", NETWORKS,
    ids=["flagless", "bag", "gru-identity", "drqn", "imagemaze"])
def test_network_q_matches_jax_in_bf16(model, env_name, kw, bag, jax_bf16):
    kw = dict(kw, **({} if model == "DRQN" else dict(context_len=L,
                                                     num_layers=1)))
    env = make_env(env_name)
    jnet = jax_build_network(model, jax_make_env(env_name), **kw)
    args = network_inputs(env, 7, kw.get("bag_size", 0))
    params = perturbed(jnet.init(jax.random.key(0), *args), 8)
    q32 = jax_q(jnet, params, args, "float32")
    q16 = jax_q(jnet, params, args, "bfloat16")

    tnet = build_network(model, env, compute_dtype=BF16, **kw)
    tnet.load_state_dict(params_from_jax(params), strict=True)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    with torch.no_grad():
        q = tnet(*(torch.tensor(a) for a in args))
    q = q[0] if isinstance(q, tuple) else q
    assert q.dtype == BF16

    ratio = rms(f32(q), q16) / rms(q16, q32)
    print(f"{model} {env_name}: port-vs-JAX bf16 RMS / JAX bf16-vs-f32 RMS "
          f"= {ratio}")
    assert ratio <= 0.5
    np.testing.assert_array_equal(f32(q), q16)
    np.testing.assert_allclose(f32(q), q32, atol=0.05, rtol=0.1)


def test_bf16_dtypes_follow_flax():
    """Where each dtype lands: the Dense, Embed and Conv outputs and the
    attention's inputs and outputs bf16; the residual stream, the
    LayerNorms, the GRU gate and the LSTM float32; parameters float32."""
    seen = {}

    def note(name):
        def hook(module, inputs, output):
            out = output[0] if isinstance(output, tuple) else output
            seen.setdefault(name, set()).add(
                (tuple(x.dtype for x in inputs
                       if isinstance(x, torch.Tensor)), out.dtype))
        return hook

    real = cuda_attention.attention_fwd

    def attention(q, k, v, *rest):
        out = real(q, k, v, *rest)
        seen.setdefault("attention", set()).add(
            ((q.dtype, k.dtype, v.dtype), out.dtype))
        return out

    nets = [build_network("DTQN", make_env("ImageMaze-9-v0"), inner_embed=16,
                          num_heads=2, context_len=4, num_layers=1,
                          gate="gru", compute_dtype=BF16),
            build_network("DRQN", make_env("Memory-5-v0"), inner_embed=16,
                          compute_dtype=BF16)]
    for net in nets:
        for module in net.modules():
            kind = type(module).__name__
            if kind == "Dense" and module.compute_dtype is None:
                kind = "float32 Dense"  # the GRU gate's
            if kind in ("Dense", "float32 Dense", "Conv3x3", "LayerNorm",
                        "GRUGate", "LSTM", "DiscreteObsEmbedding"):
                module.register_forward_hook(note(kind))
    old, cuda_attention.attention_fwd = cuda_attention.attention_fwd, attention
    try:
        nets[0](torch.zeros(2, 4, 3, 9, 9, dtype=torch.uint8),
                torch.zeros(2, 4, dtype=torch.int32))
        nets[1](torch.zeros(2, 4, *make_env("Memory-5-v0").obs_shape,
                            dtype=torch.int32),
                torch.zeros(2, 4, dtype=torch.int32))
    finally:
        cuda_attention.attention_fwd = old
    f, b = torch.float32, BF16
    assert {o for _, o in seen["Dense"]} == {b}
    assert seen["float32 Dense"] == {((f,), f)}  # the gate widens first
    assert {o for _, o in seen["Conv3x3"]} == {b}
    assert {o for _, o in seen["DiscreteObsEmbedding"]} == {b}
    assert seen["attention"] == {((b, b, b), b)}
    assert seen["LayerNorm"] == {((f,), f)}
    assert seen["GRUGate"] == {((f, b), f)}  # (residual, attention/FFN out)
    assert {o for _, o in seen["LSTM"]} == {f}
    assert all(p.dtype == f for net in nets for p in net.parameters())
    # A residual stream that is not float32 is refused, not cast.
    with pytest.raises(TypeError, match="float32"):
        nets[0].layers[0](torch.zeros(2, 4, 16, dtype=BF16))
    assert isinstance(nets[0].layers[0].attn_gate, GRUGate)
    assert isinstance(nets[1].lstm, LSTM)


# ---------------------------------------------------------------- updates
ENV = "DiscreteCarFlag-v0"
SMALL = dict(num_envs=4, inner_embed=16, num_heads=2, num_layers=1,
             context_len=6, history=4, batch_size=4, buffer_size=400,
             target_update_frequency=10)


def batch_arrays(env, seed, b, length):
    rng = np.random.default_rng(seed)
    if env.is_discrete:
        obs = rng.integers(0, int(env.obs_vocab_size) - 1,
                           (b, length + 1, *env.obs_shape)).astype(np.int32)
    else:
        obs = rng.uniform(-1.1, 1.1, (b, length + 1, 3)).astype(np.float32)
    act = rng.integers(0, env.num_actions, (b, length + 1)).astype(np.int32)
    return dict(
        obs=obs[:, :-1], action=act[:, :-1], next_obs=obs[:, 1:],
        next_action=act[:, 1:],
        reward=rng.choice([-1.0, 0.0, 1.0], (b, length)).astype(np.float32),
        done=rng.random((b, length)) < 0.1,
        ep_len=rng.integers(1, length + 1, b).astype(np.int32),
    )


def jax_gradients(jagent, params, arrays):
    """The gradient of ``apply_update``'s loss (dtqn_tpu/agents/base.py:
    465-518, no dropout) in the JAX package's current compute dtype."""
    cfg, hist = jagent.config, jagent.config.history
    obs, act, nobs, nact = (jnp.asarray(arrays[k]) for k in (
        "obs", "action", "next_obs", "next_action"))

    def q(p, o, a):
        return jagent._q_context(p, o, a, None, jnp.asarray(
            arrays["ep_len"]), dropout_key=jax.random.key(0))

    nq = q(params, nobs, nact)
    next_q = jnp.take_along_axis(nq, jnp.argmax(nq, -1)[..., None],
                                 -1)[..., 0].astype(jnp.float32)
    targets = (jnp.asarray(arrays["reward"]) + (1.0 - jnp.asarray(
        arrays["done"]).astype(jnp.float32)) * cfg.gamma * next_q)

    def loss(p):
        qt = jnp.take_along_axis(q(p, obs, act), act[..., None],
                                 -1)[..., 0].astype(jnp.float32)
        return jnp.mean(jnp.square(qt[:, -hist:] - targets[:, -hist:]))

    return jax.grad(loss)(params)


@pytest.mark.parametrize("model,env_name", [("DTQN", ENV),
                                            ("DTQN", "Memory-5-v0")],
                         ids=["continuous", "tokens"])
def test_apply_update_in_bf16(model, env_name, jax_bf16, monkeypatch):
    """One update: float32 loss, gradients, parameters and Adam moments;
    the gradients against the JAX package's bf16 ones (relative error per
    parameter, the token table's on its own tolerance)."""
    kw = dict(SMALL, target_update_frequency=10)
    jagent = JaxAgent(JaxConfig(model=model, **kw), jax_make_env(env_name))
    agent = Agent(AgentConfig(model=model, bf16=True, **kw),
                  make_env(env_name), device="cpu")
    state = agent.init_state(0)
    params = perturbed(jagent.init_state(jax.random.key(0)).params, 4)
    state.network.load_state_dict(params_from_jax(params))
    state.target_network.load_state_dict(params_from_jax(params))
    state.buffer.flushed_total.fill_(100)
    arrays = batch_arrays(agent.env, 1, 4, 6)
    batch = replay.Batch(**{k: torch.tensor(v) for k, v in arrays.items()})

    captured = {}
    real = agent_base.clip_adam_update

    def capture(params_, flat_grads, gnorm, *rest):
        captured.update(grads=flat_grads.clone(), gnorm=gnorm)
        return real(params_, flat_grads, gnorm, *rest)

    monkeypatch.setattr(agent_base, "clip_adam_update", capture)
    agent.apply_update(state, batch)
    assert int(state.train_steps) == 1 and int(state.nonfinite_grads) == 0
    for t in (captured["grads"], captured["gnorm"], state.params,
              state.target_params, state.opt_state.mu, state.opt_state.nu,
              state.diagnostics.averages.buf):
        assert t.dtype == torch.float32
    assert all(p.dtype == torch.float32
               for p in state.network.parameters())

    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_gradients(jagent, params, arrays)))
    set_compute_dtype("float32")
    ref32 = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_gradients(jagent, params, arrays)))
    offset, spread = 0, []
    for name, p in state.network.named_parameters():
        got = captured["grads"][offset:offset + p.numel()].reshape(p.shape)
        offset += p.numel()
        want = ref[name]
        scale = float(want.norm()) or 1.0
        err = float((got - want).norm()) / scale
        spread.append(float((ref32[name] - want).norm()) / scale)
        # The bias (and token table) gradients are sums over the batch:
        # JAX's are taken in bf16, the port's in float32, rounded once.
        summed = name.endswith("bias") or name.endswith("embedding.weight")
        assert err <= (2e-2 if summed else 1e-5), (name, err)
    # bf16 moves the gradients by more than the port's difference: the
    # comparison can see a layer computed in the wrong dtype.
    assert min(spread) > 1e-3


def test_bf16_training_steps_stay_finite():
    """``tests/test_bf16.py::test_bf16_training_step`` for the port: five
    updates apply, none non-finite, parameters float32, finite
    diagnostics."""
    env = make_env(ENV)
    env.max_episode_steps = 20
    agent = Agent(AgentConfig(model="DTQN", num_envs=4, context_len=8,
                              history=8, inner_embed=16, num_heads=2,
                              num_layers=1, buffer_size=800, batch_size=4,
                              target_update_frequency=10, bf16=True),
                  env, device="cpu")
    state = agent.init_state(0)
    make_prepopulate_fn(agent, 60)(state)
    make_train_chunk_fn(agent, EpsilonSchedule(1.0, 0.1, 100), 1, 5)(state)
    assert int(state.train_steps) == 5
    assert int(state.nonfinite_grads) == 0
    assert all(p.dtype == torch.float32
               for p in state.network.parameters())
    assert state.params.dtype == torch.float32
    for v in state.diagnostics.means().values():
        assert bool(torch.isfinite(v))


def test_stacked_bf16_update_equals_per_seed_updates():
    """Two seeds stacked in bf16 against each seed's own bf16 state: two
    updates each, on the batches each samples from its own ring."""
    agent = Agent(AgentConfig(model="DTQN", bf16=True, **dict(
        SMALL, target_update_frequency=1)), make_env(ENV), device="cpu")
    agent.env.max_episode_steps = 12
    stacked = agent.init_sweep_state([3, 8])
    singles = [agent.init_state(s) for s in (3, 8)]
    for st in (stacked, *singles):
        make_prepopulate_fn(agent, 40)(st)
        for _ in range(2):
            agent.learn(st)
    assert stacked.train_steps.tolist() == [2, 2]
    for i, one in enumerate(singles):
        torch.testing.assert_close(stacked.params[i], one.params, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(stacked.target_params[i],
                                   one.target_params, rtol=1e-5, atol=1e-6)


def test_bf16_argmax_ties_take_the_first_maximum():
    """bf16 makes ties common: values that differ in float32 round to one
    bf16 value, and the greedy action is the first of them, as
    ``jnp.argmax`` takes it."""
    q32 = np.array([[0.1, 0.10001, 0.1], [1.0, 1.001, 1.002]], np.float32)
    qt = torch.tensor(q32).to(BF16)
    assert torch.equal(qt[0, 0], qt[0, 1]) and torch.equal(qt[1, 0], qt[1, 2])
    want = np.asarray(jnp.argmax(jnp.asarray(q32).astype(jnp.bfloat16), -1))
    assert torch.argmax(qt, -1).tolist() == want.tolist() == [0, 0]
    # Through the agent: a head that gives every action the same Q.
    agent = Agent(AgentConfig(model="DTQN", bf16=True, **SMALL),
                  make_env(ENV), device="cpu")
    state = agent.init_state(0)
    with torch.no_grad():
        state.network.head_out.weight.zero_()
        state.network.head_out.bias.fill_(0.3)
    actions, _ = agent.greedy_actions(state.network, state.context)
    assert actions.tolist() == [0] * SMALL["num_envs"]
