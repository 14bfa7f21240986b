"""PyTorch/CUDA port of ``dtqn_tpu`` for one NVIDIA H100.

Mirrors ``dtqn_tpu``'s layout (envs, models, ops, replay, agents, train,
parallel, utils) module for module.  The attention forward and backward are
hand-written CUDA kernels (``csrc/attention.cu``); everything else is plain
PyTorch.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
