"""DDQN agent (transformer branch, no bag)."""

from dtqn_tpu_torch.agents.base import Agent, AgentConfig, AgentState

__all__ = ["Agent", "AgentConfig", "AgentState"]
