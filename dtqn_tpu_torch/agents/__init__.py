"""DDQN agent (transformer branch: DTQN and DTQN-bag)."""

from dtqn_tpu_torch.agents.base import Agent, AgentConfig, AgentState

__all__ = ["Agent", "AgentConfig", "AgentState"]
