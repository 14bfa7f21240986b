"""Rollout + learn loop and prepopulation."""
