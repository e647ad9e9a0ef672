"""Compiled plans (plan.py: the plan codec, both halves), the on-disk plan
cache and its cached planners (cache.py), the plan executor (executor.py)
and the fused segment walk (segments.py)."""
