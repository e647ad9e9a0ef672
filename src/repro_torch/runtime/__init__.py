"""Plan decoding (plan.py) and the plan executor (executor.py)."""
