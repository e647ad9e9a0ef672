"""Core of the port: op types, the paper's networks, and two-group
channel-split co-execution on torch devices and streams (coexec.py)."""
