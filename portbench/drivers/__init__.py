"""Drivers: how a configuration's system under test is set up and called.

A configuration names its driver (`"driver"` in `configs/<name>.json`);
the harness imports `drivers/<driver>.py` and builds its `Driver(config,
mix, device)`.  A driver provides:

- `precision`: the type the configuration states ("float32"), which
  picks the compute peak and the control;
- `prepare(seed)`: the seed's weights and inputs, handed to the program;
- `warmup()`: every shape this cell's traffic uses, run and synchronised;
- `make(i)` (untimed) and `call(i, payload, keep)`: call i of the closed
  loop, returning when its outputs are on the host or the walk has
  synchronised; `call` returns the call's work (`requests`, and the
  program's counters) and, with `keep`, holds what the check needs;
- `work(i)`: call i's operations and bytes by kind (`counts.Work` lists);
- `release()`: frees the program's state, keeping what the check holds;
- `check(control)`: each compared number, the program's outputs against
  the plain reference (with `control`, the control in the program's
  place).
"""
