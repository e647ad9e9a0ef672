"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

One command runs one cell of `BENCHMARK.json` once, from the root of a
checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The harness is driven by data.  A cell names a configuration and a
traffic mix; each is a file of its own (`configs/<config>.json`,
`traffic/<mix>.json`), a configuration names the driver that runs it
(`drivers/<driver>.py`) and the plain reference that judges it
(`reference/`), each metric is a reader of its own
(`metrics/<metric>.py`) and each cell's correctness limits are a file of
their own (`limits/<cell>.json`).  The core (`run.py`) holds no name of a
configuration, mix or metric.

The yardstick lives here and not in the program: the traffic generator
(`traffic.py`), the trace reduction (`trace.py`), the peak table
(`peaks.py`), the operation and byte counts (`counts.py`), the plain
references and the comparison that decides `correct`.  Nothing here
imports `jax` or the JAX package `repro`; the references import nothing
of `repro_torch` either.
"""
