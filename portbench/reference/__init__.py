"""Plain references that decide `correct`: plain PyTorch in float32 with
TF32 off, importing neither `jax`, nor `repro`, nor anything of
`repro_torch`, and taking nothing the program made.  Each takes the
benchmark's own weights and inputs and works out again whatever the
program derived from them.

A reference's matrix products go through the `mm` it is given: `exact`
(fp32, TF32 off), or one of the lower precisions in `precision.py`, which
make the controls that a limit has to fail.
"""
