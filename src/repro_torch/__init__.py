"""The PyTorch/CUDA port of the co-execution system.

`repro_torch` compiles co-execution plans and runs them on PyTorch
devices, with every co-executed node channel-split across two (device,
stream) groups: linear layers on the hand-written `split_matmul` CUDA
kernel, Winograd-eligible convolutions on `hadamard_matmul`, decode
attention on `decode_attention` and the SSD scan on `ssd_chunk_scan`:

    import repro_torch
    target = repro_torch.Target(device="moto2022", threads=3)
    compiled = repro_torch.compile("vgg16", target)   # no JAX involved
    y = compiled.run()               # CUDA by default; device="cpu" too

Plans compiled here are byte-identical to the JAX package's (`repro`), and
`CompiledNetwork.load` reads an artifact either package saved.
`compile_portfolio` compiles one plan per (batch, seq) serving bucket of a
model graph (`PlanPortfolio`, the reference's document byte for byte), and
`compiled.record()`, `recalibrate()` and `replan()` close the measurement
loop: executed walls fit a calibrator, which re-plans the network.  The
package imports torch and numpy, never jax and nothing from `repro`: it
keeps its own copy of what it needs.  CLI: `python -m repro_torch plan
...`, `python -m repro_torch execute --artifact PATH`, `python -m
repro_torch calibrate ...`; the models of the registry serve and train
through `python -m repro_torch serve ...` and `python -m repro_torch
train ...`.
"""
from repro_torch.api import (Bucket, CompiledNetwork, PlanPortfolio, Target,
                             available_networks, compile, compile_portfolio)

__version__ = "0.1.0"

__all__ = ["Bucket", "CompiledNetwork", "PlanPortfolio", "Target",
           "available_networks", "compile", "compile_portfolio",
           "__version__"]
