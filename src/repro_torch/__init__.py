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
`CompiledNetwork.load` reads an artifact either package saved.  The package
imports torch and numpy, never jax and nothing from `repro`: it keeps its
own copy of what it needs.  CLI: `python -m repro_torch plan ...`,
`python -m repro_torch execute --artifact PATH`.
"""
from repro_torch.api import (CompiledNetwork, Target, available_networks,
                             compile)

__version__ = "0.1.0"

__all__ = ["CompiledNetwork", "Target", "available_networks", "compile",
           "__version__"]
