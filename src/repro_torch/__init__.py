"""The PyTorch/CUDA port of the co-execution system.

`repro_torch` runs the compiled co-execution plans of the JAX package
(`repro`) on PyTorch devices: load a saved `repro.compiled_network`
artifact and execute it with every co-executed node channel-split across
two (device, stream) groups, linear layers on the hand-written
`split_matmul` CUDA kernel and Winograd-eligible convolutions on the
hand-written `hadamard_matmul` kernel:

    import repro_torch
    compiled = repro_torch.CompiledNetwork.load(path)
    y = compiled.run()               # CUDA by default; device="cpu" too

The package imports torch and numpy, never jax and nothing from `repro`:
it keeps its own copy of what it needs.  CLI:
`python -m repro_torch execute --artifact PATH`.
"""
from repro_torch.api import CompiledNetwork, Target

__version__ = "0.1.0"

__all__ = ["CompiledNetwork", "Target", "__version__"]
