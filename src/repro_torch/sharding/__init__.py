"""Sharding rules and the ambient mesh: the port's counterpart of
`repro.sharding` (`rules`, `ctx`), plus `shard_params`, the counterpart
of `jax.device_put` by a sharding tree."""
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        batch_shardings, batch_spec,
                                        cache_shardings, param_shardings,
                                        param_spec, replicated, sanitize,
                                        shard_params)
__all__ = ["NamedSharding", "PartitionSpec", "batch_shardings", "batch_spec",
           "cache_shardings", "param_shardings", "param_spec", "replicated",
           "sanitize", "shard_params"]
