"""Model configurations (config.py) and their name tables (registry.py).

The port's copies of `repro.models.config` and the name half of
`repro.models.registry`: what `graph.frontends.from_model` needs to build
a decoder-block graph from a model name.  The model classes come with the
port's models and serving.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import ALIASES, ARCH_IDS, get_config

__all__ = ["ModelConfig", "ALIASES", "ARCH_IDS", "get_config"]
