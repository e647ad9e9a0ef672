"""One config module per architecture (+ the paper's own models).

Every config cites its source in the module docstring and instantiates a
single `CONFIG: ModelConfig`.
"""
