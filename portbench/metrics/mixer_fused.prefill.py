"""Mamba layers of a traced prefill whose conv and gated norm ran the
`mamba_mixer` kernels (the model's `last_prefill_counts["mixer_fused"]`:
one a layer on a card).  None where the program keeps no such counter."""


def read(run):
    layers = [t["counters"]["mixer_fused"] for t in run.traced
              if "mixer_fused" in t["counters"]]
    return sum(layers) / len(layers) if layers else None
