"""The one traffic generator's parameters: a mix (`traffic/<mix>.json`) is
data, read here and run by the harness's closed loop.

    loop            "closed": one client sends its next call as soon as
                    the last returns (the only loop the harness runs)
    batch           requests per call
    pool            distinct inputs made at set-up from the seed and sent
                    in turn
    trace_calls     calls the traced run profiles after its window
    check_calls     calls whose outputs are held against the reference,
                    a sample drawn from the seed of the window's calls
    source          where the mix comes from (text; the generator does
                    not read it)

Every draw is made from `subseed(seed, ...)`, so the same seed gives the
same inputs.  Seeds are any whole number; they are folded to 64 bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

#: keys a mix may hold, with their defaults
DEFAULTS: Dict[str, Any] = {"loop": "closed", "batch": 1, "pool": 1,
                            "trace_calls": 1, "check_calls": 1,
                            "source": ""}


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and the
    stream's tags (valid for numpy and for `torch.Generator`)."""
    words = [int(seed) % (1 << 64)] + [int(t) % (1 << 64) for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, np.uint64)
    return int(state[0]) >> 1


def mix(doc: Dict[str, Any]) -> Dict[str, Any]:
    """A mix with its defaults filled in; refuses unknown keys and loops."""
    unknown = set(doc) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    out = {**DEFAULTS, **doc}
    if out["loop"] != "closed":
        raise ValueError(f"loop {out['loop']!r}: only 'closed' is run")
    return out
