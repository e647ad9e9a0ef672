"""% of the traced calls' causal attention least time over the time in
which the `prefill_attention` kernel ran.

The work is counted here from the configuration's keys and each traced
call's batch and prompt length, as `counts_zamba2.prefill_call` counts
attention: at each hybrid layer 2 H hd T (T + 1) operations a sequence
(the score and value products over the T (T + 1) / 2 pairs a causal mask
keeps), with q and o (H heads) and k and v (KV heads) moved once at 2
bytes an element.  Where the kernel never ran (a program without it, or
no card) the reader returns None."""
import re

from portbench import readers
from portbench.counts import Work
from portbench.counts_zamba2 import BF16, hybrid_ids

KERNEL = re.compile(r"\bprefill_attention_fwd<")


def attention(cfg, batch: int, t: int) -> Work:
    """One prefill call's attention: every hybrid layer's, `batch`
    sequences of `t` tokens."""
    heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
    kv = cfg.get("num_key_value_heads", heads)
    layers = len(hybrid_ids(cfg))
    flops = layers * batch * 2.0 * heads * hd * t * (t + 1)
    moved = layers * BF16 * batch * t * hd * 2 * (heads + kv)
    return Work(flops, float(moved))


def read(run):
    if run.trace is None or run.trace.calls <= 0:
        return None
    kernel_s = run.trace.kernel_s(KERNEL.search)
    if kernel_s <= 0.0:
        return None
    bound = sum(attention(run.config, run.mix["batch"], run.driver.length(i))
                .seconds(run.compute_peak(), run.memory_peak())
                for i in readers.traced_calls(run))
    return 100.0 * bound / kernel_s
