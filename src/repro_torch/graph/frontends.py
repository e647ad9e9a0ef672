"""Graph frontends: build planner-ready graphs from model configurations.

`from_model(name_or_config)` lowers a `models.config.ModelConfig`
into a decoder-block op graph — the workload class "Characterizing Mobile
SoC for Accelerating Heterogeneous LLM Inference" identifies as the next
co-execution target:

  * **attention blocks** — q projection (splittable linear), a decode
    "attention" node over the block's KV cache (`kernels/decode_attention`,
    exclusive), o projection, residual add, then the MLP pair (up/down
    projections, both splittable) with its own residual;
  * **SSM blocks** (`ssm_kind` configs) — inner projection, a chunked-SSD
    "ssm" node (`kernels/ssd_chunk`, exclusive), out projection, residual;
  * **hybrid** (`attn_every`, zamba-style) — SSM blocks with a shared
    attention block every `attn_every` layers.

The residual edges give every block real fan-out (the block input feeds
both the first projection and the residual add), which is exactly what the
executor's gather-once rule is for.  MoE routing and normalization layers
are not modeled — they are latency-negligible at decode batch 1 next to
the projections this planner splits.

Model names resolve through `models.registry` (ARCH_IDS + aliases);
`TINY_CONFIGS` adds CPU-smoke-sized decoder configs ("tiny_decoder",
"tiny_ssm", "tiny_hybrid") used by the tests.
"""
from __future__ import annotations

from typing import List, Tuple, Union

from repro_torch.core.types import AttnOp, LinearOp, SSMOp
from repro_torch.graph.ir import Graph, Node
from repro_torch.models.config import ModelConfig

#: CPU-smoke-sized decoder configs, planable+executable in seconds
TINY_CONFIGS = {
    "tiny_decoder": ModelConfig(
        name="tiny_decoder", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256),
    "tiny_ssm": ModelConfig(
        name="tiny_ssm", family="ssm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
        attn_kind="none", ssm_kind="mamba2", ssm_state=16, ssm_head_dim=32),
    "tiny_hybrid": ModelConfig(
        name="tiny_hybrid", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
        ssm_kind="mamba2", ssm_state=16, ssm_head_dim=32, attn_every=2),
}


def model_names() -> List[str]:
    """Every name `from_model` resolves (tiny configs + model registry)."""
    from repro_torch.models.registry import ALIASES, ARCH_IDS
    return sorted(set(TINY_CONFIGS) | set(ARCH_IDS) | set(ALIASES))


def resolve_config(name_or_config: Union[str, ModelConfig]) -> ModelConfig:
    if isinstance(name_or_config, ModelConfig):
        return name_or_config
    if name_or_config in TINY_CONFIGS:
        return TINY_CONFIGS[name_or_config]
    from repro_torch.models.registry import ALIASES, ARCH_IDS
    if name_or_config in ARCH_IDS or name_or_config in ALIASES:
        from repro_torch.models.registry import get_config
        return get_config(name_or_config)
    raise ValueError(f"unknown model {name_or_config!r}; "
                     f"choices: {model_names()}")


def _attention_block(prev: str, i: int, cfg: ModelConfig, cache_len: int,
                     batch: int, nodes: List[Node]) -> str:
    d = cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window or 0
    nodes += [
        Node(id=f"b{i}.q_proj", kind="linear",
             op=LinearOp(batch, d, h * hd), inputs=(prev,)),
        Node(id=f"b{i}.attn", kind="attention",
             op=AttnOp(H=h, S=cache_len, KV=kv, hd=hd, window=window),
             inputs=(f"b{i}.q_proj",)),
        Node(id=f"b{i}.o_proj", kind="linear",
             op=LinearOp(batch, h * hd, d), inputs=(f"b{i}.attn",)),
        Node(id=f"b{i}.attn_res", kind="add",
             inputs=(prev, f"b{i}.o_proj")),
        Node(id=f"b{i}.mlp_up", kind="linear",
             op=LinearOp(batch, d, cfg.d_ff), inputs=(f"b{i}.attn_res",)),
        Node(id=f"b{i}.mlp_down", kind="linear",
             op=LinearOp(batch, cfg.d_ff, d), inputs=(f"b{i}.mlp_up",)),
        Node(id=f"b{i}.mlp_res", kind="add",
             inputs=(f"b{i}.attn_res", f"b{i}.mlp_down")),
    ]
    return f"b{i}.mlp_res"


def _ssm_block(prev: str, i: int, cfg: ModelConfig, tokens: int,
               batch: int, nodes: List[Node]) -> str:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim or 64
    heads = max(1, d_in // hd)
    d_in = heads * hd                     # re-align to whole heads
    n = cfg.ssm_state or 16
    rows = tokens * batch
    nodes += [
        Node(id=f"b{i}.in_proj", kind="linear",
             op=LinearOp(rows, d, d_in), inputs=(prev,)),
        Node(id=f"b{i}.ssm", kind="ssm",
             op=SSMOp(T=tokens, H=heads, hd=hd, N=n),
             inputs=(f"b{i}.in_proj",)),
        Node(id=f"b{i}.out_proj", kind="linear",
             op=LinearOp(rows, d_in, d), inputs=(f"b{i}.ssm",)),
        Node(id=f"b{i}.res", kind="add",
             inputs=(prev, f"b{i}.out_proj")),
    ]
    return f"b{i}.res"


def from_model(name_or_config: Union[str, ModelConfig], *,
               blocks: int = 1, cache_len: int = 128,
               tokens: int = 1, batch: int = 1) -> Graph:
    """Build a decoder-block graph for one decode step of a model config.

    * `blocks` — decoder blocks to chain (default 1: the per-block
      workload is what the planner splits; totals scale linearly).
    * `cache_len` — KV-cache length the attention nodes attend over
      (the latency-dominant decode knob).
    * `tokens` — tokens scanned per step by SSM blocks (1 = pure decode;
      larger values model chunked prefill, where the scan is long enough
      for a state-split to pay for its sync).
    * `batch` — decode sequences per step (serving buckets).  Batch rows
      fold into the row dimension of every projection — the splittable,
      latency-dominant work — while attention/ssm nodes stay charged
      per-sequence (their typed ops carry no batch axis; the exclusive
      kernel cost scales linearly and does not move split decisions).

    The entry node is a shared embedding-row projection (splittable), so
    every graph has a well-defined (batch, d_model) input contract.  The
    resulting graph passes strict `check_shapes()`.  Distinct (batch,
    cache_len) buckets produce distinct content-addressed fingerprints,
    so a plan portfolio's entries never alias in the plan cache.
    """
    cfg = resolve_config(name_or_config)
    tokens = max(1, tokens)
    batch = max(1, batch)
    if tokens > 1 and (not cfg.ssm_kind or cfg.attn_every):
        raise ValueError(
            "tokens > 1 (chunked prefill) is only modeled for pure-SSM "
            "configs; attention blocks decode one position at a time")
    d = cfg.d_model
    nodes: List[Node] = [
        Node(id="embed", kind="linear", op=LinearOp(tokens * batch, d, d),
             inputs=()),
    ]
    prev = "embed"
    for i in range(max(1, blocks)):
        if cfg.ssm_kind and cfg.attn_every:
            is_attn = (i % cfg.attn_every) == (cfg.attn_every - 1)
        elif cfg.ssm_kind:
            is_attn = False
        else:
            is_attn = True
        if is_attn and cfg.attn_kind != "none":
            prev = _attention_block(prev, i, cfg, cache_len, batch, nodes)
        else:
            prev = _ssm_block(prev, i, cfg, tokens, batch, nodes)
    graph = Graph(nodes)
    graph.check_shapes()
    return graph


def fan_out_demo(c: int = 48) -> Tuple[Graph, str]:
    """A minimal fan-out graph (one producer, two consumers, one join) —
    the executor's gather-once acceptance shape.  Returns (graph, id of
    the fanned-out producer)."""
    nodes = [
        Node(id="a", kind="linear", op=LinearOp(4, 32, c), inputs=()),
        Node(id="left", kind="linear", op=LinearOp(4, c, c),
             inputs=("a",)),
        Node(id="right", kind="linear", op=LinearOp(4, c, c),
             inputs=("a",)),
        Node(id="join", kind="add", inputs=("left", "right")),
    ]
    return Graph(nodes), "a"
