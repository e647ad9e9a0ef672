"""zamba2-7b-instruct [hybrid] — Zamba2-7B-Instruct as published
(https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json,
arXiv:2411.15242): 81 Mamba2 layers with 2 groups, 13 of them hybrid at
irregular ids, each running one of 2 alternating shared blocks on
concat[x, x0] (7168 wide, 32 heads of 224) with its own rank-128 MLP
adapter and linear.  The published model's equations
(`models/zamba2_published.py`), not the JAX package's simplified Zamba2
(`configs/zamba2_7b.py`)."""
from repro_torch.models.zamba2_published import Zamba2Layout

#: the published config.json's keys that shape the model
HF_CONFIG = {
    "adapter_rank": 128, "add_bias_linear": False,
    "attention_head_dim": 224, "attention_hidden_size": 7168,
    "chunk_size": 256, "ffn_hidden_size": 14336, "hidden_act": "gelu",
    "hidden_size": 3584,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "intermediate_size": 14336, "kv_channels": 112, "mamba_d_conv": 4,
    "mamba_d_state": 64, "mamba_expand": 2, "mamba_headdim": 64,
    "mamba_ngroups": 2, "max_position_embeddings": 4096,
    "n_mamba_heads": 112, "num_attention_heads": 32,
    "num_hidden_layers": 81, "num_key_value_heads": 32,
    "num_mem_blocks": 2, "rms_norm_eps": 1e-05, "rope_theta": 10000,
    "time_step_floor": 0.0001, "time_step_limit": None,
    "time_step_max": 0.1, "time_step_min": 0.001, "use_conv_bias": True,
    "use_long_context": False, "use_mem_rope": True,
    "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
    "vocab_size": 32000,
}

CONFIG = Zamba2Layout.from_hf(HF_CONFIG, name="zamba2-7b-instruct")
