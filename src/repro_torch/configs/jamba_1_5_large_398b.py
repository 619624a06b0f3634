"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

One attention layer per 8 layers (attn_every=8); MoE MLP on every other layer.
[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, every=2, offset=1),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)
