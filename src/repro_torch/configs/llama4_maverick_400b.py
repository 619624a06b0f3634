"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, interleaved (every other layer),
early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=1, every=2, offset=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
