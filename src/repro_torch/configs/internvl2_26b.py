"""internvl2-26b [vlm] — InternViT + InternLM2 backbone; vision frontend is a STUB
(input_specs provides precomputed patch embeddings). [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    frontend="vision",
    n_frontend_tokens=256,  # precomputed InternViT patch embeddings per image
    source="arXiv:2404.16821",
)
