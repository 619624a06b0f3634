"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay linear attention.

[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,               # 2560 / 64 rwkv heads (used for state layout)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    head_dim=64,
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    source="arXiv:2404.05892",
)
