"""whisper-base [audio] — enc-dec transformer backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings for the encoder).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,               # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    encoder_seq_len=1500,     # 30 s audio at 50 Hz after conv stem (stubbed)
    frontend="audio",
    act="gelu",
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions, not RoPE
    source="arXiv:2212.04356",
)
