"""Model configurations: the DLRM-RM2 config (paper Table XII) and the LM
architectures' configs, shapes and cells.

Plain frozen dataclasses, so configs are hashable, printable and
serializable. The port keeps its own copy of the reference's
``repro.configs.base``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 2048  # Megatron-style: pad vocab so it divides any TP degree used.


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Apply MoE MLP on layers where (layer_idx % every) == offset; dense MLP otherwise.
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"          # "mamba" | "rwkv6"
    d_state: int = 16            # mamba state dim per channel
    d_conv: int = 4              # mamba local conv width
    expand: int = 2              # mamba inner expansion
    head_dim: int = 64           # rwkv6 head size


@dataclass(frozen=True)
class ModelConfig:
    """One LM-family architecture. All the assigned archs fit this schema."""

    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm | recsys
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # --- attention variants ---
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full attention
    attn_every: int = 1          # 1 attn layer per `attn_every` layers (jamba: 8)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- state-space / linear-attention ---
    ssm: Optional[SSMConfig] = None
    # --- modality frontends (stub: input_specs provides precomputed embeddings) ---
    frontend: Optional[str] = None         # None | "vision" | "audio"
    n_frontend_tokens: int = 0             # patch/frame embeddings prepended
    # --- enc-dec (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0               # fixed source length (whisper: 1500 frames)
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"                      # silu (swiglu) | gelu
    source: str = ""                       # citation tag

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (O(T) or O(window) context cost)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def n_attn_layers(self) -> int:
        if self.attention_free:
            return 0
        return self.n_layers // self.attn_every

    # Parameter counting -------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        mlp_dense = 3 * d * ff  # swiglu: gate, up, down
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        for i in range(self.n_layers):
            has_attn = (not self.attention_free) and (i % self.attn_every == (self.attn_every - 1))
            if self.attention_free or not has_attn:
                if self.ssm is not None:
                    if self.ssm.kind == "mamba":
                        di = self.ssm.expand * d
                        total += 2 * d * di + di * self.ssm.d_conv + di * (2 * self.ssm.d_state + 2) + di * d
                    else:  # rwkv6: time-mix (r,k,v,g,o) + decay params + channel-mix
                        total += 5 * d * d + 2 * d + 3 * d * ff // 1
            if has_attn:
                total += attn
            is_moe = self.moe is not None and (i % self.moe.every == self.moe.offset)
            if is_moe:
                e = self.moe.top_k if active_only else self.moe.num_experts
                total += e * mlp_dense + d * self.moe.num_experts  # experts + router
            elif self.ssm is None or has_attn:
                total += mlp_dense
            total += 2 * d  # norms
        if self.is_encoder_decoder:
            total += self.n_encoder_layers * (attn + mlp_dense + 2 * d)
            total += self.n_layers * attn  # cross attention in decoder
        return total

    # Reduced config for CPU smoke tests ---------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: few layers, small width, tiny vocab/experts."""
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=min(4, self.moe.num_experts),
                          top_k=min(self.moe.top_k, 2))
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, d_state=8, head_dim=16)
        n_layers = max(2, 2 * self.attn_every) if self.attn_every > 1 else 2
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=16 if self.sliding_window else None,
            moe=moe,
            ssm=ssm,
            n_frontend_tokens=8 if self.frontend else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else 0,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Return (applicable, reason-if-not). Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (pure full-attention arch)"
    return True, ""


@dataclass(frozen=True)
class DLRMConfig:
    """Paper Table XII — DLRM-RM2. Sizes in elements (fp16/bf16 stored)."""

    name: str
    num_tables: int = 40
    lookups_per_table: int = 80
    embed_dim: int = 32                     # 32 fp16 = 64B (small) | 128 fp16 = 256B
    rows_per_table: int = 4_194_304         # 2**22; paper: large enough to fill memory
    num_dense: int = 256
    bot_mlp: Tuple[int, ...] = (256, 128, 32)   # final layer == embed_dim appended
    top_mlp: Tuple[int, ...] = (512, 128, 1)
    batch_size: int = 200
    sharding: str = "table_wise"            # "table_wise" (unsharded) | "row_wise"

    @property
    def bot_mlp_dims(self) -> Tuple[int, ...]:
        dims = tuple(self.bot_mlp)
        if dims[-1] != self.embed_dim:
            dims = dims + (self.embed_dim,)
        return dims

    @property
    def num_interactions(self) -> int:
        s = self.num_tables + 1  # +1 for bottom-MLP output
        return s * (s - 1) // 2  # exclude diagonal, dedupe (paper Sec III-D)

    @property
    def top_mlp_in(self) -> int:
        return self.num_interactions + self.embed_dim

    @property
    def embedding_bytes(self) -> int:
        return self.num_tables * self.rows_per_table * self.embed_dim * 2

    def flops_per_sample(self) -> int:
        """Dense-layer MAC*2 per sample (paper: ~1.40 MFLOPs small / ~2 MFLOPs large)."""
        f = 0
        prev = self.num_dense
        for w in self.bot_mlp_dims:
            f += 2 * prev * w
            prev = w
        s = self.num_tables + 1
        f += 2 * s * s * self.embed_dim  # interactions bmm
        prev = self.top_mlp_in
        for w in self.top_mlp:
            f += 2 * prev * w
            prev = w
        return f

    def reduced(self) -> "DLRMConfig":
        return replace(self, name=self.name + "-smoke", num_tables=8,
                       lookups_per_table=4, rows_per_table=128, batch_size=16)
