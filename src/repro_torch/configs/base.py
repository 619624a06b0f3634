"""DLRM-RM2 model configuration (paper Table XII).

A plain frozen dataclass, so configs are hashable, printable and
serializable. The port keeps its own copy of the reference's
``DLRMConfig``; the LM architecture configs are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


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
