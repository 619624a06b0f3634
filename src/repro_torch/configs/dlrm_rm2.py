"""DLRM-RM2 configurations — paper Table XII.

Small  = batch 200, embedding 32 fp16 (64 B rows).
Large  = batch 600, embedding 128 fp16 (256 B rows).
Each in the two table-distribution extremes of Sec. IV-A / V-A:
  table_wise = paper's "unsharded" (each table whole on one processor group)
  row_wise   = paper's "full sharding" (every table split row-wise over all chips)
"""
from repro_torch.configs.base import DLRMConfig

DLRM_SMALL_UNSHARDED = DLRMConfig(
    name="dlrm-rm2-small-unsharded", embed_dim=32, batch_size=200, sharding="table_wise")
DLRM_SMALL_SHARDED = DLRMConfig(
    name="dlrm-rm2-small-sharded", embed_dim=32, batch_size=200, sharding="row_wise")
DLRM_LARGE_UNSHARDED = DLRMConfig(
    name="dlrm-rm2-large-unsharded", embed_dim=128, batch_size=600, sharding="table_wise")
DLRM_LARGE_SHARDED = DLRMConfig(
    name="dlrm-rm2-large-sharded", embed_dim=128, batch_size=600, sharding="row_wise")

DLRM_CONFIGS = {
    c.name: c for c in (
        DLRM_SMALL_UNSHARDED, DLRM_SMALL_SHARDED,
        DLRM_LARGE_UNSHARDED, DLRM_LARGE_SHARDED,
    )
}
