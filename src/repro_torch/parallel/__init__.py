"""Exchange + step composition and plan execution (one device)."""
from repro_torch.parallel.build import build_step  # noqa: F401
from repro_torch.parallel.exchange import (  # noqa: F401
    EmbeddingExchange, PlannedTieredExchange, TableWiseExchange,
    make_exchange)
from repro_torch.parallel.plan import (  # noqa: F401
    PlanGroups, merge_dlrm_params_by_plan, plan_table_groups,
    reconcile_plan_with_mesh, split_dlrm_params_by_plan)
