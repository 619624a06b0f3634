"""Exchange + step composition and plan execution (one device)."""
from repro_torch.parallel.build import (  # noqa: F401
    build_step, init_dlrm_opt_state, shard_dlrm_params)
from repro_torch.parallel.exchange import (  # noqa: F401
    EmbeddingExchange, PlannedTieredExchange, RowWiseExchange,
    TableWiseExchange, acc_key, make_exchange, planned_forward,
    row_wise_backward_update, row_wise_forward)
from repro_torch.parallel.plan import (  # noqa: F401
    PlanGroups, merge_dlrm_params_by_plan, plan_table_groups,
    reconcile_plan_with_mesh, split_dlrm_params_by_plan,
    split_dlrm_params_in_place)
from repro_torch.parallel.updates import (  # noqa: F401
    adagrad_row_update, sgd_row_update)
