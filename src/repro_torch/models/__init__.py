from repro_torch.models.common import (  # noqa: F401
    COMPUTE_DTYPE, PARAM_DTYPE, Params, count_params)
