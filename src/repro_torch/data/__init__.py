from repro_torch.data.recsys import (  # noqa: F401
    RecSysBatch, make_recsys_batch, recsys_batch_iterator)
from repro_torch.data.lm import lm_batch_iterator, make_lm_batch  # noqa: F401
