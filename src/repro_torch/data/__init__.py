from repro_torch.data.recsys import (  # noqa: F401
    RecSysBatch, make_recsys_batch, recsys_batch_iterator)
