"""Exchange + step composition (one device in this slice)."""
from repro_torch.parallel.build import build_step  # noqa: F401
from repro_torch.parallel.exchange import (  # noqa: F401
    EmbeddingExchange, TableWiseExchange, make_exchange)
