from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adagrad, adamw, cosine_schedule, sgd)
