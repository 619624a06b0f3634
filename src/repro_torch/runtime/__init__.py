"""The training loop and its straggler accounting."""
from repro_torch.runtime.straggler import (  # noqa: F401
    Action, StepTimer, StragglerPolicy)
from repro_torch.runtime.trainer import TrainLoop  # noqa: F401
