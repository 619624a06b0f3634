"""TrainLoop: the fault-tolerant outer loop tying the substrates together.

As the reference (``repro.runtime.trainer``):

  * resume-from-latest on start (checkpoint manager + step-indexed data);
  * periodic async checkpointing;
  * straggler accounting via StepTimer/StragglerPolicy;
  * metric logging.

It is model-agnostic: it drives any ``step(state, batch) -> (state,
metrics)`` over any ``batch_fn(step) -> batch``. ``float()`` of each
metric (the step's loss, a device scalar) is the loop's one wait for the
device a step, so a step's time is its real work.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.straggler import Action, StepTimer, StragglerPolicy

log = logging.getLogger(__name__)


@dataclass
class TrainLoop:
    step_fn: Callable[[Any, Any], Any]    # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], Any]        # step -> batch
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 100
    host: str = "host-0"
    timer: StepTimer = field(default_factory=StepTimer)
    policy: StragglerPolicy = field(default_factory=StragglerPolicy)
    history: List[Dict[str, float]] = field(default_factory=list)

    def resume(self, state: Any) -> tuple[Any, int]:
        """Restore the latest checkpoint into ``state``'s structure if one
        exists."""
        if self.ckpt is None:
            return state, 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return state, 0
        state, step, _ = self.ckpt.restore(state, latest)
        log.info("resumed from step %d", step)
        return state, step

    def run(self, state: Any, n_steps: int, start_step: int = 0) -> Any:
        for step in range(start_step, start_step + n_steps):
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            # wait on the loss so the timer measures real work
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0

            straggled = self.timer.is_straggler_step(dt)
            self.timer.record(dt)
            action = self.policy.report(self.host, straggled)
            if action == Action.EVICT:
                log.error("straggler policy: EVICT %s at step %d", self.host,
                          step)
            elif action != Action.NONE:
                log.warning("straggler policy: %s at step %d", action, step)

            self.history.append({"step": step, "dt": dt, **metrics})
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return state
