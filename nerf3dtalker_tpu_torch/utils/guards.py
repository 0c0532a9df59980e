"""Numerical-failure detection and recovery (port of
`nerf3dtalker_tpu/utils/guards.py`):

  * `all_finite` — one all-finite check over a list of tensors, on the
    device (no host sync);
  * the train step keeps params, both Adam states and Adam's step count on a
    non-finite step (`train.step.apply_update`), as the JAX step's
    `tree_select` does;
  * `StepGuard` — host-side monitor that warns, aborts or asks for a
    checkpoint rollback on non-finite steps (replaces the reference's
    print-and-continue at talker_trainer.py:1071-1073 and its manual
    resume-from-checkpoint recovery, :1167-1201).
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch

log = logging.getLogger("nerf3dtalker_tpu_torch.guards")


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every element of every floating tensor is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


class StepGuard:
    """Host-side NaN monitor with a recovery policy, fed once per epoch from
    the step's `finite_step` flag:

    * ``warn``     — log; the step already kept the params;
    * ``rollback`` — `epoch_check` returns "rollback": the caller restores
                     params and optimizer from the last checkpoint;
    * ``abort``    — raise `FloatingPointError` once the run of bad steps
                     reaches ``max_bad``.
    """

    def __init__(self, max_bad: int = 10, policy: str = "warn"):
        if policy not in ("warn", "rollback", "abort"):
            raise ValueError(f"unknown guard policy {policy!r}")
        self.max_bad = max_bad
        self.policy = policy
        self.bad_run = 0
        self.total_bad = 0
        self.rollbacks = 0

    def epoch_check(self, n_bad: int, n_steps: int, epoch: int) -> str:
        """The action for the caller: "ok", "warn" or "rollback"."""
        if n_bad <= 0:
            self.bad_run = 0
            return "ok"
        self._record(n_bad, f"epoch {epoch} ({n_bad}/{n_steps} steps)")
        if self.policy == "rollback":
            self.bad_run = 0
            self.rollbacks += 1
            return "rollback"
        return "warn"

    def _record(self, n_bad: int, where: str) -> None:
        self.bad_run += n_bad
        self.total_bad += n_bad
        log.warning("non-finite gradients at %s (run of %d)", where, self.bad_run)
        if self.policy == "abort" and self.bad_run >= self.max_bad:
            raise FloatingPointError(f"{self.bad_run} consecutive non-finite steps at {where}")
