"""Training state (port of ``learner/mappo.py:32`` ``TrainState``).

The rollout reads the policy parameters and the value normalizer from it.
``GRMAPPOTrainer`` (the PPO update and its optimizers) comes with training;
until then the state holds no optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.policy import PolicyParams
from .valuenorm import ValueNormState


@dataclasses.dataclass
class TrainState:
    params: PolicyParams
    vn: Optional[ValueNormState]
