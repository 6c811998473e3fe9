"""Discrete action decoding as a precomputed lookup table (port of
``envs/actions.py``).

Semantics (reference ``multiagent/environment.py:336-475`` ``_set_action``):

* Unicycle/AirTaxi: ``angle_rate_index = argmax // accel_options``,
  ``accel_index = argmax % accel_options`` over
  ``linspace(-w_max, w_max, angrate_options)`` x ``linspace(a_min, a_max,
  accel_options)``.
* DoubleIntegrator, 5 actions: index 1 -> +x, 2 -> -x, 3 -> +y, 4 -> -y,
  0 -> stop; 9 actions: the compass map with 0.71 diagonals.
* Every decoded control is multiplied by ``sensitivity`` = 5.0
  (environment.py:460-463), for all dynamics.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config.physics import DynamicsType, VehicleConfig

SENSITIVITY = 5.0

_DI_9_MAP = np.array(
    [
        [0.0, 0.0],
        [-1.0, 0.0],
        [-0.71, -0.71],
        [0.0, -1.0],
        [0.71, -0.71],
        [1.0, 0.0],
        [0.71, 0.71],
        [0.0, 1.0],
        [-0.71, 0.71],
    ]
)


def action_table(cfg: VehicleConfig, total_actions: int = 5) -> np.ndarray:
    """The static ``(A, 2)`` decoded-control table (sensitivity applied)."""
    if cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
        if total_actions == 5:
            table = np.array(
                [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]
            )
        elif total_actions == 9:
            table = _DI_9_MAP.copy()
        else:
            raise ValueError(f"double_integrator supports 5 or 9 actions, got {total_actions}")
    else:
        angle_rates = np.linspace(
            -cfg.angular_rate_max, cfg.angular_rate_max, cfg.angrate_options
        )
        accels = np.linspace(cfg.accel_min, cfg.accel_max, cfg.accel_options)
        idx = np.arange(cfg.num_motion_primitives)
        table = np.stack(
            [angle_rates[idx // cfg.accel_options], accels[idx % cfg.accel_options]],
            axis=-1,
        )
    return table * SENSITIVITY


def decode(action_idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather controls for integer action indices of any batch shape."""
    return table[action_idx]


def stop_action_index(num_actions: int) -> int:
    """The 'stop' action the runner forces for done agents
    (``collect_with_mask``, graph_mpe_runner.py:277: ``action_space.n // 2``)."""
    return num_actions // 2
