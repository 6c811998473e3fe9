"""How far a last-bit change of the state moves ORCA's filtered acceleration.

    python scripts/rvo_sensitivity_probe.py [--envs 256] [--steps 25]

Runs BASELINE config 4's env (10 agents, 10 landmarks, 2 walls, the double
integrator, world 4) with ``--safety_filter_type rvo`` in float64 on the
CPU, from the seed and actions of ``chip_smoke.py``'s safety_env_card phase.
At each step it filters the controls from the state and from the state
with each entry moved by up to 1e-16 of itself, and prints, over the
agents whose most-violated constraints are the same in all ``ORCA_ITERS``
iterations of both, the largest change of the acceleration: the cyclic
projections amplify a rounding difference of the inputs, so a card and the
CPU can differ there far beyond the last bit without a differing choice.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs import actions as action_mod  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs import env as env_mod  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.safety import rvo  # noqa: E402

SEED = 14  # chip_smoke.py's SEED + 14


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=25)
    args = ap.parse_args(argv)
    p = EnvParams(cfg=vehicle_config("double_integrator"), num_agents=10, num_landmarks=10,
                  num_walls=2, world_size=4.0, episode_length=args.steps,
                  use_safety_filter=True, safety_filter_type="rvo")
    gen = torch.Generator().manual_seed(SEED)
    state, _ = env_mod.reset(p, args.envs, gen, "cpu", torch.float64)
    rng = np.random.RandomState(SEED)
    table = torch.as_tensor(action_mod.action_table(p.cfg, p.total_actions), dtype=torch.float64)
    worst = 0.0
    for t in range(args.steps):
        act = torch.as_tensor(rng.randint(0, p.num_actions, (args.envs, p.num_agents)))
        u, st = table[act], state.agent_states
        noise = torch.rand(st.shape, generator=torch.Generator().manual_seed(t),
                           dtype=torch.float64)
        moved = st * (1 + 2e-16 * (noise - 0.5))
        tr, tr_moved = {}, {}
        a = rvo.rvo_filter(st, u, p.cfg, trace=tr)[0]
        a_moved = rvo.rvo_filter(moved, u, p.cfg, trace=tr_moved)[0]
        same = (tr["most_violated"][0] == tr_moved["most_violated"][0]).all(dim=-1)
        change = torch.where(same, (a - a_moved).abs().amax(dim=-1), 0.0)
        worst = max(worst, change.max().item())
        print(f"step {t:2d}: largest acceleration change {change.max().item():.3e} "
              f"({int((~same).sum())} agents with another most-violated choice left out)")
        state, _ = env_mod.step(p, state, act, gen)
    print(f"largest over {args.steps} steps: {worst:.3e}")
    return worst


if __name__ == "__main__":
    main()
