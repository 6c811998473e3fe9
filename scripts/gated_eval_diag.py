"""Three CPU checks behind the gated checkpoints' evaluations on the card.

    python scripts/gated_eval_diag.py trajectories {rot_inv,three_phase} [--seeds 3 4]
    python scripts/gated_eval_diag.py port_eval NAME [NAME ...]
    python scripts/gated_eval_diag.py jax_seeds NAME [--first 4 --count 20]

``trajectories`` (needs JAX): the converted checkpoint's policy, in the
port, picks deterministic actions from the port's observations for 8 envs
over a whole 75-step episode, and the port's env and the JAX package's step
on those actions from the same converted state, held at 1e-9 in float64 on
every step as ``tests/test_torch_env_gated.py step_both`` holds them
(freezes and auto-resets included).  It shows whether the two envs agree
along trained trajectories (through the corridor, the goal reaches and the
auto-reset), which random actions seldom reach.

``port_eval`` (torch only): the port's batched evaluation (4 x 256
deterministic episodes, seeds 100-103) of a converted gated checkpoint on
the CPU, seed by seed beside the JAX package's rows of its
``jax_eval*.json``: NAME is a label of ``chip_smoke.py GATED_EVALS``.

``jax_seeds`` (needs JAX): the JAX package's batched evaluation of a
shipped checkpoint (a name of ``scripts/orbax_to_torch.py``) at seeds
``100 + first`` onwards, beyond the four of its ``jax_eval.json``: how far
its seed means spread, which the four-seed bars estimate.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _port_checkpoint(rel_dir, jax_file):
    """(JAX file, env params, policy, runner, restored TrainState) of a
    converted checkpoint, built as chip_smoke.py builds it, on the CPU."""
    from contracts_marl_aam_corridors_tpu_torch.cli import train as cli_train
    from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import (
        arch_act_flags, restore_checkpoint,
    )

    d = os.path.join(ROOT, rel_dir)
    with open(os.path.join(d, jax_file)) as f:
        ref = json.load(f)
    args = parse_all(ref["argv"])
    for k, v in arch_act_flags(d).items():
        setattr(args, k, v)
    env, policy, trainer, runner = cli_train.build(args, "cpu")
    ts, _ = restore_checkpoint(d, trainer.init_state(0))
    return ref, env, policy, runner, ts


def trajectories(scenario: str, seed: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401  (JAX on the CPU in float64)
    import test_torch_env_gated as T

    T.EP_LEN = 75  # the recipe's episode; the cached JAX step is built with it
    _, env, policy, runner, ts = _port_checkpoint(
        os.path.join("model_weights_torch", scenario, "airtaxi"), "jax_eval.json")
    B, N, E = T.B, env.num_agents, env.num_entities
    jstate = T.jax_reset(scenario, seed)
    tstate, obs, node, adj, aid = T.corridor.reset_outputs(T.port_params(scenario),
                                                           T.to_port(jstate))
    jstate = T.jax_resets(scenario)[1](jstate)[0]
    h = torch.zeros((B * N, policy.cfg.recurrent_n, policy.cfg.hidden_size))
    masks = torch.ones((B * N, 1))
    prev_done = torch.zeros((B, N), dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    fl = lambda x: x.reshape((B * N,) + x.shape[2:]).float()
    froze, entered = 0, 0
    for t in range(T.EP_LEN):
        avail = runner._stop_avail(prev_done).float()
        with torch.no_grad():
            acts, h = policy.act(ts.params, None, fl(obs), fl(node),
                                 fl(adj[:, None].expand(B, N, E, E)), aid.reshape(B * N, 1),
                                 h, masks, fl(avail), deterministic=True)
        tstate, step, _, jstate, frozen = T.step_both(
            scenario, tstate, jstate, acts.reshape(B, N).numpy(), gen, f"step {t}")
        froze += len(frozen)
        entered = max(entered, int((np.asarray(step.info["Phase_reached"]) >= 1).sum()))
        obs, node, adj = step.obs, step.node_obs, step.adj
        masks = 1.0 - step.done.reshape(B * N, 1).float()
        h = h * masks[..., None]
        prev_done = step.done
    return {"scenario": scenario, "seed": seed, "envs": B, "steps": T.EP_LEN,
            "equal_at_1e-9": True, "freezes": froze, "most_agents_past_the_entrance": entered}


def port_eval(label: str) -> dict:
    import torch

    import chip_smoke

    torch.set_num_threads(4)
    entry = {e[0]: e for e in chip_smoke.GATED_EVALS}[label]
    _, rel_dir, jax_file, held = entry
    ref, env, _, runner, ts = _port_checkpoint(str(rel_dir), jax_file)
    rows = []
    for s in range(chip_smoke.EVAL_SEEDS):
        t0 = time.perf_counter()
        out = runner.eval_episode(ts, 100 + s, chip_smoke.EVAL_BATCH)
        rows.append({"seed": 100 + s, "seconds": time.perf_counter() - t0,
                     "port": {k: out["eval_" + k] for k in held},
                     "jax": {k: ref["rows"][s][k] for k in held}})
        print(json.dumps({"label": label, **rows[-1]}), flush=True)
    mean = lambda side, k: sum(r[side][k] for r in rows) / len(rows)
    return {"label": label, "port_mean": {k: mean("port", k) for k in held},
            "jax_mean": {k: mean("jax", k) for k in held}}


def jax_seeds(name: str, first: int, count: int) -> dict:
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import orbax_to_torch

    jax.config.update("jax_platforms", "cpu")
    _, _, jts, eval_fn = orbax_to_torch.jax_side(name)
    rows = []
    for s in range(first, first + count):
        out = eval_fn(jts, jax.random.PRNGKey(100 + s))
        rows.append({k.replace("eval_", ""): float(np.asarray(v)) for k, v in out.items()})
    col = lambda k: np.asarray([r[k] for r in rows])
    c = col("num_agent_collisions")
    return {"name": name, "seeds": [100 + first, 100 + first + count - 1],
            "num_agent_collisions": [round(float(v), 4) for v in c],
            "collisions_mean": float(c.mean()), "collisions_seed_sd": float(c.std(ddof=1)),
            "success_rate_mean": float(col("success_rate").mean()),
            "all_success_rate_mean": float(col("all_success_rate").mean())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    tr = sub.add_parser("trajectories")
    tr.add_argument("scenario", choices=["rot_inv", "three_phase"])
    tr.add_argument("--seeds", type=int, nargs="+", default=[3])
    pe = sub.add_parser("port_eval")
    pe.add_argument("labels", nargs="+")
    js = sub.add_parser("jax_seeds")
    js.add_argument("name")
    js.add_argument("--first", type=int, default=4)
    js.add_argument("--count", type=int, default=20)
    a = p.parse_args(argv)
    if a.mode == "jax_seeds":
        print(json.dumps(jax_seeds(a.name, a.first, a.count)), flush=True)
    elif a.mode == "trajectories":
        for seed in a.seeds:
            print(json.dumps(trajectories(a.scenario, seed)), flush=True)
    else:
        for label in a.labels:
            print(json.dumps(port_eval(label)), flush=True)


if __name__ == "__main__":
    main()
