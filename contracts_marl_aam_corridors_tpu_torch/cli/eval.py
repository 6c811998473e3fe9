"""Evaluation entry point, graph path (port of the JAX package's
``cli/eval.py`` ``main`` and ``run_eval``; reference
``onpolicy/scripts/eval_mpe.py`` and ``GMPERunner.render``,
graph_mpe_runner.py:525-1060).

    python -m contracts_marl_aam_corridors_tpu_torch.cli.eval \\
        --model_dir model_weights_torch/july/unicycle --num_agents 3 \\
        --episode_length 150 --render_episodes 5 --run_dir ./results

``--model_dir`` is a models directory of the port's checkpoints (with
``latest.json``, or ``ckpt_<N>/`` directories, the highest taken) or one
``ckpt_<N>`` directory.  The run's ``config.json``, in that directory or
its parent, wins over the command line except for the env-shape and
evaluation flags (``utils/checkpoint.py merge_eval_args``), so
``--num_agents`` and ``--episode_length`` come from the command line, as in
the JAX package.
Runs deterministic episodes one env at a time, done agents held to the
stop action (:580-589), prints a line per episode and writes
``<run_dir>/eval_stats.csv`` with the JAX package's columns.  It computes in
float32, as the JAX package's eval does.  It runs on the card; ``--cuda``
(the reference's store_false flag) runs it on the CPU, and the trained run's
recorded ``cuda`` does not change that.  Refused, naming the ROADMAP item
that brings them: the classic-MPE evaluation (A9), the reference's
``actor.pt`` weights and the gif render (A11).
"""
from __future__ import annotations

import csv
import os
import sys

import torch

CSV = "eval_stats.csv"


def run_eval(args, params, policy, runner, env_params, episodes: int) -> list[dict]:
    """``episodes`` deterministic episodes of one env (the JAX package's
    ``run_eval``, cli/eval.py:22-117, without the gif frames): one row of
    stats per episode.  Success counts an agent that froze on its goal
    before the time limit or holds a goal at the last step before the
    episode ended.  A run trained with the safety filter is evaluated with
    it (the run's flags are merged); the air taxi's HJ filter takes the
    runner's table, which the JAX package's ``run_eval`` does not pass
    (cli/eval.py:38), so there its step raises."""
    from ..envs import env as env_mod

    device = policy.device
    N, E, A = env_params.num_agents, env_params.num_entities, env_params.num_actions
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rows = []
    for ep in range(episodes):
        state, ts = env_mod.reset(env_params, 1, gen, device)
        h = torch.zeros((N, policy.cfg.recurrent_n, policy.cfg.hidden_size), device=device)
        masks = torch.ones((N, 1), device=device)
        prev_done = torch.zeros((N,), dtype=torch.bool, device=device)
        reached = torch.zeros((N,), dtype=torch.bool, device=device)
        ep_rew, info, final = 0.0, {}, state
        for t in range(env_params.episode_length):
            avail = runner._stop_avail(prev_done)
            adj_rep = ts.adj[0].expand(N, E, E)
            actions, h = policy.act(params, None, ts.obs[0], ts.node_obs[0], adj_rep,
                                    ts.agent_id[0], h, masks, avail, deterministic=True)
            state, ts = env_mod.step(env_params, state, actions[:, 0][None], gen,
                                     runner.hj_data)
            done = ts.done[0]
            ep_rew += ts.reward.mean().item()
            done_f = done[:, None].to(masks.dtype)
            masks = 1.0 - done_f
            h = h * (1.0 - done_f[..., None])
            prev_done = done
            # ts.done is the terminal step before any auto-reset; an agent
            # done before the time limit froze at its goal
            if t + 1 < env_params.episode_length:
                reached = reached | done
            info = {k: v[0] for k, v in ts.info.items()}
            if bool(done.all()):
                break
            final = state
        success = (reached | (final.goal_tracker[0] >= 0)).to(torch.float64).mean().item()
        row = {
            "episode": ep,
            "ep_rew": ep_rew,
            "success_frac": success,
            "time_mean": info["Time_mean"].item(),
            "time_stddev": info["Time_stddev"].item(),
            "dist_mean": info["Distance_mean"].item(),
            "dist_stddev": info["Distance_variance"].item(),
            "agent_collisions": info["Num_agent_collisions"].sum().item(),
            "conformance": info["Conformance"].mean().item(),
            "spacing_violations": info["Spacing_violations"].mean().item(),
        }
        rows.append(row)
        print(f"[eval ep {ep}] rew {ep_rew:.2f} success {success:.2f} "
              f"collisions {row['agent_collisions']:.0f} conformance {row['conformance']:.3f}",
              flush=True)
    return rows


def main(argv=None) -> list[dict]:
    """Evaluate the checkpoint of ``--model_dir`` from the command line
    ``argv`` (the JAX package's ``main``, cli/eval.py:206-259, graph path).
    Returns the stats rows, which it also writes to ``<run_dir>/eval_stats.csv``."""
    from ..config.flags import not_ported, parse_all
    from ..utils.checkpoint import (
        load_run_config, merge_eval_args, restore_checkpoint, run_config_dir,
    )
    from .train import build

    args = parse_all(argv)
    if not args.model_dir:
        raise ValueError("--model_dir required")
    # the device is this command line's, before the run's flags are merged
    device = None if args.cuda else "cpu"
    if run_config_dir(args.model_dir) is not None:
        args = merge_eval_args(args, load_run_config(args.model_dir))
    if args.env_name == "MPE" or args.scenario_name.startswith("simple_"):
        raise not_ported("the classic-MPE evaluation", "A9")
    if args.use_render and args.save_gifs:
        raise not_ported("--use_render --save_gifs (the gif render)", "A11")
    if (os.path.exists(os.path.join(args.model_dir, "actor.pt"))
            and not os.path.exists(os.path.join(args.model_dir, "latest.json"))):
        raise not_ported("the reference's actor.pt weights", "A11")

    # deterministic evaluation runs in full precision whatever the
    # training-time compute dtype
    args.compute_dtype = "float32"
    env_params, policy, trainer, runner = build(args, device)
    ts, episode = restore_checkpoint(args.model_dir, trainer.init_state(args.seed))
    print(f"restored episode {episode} from {args.model_dir} on {policy.device}", flush=True)
    rows = run_eval(args, ts.params, policy, runner, env_params, args.render_episodes)

    os.makedirs(args.run_dir, exist_ok=True)
    out_csv = os.path.join(args.run_dir, CSV)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    mean_succ = sum(r["success_frac"] for r in rows) / len(rows)
    print(f"eval done: {len(rows)} episodes, mean success {mean_succ:.3f}; stats -> {out_csv}",
          flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
