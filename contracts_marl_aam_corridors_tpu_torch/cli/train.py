"""Training entry point, graph path (port of the JAX package's
``cli/train.py`` ``build`` and ``main``; reference
``onpolicy/scripts/train_mpe.py``).

    python -m contracts_marl_aam_corridors_tpu_torch.cli.train \\
        --scenario_name nav_metered_one_goal_graph_rotate_tube_july \\
        --num_agents 3 --episode_length 25 --n_rollout_threads 1024 \\
        --ppo_epoch 15 --num_mini_batch 1 --data_chunk_length 10 \\
        --num_env_steps 2000000 --dynamics_type air_taxi

The flags are the JAX package's (``config/flags.py``).  It runs on one CUDA
card; ``--cuda`` (the reference's store_false flag) runs it on the CPU.
Writes ``<run_dir>/<env>/<scenario>/<algorithm>/<experiment>/seed<seed>/``:
``metrics.jsonl`` and ``models/`` (``ckpt_<episode>/``, ``latest.json``,
``config.json``).  ``--model_dir`` resumes from a checkpoint: the state is
restored whole and training restarts at the saved episode, as the JAX
package's does.  ``--warm_start_dir`` (without ``--model_dir``) starts from
another run's weights and value normalizer, with fresh optimizers at episode
0, after taking that run's activation flags (``utils/checkpoint.py
warm_start_params``; a rot_inv checkpoint's 13-dim observation is remapped
to two/three_phase's 15):

    python -m contracts_marl_aam_corridors_tpu_torch.cli.train \
        --scenario_name three_phase_graph --warm_start_dir \
        model_weights_torch/rot_inv/airtaxi ...

``--use_curriculum True`` scales ``collision_rew``, ``formation_rew`` and
``fair_rew`` by ``stage / 10``, ``stage = int(clip(episode / episodes, 0.1,
1) * 10)`` (the reference's ``update_curriculum``, july:424-438, in the JAX
package's ten stages), and ``--increase_fairness True`` sets ``fair_rew``
to 10 at half the episodes, before the curriculum's step of that episode,
as in the JAX package.  Each change swaps the env parameters of the runner
that trains and evaluates; the ``TrainState``, the rollout carry and the
generators go on.  ``config.json`` is written from the flags at every
checkpoint, so it records the rewards of the checkpoint's stage, as the
JAX package's does, and the eval CLI's ``merge_eval_args`` evaluates with
them.  ``--use_centralized_V`` (a store_false flag) gives the critic each
agent's own observation; with ``--use_cent_obs True`` as well the critic's
input is narrower than the layers built for it, which the JAX package's
first update stops on, and the port refuses before the run writes
anything.  ``--use_safety_filter True`` filters every env step's controls
(``envs/corridor.py safety_filter``); for the air taxi with
``--safety_filter_type hj`` it reads the HJ table from
``--safety_value_fn``, or uses the synthetic table where that file is
missing, as the JAX package does.

Differences from the JAX package: one device (no data mesh, ROADMAP A10);
the classic-MPE path (``build_mpe``/``main_mpe``) waits for ROADMAP A9;
a warm start from the reference's ``actor.pt`` weights and graphs of more
entities than the trunk kernels take are refused, naming the ROADMAP item
that brings them; seeds are integers
drawn from ``--seed``, not JAX keys.  ``--compute_dtype`` defaults to
bfloat16, as the JAX package's does: the MLP tails compute in bfloat16, the
GNN trunk in float32 on the kernel trunk and in bfloat16 on the dense
route (``models/nets.py``).  ``--gnn_impl dense``, ``--gnn_concat_heads``
and ``--actor_graph_aggr global`` train both networks through the dense
per-graph GNN modules, plain torch on the card (``models/config.py``);
``config.json`` records them, and the eval CLI rebuilds the same route
from it.  On that route ``--gnn_edge_packed True`` takes the packed edge
layout and ``--fuse_gnn_trunks True`` runs both GNNs of the PPO update as
one pass over their stacked parameters; the kernel trunk ignores both, as
the JAX package's transposed route does.  ``--critic_graph_aggr node`` is refused with a ``ValueError``
before the run writes anything (``models/config.py``).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch


def build(args, device=None):
    """The env parameters, policy, trainer and runner of a graph-path run
    (the JAX package's ``build``, cli/train.py:21-107), on ``device``."""
    from ..config.flags import build_env_params, build_model_config, not_ported
    from ..learner import GRMAPPOTrainer, Runner
    from ..models import GRMAPPOPolicy, PolicyDims
    from ..ops.gnn_trunk import MAX_ENTITIES

    env_params = build_env_params(args)
    if env_params.num_entities > MAX_ENTITIES:
        raise not_ported(f"graphs of more than {MAX_ENTITIES} entities (agents, landmarks, "
                         f"obstacles and walls: {env_params.num_entities})", "A6.3")
    cfg = build_model_config(args)
    dims = PolicyDims(
        obs_dim=env_params.obs_dim,
        cent_obs_dim=env_params.obs_dim * env_params.num_agents,
        num_entities=env_params.num_entities,
        node_feat_dim=env_params.node_feat_dim,
        num_actions=env_params.num_actions,
    )
    policy = GRMAPPOPolicy(
        cfg, dims, device=device, lr=args.lr, critic_lr=args.critic_lr,
        opti_eps=args.opti_eps, max_grad_norm=args.max_grad_norm,
        use_max_grad_norm=args.use_max_grad_norm, fuse_gnn_trunks=args.fuse_gnn_trunks,
    )
    # non-recurrent 'mappo' trains on single steps (graph_buffer.py:368);
    # --use_naive_recurrent_policy on whole-episode chunks
    # (graph_buffer.py:455-596)
    if not cfg.use_recurrent_policy:
        chunk = 1
    elif args.use_naive_recurrent_policy and not args.use_recurrent_policy:
        chunk = args.episode_length
    else:
        chunk = args.data_chunk_length
    trainer = GRMAPPOTrainer(
        policy,
        clip_param=args.clip_param,
        ppo_epoch=args.ppo_epoch,
        num_mini_batch=args.num_mini_batch,
        data_chunk_length=chunk,
        value_loss_coef=args.value_loss_coef,
        entropy_coef=args.entropy_coef,
        huber_delta=args.huber_delta,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        use_clipped_value_loss=args.use_clipped_value_loss,
        use_huber_loss=args.use_huber_loss,
        use_valuenorm=args.use_valuenorm and not args.use_popart,
        use_popart=args.use_popart,
        use_value_active_masks=args.use_value_active_masks,
        use_policy_active_masks=args.use_policy_active_masks,
        use_gae=args.use_gae,
        use_proper_time_limits=args.use_proper_time_limits,
    )
    # the HJ table of the air taxi's safety filter (train_mpe.py:104-116):
    # the reference's pickle is absent upstream, so the synthetic
    # distance-based table stands in where the file is missing
    hj_data = None
    if env_params.use_safety_filter and args.safety_filter_type == "hj" \
            and args.dynamics_type == "air_taxi":
        from ..safety import hj as hj_mod

        table = dict(device=policy.device, dtype=torch.float32)
        if os.path.exists(args.safety_value_fn):
            hj_data = hj_mod.load_hj_pickle(
                args.safety_value_fn, env_params.cfg.separation_distance, **table)
        else:
            print(f"[safety] {args.safety_value_fn} not found; using the "
                  "synthetic HJ table (safety.make_synthetic_airtaxi_hj)")
            hj_data = hj_mod.make_synthetic_airtaxi_hj(env_params.cfg, **table)
    runner = Runner(
        env_params=env_params, policy=policy, trainer=trainer,
        n_rollout_threads=args.n_rollout_threads, episode_length=args.episode_length,
        use_centralized_v=args.use_centralized_V, device=device, hj_data=hj_data,
    )
    return env_params, policy, trainer, runner


def main(argv=None):
    """Train from the command line ``argv`` (the JAX package's ``main``,
    cli/train.py:251-426, graph path).  Returns the run directory and the
    final ``TrainState``, the one the last checkpoint holds."""
    from ..config.flags import build_env_params, not_ported, parse_all
    from ..utils.checkpoint import (
        arch_act_flags, restore_checkpoint, save_checkpoint, warm_start_checkpoint,
        warm_start_params,
    )
    from ..utils.logging import MetricsLogger, agent_env_infos, print_box

    args = parse_all(argv)
    if args.env_name == "MPE" or args.scenario_name.startswith("simple_"):
        raise not_ported("the classic-MPE training path", "A9")
    warm = args.warm_start_dir and not args.model_dir
    if warm:
        warm_start_checkpoint(args.warm_start_dir)  # refuse a source it cannot read
        # the source's activation flags BEFORE the model is built: they change
        # the function without changing a parameter's shape, so a mismatch
        # would warm-start cleanly into a broken policy
        for k, v in arch_act_flags(args.warm_start_dir).items():
            if getattr(args, k) != v:
                print(f"warm start: adopting {k}={v} from the checkpoint's config.json "
                      f"(run requested {getattr(args, k)}; the activation must match the "
                      f"loaded weights)", flush=True)
                setattr(args, k, v)
    device = None if args.cuda else "cpu"
    env_params, policy, trainer, runner = build(args, device)

    run_dir = os.path.join(
        args.run_dir, args.env_name, args.scenario_name, args.algorithm_name,
        args.experiment_name, f"seed{args.seed}",
    )
    save_dir = os.path.join(run_dir, "models")
    os.makedirs(save_dir, exist_ok=True)
    logger = MetricsLogger(run_dir)
    config = vars(args)

    ts = trainer.init_state(args.seed)
    carry = runner.init_carry(args.seed + 1)
    # the minibatch permutations' draws
    gen = torch.Generator(device=policy.device).manual_seed(args.seed + 2)

    start_episode = 0
    if args.model_dir:
        # the whole TrainState (weights, both optimizers, value normalizer);
        # training restarts at the saved episode, as the JAX CLI's does
        ts, start_episode = restore_checkpoint(args.model_dir, ts)
        print(f"resumed from {args.model_dir} at episode {start_episode}", flush=True)
    elif warm:
        # weights and value normalizer only: fresh optimizers, episode 0
        ts = warm_start_params(args.warm_start_dir, ts, env_params.obs_dim)
        print(f"warm-started params from {args.warm_start_dir}", flush=True)

    # in-training eval (reference GMPERunner.eval, cadence at
    # graph_mpe_runner.py:162-194): eval_episodes deterministic episodes in
    # one batch every eval_interval episodes
    n_eval = max(args.n_eval_rollout_threads, args.eval_episodes)
    episodes = int(args.num_env_steps) // args.episode_length // args.n_rollout_threads
    print_box(
        f"{args.scenario_name} | {args.num_agents} agents | "
        f"{args.n_rollout_threads} envs on {policy.device} | {episodes} episodes"
    )
    base_rews = (args.collision_rew, args.formation_rew, args.fair_rew)
    cur_stage = -1

    def rebuild():
        # the rewards are EnvParams fields only: the policy, the trainer and
        # the HJ table stay, and so do the TrainState and the carry
        nonlocal runner
        runner = dataclasses.replace(runner, env_params=build_env_params(args))

    start = time.time()
    for episode in range(start_episode, episodes):
        # the mid-training fairness bump (graph_mpe_runner.py:56-61)
        if args.increase_fairness and episode == episodes // 2:
            args.fair_rew = 10
            base_rews = (args.collision_rew, args.formation_rew, args.fair_rew)
            rebuild()
        # the curriculum (JAX cli/train.py:362-374), in tenths
        if args.use_curriculum:
            ratio = min(max(episode / max(episodes, 1), 0.1), 1.0)
            stage = int(ratio * 10)
            if stage != cur_stage:
                cur_stage = stage
                s = stage / 10.0
                args.collision_rew = base_rews[0] * s
                args.formation_rew = base_rews[1] * s
                args.fair_rew = base_rews[2] * s
                rebuild()
        if args.use_linear_lr_decay:
            policy.lr_decay(ts, episode, episodes)
        ts, carry, train_info, env_info = runner.train_episode(ts, carry, gen)

        total_steps = (episode + 1) * args.episode_length * args.n_rollout_threads
        if episode % args.save_interval == 0 or episode == episodes - 1:
            save_checkpoint(save_dir, ts, episode, config=config)
        if episode % args.log_interval == 0:
            info = {k: float(v) for k, v in train_info.items()}
            info.update(agent_env_infos(env_info, args.num_agents))
            sps = total_steps / max(time.time() - start, 1e-9)
            info["env_steps_per_sec"] = sps
            logger.log(info, total_steps)
            print(
                f"ep {episode}/{episodes} steps {total_steps} "
                f"rew {info.get('average_episode_rewards', float('nan')):.3f} "
                f"vloss {info.get('value_loss', float('nan')):.4f} "
                f"sps {sps:,.0f}",
                flush=True,
            )
        if args.use_eval and episode % args.eval_interval == 0:
            einfo = runner.eval_episode(ts, args.seed + 1000 + episode, n_eval)
            logger.log(einfo, total_steps)
            print(
                f"[eval ep {episode}] rew {einfo['eval_average_episode_rewards']:.2f} "
                f"success {einfo['eval_success_rate']:.3f} "
                f"all-success {einfo['eval_all_success_rate']:.3f} "
                f"collisions {einfo['eval_num_agent_collisions']:.2f}",
                flush=True,
            )
    save_checkpoint(save_dir, ts, episodes - 1 if episodes else 0, config=config)
    print(f"[FINAL SAVE] checkpoints at: {save_dir}", flush=True)
    logger.close()
    return run_dir, ts


if __name__ == "__main__":
    main(sys.argv[1:])
