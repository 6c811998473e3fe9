"""Training flags (port of the JAX package's ``config/flags.py``).

The parser is the JAX package's, flag for flag: every name, default, choice
and ``store_false`` idiom of ``get_config`` (:30), ``graph_config`` (:135)
and ``scenario_config`` (:199), so that a command line of the JAX package
parses unchanged here (reference ``onpolicy/config.py`` ``get_config``:5-407
and ``graph_config``:409-484, train_mpe.py:71-116).  ``--use_wandb``
DISABLES wandb there (the port never logs to it), ``--use_ReLU`` keeps the
default True, and the reference's ``--cuda`` (a store_false flag the JAX
package accepts and ignores) asks the port for the CPU.

``build_env_params`` and ``build_model_config`` map the flags onto the
port's ``EnvParams`` and ``ModelConfig``.  A setting the port does not carry
yet raises ``NotImplementedError`` naming the ROADMAP item that brings it;
nothing runs in its place.  Settings that change nothing on the july path
are taken as the JAX package takes them: ``--fair_rew`` and
``--increase_fairness`` (which only raises it), ``--use_dones`` and
``--graph_feat_type`` (the env reads none of them), ``--weight_decay`` (the
JAX package's Adam takes none), ``--safety_ttr_fn``,
``--terminate_on_violation`` and ``--safety_penalty`` (read by nothing
there either).  ``--gnn_impl`` auto, transposed and pallas_fused all
name the port's kernel trunk (the transposed formulation both compute);
``--gnn_impl dense``, ``--gnn_concat_heads`` and ``--actor_graph_aggr
global`` route both networks to the dense per-graph modules, as the JAX
package's policy routes them (``models/config.py``).  ``--critic_graph_aggr
node`` is refused with a ``ValueError``: the critic would get N agent ids
a row, on which the JAX package's critic stops at its first collect.
``--compute_dtype`` defaults to bfloat16, as there: on the kernel trunk it
takes the JAX package's ``pallas_fused`` semantics (the trunk in float32,
the MLP tails in bfloat16), on the dense route the trunk computes in
bfloat16 too (``models/nets.py``).  ``--gnn_edge_packed True`` takes the
dense route's packed edge layout, and the kernel trunk ignores it, as the
JAX package's transposed route does.  Trunk widths, embed depths and conv
depths the kernels are not built for are refused on either route, and so
are graphs of more entities (``cli/train.py build``; A6.3).
"""
from __future__ import annotations

import argparse


def _bool(x: str) -> bool:
    return str(x).lower() in ("1", "true", "yes", "y", "t")


def get_config() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="contracts-marl-aam-corridors (PyTorch port)",
        formatter_class=argparse.RawDescriptionHelpFormatter
    )
    # prepare (config.py:21-80)
    p.add_argument("--algorithm_name", type=str, default="rmappo", choices=["rmappo", "mappo"])
    p.add_argument("--experiment_name", type=str, default="check")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--cuda", action="store_false")
    p.add_argument("--cuda_deterministic", action="store_false")
    p.add_argument("--n_training_threads", type=int, default=1)
    p.add_argument("--n_rollout_threads", type=int, default=32)
    p.add_argument("--n_eval_rollout_threads", type=int, default=1)
    p.add_argument("--n_render_rollout_threads", type=int, default=1)
    p.add_argument("--num_env_steps", type=int, default=20e6)
    p.add_argument("--user_name", type=str, default="marl")
    p.add_argument("--use_wandb", action="store_false", help="disables wandb (store_false idiom)")
    # env
    p.add_argument("--env_name", type=str, default="GraphMPE")
    p.add_argument("--use_obs_instead_of_state", action="store_true")
    p.add_argument("--world_size", type=float, default=2.0)
    p.add_argument("--num_scripted_agents", type=int, default=0)
    p.add_argument("--dynamics_type", type=str, default="air_taxi",
                   choices=["air_taxi", "unicycle_vehicle", "double_integrator"])
    p.add_argument("--episode_length", type=int, default=25)
    # network (config.py:141-190)
    p.add_argument("--share_policy", action="store_false")
    p.add_argument("--use_centralized_V", action="store_false")
    p.add_argument("--stacked_frames", type=int, default=1)
    p.add_argument("--use_stacked_frames", action="store_true")
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--layer_N", type=int, default=1)
    p.add_argument("--use_ReLU", action="store_false")
    p.add_argument("--use_popart", action="store_true")
    p.add_argument("--use_valuenorm", action="store_false")
    p.add_argument("--use_feature_normalization", action="store_false")
    p.add_argument("--use_orthogonal", action="store_false")
    p.add_argument("--gain", type=float, default=0.01)
    # fairness knobs (config.py:189-199)
    p.add_argument("--increase_fairness", type=_bool, default=False)
    p.add_argument("--fair_wt", type=float, default=1)
    p.add_argument("--fair_rew", type=float, default=1)
    p.add_argument("--zeroshift", type=float, default=0)
    # recurrent (config.py:201-215)
    p.add_argument("--use_naive_recurrent_policy", action="store_true")
    p.add_argument("--use_recurrent_policy", action="store_false")
    p.add_argument("--recurrent_N", type=int, default=1)
    p.add_argument("--data_chunk_length", type=int, default=10)
    # optimizer (config.py:217-231)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--critic_lr", type=float, default=5e-4)
    p.add_argument("--opti_eps", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0)
    # ppo (config.py:233-294)
    p.add_argument("--ppo_epoch", type=int, default=15)
    p.add_argument("--use_clipped_value_loss", action="store_false")
    p.add_argument("--clip_param", type=float, default=0.2)
    p.add_argument("--num_mini_batch", type=int, default=1)
    p.add_argument("--entropy_coef", type=float, default=0.01)
    p.add_argument("--value_loss_coef", type=float, default=1)
    p.add_argument("--use_max_grad_norm", action="store_false")
    p.add_argument("--max_grad_norm", type=float, default=10.0)
    p.add_argument("--use_gae", action="store_false")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--gae_lambda", type=float, default=0.95)
    p.add_argument("--use_proper_time_limits", action="store_true")
    p.add_argument("--use_huber_loss", action="store_false")
    p.add_argument("--use_value_active_masks", action="store_false")
    p.add_argument("--use_policy_active_masks", action="store_false")
    p.add_argument("--huber_delta", type=float, default=10.0)
    # run (config.py:296-320)
    p.add_argument("--use_linear_lr_decay", action="store_true")
    # minibatch splitting (config.py:300-304): the reference's GPU-memory
    # workaround (GR_Actor.forward chunks the GNN batch); the port runs the
    # whole batch in one trunk launch.  Accepted but REJECTED when enabled so
    # reference commands fail loudly instead of silently changing semantics.
    p.add_argument("--split_batch", action="store_true")
    p.add_argument("--max_batch_size", type=int, default=32)
    # frame stacking (config.py:278-281): unused by every reference MPE/graph
    # config; rejected when enabled.
    p.add_argument("--use_comm", type=_bool, default=False)
    # save/log/eval/render (config.py:322-407)
    p.add_argument("--save_interval", type=int, default=1)
    p.add_argument("--log_interval", type=int, default=5)
    p.add_argument("--use_eval", action="store_true")
    p.add_argument("--eval_interval", type=int, default=25)
    p.add_argument("--eval_episodes", type=int, default=32)
    p.add_argument("--save_gifs", action="store_true")
    p.add_argument("--use_render", action="store_true")
    p.add_argument("--render_episodes", type=int, default=5)
    p.add_argument("--ifi", type=float, default=0.1)
    # keyboard-driven demo (reference InteractivePolicy, multiagent/policy.py:
    # 13-52) — TTY keys replace pyglet events; see cli/interactive.py
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--control_agent", type=int, default=0)
    p.add_argument("--model_dir", type=str, default=None)
    # params-only warm start (reference base_runner.py:179 restore semantics:
    # weights only, fresh optimizers, episode 0) — the reference's own
    # three_phase run used exactly this via its model_dir; here --model_dir
    # means full resume, so cross-run/cross-scenario transfer gets its own flag
    p.add_argument("--warm_start_dir", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="./results")
    return p


def graph_config(args, parser: argparse.ArgumentParser, return_extras: bool = False):
    """GNN flags + auto minibatch sizing (config.py:409-484)."""
    parser.add_argument("--num_embeddings", type=int, default=4)
    parser.add_argument("--embedding_size", type=int, default=2)
    parser.add_argument("--embed_hidden_size", type=int, default=16)
    parser.add_argument("--embed_layer_N", type=int, default=1)
    parser.add_argument("--embed_use_ReLU", action="store_false")
    parser.add_argument("--embed_add_self_loop", action="store_true")
    parser.add_argument("--max_edge_dist", type=float, default=1)
    parser.add_argument("--gnn_hidden_size", type=int, default=16)
    parser.add_argument("--gnn_num_heads", type=int, default=3)
    parser.add_argument("--gnn_concat_heads", action="store_true")
    parser.add_argument("--gnn_layer_N", type=int, default=2)
    parser.add_argument("--gnn_use_ReLU", action="store_false")
    parser.add_argument("--graph_feat_type", type=str, default="relative",
                        choices=["global", "relative"])
    parser.add_argument("--actor_graph_aggr", type=str, default="node",
                        choices=["global", "node"])
    parser.add_argument("--critic_graph_aggr", type=str, default="global",
                        choices=["global", "node"])
    parser.add_argument("--global_aggr_type", type=str, default="mean",
                        choices=["mean", "max", "add"])
    parser.add_argument("--use_cent_obs", type=_bool, default=False)
    parser.add_argument("--auto_mini_batch_size", action="store_true")
    parser.add_argument("--target_mini_batch_size", type=int, default=32)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="the MLP tails' compute dtype; the GNN trunk "
                        "computes in float32 either way, as the JAX package's "
                        "pallas_fused trunk does")
    parser.add_argument("--gnn_impl", type=str, default="auto",
                        choices=["auto", "dense", "transposed", "pallas_fused"],
                        help="the JAX package's GNN trunk implementation; "
                        "the port runs the transposed formulation (its CUDA "
                        "kernels on the card) for every choice but 'dense', "
                        "which takes the dense per-graph modules")
    parser.add_argument("--gnn_edge_packed", type=_bool, default=False,
                        help="the JAX package's packed EmbedConv edge layout "
                        "(its group LayerNorm); dense route only")
    parser.add_argument("--fuse_gnn_trunks", type=_bool, default=False,
                        help="the actor's and the critic's dense GNNs as one "
                        "pass over stacked parameters in the PPO update; "
                        "dense route only")
    all_args, extras = parser.parse_known_args(args)

    if all_args.auto_mini_batch_size:
        # config.py:472-483
        num_mini_batch = max(
            1,
            int(
                all_args.n_rollout_threads
                * all_args.episode_length
                * all_args.num_agents
                / all_args.target_mini_batch_size
            ),
        )
        all_args.num_mini_batch = num_mini_batch
    if return_extras:
        return all_args, extras
    return all_args


def scenario_config(parser: argparse.ArgumentParser):
    """Script-level scenario/safety flags (train_mpe.py:71-116 + scenario
    ``make_world`` arg reads)."""
    parser.add_argument("--scenario_name", type=str,
                        default="nav_metered_one_goal_graph_rotate_tube_july")
    parser.add_argument("--num_landmarks", type=int, default=3)
    parser.add_argument("--num_agents", type=int, default=2)
    parser.add_argument("--num_obstacles", type=int, default=0)
    parser.add_argument("--num_walls", type=int, default=0)
    parser.add_argument("--collaborative", type=_bool, default=False)
    parser.add_argument("--max_speed", type=float, default=2)
    parser.add_argument("--collision_rew", type=float, default=5)
    parser.add_argument("--goal_rew", type=float, default=5)
    parser.add_argument("--formation_rew", type=float, default=1.0)
    # reference update_curriculum (july:424-438): scales collision/formation/
    # fair rewards by clip(episode/episodes, 0.1, 1).  Its invocation is
    # commented out upstream (july:418), so default OFF; when enabled here the
    # schedule is applied in 10 stages (EnvParams is compile-time static, so
    # each stage is one recompile rather than the reference's per-reset drift).
    parser.add_argument("--use_curriculum", type=_bool, default=False)
    parser.add_argument("--min_dist_thresh", type=float, default=0.05)
    parser.add_argument("--use_dones", type=_bool, default=False)
    parser.add_argument("--total_actions", type=int, default=5)
    parser.add_argument("--formation_type", type=str, default="point")
    # safety filter (train_mpe.py:104-116)
    parser.add_argument("--use_safety_filter", type=_bool, default=False)
    parser.add_argument("--safety_filter_type", type=str, default="hj",
                        choices=["hj", "cbf", "exp_cbf", "rvo"])
    parser.add_argument("--safety_value_fn", type=str,
                        default="data/airtaxi_value_function.pkl")
    parser.add_argument("--safety_ttr_fn", type=str,
                        default="data/airtaxi_ttr_function.pkl")
    parser.add_argument("--terminate_on_violation", type=_bool, default=False)
    parser.add_argument("--safety_penalty", type=float, default=20.0)
    return parser


UNSUPPORTED_WHEN_SET = {
    # flag -> why it is rejected rather than silently ignored
    "split_batch": "GR_Actor minibatch splitting is a torch GPU-memory "
    "workaround (graph_actor_critic.py:16); the port runs the whole batch "
    "in one trunk launch",
    "use_stacked_frames": "frame stacking is dead code upstream (no MPE "
    "config uses it) and is not implemented here",
    "use_comm": "communication actions are only consumed by the classic-MPE "
    "speaker/listener scenarios (supported via env_name MPE), not the "
    "corridor family",
}


def parse_all(argv=None) -> argparse.Namespace:
    """All flags, as the JAX package's ``parse_all`` (:249) parses them."""
    parser = get_config()
    scenario_config(parser)
    args, extras = graph_config(argv, parser, return_extras=True)
    # unknown flags are an error, as in the reference's argparse
    unknown = [e for e in extras if e.startswith("-")]
    if unknown:
        parser.error(f"unknown argument(s): {' '.join(unknown)}")
    for flag, why in UNSUPPORTED_WHEN_SET.items():
        if getattr(args, flag, False):
            parser.error(f"--{flag} is not supported: {why}")
    # recurrent-flag consistency (train_mpe.py:126-135)
    recurrent = args.use_recurrent_policy or args.use_naive_recurrent_policy
    if (args.algorithm_name == "rmappo") != recurrent:
        parser.error("check recurrent policy!")
    return args


# ---------------------------------------------------------------------------


def not_ported(setting: str, item: str) -> NotImplementedError:
    """The error for a setting the port does not carry yet."""
    return NotImplementedError(
        f"{setting} is not ported to the torch package yet (ROADMAP.md {item})")


def scenario_kind(scenario_name: str) -> str:
    """Map reference scenario module names to the scenario kinds (the JAX
    package's ``scenario_kind``, :310)."""
    name = scenario_name.lower()
    if "v4oct" in name:
        return "v4oct"
    if "rot_inv" in name:
        return "rot_inv"
    if "sequential" in name:
        if "split" in name:
            return "sequential_split"
        if "random" in name:
            return "sequential_random"
        return "sequential"
    if "two_phase" in name or "two_graph" in name:
        return "two_phase"
    if "three_phase" in name:
        return "three_phase"
    if "fairassign" in name or "fair_assign" in name:
        return "fairassign"
    return "rotate_tube_july"


def build_env_params(args):
    """argparse.Namespace -> the port's ``EnvParams`` (the JAX package's
    ``build_env_params``, :274).  As there, ``args.max_edge_dist`` becomes the
    vehicle's coordination range (the reference's ``make_world`` overwrites
    it, july:242), and no flag picks the integrator: ``closed_form`` unless
    ``EnvParams`` is built in code.  Raises ``NotImplementedError`` for what
    the port lacks, and ``ValueError`` for a gated scenario with walls, whose
    graph has no wall rows (``EnvParams``)."""
    from ..envs.types import EnvParams
    from .physics import vehicle_config

    scenario = scenario_kind(args.scenario_name)
    if scenario.startswith("sequential") or scenario == "fairassign":
        raise not_ported(f"the {scenario} scenario", "A7")
    cfg = vehicle_config(args.dynamics_type)
    args.max_edge_dist = cfg.coordination_range
    return EnvParams(
        cfg=cfg,
        scenario=scenario,
        num_agents=args.num_agents,
        num_landmarks=args.num_landmarks,
        num_obstacles=args.num_obstacles,
        num_walls=args.num_walls,
        episode_length=args.episode_length,
        world_size=args.world_size,
        total_actions=args.total_actions,
        collision_rew=args.collision_rew,
        goal_rew=args.goal_rew,
        formation_rew=args.formation_rew,
        max_speed=args.max_speed,
        formation_type=args.formation_type,
        use_safety_filter=args.use_safety_filter,
        safety_filter_type=args.safety_filter_type,
    )


def build_model_config(args):
    """argparse.Namespace -> the port's ``ModelConfig`` (the JAX package's
    ``build_model_config``, :332).  Raises ``NotImplementedError`` for
    trunk shapes the kernels are not built for, on either route
    (``ModelConfig`` itself takes them: the CPU's plain trunk and the dense
    modules run them), and ``ValueError`` (from
    ``ModelConfig``) for the critic's 'node' aggregation, which the JAX
    package's critic cannot run."""
    from ..models.config import ModelConfig
    from ..ops.gnn_trunk import KERNEL_WIDTH, MAX_EMBED_LAYERS, MAX_GNN_LAYERS

    if {args.embed_hidden_size, args.gnn_hidden_size} != {KERNEL_WIDTH}:
        raise not_ported(f"trunk widths other than {KERNEL_WIDTH} (--embed_hidden_size, "
                         "--gnn_hidden_size)", "A6.3")
    if args.embed_layer_N > MAX_EMBED_LAYERS or args.gnn_layer_N > MAX_GNN_LAYERS:
        raise not_ported(f"more than {MAX_EMBED_LAYERS} embed layers or "
                         f"{MAX_GNN_LAYERS} extra conv layers (--embed_layer_N, "
                         "--gnn_layer_N)", "A6.3")
    return ModelConfig(
        hidden_size=args.hidden_size,
        layer_N=args.layer_N,
        use_relu=args.use_ReLU,
        embed_use_relu=args.embed_use_ReLU,
        gnn_use_relu=args.gnn_use_ReLU,
        use_feature_normalization=args.use_feature_normalization,
        use_orthogonal=args.use_orthogonal,
        gain=args.gain,
        use_recurrent_policy=(args.algorithm_name == "rmappo")
        and (args.use_recurrent_policy or args.use_naive_recurrent_policy),
        recurrent_n=args.recurrent_N,
        num_embeddings=args.num_embeddings,
        embedding_size=args.embedding_size,
        embed_hidden_size=args.embed_hidden_size,
        embed_layer_n=args.embed_layer_N,
        gnn_hidden_size=args.gnn_hidden_size,
        gnn_num_heads=args.gnn_num_heads,
        gnn_concat_heads=args.gnn_concat_heads,
        gnn_layer_n=args.gnn_layer_N,
        actor_graph_aggr=args.actor_graph_aggr,
        critic_graph_aggr=args.critic_graph_aggr,
        global_aggr_type=args.global_aggr_type,
        use_cent_obs=args.use_cent_obs,
        max_edge_dist=args.max_edge_dist,
        compute_dtype=args.compute_dtype,
        gnn_impl=args.gnn_impl,
        gnn_edge_packed=args.gnn_edge_packed,
    )
