"""Convert the shipped checkpoints from the JAX package's orbax layout to the
torch port's, and record the JAX package's evaluation of each.

    python scripts/orbax_to_torch.py [NAME ...] [--jax_eval] [--out DIR]
    python scripts/orbax_to_torch.py --src DIR --ckpt ckpt_N --argv "..." --out DIR

Runs on the CPU and needs JAX and orbax (the port itself needs neither).
NAME is one of the shipped checkpoints of ``CHECKPOINTS`` (default: july):

    july                        model_weights/july/unicycle ckpt_1561
    rot_inv                     model_weights/rot_inv/airtaxi ckpt_950
    three_phase                 model_weights/three_phase/airtaxi ckpt_750
    two_phase_5a                model_weights/two_phase_5a/airtaxi ckpt_30
    two_phase_5a_low_collision  model_weights/two_phase_5a/airtaxi_low_collision ckpt_8

Each is converted with the recipe of its evaluation script
(``scripts/july_eval.py`` at episode length 150, ``final_eval.py``,
``three_phase_eval.py``, ``two_phase_eval.py`` at its "general" config: 5
agents, episode length 100, world 3), with the activation flags of its own
``config.yaml``, as ``scripts/_eval_common.py build_for`` takes them.  The
JAX ``TrainState`` template built from that restores the checkpoint; weights,
both Adam states and the PopArt normalizer map through the port's
``models/convert.py``, and the port's ``save_checkpoint`` writes
``ckpt_<N>/train_state.pt``, a ``latest.json`` whose path is relative to its
directory and ``config.json`` (the flags of ``config.yaml``) under the
``model_weights_torch/`` counterpart of the source.  ``--src``, ``--ckpt``
and ``--argv`` convert another checkpoint with a recipe given in full; the
recipe's architecture flags (``--gnn_concat_heads``, ``--actor_graph_aggr
global``, ``--gnn_impl dense``) build both the JAX template and the port's
modules, whose state dicts then load the flax tree strict (concatenated
heads make ``lin_skip`` and the extra conv layers' inputs H*C wide).

``--jax_eval`` also runs the JAX package's batched protocol on each (4 x
``Runner.eval_episode`` of 256 envs, ``PRNGKey(100 + s)``, as
``_eval_common.run_side``) and writes ``jax_eval.json`` beside it: the
command, the versions, the flags and the per-seed rows.  three_phase also
gets ``jax_eval_10a.json``, its evaluation at 10 agents and 10 landmarks
over 150 steps (the 20-entity row of its README, commit bef51a8).  The card,
which has no JAX, holds the port's evaluations to those files.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import platform
import shlex
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

N_EVAL, SEEDS = 256, 4
TEN_AGENTS = ("--num_agents=10", "--num_landmarks=10", "--episode_length", "150")


def _recipe_july() -> list[str]:
    """The july recipe of ``scripts/july_eval.py`` at episode length 150."""
    from july_eval import recipe as july_recipe

    return july_recipe(150)


def _recipe_rot_inv() -> list[str]:
    from final_eval import RECIPE

    return list(RECIPE)


def _recipe_three_phase() -> list[str]:
    from three_phase_eval import RECIPE

    return list(RECIPE)


def _recipe_two_phase() -> list[str]:
    """``scripts/two_phase_eval.py`` at its "general" config (5 agents,
    episode length 100, world 3), the one the 5-agent checkpoints train at."""
    from two_phase_eval import BASE, CONFIGS

    return list(BASE) + list(CONFIGS["general(5ag/ep100/w3)"])


# name -> (source under the repo, checkpoint, recipe, {eval file: extra argv})
CHECKPOINTS = {
    "july": ("model_weights/july/unicycle", "ckpt_1561", _recipe_july,
             {"jax_eval.json": ()}),
    "rot_inv": ("model_weights/rot_inv/airtaxi", "ckpt_950", _recipe_rot_inv,
                {"jax_eval.json": ()}),
    "three_phase": ("model_weights/three_phase/airtaxi", "ckpt_750", _recipe_three_phase,
                    {"jax_eval.json": (), "jax_eval_10a.json": TEN_AGENTS}),
    "two_phase_5a": ("model_weights/two_phase_5a/airtaxi", "ckpt_30", _recipe_two_phase,
                     {"jax_eval.json": ()}),
    "two_phase_5a_low_collision": ("model_weights/two_phase_5a/airtaxi_low_collision",
                                   "ckpt_8", _recipe_two_phase, {"jax_eval.json": ()}),
}

SRC_NAME, CKPT = CHECKPOINTS["july"][:2]
SRC = os.path.join(ROOT, SRC_NAME)
DST = os.path.join(ROOT, SRC_NAME.replace("model_weights", "model_weights_torch", 1))


def dst_of(name: str) -> str:
    """The ``model_weights_torch/`` counterpart of a shipped checkpoint."""
    return os.path.join(ROOT, CHECKPOINTS[name][0].replace("model_weights",
                                                           "model_weights_torch", 1))


def recipe(name: str = "july") -> list[str]:
    return CHECKPOINTS[name][2]()


@functools.lru_cache(maxsize=None)
def jax_side(name: str = "july", extra: tuple = (), src: str | None = None,
             ckpt: str | None = None, argv: tuple | None = None):
    """(activation flags of the source's config.yaml, JAX policy, TrainState
    restored from the checkpoint with numpy leaves, jitted batched eval) for
    the recipe (``argv``, or the named checkpoint's) plus ``extra``."""
    import jax
    import numpy as np

    from _eval_common import build_for
    from contracts_marl_aam_corridors_tpu.utils.checkpoint import (
        restore_checkpoint, warm_start_arch_flags,
    )

    if src is None:
        src, ckpt = os.path.join(ROOT, CHECKPOINTS[name][0]), CHECKPOINTS[name][1]
    base = list(argv) if argv is not None else recipe(name)
    policy, template, eval_fn = build_for(base + list(extra), src, N_EVAL)
    jts, episode = restore_checkpoint(os.path.join(src, ckpt), template)
    assert episode == int(ckpt.split("_")[1]), episode
    return warm_start_arch_flags(src), policy, jax.tree.map(np.asarray, jts), eval_fn


def convert(out_dir: str, name: str = "july", src: str | None = None,
            ckpt: str | None = None, argv: tuple | None = None) -> str:
    """Write the port's checkpoint of the named checkpoint (or of ``src`` /
    ``ckpt`` with the recipe ``argv``) under ``out_dir``; returns the
    checkpoint's directory."""
    import torch

    from contracts_marl_aam_corridors_tpu.utils.checkpoint import load_run_config
    from contracts_marl_aam_corridors_tpu_torch.cli.train import build
    from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
    from contracts_marl_aam_corridors_tpu_torch.models.convert import (
        load_adam_from_optax, policy_params_from_flax, value_norm_from_numpy,
    )
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import save_checkpoint

    arch, _, jts, _ = jax_side(name, (), src, ckpt, argv)
    if src is None:
        src, ckpt = os.path.join(ROOT, CHECKPOINTS[name][0]), CHECKPOINTS[name][1]
    args = parse_all(list(argv) if argv is not None else recipe(name))
    for k, v in arch.items():
        setattr(args, k, v)
    _, _, trainer, _ = build(args, "cpu")
    ts = trainer.init_state(0)
    sd_a, sd_c = policy_params_from_flax(jts.params.actor, jts.params.critic)
    ts.params.actor.load_state_dict(sd_a)
    ts.params.critic.load_state_dict(sd_c)
    load_adam_from_optax(ts.actor_opt, ts.params.actor, jts.actor_opt)
    load_adam_from_optax(ts.critic_opt, ts.params.critic, jts.critic_opt)
    ts.vn = value_norm_from_numpy(jts.vn, torch.device("cpu"))
    episode = int(ckpt.split("_")[1])
    path = save_checkpoint(out_dir, ts, episode, config=load_run_config(src))
    # a committed checkpoint names itself relative to its directory
    with open(os.path.join(out_dir, "latest.json"), "w") as f:
        json.dump({"episode": episode, "path": ckpt}, f)
    return path


def jax_eval(out_dir: str, name: str = "july", fname: str = "jax_eval.json",
             extra: tuple = (), src: str | None = None, ckpt: str | None = None,
             argv: tuple | None = None, command: str | None = None) -> dict:
    """The JAX package's batched evaluation of the checkpoint with the recipe
    plus ``extra``, written to ``out_dir``/``fname``."""
    import jax
    import jaxlib
    import numpy as np
    import orbax.checkpoint

    arch, _, jts, eval_fn = jax_side(name, tuple(extra), src, ckpt, argv)
    if src is None:
        src_name, ckpt = CHECKPOINTS[name][:2]
    else:
        src_name = os.path.relpath(src, ROOT)
    rows = []
    for s in range(SEEDS):
        t0 = time.perf_counter()
        out = eval_fn(jts, jax.random.PRNGKey(100 + s))
        row = {k.replace("eval_", ""): float(np.asarray(v)) for k, v in out.items()}
        rows.append({"seed": 100 + s, "seconds": time.perf_counter() - t0, **row})
        print(json.dumps(rows[-1]), flush=True)
    keys = [k for k in rows[0] if k not in ("seed", "seconds")]
    rec = {
        "command": command or (
            "python scripts/orbax_to_torch.py --jax_eval" if name == "july"
            else f"python scripts/orbax_to_torch.py {name} --jax_eval"),
        "checkpoint": f"{src_name}/{ckpt}",
        "protocol": f"{SEEDS} x Runner.eval_episode of {N_EVAL} envs, PRNGKey(100 + s), "
                    "deterministic, as scripts/_eval_common.py run_side",
        "argv": (list(argv) if argv is not None else recipe(name)) + list(extra),
        "arch_flags_from_config_yaml": arch,
        "versions": {"python": platform.python_version(), "jax": jax.__version__,
                     "jaxlib": jaxlib.__version__, "orbax": orbax.checkpoint.__version__,
                     "numpy": np.__version__, "device": str(jax.devices()[0])},
        "rows": rows,
        "mean": {k: float(np.mean([r[k] for r in rows])) for k in keys},
    }
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    import jax

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", metavar="NAME",
                   help=f"shipped checkpoints to convert, of {', '.join(CHECKPOINTS)} "
                        "(default: july)")
    p.add_argument("--jax_eval", action="store_true",
                   help="also run the JAX package's batched evaluation")
    p.add_argument("--out", default=None,
                   help="output directory (default: the source's model_weights_torch/ "
                        "counterpart; one checkpoint only)")
    p.add_argument("--src", default=None, help="another orbax run directory to convert")
    p.add_argument("--ckpt", default=None, help="its ckpt_<N> directory name")
    p.add_argument("--argv", default=None,
                   help="its recipe: the JAX command line the TrainState is built from")
    a = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    if a.src is not None:
        if not (a.ckpt and a.argv and a.out):
            p.error("--src needs --ckpt, --argv and --out")
        rargv = tuple(shlex.split(a.argv))
        os.makedirs(a.out, exist_ok=True)
        print("wrote", convert(a.out, src=a.src, ckpt=a.ckpt, argv=rargv), flush=True)
        if a.jax_eval:
            cmd = "python scripts/orbax_to_torch.py " + " ".join(
                shlex.quote(x) for x in (argv if argv is not None else sys.argv[1:]))
            print(json.dumps(jax_eval(a.out, src=a.src, ckpt=a.ckpt, argv=rargv,
                                      command=cmd)["mean"]), flush=True)
        return
    names = a.names or ["july"]
    unknown = [n for n in names if n not in CHECKPOINTS]
    if unknown:
        p.error(f"unknown checkpoint {unknown}; choose from {list(CHECKPOINTS)}")
    if a.out and len(names) > 1:
        p.error("--out takes one checkpoint")
    for name in names:
        out = a.out or dst_of(name)
        os.makedirs(out, exist_ok=True)
        print("wrote", convert(out, name), flush=True)
        if a.jax_eval:
            for fname, extra in CHECKPOINTS[name][3].items():
                print(fname, json.dumps(jax_eval(out, name, fname, extra)["mean"]), flush=True)


if __name__ == "__main__":
    main()
