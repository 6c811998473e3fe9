"""Convert the shipped july checkpoint from the JAX package's orbax layout to
the torch port's, and record the JAX package's evaluation of it.

    python scripts/orbax_to_torch.py [--jax_eval] [--out DIR]

Runs on the CPU and needs JAX and orbax (the port itself needs neither).
Builds the JAX ``TrainState`` template with the checkpoint's own flags (the
``scripts/july_eval.py`` recipe at episode length 150, with the activation
flags of its ``config.yaml``, as ``scripts/_eval_common.py build_for`` does),
restores ``model_weights/july/unicycle/ckpt_1561`` into it, maps weights,
both Adam states and the PopArt normalizer with the port's
``models/convert.py``, and writes the port's layout with its
``save_checkpoint``: ``ckpt_1561/train_state.pt``, a ``latest.json`` whose
path is relative to its directory, and ``config.json`` (the flags of
``config.yaml``), under ``model_weights_torch/july/unicycle/``.

``--jax_eval`` also runs the JAX package's batched protocol on it (4 x
``Runner.eval_episode`` of 256 envs, ``PRNGKey(100 + s)``, as
``_eval_common.run_side``) and writes ``jax_eval.json`` beside it: the
command, the versions, the flags and the per-seed rows.  The card, which has
no JAX, holds the port's evaluation to that file.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SRC_NAME = "model_weights/july/unicycle"
DST_NAME = "model_weights_torch/july/unicycle"
SRC, DST = os.path.join(ROOT, SRC_NAME), os.path.join(ROOT, DST_NAME)
CKPT = "ckpt_1561"
EP_LEN, N_EVAL, SEEDS = 150, 256, 4


def recipe() -> list[str]:
    """The july recipe of ``scripts/july_eval.py`` at episode length 150."""
    from july_eval import recipe as july_recipe

    return july_recipe(EP_LEN)


@functools.lru_cache(maxsize=None)
def jax_side(src: str = SRC):
    """(activation flags of ``src``'s config.yaml, JAX policy, TrainState
    restored from ``src``/ckpt_1561 with numpy leaves, jitted batched eval)
    for the checkpoint's own flags."""
    import jax
    import numpy as np

    from _eval_common import build_for
    from contracts_marl_aam_corridors_tpu.utils.checkpoint import (
        restore_checkpoint, warm_start_arch_flags,
    )

    policy, template, eval_fn = build_for(recipe(), src, N_EVAL)
    jts, episode = restore_checkpoint(os.path.join(src, CKPT), template)
    assert episode == int(CKPT.split("_")[1]), episode
    return warm_start_arch_flags(src), policy, jax.tree.map(np.asarray, jts), eval_fn


def convert(out_dir: str, src: str = SRC) -> str:
    """Write the port's checkpoint of ``src`` under ``out_dir``; returns the
    checkpoint's directory."""
    import torch

    from contracts_marl_aam_corridors_tpu.utils.checkpoint import load_run_config
    from contracts_marl_aam_corridors_tpu_torch.cli.train import build
    from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
    from contracts_marl_aam_corridors_tpu_torch.models.convert import (
        load_adam_from_optax, policy_params_from_flax, value_norm_from_numpy,
    )
    from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import save_checkpoint

    arch, _, jts, _ = jax_side(src)
    args = parse_all(recipe())
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
    episode = int(CKPT.split("_")[1])
    path = save_checkpoint(out_dir, ts, episode, config=load_run_config(src))
    # a committed checkpoint names itself relative to its directory
    with open(os.path.join(out_dir, "latest.json"), "w") as f:
        json.dump({"episode": episode, "path": CKPT}, f)
    return path


def jax_eval(out_dir: str, src: str = SRC) -> dict:
    """The JAX package's batched evaluation of ``src``, written to
    ``out_dir``/jax_eval.json."""
    import jax
    import jaxlib
    import numpy as np
    import orbax.checkpoint

    arch, _, jts, eval_fn = jax_side(src)
    rows = []
    for s in range(SEEDS):
        t0 = time.perf_counter()
        out = eval_fn(jts, jax.random.PRNGKey(100 + s))
        row = {k.replace("eval_", ""): float(np.asarray(v)) for k, v in out.items()}
        rows.append({"seed": 100 + s, "seconds": time.perf_counter() - t0, **row})
        print(json.dumps(rows[-1]), flush=True)
    keys = [k for k in rows[0] if k not in ("seed", "seconds")]
    rec = {
        "command": "python scripts/orbax_to_torch.py --jax_eval",
        "checkpoint": f"{SRC_NAME}/{CKPT}",
        "protocol": f"{SEEDS} x Runner.eval_episode of {N_EVAL} envs, PRNGKey(100 + s), "
                    "deterministic, as scripts/_eval_common.py run_side",
        "argv": recipe(), "arch_flags_from_config_yaml": arch,
        "versions": {"python": platform.python_version(), "jax": jax.__version__,
                     "jaxlib": jaxlib.__version__, "orbax": orbax.checkpoint.__version__,
                     "numpy": np.__version__, "device": str(jax.devices()[0])},
        "rows": rows,
        "mean": {k: float(np.mean([r[k] for r in rows])) for k in keys},
    }
    with open(os.path.join(out_dir, "jax_eval.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    import jax

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--jax_eval", action="store_true",
                   help="also run the JAX package's batched evaluation")
    p.add_argument("--out", default=DST, help=f"output directory (default: {DST_NAME})")
    a = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(a.out, exist_ok=True)
    print("wrote", convert(a.out), flush=True)
    if a.jax_eval:
        print(json.dumps(jax_eval(a.out)["mean"]), flush=True)


if __name__ == "__main__":
    main()
