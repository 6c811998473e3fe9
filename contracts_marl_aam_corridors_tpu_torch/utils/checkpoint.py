"""Checkpoint save, restore and warm start (port of the JAX package's
``utils/checkpoint.py``: ``save_checkpoint``, ``restore_checkpoint``,
``load_run_config``, ``merge_eval_args``, ``warm_start_arch_flags`` (as
``arch_act_flags``), ``_OBS_LAYOUT_INSERTS``, ``_obs_index_map``,
``_remap_rows``, ``_resolve_ckpt_path`` and ``warm_start_params``, :24-94
and :132-288).

The layout is the JAX package's: ``<save_dir>/ckpt_<episode>/`` holds the
whole ``TrainState`` (both networks, both Adam states, the value normalizer)
and the episode, and ``<save_dir>/latest.json`` names the newest.  The state
is one ``torch.save`` file of tensors and plain Python values, read back
with ``weights_only=True``.  The run's flags go to ``config.json`` beside
it (the JAX package writes ``config.yaml``; the port needs no YAML reader).
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..learner.mappo import TrainState
from ..learner.popart import PopArtState
from ..learner.valuenorm import ValueNormState

STATE_FILE = "train_state.pt"
CONFIG_FILE = "config.json"
_NORMALIZERS = {cls.__name__: cls for cls in (ValueNormState, PopArtState)}


def _vn_record(vn) -> dict | None:
    if vn is None:
        return None
    return {"kind": type(vn).__name__,
            "fields": {f.name: getattr(vn, f.name) for f in dataclasses.fields(vn)}}


def _vn_from_record(rec: dict | None, device):
    if rec is None:
        return None
    to_dev = lambda v: v.to(device) if isinstance(v, torch.Tensor) else v
    return _NORMALIZERS[rec["kind"]](**{k: to_dev(v) for k, v in rec["fields"].items()})


def save_checkpoint(save_dir: str, ts: TrainState, episode: int,
                    config: dict | None = None) -> str:
    """Write ``ts`` as ``<save_dir>/ckpt_<episode>/train_state.pt``, point
    ``latest.json`` at it, and write ``config`` (the run's flags) as
    ``config.json``.  Returns the checkpoint's directory."""
    path = os.path.abspath(os.path.join(save_dir, f"ckpt_{episode}"))
    os.makedirs(path, exist_ok=True)
    state = {
        "episode": int(episode),
        "actor": ts.params.actor.state_dict(),
        "critic": ts.params.critic.state_dict(),
        "actor_opt": ts.actor_opt.state_dict(),
        "critic_opt": ts.critic_opt.state_dict(),
        "vn": _vn_record(ts.vn),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(save_dir, "latest.json"), "w") as f:
        json.dump({"episode": int(episode), "path": path}, f)
    if config is not None:
        with open(os.path.join(save_dir, CONFIG_FILE), "w") as f:
            json.dump(config, f, indent=1, sort_keys=True)
    return path


def restore_checkpoint(save_dir: str, ts_template: TrainState) -> tuple[TrainState, int]:
    """Load a checkpoint into ``ts_template`` (networks and optimizers in
    place, the normalizer replaced) and return it with the checkpoint's
    episode.  ``save_dir`` takes the layouts of ``_resolve_ckpt_path``.
    Every tensor lands where the running state keeps it: the weights, the
    Adam moments and the normalizer on the template's device, Adam's step
    counts on the CPU (``load_state_dict`` places each)."""
    path = _resolve_ckpt_path(save_dir)
    device = next(ts_template.params.actor.parameters()).device
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    ts_template.params.actor.load_state_dict(state["actor"])
    ts_template.params.critic.load_state_dict(state["critic"])
    ts_template.actor_opt.load_state_dict(state["actor_opt"])
    ts_template.critic_opt.load_state_dict(state["critic_opt"])
    ts_template.vn = _vn_from_record(state["vn"], device)
    return ts_template, state["episode"]


def run_config_dir(model_dir: str) -> str | None:
    """The directory holding the run's ``config.json``: ``model_dir`` or,
    for a ``ckpt_<N>`` directory, its parent (as the JAX package's eval
    looks for ``config.yaml``, cli/eval.py:221-227); None where neither
    has one."""
    for d in (model_dir, os.path.dirname(os.path.normpath(model_dir))):
        if os.path.exists(os.path.join(d, CONFIG_FILE)):
            return d
    return None


def load_run_config(model_dir: str) -> dict:
    """The run's flags, from ``config.json`` in ``model_dir`` or its
    parent."""
    d = run_config_dir(model_dir)
    if d is None:
        raise FileNotFoundError(f"no {CONFIG_FILE} in {model_dir} or its parent")
    with open(os.path.join(d, CONFIG_FILE)) as f:
        return json.load(f)


# the flags that choose a trained network's activations
ARCH_ACT_FLAGS = ("use_ReLU", "embed_use_ReLU", "gnn_use_ReLU")


def arch_act_flags(model_dir: str) -> dict:
    """The activation flags the run's ``config.json`` records, as
    ``{flag: bool}`` ({} where there is no ``config.json``): the only flags
    the JAX package's batched comparisons take from a checkpoint's run
    (``warm_start_arch_flags``, utils/checkpoint.py:135-160, through
    scripts/_eval_common.py ``build_for``); everything else comes from their
    command line."""
    if run_config_dir(model_dir) is None:
        return {}
    rec = load_run_config(model_dir)
    out = {}
    for k in ARCH_ACT_FLAGS:
        v = rec.get(k)
        if v is not None:
            out[k] = (v.strip().lower() in ("1", "true", "yes", "y", "t")
                      if isinstance(v, str) else bool(v))
    return out


# the flags an evaluation's command line keeps against the trained run's
MERGE_EXCLUDE = frozenset({
    "num_agents", "num_landmarks", "num_obstacles", "episode_length",
    "model_dir", "use_render", "save_gifs", "render_episodes", "seed",
    "n_rollout_threads", "n_render_rollout_threads", "use_wandb",
    "scenario_name", "run_dir", "experiment_name", "eval_episodes",
})


def merge_eval_args(args, run_cfg: dict):
    """The trained run's flags win over ``args`` except for the env-shape
    and evaluation flags of ``MERGE_EXCLUDE`` (the JAX package's
    ``merge_eval_args``, utils/checkpoint.py:68-94; reference eval_mpe.py
    ``modify_args``:97-151).  Values take the type of the flag they replace;
    a bool recorded as a string is parsed, not cast.  ``args`` is updated
    in place and returned."""
    for k, v in run_cfg.items():
        if k in MERGE_EXCLUDE or not hasattr(args, k):
            continue
        cur = getattr(args, k)
        try:
            if isinstance(cur, bool) and isinstance(v, str):
                setattr(args, k, v.strip().lower() in ("1", "true", "yes", "y", "t"))
            else:
                setattr(args, k, type(cur)(v) if cur is not None else v)
        except (TypeError, ValueError):
            setattr(args, k, v)
    return args


def _resolve_ckpt_path(model_dir: str) -> str:
    """A run's models directory with ``latest.json`` (its newest
    checkpoint; a relative ``path`` there is relative to the directory that
    holds the file), a ``ckpt_<N>`` directory, or a directory holding
    ``ckpt_<N>`` directories (the highest N)."""
    latest = os.path.join(model_dir, "latest.json")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.abspath(os.path.join(model_dir, json.load(f)["path"]))
    base = os.path.basename(os.path.normpath(model_dir))
    if base.startswith("ckpt_"):
        return os.path.abspath(model_dir)
    cands = sorted(
        (d for d in os.listdir(model_dir)
         if d.startswith("ckpt_") and d[5:].isdigit()
         and os.path.isdir(os.path.join(model_dir, d))),
        key=lambda d: int(d[5:]),
    )
    if not cands:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    return os.path.abspath(os.path.join(model_dir, cands[-1]))


# ----------------------------------------------------------- warm start
# The reference's ``restore`` (base_runner.py:179-192) loads the actor and
# critic WEIGHTS only: the optimizers start fresh and the episode counter
# restarts.  A rot_inv checkpoint warm-starts the two/three_phase runs (their
# config.yaml files name model_weights/rot_inv/airtaxi), whose observation
# inserts the heading-alignment pair at slots 12-13 of rot_inv's 13 (the
# phase slot moves from 12 to 14); the new rows enter the actor's input
# LayerNorm with scale 1 and bias 0 and its first dense layer as zeros.

# (old_obs_dim, new_obs_dim) -> (insert position, count) in the obs vector.
_OBS_LAYOUT_INSERTS = {(13, 15): (12, 2)}


def _obs_index_map(old_dim: int, new_dim: int) -> list[int]:
    """new-row index -> old-row index, -1 for rows that did not exist."""
    if old_dim == new_dim:
        return list(range(old_dim))
    at, n = _OBS_LAYOUT_INSERTS[(old_dim, new_dim)]
    return list(range(at)) + [-1] * n + list(range(at, old_dim))


def _remap_rows(old: torch.Tensor, index_map: list[int], fill: float) -> torch.Tensor:
    """Reindex the leading axis of ``old`` by ``index_map``; rows mapped
    from -1 are filled with ``fill``."""
    idx = torch.as_tensor(index_map)
    out = old[idx.clamp(0, old.shape[0] - 1)].clone()
    out[idx < 0] = fill
    return out


def warm_start_checkpoint(model_dir: str) -> str:
    """The checkpoint directory a warm start from ``model_dir`` reads (the
    layouts of ``_resolve_ckpt_path``).  A reference ``actor.pt`` directory
    raises ``not_ported`` (ROADMAP A11); a JAX orbax checkpoint raises a
    ``ValueError`` that names its conversion."""
    from ..config.flags import not_ported

    if os.path.exists(os.path.join(model_dir, "actor.pt")):
        raise not_ported(f"a warm start from the reference's actor.pt weights ({model_dir})",
                         "A11")
    path = _resolve_ckpt_path(model_dir)
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        norm = os.path.normpath(model_dir)
        parts = norm.split(os.sep)
        hint = ""
        if "model_weights" in parts:
            parts[parts.index("model_weights")] = "model_weights_torch"
            hint = f" and warm-start from {os.sep.join(parts)}"
        raise ValueError(
            f"{path} holds no {STATE_FILE}: it is the JAX package's orbax checkpoint, not "
            f"the torch port's; convert it with scripts/orbax_to_torch.py (on the CPU, with "
            f"JAX){hint}")
    return path


def warm_start_params(model_dir: str, ts_new: TrainState, new_obs_dim: int) -> TrainState:
    """Weights-only warm start (reference base_runner.py:179): ``ts_new``
    with the actor's and critic's weights and the value normalizer of the
    checkpoint at ``model_dir``.  Its optimizers stay as they are (fresh)
    and the checkpoint's episode is not restored.  Where the checkpointed
    actor took a narrower observation than ``ts_new``'s, its input LayerNorm
    and first dense layer are remapped by ``_OBS_LAYOUT_INSERTS``.  Where the
    value normalizers' kinds differ (PopArt against ValueNorm), the fresh
    one is kept.  The JAX package's ``warm_start_params`` on the port's
    layout."""
    path = warm_start_checkpoint(model_dir)
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    old_actor = dict(state["actor"])
    new_actor = ts_new.params.actor.state_dict()
    fc0 = "base.mlp.fc0.weight"
    old_in, new_in = old_actor[fc0].shape[1], new_actor[fc0].shape[1]
    if old_in != new_in:
        nbd_dim = new_in - new_obs_dim  # GNN aggregate columns, after the obs
        old_obs = old_in - nbd_dim
        full = _obs_index_map(old_obs, new_obs_dim) + list(range(old_obs, old_in))
        for k, fill in (("base.feature_norm.weight", 1.0), ("base.feature_norm.bias", 0.0)):
            if k in old_actor:
                old_actor[k] = _remap_rows(old_actor[k], full, fill)
        old_actor[fc0] = _remap_rows(old_actor[fc0].T, full, 0.0).T.contiguous()
    ts_new.params.actor.load_state_dict(old_actor)
    ts_new.params.critic.load_state_dict(state["critic"])
    rec, fresh = state["vn"], ts_new.vn
    if rec is not None and fresh is not None:
        if rec["kind"] != type(fresh).__name__:
            # the reference's restore takes weights only anyway
            print("warm start: value-norm type differs from checkpoint; "
                  "keeping freshly initialized normalizer", flush=True)
        else:
            # tensors from the checkpoint on the fresh state's device and
            # type, the constants (beta, epsilon) the fresh state's
            ts_new.vn = dataclasses.replace(fresh, **{
                k: v.to(getattr(fresh, k)) for k, v in rec["fields"].items()
                if isinstance(v, torch.Tensor)})
    return ts_new
