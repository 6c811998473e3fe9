"""Flax parameter trees and training state -> the port's.

The JAX package's actor and critic parameter trees, as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), become state dicts of the
port's ``GRActor``/``GRCritic``.  Module names are the flax names; leaves are
renamed and, where the layouts differ, transposed:

    Dense ``kernel`` (in, out)      -> ``weight`` (out, in)
    LayerNorm ``scale``             -> ``weight``
    Embed ``embedding``             -> ``weight``
    GRU ``w_ih``/``w_hh`` (in, 3H)  -> (3H, in)
    ``bias``, ``b_ih``, ``b_hh``, ``lin1_edge``, ``lin_edge`` unchanged

The training state comes across too: an optax
``chain(clip_by_global_norm, inject_hyperparams(adam))`` state (given with
numpy leaves) becomes a torch Adam state (``count`` -> ``step``, ``mu`` ->
``exp_avg``, ``nu`` -> ``exp_avg_sq``, the injected learning rate -> the
param group's ``lr``), and a ``ValueNormState`` or ``PopArtState`` the
port's.  Only attribute names are read, so nothing of JAX or optax is
imported.
"""
from __future__ import annotations

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_TRANSPOSE = {"kernel", "w_ih", "w_hh"}


def state_dict_from_flax(tree: dict, prefix: str = "") -> dict:
    """One flax tree -> a flat state dict of float32 CPU tensors."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(state_dict_from_flax(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, dtype=np.float32)
        if key in _TRANSPOSE:
            arr = arr.T
        out[prefix + _RENAME.get(key, key)] = torch.tensor(arr)
    return out


def policy_params_from_flax(actor_tree: dict, critic_tree: dict) -> tuple[dict, dict]:
    """(actor state dict, critic state dict) for ``PolicyParams`` modules."""
    return state_dict_from_flax(actor_tree), state_dict_from_flax(critic_tree)


def _find_adam(opt_state):
    """(adam state with count/mu/nu, injected hyperparams) in an optax chain
    state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state, None
    if hasattr(opt_state, "inner_state"):
        adam, _ = _find_adam(opt_state.inner_state)
        return adam, getattr(opt_state, "hyperparams", None)
    if isinstance(opt_state, tuple):
        for sub in opt_state:
            adam, hp = _find_adam(sub)
            if adam is not None:
                return adam, hp
    return None, None


def load_adam_from_optax(opt: torch.optim.Adam, module: torch.nn.Module, opt_state) -> None:
    """Load an optax adam state (``jax.tree.map(np.asarray, state)``) into a
    torch Adam over ``module``'s parameters: moments renamed and transposed
    as the parameters are, the step count, the learning rate."""
    adam, hp = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no optax adam state (count, mu, nu) found")
    mu, nu = state_dict_from_flax(adam.mu), state_dict_from_flax(adam.nu)
    count = int(np.asarray(adam.count))
    named = dict(module.named_parameters())
    if set(named) != set(mu):
        raise ValueError(f"moment names differ from the module's: {set(named) ^ set(mu)}")
    for name, p in named.items():
        if count == 0:
            opt.state.pop(p, None)
            continue
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype),
        }
    if hp is not None and "learning_rate" in hp:
        for group in opt.param_groups:
            group["lr"] = float(np.asarray(hp["learning_rate"]))


def value_norm_from_numpy(state, device=None, dtype=torch.float32):
    """A JAX ``ValueNormState`` or ``PopArtState`` (numpy leaves) -> the
    port's (None stays None)."""
    from ..learner.popart import PopArtState
    from ..learner.valuenorm import ValueNormState

    if state is None:
        return None
    t = lambda v: torch.tensor(np.asarray(v), dtype=dtype, device=device)
    if hasattr(state, "running_mean"):
        return ValueNormState(
            running_mean=t(state.running_mean), running_mean_sq=t(state.running_mean_sq),
            debiasing_term=t(state.debiasing_term), beta=state.beta, epsilon=state.epsilon)
    return PopArtState(
        mean=t(state.mean), mean_sq=t(state.mean_sq), stddev=t(state.stddev),
        debiasing_term=t(state.debiasing_term), beta=state.beta, epsilon=state.epsilon)
