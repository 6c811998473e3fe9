"""Flax parameter trees -> the port's state dicts.

The JAX package's actor and critic parameter trees, as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), become state dicts of the
port's ``GRActor``/``GRCritic``.  Module names are the flax names; leaves are
renamed and, where the layouts differ, transposed:

    Dense ``kernel`` (in, out)      -> ``weight`` (out, in)
    LayerNorm ``scale``             -> ``weight``
    Embed ``embedding``             -> ``weight``
    GRU ``w_ih``/``w_hh`` (in, 3H)  -> (3H, in)
    ``bias``, ``b_ih``, ``b_hh``, ``lin1_edge``, ``lin_edge`` unchanged
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
