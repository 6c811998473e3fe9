"""The batched evaluation protocol of the JAX package's comparison scripts
(``scripts/_eval_common.py run_side``): deterministic evaluations of a
trained policy over several seeded batches of fresh episodes.

    from contracts_marl_aam_corridors_tpu_torch.tools.eval_batched import run_side
    row = run_side(ts, runner)  # 4 x 256 episodes, seeds 100..103

The seeds are those of the JAX scripts (``PRNGKey(100 + s)``); the two
frameworks draw different resets from them, so the two sides are compared
by their means.
"""
from __future__ import annotations

import statistics


def run_side(ts, runner, n_eval: int = 256, seeds: int = 4) -> dict:
    """The mean over ``seed = 100 + s``, s < ``seeds``, of
    ``runner.eval_episode(ts, seed, n_eval)`` (``learner/runner.py``), each
    metric named without its ``eval_`` prefix, as the JAX ``run_side``
    names them."""
    rows = [runner.eval_episode(ts, 100 + s, n_eval) for s in range(seeds)]
    return {k.removeprefix("eval_"): statistics.fmean(r[k] for r in rows) for k in rows[0]}
