"""Metrics logging (port of the JAX package's ``utils/logging.py``).

The reference logs through wandb or tensorboardX
(onpolicy/runner/shared/base_runner.py:292-302); the port writes a JSONL
file, and the train entry point prints to stdout.  Metric names keep the
reference's ``agent{i}/<metric>`` convention (base_runner.process_infos:
194-290), so curves compare with the JAX package's.
"""
from __future__ import annotations

import json
import os
import time

import torch


class MetricsLogger:
    """Appends one JSON record per ``log`` call to ``<run_dir>/metrics.jsonl``:
    the step, the wall seconds since the logger started, and every metric
    that converts to a float."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self.t0 = time.time()

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self.t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def agent_env_infos(env_info: dict, num_agents: int) -> dict:
    """Per-agent metric arrays -> ``agent{i}/<metric>`` keys, scalars as
    they are (process_infos, base_runner.py:194-290)."""
    out = {}
    for k, v in env_info.items():
        t = torch.as_tensor(v).detach().cpu()
        if t.ndim == 0:
            out[k] = float(t)
        else:
            for i in range(min(num_agents, t.shape[-1])):
                out[f"agent{i}/{k.lower()}"] = float(t.reshape(-1)[i])
    return out


def print_box(msg: str, width: int = 72) -> None:
    line = "-" * width
    print(f"+{line}+\n|{msg:^{width}}|\n+{line}+", flush=True)
