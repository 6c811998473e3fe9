"""The double integrator's velocity update ``vel + action * dt`` rounded
once, three ways, on the card and on the host: a multiply-add built from
plain products and sums (Dekker's exact product, Knuth's exact sum), one
``torch.addcmul`` and one ``torch.add(..., alpha=dt)``.

    python scripts/torch_fma_probe.py [--envs 4096] [--steps 20]

Part 1 holds the bits: velocities and accelerations of the double
integrator's action table, from a seed, with a share of them set to bring a
velocity component back to rest, in float64 and float32; each fused op
against the built one, on each device, and the card against the host.
Part 2 prices the built one: v4oct with the double integrator at ``--envs``
envs in float32, ``env.step`` on the card with each velocity update in
turn (patched into ``envs/dynamics.py``), the kernels and device ms a step
from the profiler and the wall ms a step around ``--steps`` steps (host
clock, the steps ending in a synchronize), in the order built, fused,
fused, built.  Prints one JSON line, and the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from contracts_marl_aam_corridors_tpu_torch.config.physics import vehicle_config  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs import dynamics, env as tenv  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs.actions import action_table  # noqa: E402
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams  # noqa: E402

_SPLIT = {torch.float64: 134217729.0, torch.float32: 4097.0}


def _split(x):
    c = _SPLIT[x.dtype] * x
    hi = c - (c - x)
    return hi, x - hi


def fma_built(a, b: float, c):
    """``a * b + c`` from exact products and sums, rounded once at the end."""
    b = torch.full_like(a, b)
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


VARIANTS = {
    "built": fma_built,
    "addcmul": lambda a, b, c: torch.addcmul(c, a, a.new_tensor(b)),
    "add_alpha": lambda a, b, c: torch.add(c, a, alpha=b),
}


def closed_form_with(fma):
    def closed_form_di(values, action, dt):
        pos, vel = values[..., :2], values[..., 2:]
        pos1 = pos + vel * dt + 0.5 * action * dt * dt
        return torch.cat([pos1, fma(action, dt, vel)], dim=-1)
    return closed_form_di


def bits(n: int, seed: int) -> dict:
    cfg = vehicle_config("double_integrator")
    table = action_table(cfg, 5)
    rng = np.random.default_rng(seed)
    acc = table[rng.integers(0, len(table), (n,))].reshape(-1)
    vel = rng.normal(0.0, 0.5, acc.shape)
    rest = rng.random(acc.shape) < 0.25  # velocities one step from rest
    vel[rest] = -rng.integers(1, 8, rest.sum()) * acc[rest] * cfg.dt
    out = {}
    for dt in (torch.float64, torch.float32):
        a_h, v_h = torch.tensor(acc, dtype=dt), torch.tensor(vel, dtype=dt)
        res = {}
        for dev in ("cuda", "cpu"):
            a, v = a_h.to(dev), v_h.to(dev)
            res[dev] = {k: f(a, cfg.dt, v).cpu() for k, f in VARIANTS.items()}
        row = {}
        for k in VARIANTS:
            row[k] = {
                "cuda_differs_from_built": int((res["cuda"][k] != res["cuda"]["built"]).sum()),
                "cpu_differs_from_built": int((res["cpu"][k] != res["cpu"]["built"]).sum()),
                "cuda_differs_from_cpu": int((res["cuda"][k] != res["cpu"][k]).sum()),
                "signbit_cuda_differs_from_cpu": int(
                    (torch.signbit(res["cuda"][k]) != torch.signbit(res["cpu"][k])).sum()),
            }
        row["values"] = acc.size
        row["twice_rounded_differs_from_built"] = int(
            ((v_h + a_h * cfg.dt) != res["cpu"]["built"]).sum())
        out[str(dt).removeprefix("torch.")] = row
    return out


def price(envs: int, steps: int, seed: int) -> dict:
    dev = torch.device("cuda")
    params = EnvParams(cfg=vehicle_config("double_integrator"),
                       scenario="v4oct", episode_length=25)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    original = dynamics._closed_form_di
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, _ = tenv.reset(params, envs, gen, dev, torch.float32)
    act = torch.randint(0, params.num_actions, (steps, envs, params.num_agents),
                        generator=gen, device=dev)
    out = {name: {"wall_ms_per_step": []} for name in ("built", "addcmul")}
    try:
        for name in ("built", "addcmul", "addcmul", "built"):
            dynamics._closed_form_di = closed_form_with(VARIANTS[name])
            s = state
            for t in range(3):  # warm-up
                s, _ = tenv.step(params, s, act[t], gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(steps):
                s, _ = tenv.step(params, s, act[t], gen)
            torch.cuda.synchronize()
            out[name]["wall_ms_per_step"].append((time.perf_counter() - t0) * 1e3 / steps)
            if "kernels_per_step" in out[name]:
                continue
            prof_steps = min(5, steps)
            with torch.profiler.profile(activities=acts) as prof:
                for t in range(prof_steps):
                    s, _ = tenv.step(params, s, act[t], gen)
                torch.cuda.synchronize()
            evts = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            out[name]["kernels_per_step"] = sum(e.count for e in evts) / prof_steps
            out[name]["device_ms_per_step"] = (
                sum(e.self_device_time_total for e in evts) / 1e3 / prof_steps)
    finally:
        dynamics._closed_form_di = original
    for name in out:
        out[name]["wall_ms_per_step_median"] = statistics.median(out[name]["wall_ms_per_step"])
    b, f = out["built"], out["addcmul"]
    out["built_extra_kernels_per_step"] = b["kernels_per_step"] - f["kernels_per_step"]
    out["built_extra_device_ms_per_step"] = b["device_ms_per_step"] - f["device_ms_per_step"]
    out["envs"], out["agents"], out["steps"] = envs, params.num_agents, steps
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--values", type=int, default=1 << 22)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"host_cpu_capability": torch.backends.cpu.get_cpu_capability(),
                      "torch": torch.__version__, "bits": bits(a.values, a.seed),
                      "env_step": price(a.envs, a.steps, a.seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
