"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the reference, and the result's line.

:func:`main` is the command (``python3 -m portbench``); :func:`measure`
is the run itself on any device, which the tests drive on the host at
small sizes.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any

from . import reference, spec

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "parsec_tpu")
#: the program's and its libraries' caches, at fixed places in the checkout
CACHE = spec.ROOT / ".portbench-cache"
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "TORCHINDUCTOR_CACHE_DIR": "inductor",
             "CUDA_CACHE_PATH": "nv_compute"}


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among loaded modules (``names``,
    else ``sys.modules``), each compared whole: ``parsec_tpu_torch`` is
    not ``parsec_tpu``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(CACHE / sub)


@dataclass
class Run:
    """What the metric readers read."""

    cfg: dict
    traffic: dict
    kind: ModuleType
    flops: float
    setup_s: float
    window: Any
    trace: Any = None


def _k1_launches() -> dict:
    from parsec_tpu_torch.ops.gemm import gemm_update
    return dict(gemm_update.launches_by_variant)


def measure(bench: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, device, t0: float, cfg: dict | None = None,
            break_step=None, marks: dict | None = None
            ) -> tuple[dict, list[str]]:
    """Run cell ``cell_name`` on ``device`` and return its result (the
    object the last line prints) and its check lines.  ``t0`` is the
    process's start on the host clock; ``cfg`` replaces the cell's
    configuration (the tests' small sizes); ``break_step``, given the
    built problem, replaces its step (the tests' faults); ``marks`` are
    set-up's earlier moments (seconds since ``t0``), reported beside its
    parts."""
    import torch

    from . import loop
    from . import trace as tracing

    cell = spec.cell(bench, cell_name)
    cfg = cfg or spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = spec.kind(cfg["kind"])

    t_build = time.perf_counter()
    problem = kind.build(cfg, seed, device)
    if break_step is not None:
        problem.step = break_step(problem)
    t_warm = time.perf_counter()
    loop.run(problem, device, solves=traffic["warmup_solves"])
    loop.synchronize(device)
    t_ready = time.perf_counter()
    setup_s = t_ready - t0

    cuda = device.type == "cuda"
    k1_before = _k1_launches()
    window = loop.run(problem, device, seconds=seconds,
                      keep=traffic["keep"], rng=random.Random(seed))
    k1_after = _k1_launches()
    traced = None
    if trace:
        traced = tracing.traced(problem, device, traffic["trace_seconds"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    run = Run(cfg=cfg, traffic=traffic, kind=kind, flops=kind.flops(cfg),
              setup_s=setup_s, window=window, trace=traced)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry in spec.metrics_of(bench, cell_name, group):
        value = spec.metric(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    # the program's state goes before the reference runs on the card
    kept = [res for _, res in window.kept]
    kept_at = [i for i, _ in window.kept]
    window.kept = []
    problem.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = kind.check(cfg, problem, kept)
    limits = cfg["limits"]
    checks, lines, failed = {}, [], set()
    for name, values in readings.items():
        worst = reference.worst(values)
        ok = all(v <= limits[name] for v in values)
        failed.update(i for i, v in enumerate(values)
                      if not v <= limits[name])
        checks[name] = {"value": worst, "limit": limits[name]}
        lines.append(f"check {name} {worst!r} limit {limits[name]!r} "
                     f"{'ok' if ok else 'FAILED'}")
    correct = bool(kept) and not failed

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result: dict[str, Any] = {"correct": correct, "attempted": window.solves,
                              "failed": len(failed), "metrics": metrics,
                              "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    per_solve = {k: (k1_after[k] - k1_before[k]) / max(1, window.solves)
                 for k in k1_after}
    result["detail"] = {
        "solves": window.solves, "window_s": window.seconds,
        "latency_samples": len(window.latency_ms),
        "setup": {**(marks or {}), "before_build_s": t_build - t0,
                  "lower_s": problem.lower_s, "stores_s": problem.stores_s,
                  "build_s": t_warm - t_build, "warmup_s": t_ready - t_warm},
        "check_s": time.perf_counter() - t_check, "kept_solves": kept_at,
        "plan": problem.plan, "k1_launches_per_solve": per_solve}
    if traced is not None:
        result["detail"]["trace"] = {
            "solves": traced.solves, "device_events": traced.device_events,
            "enqueue_ms_mean": 1e3 * sum(traced.enqueue_s)
            / max(1, len(traced.enqueue_s))}
    if cuda:
        result["card"] = card_info()
    result["checks"] = checks
    return result, lines


def card_info() -> dict:
    """The card's name, power limit and clocks as ``nvidia-smi`` reads
    them (empty where it cannot)."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.stdout.splitlines()[0].split(",")]
    return dict(zip(fields.split(","), vals))


def program_in_checkout() -> None:
    """Raise unless the program imports from this checkout."""
    import parsec_tpu_torch
    where = Path(parsec_tpu_torch.__file__).resolve()
    if not where.is_relative_to(spec.ROOT):
        raise ImportError(f"parsec_tpu_torch comes from {where}, outside "
                          f"the checkout {spec.ROOT}")


def main(argv: list[str] | None = None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    set_cache_dirs()
    import torch
    marks = {"torch_imported_s": time.perf_counter() - t0}
    program_in_checkout()
    marks["program_imported_s"] = time.perf_counter() - t0
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = measure(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0), t0,
                            marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
