#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``parsec_tpu_torch``).

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit::

    python3 chip_smoke.py

It needs one card, builds the port's kernels from ``parsec_tpu_torch/csrc``
with ``nvcc`` at first use, and fails (exit code other than 0, no result
line) when no card is visible, when the package is not beside it, or when
any phase fails:

1. **build** — every kernel source, one ``nvcc`` each, in parallel.
2. **kernel** — ``gemm_update`` against its plain PyTorch version on the
   card at the main path's shapes (batch 64 x 1024^3 fp32, batch 64 x
   512^3 bf16 -> fp32, one ragged 2-D shape), the batched ones through the
   tile-list wrapper the path calls, with the kernel's, the plain
   version's and ``torch.baddbmm``/``torch.addmm``'s times (a yardstick the
   port never calls; bf16 -> fp32 through ``baddbmm``'s ``out_dtype``) and
   the least time the card could take.
3. **path** — the dynamic-runtime tiled GEMM at full size (n=8192, nb=1024,
   fp32: 8x8x8 = 512 tasks, 768 MiB of tiles through the device LRU)
   through ``Context`` and ``init_cuda_devices()``, every tile of C checked
   against one float64 product on the card, with its phase walls.

TF32 is off for every PyTorch matmul, so the plain versions compute
strict fp32.  Every printed number stands beside the card's name and
power limit.  The line before the last lists each kernel with its launch
count on the path; the last line is the result object.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: int, in_dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[in_dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _emit(card: str, **kw) -> None:
    print(json.dumps({**kw, "card": card}))


def phase_build(card: str) -> None:
    from parsec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    for name in secs:
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    _emit(card, phase="build", sources=sorted(secs), seconds=wall)


def phase_kernel(card: str, torch) -> dict:
    """gemm_update against its plain version at the path's shapes; returns
    the main-path shape's record for the kernels line.  The batched shapes
    go through gemm_update_tiles on lists of tiles, the wrapper the path's
    fused dispatch calls, and through gemm_update on the stacked tensors."""
    from parsec_tpu_torch.ops import gemm as tg
    cases = [("batch64x1024^3 fp32", (64, 1024, 1024, 1024), torch.float32),
             ("batch64x512^3 bf16->fp32", (64, 512, 512, 512), torch.bfloat16),
             ("ragged 1000x700x300 fp32", (1000, 700, 300), torch.float32)]
    # fp32 sums in another order than cuBLAS: |C| ~ sqrt(k), so
    # differences of a few 1e-4 are rounding, a wrong element is O(1)
    tol = dict(rtol=1e-4, atol=1e-3)
    main = None
    for i, (label, shape, in_dtype) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        *lead, m, n, k = shape
        a = torch.randn(*lead, m, k, device="cuda", generator=g).to(in_dtype)
        b = torch.randn(*lead, k, n, device="cuda", generator=g).to(in_dtype)
        c = torch.randn(*lead, m, n, device="cuda", generator=g)
        want = tg.gemm_update_plain(a, b, c)
        if lead:
            tiles = (list(a.unbind(0)), list(b.unbind(0)), list(c.unbind(0)))
            run = lambda: tg.gemm_update_tiles(*tiles)  # noqa: E731
            got = torch.stack(run())
            strided = tg.gemm_update(a, b, c)
            # the library's batched call, a yardstick the port never calls
            lib = lambda: torch.baddbmm(c, a, b, torch.float32)  # noqa: E731
        else:
            run = lambda: tg.gemm_update(a, b, c)  # noqa: E731
            got = strided = run()
            lib = lambda: torch.addmm(c, a, b)  # noqa: E731
        lib_out = lib()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(strided, want, **tol)
        torch.testing.assert_close(lib_out, want, **tol)
        # enough launches that the small ragged shape times the kernel
        # and not the launch overhead
        iters = 5 if lead else 200
        ms = _time_ms(torch, run, iters)
        strided_ms = (_time_ms(torch, lambda: tg.gemm_update(a, b, c), iters)
                      if lead else ms)
        plain_ms = _time_ms(torch, lambda: tg.gemm_update_plain(a, b, c),
                            iters)
        lib_ms = _time_ms(torch, lib, iters)
        batch = lead[0] if lead else 1
        flops = 2.0 * batch * m * n * k
        nbytes = sum(t.numel() * t.element_size() for t in (a, b, c, got))
        bound_ms, bound_by = _bound(flops, nbytes, str(in_dtype)[6:])
        rec = dict(shape=label, max_abs_err=err, ms=ms, strided_ms=strided_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, tflops=flops / ms / 1e9,
                   library_max_abs_err=(lib_out - want).abs().max().item())
        _emit(card, phase="kernel", name="gemm_update", **rec)
        if main is None:
            main = rec
        del a, b, c, got, want, strided, lib_out
    # the matmul_pallas counterpart: same kernel, no C, bf16 output
    g = torch.Generator(device="cuda").manual_seed(200)
    a = torch.randn(1000, 300, device="cuda", generator=g).bfloat16()
    b = torch.randn(300, 700, device="cuda", generator=g).bfloat16()
    mm = tg.matmul(a, b)
    ref = torch.matmul(a.float(), b.float())
    torch.cuda.synchronize()
    # bf16 output: 8 mantissa bits, about 0.4% of |C| ~ sqrt(300)
    torch.testing.assert_close(mm.float(), ref, rtol=1e-2, atol=5e-2)
    _emit(card, phase="kernel", name="matmul",
          max_abs_err=(mm.float() - ref).abs().max().item())
    torch.cuda.empty_cache()
    return main


def phase_path(card: str, torch, n: int = 8192, nb: int = 1024,
               seed: int = 0) -> dict:
    """The dynamic-runtime tiled GEMM through the entry points."""
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    def init(tag):
        def fn(m, n_, shape):
            rng = np.random.default_rng((seed, tag, m, n_))
            return rng.standard_normal(shape, dtype=np.float32)
        return fn

    A = TiledMatrix("A", n, n, nb, nb, init_fn=init(1))
    B = TiledMatrix("B", n, n, nb, nb, init_fn=init(2))
    C = TiledMatrix("C", n, n, nb, nb)
    t_gen = time.perf_counter()
    for M in (A, B, C):      # host tiles are set-up, made before the clock
        for i in range(M.mt):
            for j in range(M.nt):
                M.data_of(i, j)
    t_gen = time.perf_counter() - t_gen
    dev = init_cuda_devices()[0]
    tp = tiled_gemm_ptg(A, B, C)
    chores = [c.device_type for c in tp.task_classes[0].chores]
    cpu = registry.get(0)
    cpu_before = cpu.executed_tasks

    tg.gemm_update.launches = 0          # counts from here are the path's
    ctx = Context(nb_cores=0)
    t0 = time.perf_counter()
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
        dev.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ctx.fini(timeout=60)
    launches = tg.gemm_update.launches
    dev.flush_cache()
    ntasks = C.mt * C.nt * A.nt
    _check(chores == ["cuda"], f"chores {chores}")
    _check(dev.executed_tasks == ntasks == 512,
           f"{dev.executed_tasks} tasks ran on the card, expected 512")
    _check(launches > 0, "the path launched no gemm_update kernel")
    _check(dev.batched_dispatches > 0, "no batched dispatch on the path")
    _check(cpu.executed_tasks == cpu_before, "a CPU chore ran")
    _check(dev.enabled, "the device was disabled")

    # correctness: every tile shaped and finite, and all of C against one
    # float64 product on the card.  |C| ~ sqrt(8192) ~ 90; fp32 rounding
    # over 8192 terms stays near 1e-3, a wrong tile is off by O(90)
    for i in range(C.mt):
        for j in range(C.nt):
            t = C.data_of(i, j).newest_copy().value
            _check(tuple(t.shape) == (nb, nb) and t.dtype == torch.float32,
                   f"tile ({i},{j}) is {tuple(t.shape)} {t.dtype}")
    got = torch.from_numpy(C.to_dense()).cuda().double()
    _check(bool(torch.isfinite(got).all()), "C is not finite")
    ref = (torch.from_numpy(A.to_dense()).cuda().double()
           @ torch.from_numpy(B.to_dense()).cuda().double())
    err = (got - ref).abs()
    bad = err > 1e-2 + 1e-4 * ref.abs()
    worst = err.max().item()
    if bool(bad.any()):
        r, c_ = (int(x) for x in bad.nonzero()[0])
        raise RuntimeError(f"chip_smoke: C wrong in tile ({r // nb},"
                           f"{c_ // nb}); max abs err {worst}")
    del got, ref, err, bad
    s = dev.stats()
    rec = dict(n=n, nb=nb, tasks=dev.executed_tasks, wall_s=wall,
               gflops=gemm_flops(n, n, n) / wall / 1e9,
               stage_in_s=s["t_stage_in"], pin_s=s["t_pin"],
               dispatch_s=s["t_dispatch"],
               complete_s=s["t_complete"], manager_s=s["t_manager"],
               drain_s=s["t_drain"], gemm_launches=launches,
               device_dispatches=dev.kernel_launches,
               batched_dispatches=dev.batched_dispatches,
               mean_batch=dev.executed_tasks / max(1, dev.kernel_launches),
               h2d_mb=dev.bytes_in / 1e6,
               h2d_MBps=(dev.bytes_in / 1e6 / s["t_stage_in"]
                         if s["t_stage_in"] > 0 else None),
               cache_hits=dev.cache_hits, cache_misses=dev.cache_misses,
               host_tile_gen_s=t_gen, max_abs_err=worst)
    _emit(card, phase="path", **rec)
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 1
    try:
        import parsec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the parsec_tpu_torch package is missing ({e}); "
              f"run from the repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    phase_build(card)
    main_rec = phase_kernel(card, torch)
    path = phase_path(card, torch)
    kernels = [{"name": "gemm_update", "route": "cuda",
                "source": "parsec_tpu_torch/csrc/gemm.cu",
                "replaces": "parsec_tpu/ops/gemm.py:66",
                "launches": path["gemm_launches"],
                "max_abs_err": main_rec["max_abs_err"],
                "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"]}]
    _check(all(math.isfinite(k["ms"]) for k in kernels), "a time is not finite")
    _emit(card, phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
