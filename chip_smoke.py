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
2. **kernel** — each K1 variant (``ops/gemm.py:k1_variant``) against the
   plain PyTorch version of its arithmetic on the card at the main
   paths' shapes: batch 64 x 1024^3 fp32 under ``gemm_precision``
   ``default`` (``mma_tf32``, held against TF32-rounded inputs) and
   ``highest`` (``simt_fp32``), batch 64 x 512^3 bf16 -> fp32
   (``wgmma_bf16``), and one ragged 2-D shape under each; the batched
   ones through the tile-list wrapper the path calls (its host time
   apart), with the kernel's, the plain version's and
   ``torch.baddbmm``'s times (a yardstick the port never
   calls; TF32 on for it alone where the variant is ``mma_tf32``; bf16 ->
   fp32 through ``baddbmm``'s ``out_dtype``) and the least time the card
   could take (TF32 at 495 TFLOP/s for ``mma_tf32``).
3. **path** — the dynamic-runtime tiled GEMM at full size (n=8192, nb=1024,
   fp32: 8x8x8 = 512 tasks, 768 MiB of tiles through the device LRU)
   through ``Context`` and ``init_cuda_devices()`` at the default
   ``gemm_precision``, so every launch is ``mma_tf32``; every element of
   C within ``2e-3 * (|A| @ |B|) + 1e-2`` of one float64 product on the
   card, with its phase walls.
4. **kernel ragged_attn_page** — K2 against its plain version on the
   card through both forms of the tile-list entry (the functional one,
   and the in-place one the serving path calls, held on a clone of the
   accumulators) and the strided one: (a) the path's shape, a batch of 64
   ToyLM pages (3,16,4,8) with fills 0..16 and empty and non-empty
   accumulators; (b) a Llama-2-7B head geometry, 1024 pages
   (3,16,32,128) fp32, about 805 MB; (c) the same pages in bf16.  For
   each: the entry's time in both forms, its host time, the kernel's own
   device time (``torch.profiler`` device events), the plain version's
   time and the bound; no single PyTorch call computes the flash-state
   page update, so there is no library time.
5. **path llm** — LLM decode serving through ``RuntimeServer(nb_cores=2)``
   and ``submit_stream`` with no device argument, so the batcher decodes
   on the card: 32 concurrent streams of ToyLM (the only model the repo
   serves, at its defaults), prompts of 64-512 tokens drawn from a seed,
   64 new tokens each, k=8 steps per superpool, two tenants, one stream
   with an EOS and one forked from another's prompt.  Every stream's
   tokens must equal the float64 oracle ``ToyLM.reference_generate``,
   every ATTN/OUT/SAMPLE/PF task must have run on the card, K2 must have
   launched and batched.
6. **trace llm** — the same backlog with 16 new tokens a stream, under
   ``torch.profiler`` (device activity only): the card's busy time over
   the serving wall, the kernels that took it, and K2's share.
   Then **path llm_wide** and **trace llm_wide**: ToyLM at a Llama-2-7B
   attention width (32 heads of 128, fp32 pages (3,16,32,128)) through a
   ``ContinuousBatcher`` of its own on a ``RuntimeServer(nb_cores=2)``:
   16 streams, prompts of 64-512 tokens from seed 11, 32 new tokens (8
   traced), k=8, two tenants, held to the oracle and to the card like
   the ``llm`` phase.
7. **kernel stencil1d** — K3 against its plain PyTorch version on the
   card: the lowered stencil's interior group (62 rows of 2^18 + 8, fp32,
   9 taps), the same in bf16, one row of 2^20 + 8 (past the TPU kernel's
   VMEM limit) and a 3-D batch; kernel, plain and bound times, and
   ``torch.nn.functional.conv1d`` on the same rows (the same
   cross-correlation; a yardstick the port never calls).
8. **path lowered_stencil** — ``lower_taskpool(stencil_1d_ptg(V, w, 64))``
   at the JAX bench's configuration (n = 2^24, mb = 2^18, R = 4, weights
   1/9, base from seed 0): the wavefront pass, 3 K3 launches a level, all
   of V against a float64 oracle computed on the card; the execute wall,
   the step wall with stores resident, one step under ``torch.profiler``.
9. **path lowered_stencil2d** — ``stencil_2d_ptg`` lowered at 8192^2
   fp32, 1024^2 tiles, 16 iterations (plain PyTorch traceable, no
   kernel), against the float64 oracle on the card.
10. **path lowered_gemm** — ``lower_taskpool(tiled_gemm_ptg(A, B, C))`` at
   N = 16384, nb = 512, bf16 A/B, fp32 C of zeros (the JAX bench's
   headline): chain collapse on dense stores, one K1 launch a step; the
   step timed with stores resident, ``execute()`` end to end, all of C
   against a float64 product of the same bf16 inputs on the card, and
   K1 (``wgmma_bf16``, its one launch) and ``torch.baddbmm`` at that shape.
11. **kernel gemm_update forms** — K1's forms for the factorizations
   (``nt``: B transposed, ``-sub``: ``c - a@b``, ``-noc``: no C) against
   their plain version: ``nt-sub`` (Cholesky's GEMM and SYRK), ``nt-noc``
   (its TRSM), ``nn-sub`` and ``nn-noc`` (LU's GEMM and TRSMs) as tile
   lists of 64 1024^3 fp32 tiles (the dynamic paths' batch) on
   ``mma_tf32``, on TF32-rounded inputs; ``nt-sub`` and ``nt-noc`` on
   ``simt_fp32`` under ``highest`` (the ``dynamic_cholesky_highest``
   path's) against the strict plain version; ``nt-sub`` as a strided batch
   of 465 and ``nn-sub`` of 225 512^3 tiles (the lowered groups' shapes).
   Each with the kernel's, the plain version's and the library call's
   times (``torch.baddbmm(c, a, b, alpha=-1)``, or ``torch.bmm`` with no
   C, TF32 on for that call alone under ``default``) and the bound.
12. **path dynamic_cholesky** — ``tiled_cholesky_ptg`` through
   ``Context`` on the card at n=8192, nb=1024, fp32 (the JAX bench's
   ``dynamic_cholesky`` stage), under ``gemm_precision`` ``default``
   (TF32) and again under ``highest``; **path dynamic_lu** — the nopiv
   LU at the same size (each after a 2x2-tile run of the same pool off
   the clock, so the library's first-call set-up is not timed).  **path
   lowered_cholesky** at n=16384, nb=512 and **path lowered_lu** at
   n=8192, nb=512 (the JAX bench's ``lowered_*`` stages): the wavefront
   pass, its step on resident stores (mean of 3), ``execute()`` end to
   end, one step under ``torch.profiler``.  The SPD input is
   ``make_spd_fast`` at both sizes (the JAX bench's dynamic stage takes
   ``make_spd``, an n^3 host Gram product), the LU input ``make_dd``.
   Each factor is held in float64 on the card against the float64
   factor of the same input, tile by tile (``ops/factor.py:tile_error``)
   under ``FACTOR_TOL``; its backward error ``||A - L·Lᵀ||_F / ||A||_F``
   (``L·U`` for LU) under ``BACKWARD_TOL``, and tile (0,0) under
   ``TILE00_TOL``.  **control** — each default path once more with one
   trailing update dropped (the first C tile its GEMM forms are given
   passes through): its tile error must exceed the gate; and the TF32
   run's readings must exceed the ``highest`` gates.  So every run shows
   that its gates can fail.
13. **path dtd_gemm** (after **path**) — the JAX bench's ``dtd_gemm``
   stage at full size: n=8192, nb=1024, fp32, 512 ``insert_task(gemm,
   (A[m][k], INPUT), (B[k][n], INPUT), (C[m][n], INOUT),
   cuda_kernel="gemm")`` calls through ``Context`` and
   ``init_cuda_devices()``, after a 2x2-tile run off the clock: the wall
   from the first insertion to the last kernel's completion, the time
   inside ``insert_task``, K1's launches by variant and the mean batch;
   every task on the card (the host body never called), and all of C, home
   after ``data_flush_all``, within the TF32 bound of a float64 product.
   The PTG GEMM's wall stands beside it: phase **path**'s cold first run,
   and a run on the same tiles after the DTD run, under the same bound.
14. **dispatch** — per-task dispatch on the card machine's host: the EP
   pool of ``models/ep.py`` (50 lanes, 10,000 CTL-only tasks with
   empty bodies), median of 5: ``dispatch_us`` on the compiled-DAG
   executor (it fails unless the executor and the native core engaged)
   and ``dynamic_dispatch_us`` under each of the eleven schedulers,
   beside the host CPU.
15. **path multirank_gemm, multirank_cholesky, multirank_lu** (after the
   factorizations) — the dynamic GEMM, Cholesky and LU of phases
   **path** and **dynamic_*** at the same sizes across 4 ranks: threads
   of this process, one ``Context`` each, on a 2 x 2 block-cyclic grid,
   sharing the card through the device fabric
   (``run_multirank(4, ..., transport="device", devices=[cuda:0] * 4)``,
   ``nb_cores=0``), each after a 2 x 2-tile run off the clock; Cholesky
   under the four-counter detector.  Per-rank task counts must sum to
   512, 120 and 204, every tile product be a K1 launch (``mma_tf32``),
   C lie within the TF32 bound and each factor pass the gates of its
   single-rank phase with its dropped-update control; the factorizations
   must move tiles between the ranks on the card (``bytes_got``).  Each
   line carries the wall from the first ``add_taskpool`` to the last
   rank's ``wait``, each rank's tasks and comm counters, K1's launches
   by variant and form, the mean batch and the single-rank wall beside
   it.

16. **path multiproc_gemm, multiproc_cholesky, multiproc_lu** (after the
   multi-rank paths) — the same three pools at the same sizes across 4
   rank *processes* (``run_multiproc(4, ..., transport="device",
   distributed=True)``: each rank an interpreter of its own with its own
   CUDA context and device module on ``cuda:0``, the ranks joined by the
   TCP socket fabric and a gloo process group; tiles cross by D2H, TCP and
   H2D), one launch running the three kinds in turn through
   ``parsec_tpu_torch/comm/mp_bodies.py:pool_body``, each after a 2 x
   2-tile run off the clock.  Every rank joins at a barrier and stamps
   ``time.monotonic()`` before ``add_taskpool`` and after ``wait`` (its
   card synchronized); the wall runs from the first stamp to the last.
   Per-rank task counts must sum to the single-rank count, every tile
   product be K1 (``mma_tf32``) in its rank and no task a host chore; C
   within the TF32 bound, a factor under the ``dynamic_*`` gates; the
   GETs and landed payload bytes of each rank equal the in-process
   phase's, the payload served over the ranks equal the payload landed;
   no rank holds ``jax`` or ``parsec_tpu``, and the group spans 4.  Each
   line carries the wall, each rank's ``manager_s``, GETs, payload bytes
   and bytes by tier, the host seconds of each hop (D2H to its event,
   frames sent, frames received, H2D enqueued, and the GETs from request to
   landing), K1's launches by variant and form, and whether the readings
   equal the in-process phase's to every digit.
17. **path multirank_dtd_gemm** — the distributed DTD GEMM of
   ``parsec_tpu_torch/dtd/multirank_check.py`` (``AFFINITY`` on C, A and
   B tiles pushed between the ranks) at n=8192, nb=1024 across 4 rank
   threads on the card (``run_multirank(4, transport="device",
   devices=[cuda:0] * 4)``) with ``cuda_kernel="gemm"``, after a 2 x
   2-tile run off the clock: every GEMM on K1, C within the TF32 bound,
   each rank's tasks and received pushes equal to a rehearsal of the same
   insertion program on the host at 8 x 8 small tiles; the line carries
   the wall, each rank's pushes and their bytes, and K1's launches.

TF32 is off for every PyTorch matmul and convolution, so the plain
versions and the yardsticks compute strict fp32, but for the one
yardstick call of ``mma_tf32``.  Every printed number stands beside the card's name and
power limit.  The line before the last lists each kernel with its launch
count on its own path; the last line is the result object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12

# The factorizations' gates.  A diagonally dominant input carries nearly
# all of its norm on the diagonal, so a whole-matrix error cannot see one
# wrong tile; the discriminating gate is ``tile_error``: each tile's parts
# below, on and above the diagonal, apart, against the float64 factor.
# Under ``default`` every product rounds its inputs to TF32 (2^-11), and
# the TRSMs carry that rounding of the panel into every tile: the four
# paths read 2.4e-4 to 3.0e-4 on an H100.  One dropped trailing update
# moves its tile by about sqrt(nb)/n (1.25 sqrt(nb)/n on make_spd_fast):
# 1.76e-3 at n=16384, nb=512, the least of the four paths' controls.  The
# gate is their geometric mean, 2.3x from each.  Under ``highest`` all is
# strict fp32 (2.4e-7); the TF32 run (2.6e-4) is the control, and the gate
# again sits at the geometric mean.  Both controls run in every run
# (phase ``control``).
FACTOR_TOL = {"default": 7e-4, "highest": 8e-6}
# The backward error ||A - L·Lᵀ||_F / ||A||_F is reported and gated, but
# it sees only gross faults under ``default`` (a dropped update moves it
# by 1e-7 to 9e-6 on these paths, from about 3e-6); under ``highest`` it sits between strict fp32 (about
# 3e-7) and the TF32 run (about 3e-6), which is its control.
BACKWARD_TOL = {"default": 2e-3, "highest": 1e-6}
# tile (0,0) is the first POTRF/GETRF alone (no TF32 product reaches it):
# fp32 library factors of a tile, relative to its largest entry
TILE00_TOL = 1e-4


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


def _host_ms(torch, fn, iters: int) -> float:
    """A call's host time: the enqueue, with no synchronize inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def _bound(flops: float, nbytes: int, in_dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[in_dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _emit(card: str, **kw) -> None:
    print(json.dumps({**kw, "card": card}))


def _entry_label(mangled: str) -> str:
    """``ns::kernel`` and the start of its mangled template arguments,
    from an Itanium name such as ``_ZN<n>_GLOBAL__N_...<n>ns<n>kernelI..``
    (the anonymous namespace dropped)."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") \
        else 0
    names = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
    names = [x for x in names if not x.startswith("_GLOBAL__N")]
    return "::".join(names) + " " + mangled[i:i + 24]


def phase_build(card: str) -> None:
    from parsec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    for name in secs:
        entry = "?"
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                entry = _entry_label(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}")
    _emit(card, phase="build", sources=sorted(secs), seconds=wall,
          source_seconds=secs)


def _k1_reset(tg) -> None:
    """Zero K1's launch counts: what follows is a path's own."""
    tg.gemm_update.launches = 0
    tg.gemm_update.launches_by_variant = dict.fromkeys(tg.K1_VARIANTS, 0)
    tg.gemm_update.launches_by_form = {}


def phase_kernel(card: str, torch) -> tuple[dict, list]:
    """Each K1 variant against its plain version at the paths' shapes;
    returns the dynamic path's shape record (``mma_tf32``) for the
    kernels line, and every record.  The batched shapes go through
    gemm_update_tiles on lists of tiles, the wrapper the path's fused
    dispatch calls, and through gemm_update on the stacked tensors."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.ops import gemm as tg
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("batch64x1024^3 fp32", (64, 1024, 1024, 1024), f32, "default",
              "mma_tf32"),
             ("batch64x1024^3 fp32", (64, 1024, 1024, 1024), f32, "highest",
              "simt_fp32"),
             ("batch64x512^3 bf16->fp32", (64, 512, 512, 512), bf16,
              "default", "wgmma_bf16"),
             ("ragged 1000x700x300 fp32", (1000, 700, 300), f32, "default",
              "mma_tf32"),
             ("ragged 1000x700x300 fp32", (1000, 700, 300), f32, "highest",
              "simt_fp32"),
             ("ragged 1000x700x300 bf16->fp32", (1000, 700, 300), bf16,
              "default", "simt_fp32")]
    # each variant against the plain version of its own arithmetic (TF32
    # inputs rounded first, their products exact in fp32): both sum fp32
    # products in other orders, |C| ~ sqrt(k), so differences of a few
    # 1e-4 are rounding, a wrong element is O(1)
    tol = dict(rtol=1e-4, atol=1e-3)
    recs = []
    try:
        for i, (label, shape, in_dtype, prec, variant) in enumerate(cases):
            params.set("gemm_precision", prec)
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            *lead, m, n, k = shape
            a = torch.randn(*lead, m, k, device="cuda",
                            generator=g).to(in_dtype)
            b = torch.randn(*lead, k, n, device="cuda",
                            generator=g).to(in_dtype)
            c = torch.randn(*lead, m, n, device="cuda", generator=g)
            tf32 = variant == "mma_tf32"
            want = tg.gemm_update_plain(a, b, c, tf32=tf32)
            before = dict(tg.gemm_update.launches_by_variant)
            if lead:
                tiles = (list(a.unbind(0)), list(b.unbind(0)),
                         list(c.unbind(0)))
                run = lambda: tg.gemm_update_tiles(*tiles)  # noqa: E731
                got = torch.stack(run())
                strided = tg.gemm_update(a, b, c)
                # the library's batched call, a yardstick the port never
                # calls
                lib_call = lambda: torch.baddbmm(  # noqa: E731
                    c, a, b, torch.float32)
            else:
                run = lambda: tg.gemm_update(a, b, c)  # noqa: E731
                got = strided = run()
                lib_call = lambda: torch.baddbmm(  # noqa: E731
                    c[None], a[None], b[None], torch.float32)[0]

            def lib():
                torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    return lib_call()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False

            lib_out = lib()
            torch.cuda.synchronize()
            after = dict(tg.gemm_update.launches_by_variant)
            ran = {v: after[v] - before[v] for v in after
                   if after[v] != before[v]}
            _check(ran == {variant: 2 if lead else 1},
                   f"gemm_update {label} {prec}: ran {ran}, expected "
                   f"{variant}")
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, **tol)
            torch.testing.assert_close(strided, want, **tol)
            lib_err = (lib_out - want).abs().max().item()
            if not tf32:
                torch.testing.assert_close(lib_out, want, **tol)
            # enough launches that the small ragged shape times the
            # kernel and not the launch overhead
            iters = 5 if lead else 200
            ms = _time_ms(torch, run, iters)
            strided_ms = (_time_ms(torch, lambda: tg.gemm_update(a, b, c),
                                   iters) if lead else ms)
            plain_ms = _time_ms(torch, lambda: tg.gemm_update_plain(
                a, b, c, tf32=tf32), iters)
            lib_ms = _time_ms(torch, lib, iters)
            # the wrapper's own host time a call (enqueue, no sync)
            host_ms = _host_ms(torch, run, iters)
            batch = lead[0] if lead else 1
            flops = 2.0 * batch * m * n * k
            nbytes = sum(t.numel() * t.element_size() for t in (a, b, c, got))
            peak = "tfloat32" if tf32 else str(in_dtype)[6:]
            bound_ms, bound_by = _bound(flops, nbytes, peak)
            rec = dict(shape=label, precision=prec, variant=variant,
                       max_abs_err=err, ms=ms, strided_ms=strided_ms,
                       host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_tf32=tf32, bound_ms=bound_ms,
                       bound_by=bound_by, tflops=flops / ms / 1e9,
                       library_max_abs_err=lib_err)
            _emit(card, phase="kernel", name="gemm_update", **rec)
            recs.append(rec)
            del a, b, c, got, want, strided, lib_out
    finally:
        params.set("gemm_precision", "default")
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
    return recs[0], recs


def phase_path(card: str, torch, n: int = 8192, nb: int = 1024,
               seed: int = 0) -> dict:
    """The dynamic-runtime tiled GEMM through the entry points."""
    import numpy as np

    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    params.set("gemm_precision", "default")    # whatever the environment says

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

    _k1_reset(tg)                        # counts from here are the path's
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
    by_variant = dict(tg.gemm_update.launches_by_variant)
    dev.flush_cache()
    ntasks = C.mt * C.nt * A.nt
    _check(chores == ["cuda"], f"chores {chores}")
    _check(dev.executed_tasks == ntasks == 512,
           f"{dev.executed_tasks} tasks ran on the card, expected 512")
    _check(launches > 0, "the path launched no gemm_update kernel")
    _check(by_variant["mma_tf32"] == launches,
           f"fp32 tiles at the default gemm_precision ran {by_variant}")
    _check(dev.batched_dispatches > 0, "no batched dispatch on the path")
    _check(cpu.executed_tasks == cpu_before, "a CPU chore ran")
    _check(dev.enabled, "the device was disabled")

    # correctness: every tile shaped and finite, and all of C against one
    # float64 product on the card.  The tiles ran on TF32 tensor cores:
    # each input within 2^-11 of its value, so each product within about
    # 2^-10 (1e-3) of its magnitude; the bound is elementwise, 2e-3 *
    # (|A| @ |B|) + 1e-2 (|C| ~ sqrt(8192) ~ 90, |A| @ |B| ~ 5,200: about
    # 10 at each element, where the TF32 error is ~0.05 and a wrong tile
    # is off by O(90))
    for i in range(C.mt):
        for j in range(C.nt):
            t = C.data_of(i, j).newest_copy().value
            _check(tuple(t.shape) == (nb, nb) and t.dtype == torch.float32,
                   f"tile ({i},{j}) is {tuple(t.shape)} {t.dtype}")
    worst = _check_c(torch, C.to_dense(), A.to_dense(), B.to_dense(), nb,
                     "path")
    s = dev.stats()
    rec = dict(n=n, nb=nb, tasks=dev.executed_tasks, wall_s=wall,
               gflops=gemm_flops(n, n, n) / wall / 1e9,
               stage_in_s=s["t_stage_in"], pin_s=s["t_pin"],
               dispatch_s=s["t_dispatch"],
               complete_s=s["t_complete"], manager_s=s["t_manager"],
               drain_s=s["t_drain"], gemm_launches=launches,
               gemm_launches_by_variant=by_variant,
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


def _check_c(torch, c, a, b, nb: int, what: str) -> float:
    """All of C (host arrays ``c``, ``a``, ``b``) against one float64
    product on the card under the TF32 bound ``2e-3 * (|A| @ |B|) +
    1e-2``; returns the largest error."""
    got = torch.from_numpy(c).cuda().double()
    _check(bool(torch.isfinite(got).all()), f"{what}: C is not finite")
    a64 = torch.from_numpy(a).cuda().double()
    b64 = torch.from_numpy(b).cuda().double()
    ref = a64 @ b64
    err = (got - ref).abs()
    bad = err > 2e-3 * (a64.abs() @ b64.abs()) + 1e-2
    del a64, b64
    worst = err.max().item()
    if bool(bad.any()):
        r, c_ = (int(x) for x in bad.nonzero()[0])
        raise RuntimeError(f"chip_smoke: {what}: C wrong in tile "
                           f"({r // nb},{c_ // nb}); max abs err {worst}")
    del got, ref, err, bad
    torch.cuda.empty_cache()
    return worst


def _dtd_gemm_run(torch, dev, nt: int, nb: int, seed: int) -> dict:
    """One DTD GEMM through ``Context(nb_cores=0)``: host tiles made from
    ``seed`` (set-up, off the clock), then the ``nt**3`` insertions of
    ``models/tiled_gemm.py:insert_dtd_gemm`` (``cuda_kernel="gemm"``, the
    bench's order).  The wall runs from the first insertion to the last
    kernel's completion (the caller drives the pool until no task is in
    flight, then synchronizes); ``data_flush_all`` and the pool's wait
    follow, off the clock."""
    from parsec_tpu_torch.dtd import DTDTaskpool
    from parsec_tpu_torch.models.tiled_gemm import insert_dtd_gemm
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    g = torch.Generator().manual_seed(seed)
    A = [[torch.randn(nb, nb, generator=g) for _ in range(nt)]
         for _ in range(nt)]
    B = [[torch.randn(nb, nb, generator=g) for _ in range(nt)]
         for _ in range(nt)]
    C = [[torch.zeros(nb, nb) for _ in range(nt)] for _ in range(nt)]
    host_calls = []

    def gemm(a, b, c):                 # the host body: must never run
        host_calls.append(1)
        c += a @ b

    _k1_reset(tg)                        # counts from here are the run's
    before = dict(tasks=dev.tasks_by_class["gemm"],
                  dispatches=dev.dispatches_by_class["gemm"],
                  batched=dev.batched_dispatches, stage_in=dev.t_stage_in,
                  pin=dev.t_pin, manager=dev.t_manager, h2d=dev.bytes_in)
    ctx = Context(nb_cores=0)
    tp = DTDTaskpool()
    try:
        ctx.add_taskpool(tp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        insert_s = insert_dtd_gemm(tp, A, B, C, body=gemm)
        ctx._drive_until(lambda: tp._inflight == 0, timeout=600)
        dev.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        tp.data_flush_all()
        tp.wait(timeout=600)
        flush_s = time.perf_counter() - t1
    finally:
        ctx.fini(timeout=60)
    dispatches = dev.dispatches_by_class["gemm"] - before["dispatches"]
    tasks = dev.tasks_by_class["gemm"] - before["tasks"]
    return dict(A=A, B=B, C=C, wall_s=wall, insert_s=insert_s,
                flush_s=flush_s, tasks=tasks, host_calls=len(host_calls),
                dispatches=dispatches,
                batched=dev.batched_dispatches - before["batched"],
                stage_in_s=dev.t_stage_in - before["stage_in"],
                pin_s=dev.t_pin - before["pin"],
                manager_s=dev.t_manager - before["manager"],
                h2d_mb=(dev.bytes_in - before["h2d"]) / 1e6,
                gemm_launches=tg.gemm_update.launches,
                gemm_launches_by_variant=dict(
                    tg.gemm_update.launches_by_variant))


def _ptg_gemm_warm(torch, dev, A: list, B: list, nb: int) -> dict:
    """The PTG dynamic GEMM (phase ``path``'s pool) on the DTD run's host
    tiles, run after it: the same set-up (``Context(nb_cores=0)``, tiles
    made before the clock, the device module and the pinned host
    allocator as the DTD run left them), so its wall compares with the
    DTD wall, which phase ``path``'s cold first run does not.  Returns
    its wall, manager and stage-in times and C on the card in float64."""
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.runtime import Context

    nt = len(A)
    n = nt * nb
    TA = TiledMatrix("A", n, n, nb, nb, init_fn=lambda m, k, _: A[m][k])
    TB = TiledMatrix("B", n, n, nb, nb, init_fn=lambda k, n_, _: B[k][n_])
    TC = TiledMatrix("C", n, n, nb, nb)
    for M in (TA, TB, TC):
        for i in range(nt):
            for j in range(nt):
                M.data_of(i, j)
    tasks0, manager0, stage0 = dev.executed_tasks, dev.t_manager, \
        dev.t_stage_in
    tp = tiled_gemm_ptg(TA, TB, TC)
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
    dev.flush_cache()
    _check(dev.executed_tasks - tasks0 == nt ** 3,
           f"warm PTG GEMM: {dev.executed_tasks - tasks0} tasks on the card")
    return dict(wall_s=wall, manager_s=dev.t_manager - manager0,
                stage_in_s=dev.t_stage_in - stage0,
                C=torch.from_numpy(TC.to_dense()).cuda().double())


def phase_dtd_gemm(card: str, torch, path: dict, n: int = 8192,
                   nb: int = 1024, seed: int = 9) -> dict:
    """The JAX bench's ``dtd_gemm`` stage (``bench.py:707-769``) on the
    card at its full size: n=8192, nb=1024, fp32, 512 DTD GEMM tasks
    with ``cuda_kernel="gemm"`` through ``Context`` and
    ``init_cuda_devices()`` at the default ``gemm_precision``, after a
    2x2-tile run of the same kind off the clock.  Every task must run on
    the card as K1 (``mma_tf32``), the host body never called, and all of
    C, brought home by ``data_flush_all``, within ``2e-3 * (|A| @ |B|) +
    1e-2`` of one float64 product on the card.  The PTG dynamic GEMM's
    wall at the same size stands beside it twice: phase ``path``'s cold
    first run, and a run on the same tiles after the DTD run (its C
    under the same bound), the one that compares."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops

    params.set("gemm_precision", "default")
    dev = init_cuda_devices()[0]
    warm = _dtd_gemm_run(torch, dev, 2, nb, seed + 1)
    _check(warm["tasks"] == 8 and warm["host_calls"] == 0,
           f"dtd warm-up: {warm['tasks']} tasks on the card, "
           f"{warm['host_calls']} on the host")
    del warm
    nt = n // nb
    r = _dtd_gemm_run(torch, dev, nt, nb, seed)
    ntasks = nt ** 3
    launches = r["gemm_launches"]
    by_variant = r["gemm_launches_by_variant"]
    _check(r["tasks"] == ntasks == 512,
           f"{r['tasks']} DTD GEMM tasks ran on the card, expected 512")
    _check(r["host_calls"] == 0,
           f"{r['host_calls']} DTD GEMM tasks called the host body")
    _check(launches > 0 and by_variant["mma_tf32"] == launches,
           f"fp32 DTD tiles at the default gemm_precision ran {by_variant}")
    _check(launches == r["dispatches"],
           f"{launches} K1 launches for {r['dispatches']} dispatches")
    A, B, C = r["A"], r["B"], r["C"]
    for i in range(nt):
        for j in range(nt):
            t = C[i][j]
            _check(t.device.type == "cpu" and tuple(t.shape) == (nb, nb)
                   and t.dtype == torch.float32,
                   f"C tile ({i},{j}) is {t.device} {tuple(t.shape)} "
                   f"{t.dtype}")
    warm = _ptg_gemm_warm(torch, dev, A, B, nb)
    got = torch.cat([torch.cat(row, 1) for row in C]).cuda().double()
    a64 = torch.cat([torch.cat(row, 1) for row in A]).cuda().double()
    b64 = torch.cat([torch.cat(row, 1) for row in B]).cuda().double()
    ref = a64 @ b64
    bound = 2e-3 * (a64.abs() @ b64.abs()) + 1e-2
    del a64, b64
    worst = {}
    for what, c in (("DTD", got), ("warm PTG", warm.pop("C"))):
        _check(bool(torch.isfinite(c).all()), f"{what} C is not finite")
        err = (c - ref).abs()
        worst[what] = err.max().item()
        bad = err > bound
        if bool(bad.any()):
            r_, c_ = (int(x) for x in bad.nonzero()[0])
            raise RuntimeError(f"chip_smoke: {what} C wrong in tile "
                               f"({r_ // nb},{c_ // nb}); max abs err "
                               f"{worst[what]}")
        del c, err, bad
    del got, ref, bound
    rec = dict(n=n, nb=nb, tasks=r["tasks"], host_body_calls=r["host_calls"],
               wall_s=r["wall_s"], insert_s=r["insert_s"],
               insert_us_per_task=r["insert_s"] / ntasks * 1e6,
               gflops=gemm_flops(n, n, n) / r["wall_s"] / 1e9,
               flush_s=r["flush_s"], stage_in_s=r["stage_in_s"],
               pin_s=r["pin_s"], manager_s=r["manager_s"],
               h2d_mb=r["h2d_mb"], gemm_launches=launches,
               gemm_launches_by_variant=by_variant,
               batched_dispatches=r["batched"],
               mean_batch=r["tasks"] / max(1, launches),
               ptg_wall_s=path["wall_s"], ptg_gflops=path["gflops"],
               ptg_gemm_launches=path["gemm_launches"],
               ptg_warm_wall_s=warm["wall_s"],
               ptg_warm_gflops=(gemm_flops(n, n, n) / warm["wall_s"]
                                / 1e9),
               ptg_warm_manager_s=warm["manager_s"],
               ptg_warm_stage_in_s=warm["stage_in_s"],
               max_abs_err=worst["DTD"],
               ptg_warm_max_abs_err=worst["warm PTG"])
    _emit(card, phase="path", name="dtd_gemm", **rec)
    return rec


def _drain_us(builder, ntasks: int, reps: int, compiled: bool,
              scheduler: str = "lfq") -> tuple[float, bool]:
    """Median enqueue-to-drain wall per task in µs over ``reps`` fresh
    pools, and whether the compiled-DAG executor took every one."""
    import statistics

    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.runtime import Context

    saved = params.get("runtime_dag_compile")
    params.set("runtime_dag_compile", compiled)
    times, engaged = [], True
    try:
        for _ in range(reps):
            tp = builder.build()
            ctx = Context(nb_cores=0, scheduler=scheduler)
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            engaged &= getattr(tp, "_compiled_dag", None) is not None
            ctx.wait(timeout=600)
            times.append(time.perf_counter() - t0)
            ctx.fini(timeout=60)
    finally:
        params.set("runtime_dag_compile", saved)
    return statistics.median(times) / ntasks * 1e6, engaged


def _host_cpu() -> str:
    """The host CPU from ``/proc/cpuinfo``: its model name, or, where the
    machine hides it, vendor, family, model number and clock."""
    info: dict[str, str] = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break                     # the first processor is enough
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', '?')} family {info.get('cpu family', '?')}"
            f" model {info.get('model', '?')} at {info.get('cpu MHz', '?')}"
            f" MHz")


def phase_dispatch(card: str, ntasks: int = 10000, reps: int = 5) -> dict:
    """Per-task dispatch cost on the host of the card's machine: the EP
    pool (50 lanes, 10,000 tasks, empty bodies) drained by the caller,
    median of ``reps``; ``dispatch_us`` on the compiled-DAG executor (the
    phase fails unless it and the native tier engaged), and
    ``dynamic_dispatch_us`` under each of the eleven schedulers with
    ``runtime_dag_compile`` off."""
    from parsec_tpu_torch import native
    from parsec_tpu_torch.models.ep import ep_pool
    from parsec_tpu_torch.runtime import Context

    _check(native.available(),
           f"the native core did not build: {native.build_error}")
    ctx = Context(nb_cores=0)
    native_deps = ctx.deps.native_enabled
    ctx.fini()
    _check(native_deps, "the native dep table is off")
    nt = 50
    builder = ep_pool(nt, ntasks // nt)
    us, engaged = _drain_us(builder, ntasks, reps, compiled=True)
    _check(engaged, "the EP pool did not run on the compiled DAG")
    dynamic = {}
    for name in ("lfq", "ap", "spq", "ip", "gd", "rnd", "ll", "llp", "pbq",
                 "ltq", "lhq"):
        dyn_us, dyn_engaged = _drain_us(builder, ntasks, reps,
                                        compiled=False, scheduler=name)
        _check(not dyn_engaged, f"{name}: the dynamic run was compiled")
        dynamic[name] = dyn_us
    rec = dict(ntasks=ntasks, reps=reps, dispatch_us=us,
               dispatch_path="compiled", dynamic_dispatch_us=dynamic,
               native_lib=native.loaded_path(), host_cpu=_host_cpu(),
               host_cpus=len(os.sched_getaffinity(0)))
    _emit(card, phase="dispatch", **rec)
    return rec


def _attn_inputs(torch, batch: int, P: int, H: int, D: int, seed: int):
    """Tile lists for K2: fills cycle 0..P (so 0 and P occur), odd tasks
    carry a non-empty accumulator (one plain update on another page)."""
    from parsec_tpu_torch.ops import ragged_attention as ra
    g = torch.Generator(device="cuda").manual_seed(seed)
    q3 = torch.randn(batch, 3, H, D, device="cuda", generator=g)
    page = torch.randn(batch, 3, P, H, D, device="cuda", generator=g)
    fills = torch.arange(batch, device="cuda") % (P + 1)
    page[:, 2] = 0.0
    page[:, 2, 0, 0, 0] = fills.float()
    acc = torch.zeros(batch, H, D + 2, device="cuda")
    warm = page[1::2].clone()
    warm[:, 2, 0, 0, 0] = float(P)
    acc[1::2] = ra.attn_page_update_plain(q3[1::2], warm, acc[1::2])
    del warm
    return (list(q3.unbind(0)), list(page.unbind(0)), list(acc.unbind(0)),
            q3, page, acc, int(fills.sum()))


def _kernel_device_ms(torch, fn, iters: int, name: str,
                      counter) -> tuple[float, list]:
    """Mean device time of the kernel named ``name`` over ``iters`` calls
    of ``fn`` (one launch each), from ``torch.profiler``'s device events:
    the kernel's own time, whatever the host spends enqueueing it.

    ``counter`` is the wrapper's launch count, as a function object with
    a ``launches`` attribute; it is set to 0 before each session and must
    read ``iters`` after it, or the phase fails.  The profiler has been
    seen to drop a device event of a session: only a session in which
    the wrapper counted every launch and the profiler held fewer events
    is taken again, up to three in all.  Returns the time and, for every
    session, ``[wrapper launches, device events]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sessions = []
    for _ in range(3):
        counter.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launched = counter.launches
        durs = [e.duration_ns()
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and name in e.name()]
        sessions.append([launched, len(durs)])
        _check(launched == iters,
               f"{name}: the wrapper counted {launched} launches for "
               f"{iters} calls (sessions {sessions})")
        if len(durs) == iters:
            return sum(durs) / len(durs) / 1e6, sessions
        _check(len(durs) < iters,
               f"{name}: {len(durs)} device events for {iters} launches")
    raise RuntimeError(f"chip_smoke: {name} sessions [launches, device "
                       f"events]: {sessions}")


def phase_attn_kernel(card: str, torch) -> list:
    """K2 (``ragged_attn_page``) against its plain version at the serving
    path's shape and at a Llama-2-7B head geometry in fp32 and bf16, in
    both forms of the tile-list entry; returns every shape's record, the
    path shape's first."""
    from parsec_tpu_torch.ops import ragged_attention as ra
    # fp32 sums in another order than the plain version: 1e-5 at D=8,
    # 1e-4 at D=128 (scores sum 128 products); bf16 pages widen exactly
    # to fp32 on both sides, so the fp32 tolerance holds; a wrong slot
    # is O(1)
    cases = [("ToyLM 64x(3,16,4,8) fp32", 64, 16, 4, 8, torch.float32,
              1e-5, 200),
             ("Llama-2-7B heads 1024x(3,16,32,128) fp32", 1024, 16, 32, 128,
              torch.float32, 1e-4, 20),
             ("Llama-2-7B heads 1024x(3,16,32,128) bf16", 1024, 16, 32, 128,
              torch.bfloat16, 1e-4, 20)]
    recs = []
    for i, (label, batch, P, H, D, dtype, tol, iters) in enumerate(cases):
        qs, pages, accs, q3, page, acc, fill_sum = _attn_inputs(
            torch, batch, P, H, D, 300 + min(i, 1))
        if dtype != torch.float32:
            page = page.to(dtype)
            pages = list(page.unbind(0))
        want = ra.attn_page_update_plain(q3, page, acc)
        got = torch.stack(ra.attn_page_update_tiles(qs, pages, accs))
        # the in-place form on a clone: the timing loop below keeps
        # updating the tiles it is given
        accs_ = [a.clone() for a in accs]
        got_ = ra.attn_page_update_tiles_(qs, pages, accs_)
        _check(all(g is a for g, a in zip(got_, accs_)),
               f"{label}: the in-place form returned other tiles")
        got_ = torch.stack(got_)
        strided = ra.attn_page_update(q3, page, acc)
        torch.cuda.synchronize()
        errs = {k: (v - want).abs().max().item() for k, v in
                (("tiles", got), ("inplace", got_), ("strided", strided))}
        _check(max(errs.values()) <= tol,
               f"ragged_attn_page {label}: max abs errs {errs} above {tol}")
        _check(bool(torch.isfinite(got).all()), f"{label}: not finite")
        del got, got_, strided, accs_

        def tiles():
            return ra.attn_page_update_tiles(qs, pages, accs)

        def inplace():
            return ra.attn_page_update_tiles_(qs, pages, accs)

        # the tile-list entry in both forms (CUDA events over a run of
        # calls: where the host is slower than the kernel, this is the
        # host's time), its host time alone, the kernel's own device time,
        # the strided entry and the plain version
        ms = _time_ms(torch, tiles, iters)
        inplace_ms = _time_ms(torch, inplace, iters)
        host_ms = _host_ms(torch, inplace, iters)
        kernel_ms, kernel_sessions = _kernel_device_ms(
            torch, inplace, iters, "ragged_attn_page_kernel",
            ra.attn_page_update)
        strided_ms = _time_ms(torch, lambda: ra.attn_page_update(
            q3, page, acc), iters)
        plain_ms = _time_ms(torch, lambda: ra.attn_page_update_plain(
            q3, page, acc), iters)
        # bytes the function must move: the query rows, the filled slots'
        # K and V, each page's fill, acc in and out; operations: the
        # scores and the weighted V sum, 4 flops a (slot, head, dim)
        esize = page.element_size()
        nbytes = (batch * H * D * 4 + fill_sum * 2 * H * D * esize
                  + batch * esize + 2 * batch * H * (D + 2) * 4)
        bound_ms, bound_by = _bound(4.0 * fill_sum * H * D, nbytes,
                                    "float32")
        rec = dict(shape=label, max_abs_err=errs["inplace"],
                   tiles_max_abs_err=errs["tiles"],
                   strided_max_abs_err=errs["strided"], tol=tol,
                   plan=list(ra.plan(P, H, D, esize)), ms=inplace_ms,
                   tiles_ms=ms, host_ms=host_ms, kernel_ms=kernel_ms,
                   kernel_ms_sessions=kernel_sessions,
                   strided_ms=strided_ms, plain_ms=plain_ms,
                   library_ms=None,
                   library_none="no single PyTorch call computes the "
                   "flash-state page update (scaled_dot_product_attention "
                   "returns the normalized output, not m and l)",
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   kernel_share_of_bound=bound_ms / kernel_ms,
                   kernel_gbps=nbytes / kernel_ms / 1e6)
        _emit(card, phase="kernel", name="ragged_attn_page", **rec)
        recs.append(rec)
        del qs, pages, accs, q3, page, acc, want
        torch.cuda.empty_cache()
    return recs


def _backlog(seed: int, n: int = 32, max_new: int = 64):
    """The serving backlog: n streams of ToyLM, prompts of 64-512 tokens
    drawn from the seed, two tenants; stream 1 forks stream 0's prompt.
    Returns (model, [(prompt, tenant, fork_of, eos)])."""
    import numpy as np

    from parsec_tpu_torch.llm import ToyLM
    model = ToyLM()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i == 1:
            prompt, fork_of = list(out[0][0]), 0
        else:
            length = int(rng.integers(64, 513))
            prompt = [int(t) for t in rng.integers(0, model.vocab, length)]
            fork_of = None
        out.append((prompt, f"tenant{i % 2}", fork_of, None))
    # stream 2 stops at an EOS: the token its free run samples a third
    # of the way in
    free = model.reference_generate(out[2][0], max_new)
    out[2] = (out[2][0], out[2][1], None, free[(max_new - 1) // 3])
    return model, out


def _wide_backlog(seed: int, n: int = 16):
    """The llm_wide backlog: n streams of ToyLM at a Llama-2-7B attention
    width (32 heads of 128; fp32 pages of 16 tokens, (3, 16, 32, 128),
    768 KiB each), prompts of 64-512 tokens drawn from the seed, two
    tenants, no fork and no EOS."""
    import numpy as np

    from parsec_tpu_torch.llm import ToyLM
    model = ToyLM(num_heads=32, head_dim=128)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(64, 513))
        prompt = [int(t) for t in rng.integers(0, model.vocab, length)]
        out.append((prompt, f"tenant{i % 2}", None, None))
    return model, out


def phase_llm(card: str, torch, seed: int = 7, max_new: int = 64,
              label: str = "llm", wide: bool = False) -> dict:
    """LLM decode serving through the entry points, on the card.  With
    ``wide``, the llm_wide backlog through a ``ContinuousBatcher`` of its
    own on the server (the model is not the server's default)."""
    import statistics

    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.llm import ContinuousBatcher
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve import RuntimeServer

    model, backlog = (_wide_backlog(seed) if wide
                      else _backlog(seed, max_new=max_new))
    want, margins = [], []
    for prompt, _, _, eos in backlog:
        m: list[float] = []
        want.append(model.reference_generate(prompt, max_new, eos=eos,
                                             margins=m))
        margins.append(m)
    cuda_devs = registry.by_type("cuda")
    before = {d.name: d.stats() for d in cuda_devs}
    cpu = registry.by_type("cpu")[0]
    cpu_before = cpu.executed_tasks
    ra.attn_page_update.launches = 0     # counts from here are the path's
    t0 = time.perf_counter()
    with RuntimeServer(nb_cores=2) as server:
        batcher = ContinuousBatcher(server, model=model) if wide else None
        submit = batcher.submit_stream if wide else server.submit_stream
        tickets = []
        for prompt, tenant, fork_of, eos in backlog:
            tickets.append(submit(
                prompt, max_new_tokens=max_new, tenant=tenant, eos=eos,
                fork_from=None if fork_of is None else tickets[fork_of]))
        results = [tk.result(timeout=600) for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if wide:
            llm = batcher.stats()
            batcher.stop()
        else:
            llm = server.stats()["llm"]
    launches = ra.attn_page_update.launches
    devs = registry.by_type("cuda")
    _check(len(devs) == 1 and devs[0].is_cuda,
           f"the serving path ran on {[d.name for d in devs]}, not a card")
    dev = devs[0]
    s = dev.stats()
    b = before.get(dev.name, {})

    def delta(key):
        return s[key] - b.get(key, 0)

    def delta_cls(key):
        old = b.get(key, {})
        return {c: n - old.get(c, 0) for c, n in s[key].items()
                if n - old.get(c, 0)}

    for i, (r, w) in enumerate(zip(results, want)):
        got = r["tokens"]
        if got != w:
            step = next((j for j, (a, c) in enumerate(zip(got, w))
                         if a != c), min(len(got), len(w)))
            gap = margins[i][step] if step < len(margins[i]) else None
            raise RuntimeError(
                f"chip_smoke: stream {i} differs from the oracle at step "
                f"{step} (oracle top-2 logit margin there: {gap}): got "
                f"{got[max(0, step - 2):step + 3]}, want "
                f"{w[max(0, step - 2):step + 3]}")
    tasks = delta_cls("tasks_by_class")
    dispatches = delta_cls("dispatches_by_class")
    steps = sum(8 * -(-len(w) // 8) for w in want)
    pf = sum(-(-(len(p) - 1) // 16) for i, (p, _, f, _) in enumerate(backlog)
             if f is None)
    if not wide:
        _check(backlog[2][3] is not None and len(want[2]) < max_new,
               "the EOS stream did not stop early")
    forks = sum(f is not None for _, _, f, _ in backlog)
    _check(llm["forked_streams"] == forks,
           f"forked {llm['forked_streams']}, expected {forks}")
    _check(set(tasks) == {"ATTN", "OUT", "SAMPLE", "PF"},
           f"task classes on the card: {sorted(tasks)}")
    _check(tasks["SAMPLE"] == tasks["OUT"] == steps,
           f"SAMPLE {tasks['SAMPLE']} OUT {tasks['OUT']} steps {steps}")
    _check(tasks["PF"] == pf, f"PF {tasks['PF']}, prompt pages {pf}")
    _check(sum(tasks.values()) == delta("executed_tasks"),
           "task counts by class do not add up")
    _check(cpu.executed_tasks == cpu_before, "a task ran on the CPU")
    _check(launches > 0, "the path launched no ragged_attn_page kernel")
    _check(delta("batched_dispatches") > 0, "no batched dispatch")
    def p99(xs):
        return xs[int(0.99 * (len(xs) - 1))]

    # per-token latency as a client sees it: the gaps between token
    # arrivals, stamped at delivery; a superpool's tokens arrive in one
    # burst, so most gaps are 0 and the rest are whole iterations
    itl = sorted(b - a for tk in tickets
                 for a, b in zip(tk.token_at, tk.token_at[1:]))
    _check(len(itl) == sum(len(r["tokens"]) - 1 for r in results),
           "a token without its arrival stamp")
    share = sorted(x for r in results for x in r["per_token_s"])
    ttft = sorted(tk.first_token_at - tk.submitted_at for tk in tickets)
    ntok = sum(len(r["tokens"]) for r in results)
    rec = dict(streams=len(backlog), heads=model.num_heads,
               head_dim=model.head_dim, tokens=ntok, wall_s=wall,
               tokens_per_s=ntok / wall,
               itl_ms_p50=1e3 * statistics.median(itl),
               itl_ms_p99=1e3 * p99(itl), itl_ms_max=1e3 * itl[-1],
               iter_wall_over_k_ms_p50=1e3 * statistics.median(share),
               iter_wall_over_k_ms_p99=1e3 * p99(share),
               ttft_ms_p50=1e3 * statistics.median(ttft),
               prompt_tokens=sum(len(p) for p, *_ in backlog),
               ragged_attn_page_launches=launches,
               tasks_by_class=tasks, dispatches_by_class=dispatches,
               mean_batch=delta("executed_tasks")
               / max(1, delta("kernel_launches")),
               batched_dispatches=delta("batched_dispatches"),
               decode_submits=llm["decode_submits"],
               prefill_submits=llm["prefill_submits"],
               forked_streams=llm["forked_streams"],
               stage_in_s=delta("t_stage_in"), dispatch_s=delta("t_dispatch"),
               complete_s=delta("t_complete"), manager_s=delta("t_manager"),
               h2d_mb=delta("bytes_in") / 1e6,
               min_oracle_margin=min(min(m) for m in margins))
    _emit(card, phase="path", name=label, **rec)
    return rec


def _device_busy(prof) -> tuple[float, int, list, dict]:
    """A profile's device busy seconds (the union of its kernel and copy
    intervals), its device event count, the five names that took the most
    device time, and the device nanoseconds of every name."""
    from collections import Counter

    from torch.autograd import DeviceType

    spans, count, dev_ns = [], Counter(), Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        count[e.name()] += 1
        dev_ns[e.name()] += dur
    _check(bool(spans), "the profiler recorded no device activity")
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = [{"name": n[:60], "count": count[n], "ms": dev_ns[n] / 1e6}
           for n, _ in dev_ns.most_common(5)]
    return busy / 1e9, len(spans), top, dev_ns


def phase_llm_trace(card: str, torch, max_new: int = 16,
                    wide: bool = False) -> dict:
    """An LLM path again, shorter, under ``torch.profiler`` recording
    device activity only: the card's busy time is the union of its kernel
    and copy intervals, its idle share the rest of the serving wall, and
    K2's share the part of the busy time its launches took."""
    from torch.profiler import ProfilerActivity, profile

    name = "llm_wide" if wide else "llm"
    kw = dict(seed=11, wide=True) if wide else {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec = phase_llm(card, torch, max_new=max_new,
                        label=f"{name} traced", **kw)
    busy, events, top, dev_ns = _device_busy(prof)
    k2_s = sum(ns for n, ns in dev_ns.items()
               if "ragged_attn_page_kernel" in n) / 1e9
    out = dict(wall_s=rec["wall_s"], device_busy_s=busy,
               idle_share=1.0 - busy / rec["wall_s"],
               k2_device_s=k2_s, k2_share_of_busy=k2_s / busy,
               k2_launches=rec["ragged_attn_page_launches"],
               device_events=events, top_device_time=top)
    _emit(card, phase="trace", name=name, **out)
    return out


def phase_stencil_kernel(card: str, torch) -> dict:
    """K3 (``stencil1d``) against its plain version at the lowered
    stencil's interior group and at shapes the TPU kernel could not take;
    returns the interior group's record for the kernels line."""
    import torch.nn.functional as F

    from parsec_tpu_torch.ops import stencil as ks
    taps = 9
    w = [1.0 / taps] * taps
    # fp32: the kernel fuses each tap's multiply-add, the plain version
    # rounds the product first: a few ulp of |out| <= ~5, a wrong element
    # is O(0.1).  bf16 output: one bf16 ulp (2^-7 relative) where the two
    # fp32 sums round to neighbouring bf16 values
    cases = [("interior group [62, 262152] fp32", (62, 262152),
              torch.float32, 1e-5, 50),
             ("interior group [62, 262152] bf16", (62, 262152),
              torch.bfloat16, 4e-2, 50),
             ("one row of 2^20+8 fp32", (1, (1 << 20) + 8), torch.float32,
              1e-5, 50),
             ("3-D batch [4, 8, 4104] fp32", (4, 8, 4104), torch.float32,
              1e-5, 200)]
    main = None
    for i, (label, shape, dtype, tol, iters) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        p = torch.randn(*shape, device="cuda", generator=g).to(dtype)
        got = ks.stencil1d(p, w)
        want = ks.stencil1d_plain(p, w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        _check(got.shape == want.shape and got.dtype == dtype,
               f"stencil1d {label}: {tuple(got.shape)} {got.dtype}")
        _check(err <= tol, f"stencil1d {label}: max abs err {err} above "
               f"{tol}")
        ms = _time_ms(torch, lambda: ks.stencil1d(p, w), iters)
        plain_ms = _time_ms(torch, lambda: ks.stencil1d_plain(p, w), iters)
        # the same cross-correlation as one library call on (rows, 1, L)
        rows2 = p.reshape(-1, 1, shape[-1])
        wt = torch.tensor(w, device="cuda", dtype=dtype).reshape(1, 1, taps)
        lib = lambda: F.conv1d(rows2, wt)  # noqa: E731
        lib_out = lib().reshape(got.shape)
        torch.cuda.synchronize()
        lib_err = (lib_out.float() - want.float()).abs().max().item()
        lib_ms = _time_ms(torch, lib, iters)
        nbytes = (p.numel() + got.numel()) * p.element_size()
        bound_ms, bound_by = _bound(2.0 * taps * got.numel(), nbytes,
                                    "float32")
        rec = dict(shape=label, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library_max_abs_err=lib_err, bound_ms=bound_ms,
                   bound_by=bound_by, gbps=nbytes / ms / 1e6)
        _emit(card, phase="kernel", name="stencil1d", **rec)
        if main is None:
            main = rec
        del p, got, want, lib_out, rows2
    torch.cuda.empty_cache()
    return main


def _step_wall(torch, step, stores, reps: int) -> float:
    """Mean host wall of ``reps`` steps on resident stores, each ended by
    a synchronize, after one warm-up step."""
    step(stores)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(stores)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def phase_lowered_stencil(card: str, torch, n: int = 1 << 24,
                          mb: int = 1 << 18, radius: int = 4,
                          iterations: int = 64) -> dict:
    """The compiled 1-D stencil at the JAX bench's configuration
    (``bench.py:676-704``), through ``lower_taskpool`` on the card."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from parsec_tpu_torch.data_dist.matrix import VectorTwoDimCyclic
    from parsec_tpu_torch.models.stencil import (stencil_1d_ptg,
                                                 stencil_flops,
                                                 stencil_reference)
    from parsec_tpu_torch.ops import stencil as ks
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    base = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    V = VectorTwoDimCyclic("V", lm=n, mb=mb, P=1,
                           init_fn=lambda m, size:
                           base[m * mb:m * mb + size])
    weights = np.full(2 * radius + 1, 1.0 / (2 * radius + 1))
    t0 = time.perf_counter()
    low = lower_taskpool(stencil_1d_ptg(V, weights, iterations))
    lower_s = time.perf_counter() - t0
    _check(low.mode == "wavefront", f"lowered stencil mode {low.mode}")
    ks.stencil1d.launches = 0            # counts from here are the path's
    t0 = time.perf_counter()
    low.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ks.stencil1d.launches
    # one interior group and two one-row boundary groups a level
    _check(launches == 3 * iterations,
           f"K3 launched {launches} times, expected {3 * iterations}")

    # all of V against the float64 tap loop on the card: fp32 stores
    # round every level (2^-24 of |x| <= ~5), 64 levels stay far under
    # 1e-4; a wrong ghost or group is O(0.1)
    got = torch.cat([V.data_of(i).newest_copy().value
                     for i in range(V.mt)]).cuda()
    _check(got.shape == (n,) and got.dtype == torch.float32,
           f"V is {tuple(got.shape)} {got.dtype}")
    _check(bool(torch.isfinite(got).all()), "V is not finite")
    ref = stencil_reference(torch.from_numpy(base).cuda(), weights,
                            iterations)
    err = (got.double() - ref).abs().max().item()
    _check(err <= 1e-4, f"lowered stencil: max abs err {err} above 1e-4")
    del got, ref

    t0 = time.perf_counter()
    stores = low.initial_stores()
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    step_s = _step_wall(torch, low.step_fn, stores, reps=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        low.step_fn(stores)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy, events, top, _ = _device_busy(prof)
    # the ideal step reads and writes the vector once a level
    nbytes = 2.0 * 4 * n * iterations
    rec = dict(n=n, mb=mb, radius=radius, iterations=iterations,
               mode=low.mode, levels=iterations, lower_s=lower_s,
               execute_wall_s=wall, materialize_s=materialize_s,
               step_s=step_s,
               gflops=stencil_flops(n, radius, iterations) / step_s / 1e9,
               gbps=nbytes / step_s / 1e9, stencil1d_launches=launches,
               traced_step_s=traced_s, device_busy_s=busy,
               idle_share=1.0 - busy / traced_s, device_events=events,
               top_device_time=top, max_abs_err=err)
    _emit(card, phase="path", name="lowered_stencil", **rec)
    del stores
    torch.cuda.empty_cache()
    return rec


def phase_lowered_stencil2d(card: str, torch, size: int = 8192,
                            tile: int = 1024, iterations: int = 16) -> dict:
    """``stencil_2d_ptg`` through the wavefront lowering on the card."""
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.stencil2d import (stencil2d_flops,
                                                   stencil2d_reference,
                                                   stencil_2d_ptg)
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    w = (0.5, 0.15, 0.15, 0.1, 0.1)
    dense = np.random.default_rng(1).standard_normal((size, size),
                                                     dtype=np.float32)
    M = TiledMatrix.from_dense("M", dense, tile, tile)
    t0 = time.perf_counter()
    low = lower_taskpool(stencil_2d_ptg(M, w, iterations))
    lower_s = time.perf_counter() - t0
    _check(low.mode == "wavefront", f"lowered stencil2d mode {low.mode}")
    t0 = time.perf_counter()
    low.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # fp32 stores round every level; the weights sum to 1, so |x| stays
    # O(5) and 16 levels stay under 1e-5; a wrong ghost row is O(0.1)
    got = M.to_tensor().cuda()
    _check(bool(torch.isfinite(got).all()), "M is not finite")
    ref = stencil2d_reference(torch.from_numpy(dense).cuda(), w, iterations)
    err = (got.double() - ref).abs().max().item()
    _check(err <= 1e-4, f"lowered stencil2d: max abs err {err} above 1e-4")
    del got, ref
    stores = low.initial_stores()
    step_s = _step_wall(torch, low.step_fn, stores, reps=3)
    rec = dict(size=size, tile=tile, iterations=iterations, mode=low.mode,
               lower_s=lower_s, execute_wall_s=wall, step_s=step_s,
               gflops=stencil2d_flops(size, size, iterations) / step_s / 1e9,
               max_abs_err=err)
    _emit(card, phase="path", name="lowered_stencil2d", **rec)
    del stores
    torch.cuda.empty_cache()
    return rec


def phase_lowered_gemm(card: str, torch, n: int = 16384,
                       nb: int = 512) -> dict:
    """The headline: ``lower_taskpool(tiled_gemm_ptg(A, B, C))`` at the
    JAX bench's configuration (``bench.py:24-102``), bf16 A/B, fp32 C of
    zeros, on the card; K1 and ``torch.baddbmm`` at that shape."""
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    # the operands are made on the card from a seed, in bulk, and the
    # host tiles cut from them (set-up, before any clock)
    g = torch.Generator(device="cuda").manual_seed(600)
    a_dev = torch.randn(n, n, device="cuda", generator=g).bfloat16()
    b_dev = torch.randn(n, n, device="cuda", generator=g).bfloat16()
    A = TiledMatrix.from_dense("A", a_dev.cpu(), nb, nb)
    B = TiledMatrix.from_dense("B", b_dev.cpu(), nb, nb)
    C = TiledMatrix("C", n, n, nb, nb, dtype=torch.float32)
    t0 = time.perf_counter()
    low = lower_taskpool(tiled_gemm_ptg(A, B, C))
    lower_s = time.perf_counter() - t0
    _check(low.mode == "chain-collapse", f"lowered gemm mode {low.mode}")
    _check(low.layout == {"A": "dense", "B": "dense", "C": "dense"},
           f"lowered gemm layout {low.layout}")
    _k1_reset(tg)                        # counts from here are the path's
    t0 = time.perf_counter()
    low.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tg.gemm_update.launches
    by_variant = dict(tg.gemm_update.launches_by_variant)
    _check(launches == 1 and by_variant["wgmma_bf16"] == 1,
           f"K1 launched {by_variant}, expected one wgmma_bf16")

    # all of C against a float64 product of the same bf16 inputs: the
    # products are exact in fp32, the 16384-term fp32 sums of |C| ~ 128
    # round to about 1e-3 (a random walk of half-ulp steps); a wrong tile
    # is off by O(100)
    got = C.to_tensor().cuda()
    _check(got.shape == (n, n) and got.dtype == torch.float32,
           f"C is {tuple(got.shape)} {got.dtype}")
    _check(bool(torch.isfinite(got).all()), "C is not finite")
    ref = a_dev.double() @ b_dev.double()
    err = (got.double() - ref).abs().max().item()
    _check(err <= 2e-2, f"lowered gemm: max abs err {err} above 2e-2")
    # the library's bf16 tensor-core product against the same reference
    lib_out = torch.baddbmm(torch.zeros_like(got)[None], a_dev[None],
                            b_dev[None], torch.float32)[0]
    lib_err = (lib_out.double() - ref).abs().max().item()
    del got, ref, lib_out

    t0 = time.perf_counter()
    stores = low.initial_stores()        # one host stack + H2D a store
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    low.step_fn(stores)
    reps = 3
    start.record()
    for _ in range(reps):
        low.step_fn(stores)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / reps
    del stores
    torch.cuda.empty_cache()

    # K1 alone at the step's shape, its plain version and the library's
    # bf16 -> fp32 product (a yardstick the port never calls)
    c0 = torch.zeros(n, n, device="cuda")
    ms = _time_ms(torch, lambda: tg.gemm_update(a_dev, b_dev, c0), 3, 1)
    plain_ms = _time_ms(torch, lambda: tg.gemm_update_plain(a_dev, b_dev,
                                                            c0), 3, 1)
    lib_ms = _time_ms(torch, lambda: torch.baddbmm(
        c0[None], a_dev[None], b_dev[None], torch.float32), 3, 1)
    flops = gemm_flops(n, n, n)
    nbytes = 2 * n * n * 2 + 2 * n * n * 4
    bound_ms, bound_by = _bound(flops, nbytes, "bfloat16")
    rec = dict(n=n, nb=nb, mode=low.mode, layout="dense", lower_s=lower_s,
               execute_wall_s=wall, materialize_s=materialize_s,
               step_ms=step_ms,
               gflops=flops / step_ms / 1e6,
               execute_gflops=flops / wall / 1e9, gemm_launches=launches,
               gemm_launches_by_variant=by_variant, variant="wgmma_bf16",
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
               library_max_abs_err=lib_err)
    _emit(card, phase="path", name="lowered_gemm", **rec)
    del a_dev, b_dev, c0
    torch.cuda.empty_cache()
    return rec


def phase_k1_forms(card: str, torch) -> list:
    """K1's forms for the factorizations at their paths' shapes and
    variants, each against its plain version (TF32-rounded inputs on
    ``mma_tf32``, strict on ``simt_fp32``); returns the records for the
    kernels line."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.ops import gemm as tg
    big, tile_list = (64, 1024, 1024, 1024), True
    # the multi-rank paths' batches: a rank's k-step of 16 GEMM chains,
    # and 1-4 trailing-update or TRSM tiles a launch in the factorizations
    rank16, rank4 = (16, 1024, 1024, 1024), (4, 1024, 1024, 1024)
    # (form, shape, tile list, precision, iterations)
    cases = [("nt-sub", big, tile_list, "default", 5),
             ("nt-sub", (465, 512, 512, 512), False, "default", 5),
             ("nt-noc", big, tile_list, "default", 5),
             ("nn-sub", big, tile_list, "default", 5),
             ("nn-sub", (225, 512, 512, 512), False, "default", 5),
             ("nn-noc", big, tile_list, "default", 5),
             ("nt-sub", big, tile_list, "highest", 3),
             ("nt-noc", big, tile_list, "highest", 3),
             ("nn", rank16, tile_list, "default", 5),
             ("nt-sub", rank4, tile_list, "default", 5),
             ("nt-noc", rank4, tile_list, "default", 5),
             ("nn-sub", rank4, tile_list, "default", 5),
             ("nn-noc", rank4, tile_list, "default", 5)]
    # as phase_kernel: fp32 sums in other orders, |C| ~ sqrt(k)
    tol = dict(rtol=1e-4, atol=1e-3)
    recs = []
    try:
        for i, (form, (batch, m, n, k), tiles, precision, iters) \
                in enumerate(cases):
            params.set("gemm_precision", precision)
            tf32 = precision == "default"
            variant = "mma_tf32" if tf32 else "simt_fp32"
            trans_b, with_c = form.startswith("nt"), not form.endswith("-noc")
            kw = dict(trans_b=trans_b, subtract="-sub" in form)
            label = (f"batch{batch}x{m}^3 fp32 {form} "
                     f"{'tile list' if tiles else 'strided'}")
            g = torch.Generator(device="cuda").manual_seed(700 + i)
            a = torch.randn(batch, m, k, device="cuda", generator=g)
            b = torch.randn(batch, *((n, k) if trans_b else (k, n)),
                            device="cuda", generator=g)
            c = torch.randn(batch, m, n, device="cuda", generator=g) \
                if with_c else None
            want = tg.gemm_update_plain(a, b, c, tf32=tf32, **kw)
            before = dict(tg.gemm_update.launches_by_variant)
            if tiles:
                lists = (list(a.unbind(0)), list(b.unbind(0)),
                         None if c is None else list(c.unbind(0)))
                run = lambda: tg.gemm_update_tiles(*lists, **kw)  # noqa: E731
                got = torch.stack(run())
            else:
                run = lambda: tg.gemm_update(a, b, c, **kw)  # noqa: E731
                got = run()
            strided = tg.gemm_update(a, b, c, **kw)
            bt = b.mT if trans_b else b

            def lib():
                # the library's batched call, a yardstick the port never
                # calls, at the variant's precision
                torch.backends.cuda.matmul.allow_tf32 = tf32
                try:
                    if c is None:
                        return torch.bmm(a, bt)
                    return torch.baddbmm(c, a, bt,
                                         alpha=-1 if kw["subtract"] else 1)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False

            lib_out = lib()
            torch.cuda.synchronize()
            after = dict(tg.gemm_update.launches_by_variant)
            ran = {v: after[v] - before[v] for v in after
                   if after[v] != before[v]}
            _check(ran == {variant: 2},
                   f"gemm_update {label}: ran {ran}, expected {variant}")
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, **tol)
            torch.testing.assert_close(strided, want, **tol)
            lib_err = (lib_out - want).abs().max().item()
            ms = _time_ms(torch, run, iters)
            strided_ms = _time_ms(torch, lambda: tg.gemm_update(a, b, c, **kw),
                                  iters)
            plain_ms = _time_ms(torch, lambda: tg.gemm_update_plain(
                a, b, c, tf32=tf32, **kw), iters)
            lib_ms = _time_ms(torch, lib, iters)
            host_ms = _host_ms(torch, run, iters)
            flops = 2.0 * batch * m * n * k
            nbytes = sum(t.numel() * t.element_size()
                         for t in (a, b, c, got) if t is not None)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        "tfloat32" if tf32 else "float32")
            rec = dict(shape=label, precision=precision, variant=variant,
                       form=form, max_abs_err=err, ms=ms,
                       strided_ms=strided_ms, host_ms=host_ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       library_tf32=tf32, bound_ms=bound_ms,
                       bound_by=bound_by, tflops=flops / ms / 1e9,
                       library_max_abs_err=lib_err)
            _emit(card, phase="kernel", name="gemm_update", **rec)
            recs.append(rec)
            del a, b, c, got, want, strided, lib_out
            torch.cuda.empty_cache()
    finally:
        params.set("gemm_precision", "default")
    return recs


def _factor_matrix(kind: str, a, nb: int):
    """The tiled matrix over a copy of ``a``, every stored tile made: the
    lower symmetric distribution for Cholesky, a square grid for LU."""
    from parsec_tpu_torch.data_dist.collection import enumerate_keys
    from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                                   TwoDimBlockCyclic)
    cls = SymTwoDimBlockCyclic if kind == "cholesky" else TwoDimBlockCyclic
    A = cls.from_dense("A", a.copy(), nb, nb)
    for key in enumerate_keys(A):
        A.data_of(*key)
    return A


def _factor_input(kind: str, n: int, nb: int):
    """The factorization's input on the host (set-up, before any clock):
    ``make_spd_fast(n)`` for Cholesky, ``make_dd(n, seed=1)`` for LU (the
    JAX bench's constructors), and its tiled matrix."""
    from parsec_tpu_torch.models.cholesky import make_spd_fast
    from parsec_tpu_torch.models.lu import make_dd
    a = make_spd_fast(n) if kind == "cholesky" else make_dd(n, seed=1)
    return a, _factor_matrix(kind, a, nb)


def _factor_ptg(kind: str, A):
    from parsec_tpu_torch.models.cholesky import tiled_cholesky_ptg
    from parsec_tpu_torch.models.lu import tiled_lu_ptg
    return (tiled_cholesky_ptg if kind == "cholesky" else tiled_lu_ptg)(A)


def _factor_flops(kind: str, n: int) -> float:
    from parsec_tpu_torch.models.cholesky import cholesky_flops
    from parsec_tpu_torch.models.lu import lu_flops
    return (cholesky_flops if kind == "cholesky" else lu_flops)(n)


def _factor_readings(torch, kind: str, dense, a, nb: int) -> dict:
    """The factored matrix (``dense``, on the host: one rank's
    ``to_dense``, or the sum of every rank's) in float64 on the card,
    against the float64 factor of ``a``: its tile error
    (``tile_error``), its backward error and tile (0,0)'s largest error
    relative to the tile's largest entry."""
    from parsec_tpu_torch.ops.factor import tile_error
    f = torch.from_numpy(dense).cuda().double()
    _check(bool(torch.isfinite(f).all()), f"{kind}: the factor is not finite")
    ref = torch.from_numpy(a).cuda().double()
    if kind == "cholesky":
        got = torch.tril(f)
        prod = got @ got.T
        want = torch.linalg.cholesky(ref)
    else:
        got = f
        unit = torch.tril(f, -1)
        unit.diagonal().fill_(1.0)
        prod = unit @ torch.triu(f)
        del unit
        want = torch.linalg.lu_factor_ex(ref, pivot=False)[0]
    backward = (torch.linalg.norm(ref - prod)
                / torch.linalg.norm(ref)).item()
    del prod, ref
    tile00 = ((got[:nb, :nb] - want[:nb, :nb]).abs().max()
              / want[:nb, :nb].abs().max()).item()
    err = tile_error(got, want, nb)
    del f, got, want
    torch.cuda.empty_cache()
    return dict(tile_error=err, backward_error=backward,
                tile00_rel_err=tile00)


def _factor_check(torch, kind: str, dense, a, nb: int,
                  precision: str) -> dict:
    """:func:`_factor_readings` under the gates of ``precision``."""
    r = _factor_readings(torch, kind, dense, a, nb)
    n = len(a)
    _check(r["tile_error"] <= FACTOR_TOL[precision],
           f"{kind} n={n}: tile error {r['tile_error']} above "
           f"{FACTOR_TOL[precision]} ({precision})")
    _check(r["backward_error"] <= BACKWARD_TOL[precision],
           f"{kind} n={n}: backward error {r['backward_error']} above "
           f"{BACKWARD_TOL[precision]} ({precision})")
    _check(r["tile00_rel_err"] <= TILE00_TOL,
           f"{kind} n={n}: tile (0,0) off its float64 factor by "
           f"{r['tile00_rel_err']} (relative) above {TILE00_TOL}")
    return dict(r, tile_tol=FACTOR_TOL[precision],
                backward_tol=BACKWARD_TOL[precision])


def _factor_control(card: str, torch, kind: str, a, nb: int, run,
                    label: str) -> dict:
    """The path ``run(a)`` (which returns the factor on the host) once
    more with one trailing update dropped: its tile error must exceed
    the ``default`` gate."""
    from parsec_tpu_torch.models import cholesky, lu
    from parsec_tpu_torch.ops.factor import one_update_dropped
    name, mod = ("gemm_nt", cholesky) if kind == "cholesky" \
        else ("lu_gemm", lu)
    with one_update_dropped(name, *mod._FORMS[name]) as dropped:
        dense = run(a)
    torch.cuda.synchronize()
    _check(dropped == [1], f"control {label}: no update was dropped")
    r = _factor_readings(torch, kind, dense, a, nb)
    _check(r["tile_error"] > FACTOR_TOL["default"],
           f"control {label}: one dropped update reads a tile error of "
           f"{r['tile_error']}, within the gate {FACTOR_TOL['default']}")
    rec = dict(path=label, dropped="the first C tile of the trailing "
               "update's first call", tile_tol=FACTOR_TOL["default"], **r)
    _emit(card, phase="control", name=f"{label}_one_update_dropped", **rec)
    return rec


def _expected_tasks(kind: str, nt: int) -> dict:
    tri = nt * (nt - 1) // 2
    if kind == "cholesky":
        return {"POTRF": nt, "TRSM": tri, "SYRK": tri,
                "GEMM": nt * (nt - 1) * (nt - 2) // 6}
    return {"GETRF": nt, "TRSM_L": tri, "TRSM_U": tri,
            "GEMM": sum(j * j for j in range(1, nt))}


# the K1 forms each factorization's bodies launch: TRSM with no C, the
# trailing update subtracting
K1_FORMS = {"cholesky": {"nt-noc", "nt-sub"}, "lu": {"nn-noc", "nn-sub"}}


def _run_pool(tp, timeout: float = 600) -> None:
    from parsec_tpu_torch.runtime import Context
    ctx = Context(nb_cores=0)
    try:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=timeout)
    finally:
        ctx.fini(timeout=60)


def phase_dynamic_factor(card: str, torch, kind: str, n: int = 8192,
                         nb: int = 1024, precision: str = "default") -> dict:
    """``tiled_cholesky_ptg`` or ``tiled_lu_ptg`` through ``Context`` and
    the device module on the card (the JAX bench's ``dynamic_cholesky``
    stage, ``bench.py:264-298``, and LU at the same size).  A 2x2-tile
    run of the same pool first is set-up: the library's first calls
    (cuSOLVER and cuBLAS handles, workspaces) stay off the clock."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.ops import gemm as tg

    params.set("gemm_precision", precision)
    try:
        a, A = _factor_input(kind, n, nb)
        dev = init_cuda_devices()[0]
        _run_pool(_factor_ptg(kind, _factor_input(kind, 2 * nb, nb)[1]))
        dev.sync()
        dev.flush_cache()
        tp = _factor_ptg(kind, A)
        chores = {c.device_type for tc in tp.task_classes for c in tc.chores}
        cpu = registry.get(0)
        cpu_before = cpu.executed_tasks
        before = dev.stats()
        _k1_reset(tg)                    # counts from here are the path's
        t0 = time.perf_counter()
        _run_pool(tp)
        dev.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tg.gemm_update.launches
        by_variant = dict(tg.gemm_update.launches_by_variant)
        by_form = dict(tg.gemm_update.launches_by_form)
        dev.flush_cache()
        s = dev.stats()

        def delta(key):
            return s[key] - before[key]

        tasks = {c: k - before["tasks_by_class"].get(c, 0)
                 for c, k in s["tasks_by_class"].items()
                 if k - before["tasks_by_class"].get(c, 0)}
        want = _expected_tasks(kind, A.mt)
        variant = "mma_tf32" if precision == "default" else "simt_fp32"
        _check(chores == {"cuda"}, f"{kind}: chores {chores}")
        _check(tasks == want, f"{kind}: tasks {tasks}, expected {want}")
        _check(cpu.executed_tasks == cpu_before, f"{kind}: a CPU chore ran")
        _check(launches > 0 and by_variant[variant] == launches,
               f"{kind} ({precision}): K1 ran {by_variant}, expected "
               f"{variant} only")
        _check(set(by_form) == K1_FORMS[kind],
               f"{kind}: K1 forms {by_form}, expected {K1_FORMS[kind]}")
        _check(dev.enabled, "the device was disabled")
        rec = dict(n=n, nb=nb, precision=precision, wall_s=wall,
                   gflops=_factor_flops(kind, n) / wall / 1e9,
                   tasks=sum(tasks.values()), tasks_by_class=tasks,
                   gemm_launches=launches, gemm_launches_by_variant=by_variant,
                   gemm_launches_by_form=by_form,
                   stage_in_s=delta("t_stage_in"),
                   dispatch_s=delta("t_dispatch"),
                   complete_s=delta("t_complete"),
                   manager_s=delta("t_manager"),
                   device_dispatches=delta("kernel_launches"),
                   batched_dispatches=delta("batched_dispatches"),
                   mean_batch=delta("executed_tasks")
                   / max(1, delta("kernel_launches")),
                   h2d_mb=delta("bytes_in") / 1e6,
                   **_factor_check(torch, kind, A.to_dense(), a, nb,
                                   precision))
        name = f"dynamic_{kind}" + ("" if precision == "default"
                                    else f"_{precision}")
        _emit(card, phase="path", name=name, **rec)
        if precision == "default":

            def run(a_):
                B = _factor_matrix(kind, a_, nb)
                _run_pool(_factor_ptg(kind, B))
                dev.sync()
                dev.flush_cache()
                return B.to_dense()

            rec["control"] = _factor_control(card, torch, kind, a, nb, run,
                                             name)
        return rec
    finally:
        params.set("gemm_precision", "default")


def phase_lowered_factor(card: str, torch, kind: str, n: int,
                         nb: int = 512) -> dict:
    """``lower_taskpool`` of the factorization on the card (the JAX
    bench's ``lowered_cholesky`` and ``lowered_lu`` stages,
    ``bench.py:562-583,651-675``): the wavefront pass."""
    from torch.profiler import ProfilerActivity, profile

    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool

    params.set("gemm_precision", "default")
    a, A = _factor_input(kind, n, nb)
    t0 = time.perf_counter()
    low = lower_taskpool(_factor_ptg(kind, A))
    lower_s = time.perf_counter() - t0
    _check(low.mode == "wavefront", f"lowered {kind} mode {low.mode}")
    _k1_reset(tg)                        # counts from here are the path's
    t0 = time.perf_counter()
    low.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tg.gemm_update.launches
    by_variant = dict(tg.gemm_update.launches_by_variant)
    by_form = dict(tg.gemm_update.launches_by_form)
    _check(launches > 0 and by_variant["mma_tf32"] == launches,
           f"lowered {kind}: K1 ran {by_variant}, expected mma_tf32 only")
    _check(set(by_form) == K1_FORMS[kind],
           f"lowered {kind}: K1 forms {by_form}, expected {K1_FORMS[kind]}")
    checks = _factor_check(torch, kind, A.to_dense(), a, nb, "default")

    t0 = time.perf_counter()
    stores = low.initial_stores()
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    step_s = _step_wall(torch, low.step_fn, stores, reps=3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        low.step_fn(stores)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy, events, top, dev_ns = _device_busy(prof)
    k1_s = sum(ns for nm, ns in dev_ns.items() if "gemm_update_kernel" in nm)
    flops = _factor_flops(kind, n)
    rec = dict(n=n, nb=nb, mode=low.mode, levels=low.levels,
               groups=low.groups, lower_s=lower_s, execute_wall_s=wall,
               materialize_s=materialize_s, step_s=step_s,
               gflops=flops / step_s / 1e9, execute_gflops=flops / wall / 1e9,
               gemm_launches=launches, gemm_launches_by_variant=by_variant,
               gemm_launches_by_form=by_form,
               launches_per_level=launches / low.levels,
               traced_step_s=traced_s, device_busy_s=busy,
               idle_share=1.0 - busy / traced_s, device_events=events,
               k1_device_s=k1_s / 1e9, top_device_time=top, **checks)
    _emit(card, phase="path", name=f"lowered_{kind}", **rec)
    del stores, low
    torch.cuda.empty_cache()
    def run(a_):
        B = _factor_matrix(kind, a_, nb)
        lower_taskpool(_factor_ptg(kind, B)).execute()
        return B.to_dense()

    rec["control"] = _factor_control(card, torch, kind, a, nb, run,
                                     f"lowered_{kind}")
    return rec


# the multi-rank paths: 4 ranks as threads of this process, one context
# each, on a 2 x 2 block-cyclic grid, sharing the one card through the
# device fabric (run_multirank(transport="device") with devices=[cuda:0]*4)
MR_RANKS, MR_P, MR_Q = 4, 2, 2


def _mr_grid(rank: int) -> dict:
    return dict(P=MR_P, Q=MR_Q, myrank=rank)


def _mr_gemm_mats(n: int, nb: int, seed: int):
    """Each rank's A, B and C (set-up, off the clock) with the tiles it
    reads made: C's local tiles, the A rows and B columns they take.
    The ranks share the host A and B tiles (read-only), made once from
    ``seed`` as phase ``path`` makes its own.  Returns the dense A and B
    and the per-rank triples."""
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import TwoDimBlockCyclic
    tiles: dict = {}

    def init(tag):
        def fn(m, k, shape):
            t = tiles.get((tag, m, k))
            if t is None:
                rng = np.random.default_rng((seed, tag, m, k))
                t = tiles[(tag, m, k)] = rng.standard_normal(
                    shape, dtype=np.float32)
            return t
        return fn

    nt = n // nb
    mats = []
    for r in range(MR_RANKS):
        A, B = (TwoDimBlockCyclic(x, n, n, nb, nb, init_fn=init(tag),
                                  **_mr_grid(r))
                for x, tag in (("A", 1), ("B", 2)))
        C = TwoDimBlockCyclic("C", n, n, nb, nb, **_mr_grid(r))
        for i in range(nt):
            for j in range(nt):
                if C.is_local(i, j):
                    C.data_of(i, j)
                    for k in range(nt):
                        A.data_of(i, k)
                        B.data_of(k, j)
        mats.append((A, B, C))
    dense = [np.block([[tiles[(tag, i, j)] for j in range(nt)]
                       for i in range(nt)]) for tag in (1, 2)]
    return dense, mats


def _mr_factor_mats(kind: str, a, nb: int):
    """Each rank's matrix over one copy of ``a`` (set-up, off the clock),
    its own tiles made."""
    from parsec_tpu_torch.data_dist.collection import enumerate_keys
    from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                                   TwoDimBlockCyclic)
    cls = SymTwoDimBlockCyclic if kind == "cholesky" else TwoDimBlockCyclic
    a = a.copy()
    mats = []
    for r in range(MR_RANKS):
        A = cls.from_dense("A", a, nb, nb, **_mr_grid(r))
        for key in enumerate_keys(A):
            if A.is_local(*key):
                A.data_of(*key)
        mats.append((A,))
    return mats


def _mr_run(torch, kind: str, mats: list, timeout: float = 600) -> tuple:
    """One run of ``kind``'s pool on every rank (device chores) through
    ``run_multirank``.  Returns the first rank's ``add_taskpool`` time,
    the last rank's return from ``wait`` (after the card synchronized),
    and each rank's record: its local tasks, its detector and its comm
    counters."""
    from parsec_tpu_torch.comm import run_multirank
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    t_add, t_wait = [], []

    def body(ctx, rank, nranks):
        m = mats[rank]
        tp = tiled_gemm_ptg(*m) if kind == "gemm" else _factor_ptg(kind, m[0])
        t_add.append(time.perf_counter())
        ctx.add_taskpool(tp)
        ctx.wait(timeout=timeout)
        torch.cuda.synchronize()
        t_wait.append(time.perf_counter())
        ctx.comm_barrier()
        eng = ctx.comm_engine
        return dict(tasks=tp.nb_local_tasks(), termdet=tp.tdm.name,
                    ranks_per_card=eng.ce.fabric.ranks_per_device,
                    **eng.stats())

    recs = run_multirank(MR_RANKS, body, timeout=timeout, transport="device",
                         devices=[torch.device("cuda", 0)] * MR_RANKS)
    return min(t_add), max(t_wait), recs


def _mr_dense(mats: list):
    """The whole result: the sum of every rank's own tiles."""
    return sum(m[-1].to_dense() for m in mats)


def phase_multirank(card: str, torch, kind: str, single: dict,
                    n: int = 8192, nb: int = 1024, seed: int = 0) -> dict:
    """``tiled_gemm_ptg``, ``tiled_cholesky_ptg`` or ``tiled_lu_ptg``
    across 4 ranks on the card (``run_multirank`` over the device fabric,
    ``devices=[cuda:0] * 4``, a 2 x 2 grid, ``nb_cores=0``, fp32 under
    ``gemm_precision=default``) at the single-rank phase's size, after a
    2 x 2-tile run of the same kind off the clock.  The wall runs from
    the first rank's ``add_taskpool`` to the last rank's return from
    ``wait`` (the card synchronized).  Cholesky runs under the
    four-counter detector, GEMM and LU under the local one with a comm
    barrier.  Per-rank task counts must sum to the single-rank count,
    every task run on the card, every tile product on K1 (``mma_tf32``);
    C within the TF32 bound of a float64 product, a factor under the
    gates of phase ``dynamic_*`` with its dropped-update control, and
    tiles moved between the ranks' copies on the card (``bytes_got``)."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.cholesky import make_spd_fast
    from parsec_tpu_torch.models.lu import make_dd
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops
    from parsec_tpu_torch.ops import gemm as tg

    params.set("gemm_precision", "default")
    params.set("termdet", "fourcounter" if kind == "cholesky" else "")
    try:
        dev = init_cuda_devices()[0]

        def mats_for(size, sd):
            if kind == "gemm":
                return _mr_gemm_mats(size, nb, sd)
            a = make_spd_fast(size) if kind == "cholesky" \
                else make_dd(size, seed=1)
            return (a, None), _mr_factor_mats(kind, a, nb)

        _mr_run(torch, kind, mats_for(2 * nb, seed + 1)[1])
        dev.sync()
        dev.flush_cache()
        (a, b), mats = mats_for(n, seed)
        cpu = registry.get(0)
        cpu_before = cpu.executed_tasks
        before = dev.stats()
        _k1_reset(tg)                    # counts from here are the path's
        t0, t1, recs = _mr_run(torch, kind, mats)
        wall = t1 - t0
        launches = tg.gemm_update.launches
        by_variant = dict(tg.gemm_update.launches_by_variant)
        by_form = dict(tg.gemm_update.launches_by_form)
        dev.flush_cache()
        s = dev.stats()
        tasks = {c: k - before["tasks_by_class"].get(c, 0)
                 for c, k in s["tasks_by_class"].items()
                 if k - before["tasks_by_class"].get(c, 0)}
        want = {"GEMM": (n // nb) ** 3} if kind == "gemm" \
            else _expected_tasks(kind, n // nb)
        per_rank = [r["tasks"] for r in recs]
        name = f"multirank_{kind}"
        _check(sum(per_rank) == sum(want.values()) == single["tasks"],
               f"{name}: per-rank tasks {per_rank} do not sum to the "
               f"single-rank {single['tasks']}")
        _check(tasks == want, f"{name}: tasks on the card {tasks}, "
               f"expected {want}")
        _check(cpu.executed_tasks == cpu_before, f"{name}: a CPU chore ran")
        _check(launches > 0 and by_variant["mma_tf32"] == launches,
               f"{name}: K1 ran {by_variant}, expected mma_tf32 only")
        forms = {"nn"} if kind == "gemm" else K1_FORMS[kind]
        _check(set(by_form) == forms,
               f"{name}: K1 forms {by_form}, expected {forms}")
        termdet = "fourcounter" if kind == "cholesky" else "local"
        _check({r["termdet"] for r in recs} == {termdet},
               f"{name}: detectors {[r['termdet'] for r in recs]}")
        got = sum(r["bytes_got"] for r in recs)
        if kind != "gemm":
            _check(got > 0, f"{name}: no tile moved between the ranks")
        _check(dev.enabled, "the device was disabled")
        dispatches = s["kernel_launches"] - before["kernel_launches"]
        executed = s["executed_tasks"] - before["executed_tasks"]
        flops = gemm_flops(n, n, n) if kind == "gemm" \
            else _factor_flops(kind, n)
        dense = _mr_dense(mats)
        checks = dict(max_abs_err=_check_c(torch, dense, a, b, nb, name)) \
            if kind == "gemm" else \
            _factor_check(torch, kind, dense, a, nb, "default")
        del dense
        rec = dict(n=n, nb=nb, ranks=MR_RANKS, grid=[MR_P, MR_Q],
                   ranks_per_card=recs[0]["ranks_per_card"],
                   termdet=termdet, wall_s=wall,
                   gflops=flops / wall / 1e9,
                   single_wall_s=single["wall_s"],
                   single_gflops=single["gflops"],
                   tasks=sum(per_rank), tasks_by_rank=per_rank,
                   tasks_by_class=tasks,
                   **{f"{key}_by_rank": [r[key] for r in recs] for key in (
                       "activations_sent", "activations_received", "gets",
                       "bytes_put", "bytes_got", "payload_bytes_received")},
                   gemm_launches=launches,
                   gemm_launches_by_variant=by_variant,
                   gemm_launches_by_form=by_form,
                   device_dispatches=dispatches,
                   mean_batch=executed / max(1, dispatches),
                   single_mean_batch=single["mean_batch"],
                   stage_in_s=s["t_stage_in"] - before["t_stage_in"],
                   manager_s=s["t_manager"] - before["t_manager"],
                   h2d_mb=(s["bytes_in"] - before["bytes_in"]) / 1e6,
                   **checks)
        _emit(card, phase="path", name=name, **rec)
        if kind != "gemm":

            def run(a_):
                ms = _mr_factor_mats(kind, a_, nb)
                _mr_run(torch, kind, ms)
                dev.flush_cache()
                return _mr_dense(ms)

            rec["control"] = _factor_control(card, torch, kind, a, nb, run,
                                             name)
        torch.cuda.empty_cache()
        return rec
    finally:
        params.set("termdet", "")
        params.set("gemm_precision", "default")


def _by_variant(counts: dict) -> dict:
    """K1 launch counts by variant, every variant keyed."""
    from parsec_tpu_torch.ops import gemm as tg
    out = dict.fromkeys(tg.K1_VARIANTS, 0)
    for v, k in counts.items():
        out[v] += k
    return out


def _sum_counts(dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


MP_KINDS = ("gemm", "cholesky", "lu")


def phase_multiproc(card: str, torch, multirank: dict, n: int = 8192,
                    nb: int = 1024, seed: int = 0) -> dict:
    """GEMM, Cholesky and LU across 4 rank processes on the card (see
    the module docstring, phase 16): one ``run_multiproc`` launch with
    ``distributed=True``; returns each kind's path record."""
    import numpy as np

    from parsec_tpu_torch.comm import run_multiproc
    from parsec_tpu_torch.comm.mp_bodies import factor_input, gemm_dense
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops

    dev = init_cuda_devices()[0]
    dev.flush_cache()
    torch.cuda.empty_cache()       # the ranks' contexts share the card
    env = {"PARSEC_MP_KINDS": ",".join(MP_KINDS), "PARSEC_MP_N": str(n),
           "PARSEC_MP_NB": str(nb), "PARSEC_MP_SEED": str(seed),
           "PARSEC_MP_CHORES": "cuda", "PARSEC_MP_WARMUP": "1",
           "PARSEC_MCA_gemm_precision": "default"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        res = run_multiproc(MR_RANKS,
                            "parsec_tpu_torch.comm.mp_bodies:pool_body",
                            timeout=420, transport="device",
                            distributed=True)
        launch_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _check([r["modules"] for r in res] == [[]] * MR_RANKS,
           f"multiproc: ranks hold {[r['modules'] for r in res]}")
    _check([r["world_size"] for r in res] == [MR_RANKS] * MR_RANKS,
           f"multiproc: process groups of {[r['world_size'] for r in res]}")
    out = {}
    for kind in MP_KINDS:
        name = f"multiproc_{kind}"
        inproc = multirank[f"multirank_{kind}"]
        recs = [r["kinds"][kind] for r in res]
        wall = max(r["t_wait"] for r in recs) - min(r["t_add"] for r in recs)
        per_rank = [r["tasks"] for r in recs]
        want = {"GEMM": (n // nb) ** 3} if kind == "gemm" \
            else _expected_tasks(kind, n // nb)
        tasks = _sum_counts(r["dev"]["tasks_by_class"] for r in recs)
        by_variant = _by_variant(_sum_counts(r["k1_by_variant"]
                                             for r in recs))
        by_form = _sum_counts(r["k1_by_form"] for r in recs)
        launches = sum(r["k1"] for r in recs)
        gets = [r["gets"] for r in recs]
        tiers = [r["tiers"] for r in recs]
        got = [t["payload_in"] for t in tiers]
        _check(sum(per_rank) == sum(want.values()) == inproc["tasks"],
               f"{name}: per-rank tasks {per_rank} do not sum to "
               f"{inproc['tasks']}")
        _check(tasks == want, f"{name}: tasks on the card {tasks}, "
               f"expected {want}")
        _check(all(r["cpu_tasks"] == 0 for r in recs),
               f"{name}: a host chore ran")
        _check(launches > 0 and by_variant["mma_tf32"] == launches
               and all(r["k1"] > 0 for r in recs),
               f"{name}: K1 ran {by_variant} ({[r['k1'] for r in recs]} "
               f"by rank), expected mma_tf32 in every rank")
        forms = {"nn"} if kind == "gemm" else K1_FORMS[kind]
        _check(set(by_form) == forms,
               f"{name}: K1 forms {by_form}, expected {forms}")
        _check(gets == inproc["gets_by_rank"],
               f"{name}: GETs {gets}, in process "
               f"{inproc['gets_by_rank']}")
        _check(got == inproc["bytes_got_by_rank"],
               f"{name}: payload landed {got}, in process "
               f"{inproc['bytes_got_by_rank']}")
        _check(sum(t["payload_out"] for t in tiers) == sum(got),
               f"{name}: payload served {[t['payload_out'] for t in tiers]}"
               f" != landed {got}")
        dense = np.zeros((n, n), np.float32)
        for r in recs:
            for (i, j), tile in r["tiles"].items():
                dense[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
        if kind == "gemm":
            a, b = gemm_dense(n, nb, seed)
            checks = dict(max_abs_err=_check_c(torch, dense, a, b, nb, name))
            reading = "max_abs_err"
            flops = gemm_flops(n, n, n)
        else:
            a = factor_input(kind, n)
            checks = _factor_check(torch, kind, dense, a, nb, "default")
            reading = "tile_error"
            flops = _factor_flops(kind, n)
        del dense
        rec = dict(n=n, nb=nb, ranks=MR_RANKS, grid=[MR_P, MR_Q],
                   processes=MR_RANKS, world_size=res[0]["world_size"],
                   termdet=recs[0]["termdet"], wall_s=wall,
                   gflops=flops / wall / 1e9,
                   multirank_wall_s=inproc["wall_s"],
                   single_wall_s=inproc["single_wall_s"],
                   launch_s=launch_s, tasks=sum(per_rank),
                   tasks_by_rank=per_rank, tasks_by_class=tasks,
                   manager_s_by_rank=[r["dev"]["t_manager"] for r in recs],
                   stage_in_s_by_rank=[r["dev"]["t_stage_in"]
                                       for r in recs],
                   gets_by_rank=gets, payload_in_by_rank=got,
                   payload_out_by_rank=[t["payload_out"] for t in tiers],
                   wire_sent_by_rank=[t["wire_total_sent"] for t in tiers],
                   control_sent_by_rank=[t["control_sent"] for t in tiers],
                   **{f"{hop}_by_rank": [r["tier_s"][hop] for r in recs]
                      for hop in ("d2h_s", "send_s", "recv_s", "h2d_s",
                                  "get_s")},
                   get_ms_mean=(sum(r["tier_s"]["get_s"] for r in recs)
                                / max(1, sum(gets)) * 1e3),
                   gemm_launches=launches,
                   gemm_launches_by_rank=[r["k1"] for r in recs],
                   gemm_launches_by_variant=by_variant,
                   gemm_launches_by_form=by_form,
                   mean_batch=sum(per_rank) / max(1, launches),
                   **checks, **{f"{reading}_equals_multirank":
                                checks[reading] == inproc[reading],
                                f"multirank_{reading}": inproc[reading]})
        _emit(card, phase="path", name=name, **rec)
        out[name] = rec
    return out


def _dtd_rehearsal(nranks: int, nt: int) -> list:
    """The DTD GEMM's insertion program on host chores at ``nt`` x ``nt``
    tiles of 8 (ranks as threads): each rank's tasks and pushes."""
    import numpy as np

    from parsec_tpu_torch.comm import run_multirank
    from parsec_tpu_torch.dtd.multirank_check import dtd_gemm_rank_body
    a = np.ones((8 * nt, 8 * nt), np.float32)
    return run_multirank(nranks, dtd_gemm_rank_body(a, a, 8, MR_P, MR_Q))


def phase_multirank_dtd(card: str, torch, n: int = 8192, nb: int = 1024,
                        seed: int = 5) -> dict:
    """The distributed DTD GEMM on the card (phase 17 of the module
    docstring)."""
    from parsec_tpu_torch.comm import run_multirank
    from parsec_tpu_torch.comm.mp_bodies import gemm_dense
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.dtd.multirank_check import dtd_gemm_rank_body
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops
    from parsec_tpu_torch.ops import gemm as tg

    params.set("gemm_precision", "default")
    dev = init_cuda_devices()[0]
    cuda0 = [torch.device("cuda", 0)] * MR_RANKS

    def run(a, b):
        return run_multirank(
            MR_RANKS, dtd_gemm_rank_body(a, b, nb, MR_P, MR_Q,
                                         cuda_kernel="gemm", timeout=600),
            timeout=600, transport="device", devices=cuda0)

    run(*gemm_dense(2 * nb, nb, seed + 1))
    dev.flush_cache()
    a, b = gemm_dense(n, nb, seed)
    before = dev.stats()
    _k1_reset(tg)                       # counts from here are the path's
    recs = run(a, b)
    launches = tg.gemm_update.launches
    by_variant = dict(tg.gemm_update.launches_by_variant)
    s = dev.stats()
    wall = max(r["t_wait"] for r in recs) - min(r["t_start"] for r in recs)
    tasks = {c: k - before["tasks_by_class"].get(c, 0)
             for c, k in s["tasks_by_class"].items()
             if k - before["tasks_by_class"].get(c, 0)}
    rehearsal = _dtd_rehearsal(MR_RANKS, n // nb)
    per_rank = [r["tasks"] for r in recs]
    pushes = [r["pushes"] for r in recs]
    name = "multirank_dtd_gemm"
    _check(tasks == {"gemm": (n // nb) ** 3},
           f"{name}: tasks on the card {tasks}")
    _check(per_rank == [r["tasks"] for r in rehearsal],
           f"{name}: per-rank tasks {per_rank}, rehearsal "
           f"{[r['tasks'] for r in rehearsal]}")
    _check(pushes == [r["pushes"] for r in rehearsal] and sum(pushes) > 0,
           f"{name}: pushes {pushes}, rehearsal "
           f"{[r['pushes'] for r in rehearsal]}")
    _check(launches > 0 and by_variant["mma_tf32"] == launches,
           f"{name}: K1 ran {by_variant}, expected mma_tf32 only")
    dense = sum(r["C"] for r in recs)
    err = _check_c(torch, dense, a, b, nb, name)
    del dense
    rec = dict(n=n, nb=nb, ranks=MR_RANKS, grid=[MR_P, MR_Q], wall_s=wall,
               gflops=gemm_flops(n, n, n) / wall / 1e9,
               insert_s_by_rank=[r["insert_s"] for r in recs],
               tasks_by_rank=per_rank, tasks_by_class=tasks,
               pushes_by_rank=pushes,
               push_bytes_by_rank=[r["push_bytes"] for r in recs],
               gemm_launches=launches,
               gemm_launches_by_variant=by_variant,
               mean_batch=tasks["gemm"] / max(1, launches),
               manager_s=s["t_manager"] - before["t_manager"],
               h2d_mb=(s["bytes_in"] - before["bytes_in"]) / 1e6,
               max_abs_err=err)
    _emit(card, phase="path", name=name, **rec)
    dev.flush_cache()
    torch.cuda.empty_cache()
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
    main_rec, k1_recs = phase_kernel(card, torch)
    path = phase_path(card, torch)
    dtd = phase_dtd_gemm(card, torch, path)
    phase_dispatch(card)
    attn_recs = phase_attn_kernel(card, torch)
    attn_rec = attn_recs[0]
    llm = phase_llm(card, torch)
    phase_llm_trace(card, torch)
    wide = phase_llm(card, torch, seed=11, max_new=32, label="llm_wide",
                     wide=True)
    phase_llm_trace(card, torch, max_new=8, wide=True)
    sten_rec = phase_stencil_kernel(card, torch)
    sten = phase_lowered_stencil(card, torch)
    phase_lowered_stencil2d(card, torch)
    lgemm = phase_lowered_gemm(card, torch)
    form_recs = phase_k1_forms(card, torch)
    factor_paths = {
        "dynamic_cholesky": phase_dynamic_factor(card, torch, "cholesky"),
        "dynamic_cholesky_highest": phase_dynamic_factor(
            card, torch, "cholesky", precision="highest"),
        "dynamic_lu": phase_dynamic_factor(card, torch, "lu"),
        "lowered_cholesky": phase_lowered_factor(card, torch, "cholesky",
                                                 16384),
        "lowered_lu": phase_lowered_factor(card, torch, "lu", 8192)}
    # the TF32 run is the control of the ``highest`` gates
    tf32_run = factor_paths["dynamic_cholesky"]
    for key, tol in (("tile_error", FACTOR_TOL), ("backward_error",
                                                  BACKWARD_TOL)):
        _check(tf32_run[key] > tol["highest"],
               f"control: the TF32 Cholesky's {key} {tf32_run[key]} is "
               f"within the highest gate {tol['highest']}")
    _emit(card, phase="control", name="dynamic_cholesky_tf32_vs_highest",
          tile_error=tf32_run["tile_error"],
          tile_tol=FACTOR_TOL["highest"],
          backward_error=tf32_run["backward_error"],
          backward_tol=BACKWARD_TOL["highest"])
    multirank = {
        "multirank_gemm": phase_multirank(card, torch, "gemm", path),
        "multirank_cholesky": phase_multirank(
            card, torch, "cholesky", factor_paths["dynamic_cholesky"]),
        "multirank_lu": phase_multirank(card, torch, "lu",
                                        factor_paths["dynamic_lu"])}
    multiproc = phase_multiproc(card, torch, multirank)
    mr_dtd = phase_multirank_dtd(card, torch)
    k1_paths = {"gemm": path, "dtd_gemm": dtd, "lowered_gemm": lgemm,
                **factor_paths, **multirank, **multiproc,
                "multirank_dtd_gemm": mr_dtd}
    row_keys = ("variant", "shape", "precision", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": "gemm_update", "route": "cuda",
                "source": "parsec_tpu_torch/csrc/gemm.cu",
                "replaces": "parsec_tpu/ops/gemm.py:66",
                "launches": sum(p["gemm_launches"]
                                for p in k1_paths.values()),
                "launches_by_path": {name: p["gemm_launches"]
                                     for name, p in k1_paths.items()},
                "launches_by_variant": {
                    v: sum(p["gemm_launches_by_variant"][v]
                           for p in k1_paths.values())
                    for v in path["gemm_launches_by_variant"]},
                "variant": main_rec["variant"],
                "variants": [
                    {"form": "nn", **{key: r[key] for key in row_keys}}
                    for r in k1_recs]
                + [{"form": "nn", "variant": "wgmma_bf16",
                    "shape": f"{lgemm['n']}^3 bf16->fp32",
                    "precision": "default",
                    "max_abs_err": lgemm["max_abs_err"],
                    "ms": lgemm["kernel_ms"], "plain_ms": lgemm["plain_ms"],
                    "bound_ms": lgemm["bound_ms"],
                    "bound_by": lgemm["bound_by"],
                    "library_ms": lgemm["library_ms"]}]
                + [{"form": r["form"], **{key: r[key] for key in row_keys}}
                   for r in form_recs],
                "max_abs_err": main_rec["max_abs_err"],
                "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
                "bound_ms": main_rec["bound_ms"],
                "bound_by": main_rec["bound_by"],
                "library_ms": main_rec["library_ms"]},
               {"name": "ragged_attn_page", "route": "cuda",
                "source": "parsec_tpu_torch/csrc/ragged_attn.cu",
                "replaces": "parsec_tpu/ops/ragged_attention.py:448",
                "launches": llm["ragged_attn_page_launches"]
                + wide["ragged_attn_page_launches"],
                "launches_by_path": {
                    "llm": llm["ragged_attn_page_launches"],
                    "llm_wide": wide["ragged_attn_page_launches"]},
                "shapes": [
                    {key: r[key] for key in (
                        "shape", "max_abs_err", "ms", "tiles_ms", "host_ms",
                        "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")} for r in attn_recs],
                "max_abs_err": attn_rec["max_abs_err"],
                "ms": attn_rec["ms"], "plain_ms": attn_rec["plain_ms"],
                "bound_ms": attn_rec["bound_ms"],
                "bound_by": attn_rec["bound_by"],
                "library_ms": attn_rec["library_ms"]},
               {"name": "stencil1d", "route": "cuda",
                "source": "parsec_tpu_torch/csrc/stencil.cu",
                "replaces": "parsec_tpu/ops/stencil.py:54",
                "launches": sten["stencil1d_launches"],
                "max_abs_err": sten_rec["max_abs_err"],
                "ms": sten_rec["ms"], "plain_ms": sten_rec["plain_ms"],
                "bound_ms": sten_rec["bound_ms"],
                "bound_by": sten_rec["bound_by"],
                "library_ms": sten_rec["library_ms"]}]
    _check(all(math.isfinite(k["ms"]) for k in kernels), "a time is not finite")
    _emit(card, phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
