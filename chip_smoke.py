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
   of 465 and ``nn-sub`` of 225 512^3 tiles (the lowered groups' shapes);
   ``nt-sub`` and ``nt-noc`` as tile lists of 3 2048^3 tiles (the tile
   size **tuned_cholesky** chose, a panel's TRSMs and SYRK/GEMMs).
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
   beside the host CPU, with the always-on flight recorder at its
   default ring of 256 events a thread, and again with it off
   (``prof_flightrec_size`` 0, ``recorder_off``).
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

18. **path llm_prefix, llm_spec, llm_tiers** (after **trace llm_wide**) —
   the rest of the serving layer at the ``llm_wide`` width (ToyLM with 32
   heads of 128, fp32 pages (3,16,32,128) of 768 KiB), each through a
   ``ContinuousBatcher`` on a ``RuntimeServer(nb_cores=2)``, every
   stream's tokens equal to the oracle's.  ``llm_prefix``
   (``llm_prefix_cache=1``): 16 streams share a 1024-token system prompt
   (64 pages, 48 MiB, inside the 64 MiB default budget), each with a
   seeded 16-64-token suffix, 16 new tokens; a first wave of 2 retires
   and donates, then the other 14 must make 14 prefix hits, skip 14 x
   1024 prefill tokens and run PF on their tail pages only; the same 14
   again with the cache off (``llm_prefix_control``) run PF on every
   prompt page; TTFT p50/p99 and PF tasks of both.  ``llm_spec``
   (``llm_spec_k=6``): 8 streams of 64 new tokens, four repeating a short
   cycle (the n-gram drafter proposes), four random; spec submits and
   accepted drafts must be counted, SATTN and SVERIFY must run on the
   card and no task on the CPU; the same backlog with it off
   (``llm_spec_control``), the two in turns (spec, control, control,
   spec); tokens/s of every run, the acceptance rate, tokens
   per spec submit and rollbacks; then one ``spec_superpool_ptg`` pool
   seeded directly with oracle drafts on a KV cache of its own
   (``llm_spec_superpool``: ATTN on K2, every position accepted), and
   SATTN's batched body (PyTorch ops, not a kernel) timed against the
   bytes it must move (``body llm_spec_attn``).  ``llm_tiers``: 6 streams
   of 256-512-token prompts, 24 new tokens, the card's tile budget set to
   24 pages, below the live KV, and a host tier of 8 pages past which
   cold pages spill to a ``PeerKVStore`` on the second rank of an
   in-process ``DeviceFabric`` (two ranks, one card): spills, prefetched
   pages and a peer round trip through ``prefetch_get`` must be counted.
   No spill subscriber may raise (``spill_hook_failures`` stays 0).

19. **path path_checked** (after **path dtd_gemm**) — phase **path**'s
   dynamic GEMM again (n=8192, nb=1024, fp32, K1 ``mma_tf32``) under the
   ``analysis_check`` enqueue gate with the task profiler and the SDE
   module on (``pins=task_profiler,sde``): C under the same bound, K1's
   launches equal to **path**'s, 512 ``task_exec`` spans in the trace
   file (dumped and read back), 512 retired tasks in the SDE counters,
   and the DEVICE_STAGE_IN payloads summing to the device module's
   ``bytes_in`` for the run; the line carries the gate's seconds (from
   ``add_taskpool`` to the TASKPOOL_INIT fire) and the wall beside
   **path**'s.
20. **analysis** — graphcheck over every pool the script runs, at the size
   it runs: the dynamic, DTD (after its run) and lowered GEMMs, both
   lowered stencils, the dynamic and lowered Cholesky and LU, the
   speculative pools at the ``llm_spec`` shapes (built and seeded, not
   run), and the GEMM, Cholesky and LU of the 2 x 2 grid checked for 4
   ranks; one line a pool with its nodes, edges, findings (no error) and
   ``check_s``.  The prefill and decode pools of ``llm_wide`` are checked
   in phase 21, as they are enqueued.  **control analysis_gate**: the
   dynamic GEMM with its chain input dropped, enqueued under
   ``analysis_check``, must raise ``GraphCheckError`` naming
   ``missing-input-edge`` (GEMM.C, with its instance) before any K1
   launch, and leave the context without a pool.
   **dispatch** (phase 14) also carries ``pins_disabled_ns``: one disabled
   PINS site (index load and falsy branch), the cost every fire site adds
   with PINS off.
21. **path llm_wide_pins** (after **trace llm_wide**) — the traced
   ``llm_wide`` run's backlog (seed 11, 8 new tokens, 32 heads of 128,
   K2) with the task profiler on and every prefill and decode pool
   checked as it is enqueued: every stream equal to the oracle, one EXEC
   span a task run, no pool with an error; K2's launches on the line.
22. **path multiproc_comm_thread** (after **multiproc_***) — the
   four-process Cholesky of **multiproc_cholesky** (n=8192, nb=1024, K1)
   with ``comm_thread`` off, on, on, off, one launch each: every factor
   under the gates, every run's GETs and payload bytes by tier equal to
   the first run's (and its GETs to **multiproc_cholesky**'s); each line
   carries the wall, ``get_ms_mean`` and the hops' host seconds
   (``tier_seconds``).
23. **slo llm_wide_slo** (after **path llm_wide_pins**) — the ``llm_wide``
   backlog (seed 11, 16 streams, 32 new tokens, 32 heads of 128, K2)
   through a ``RuntimeServer`` with the span recorder on
   (``prof_spans``): every stream equal to the oracle; per tenant,
   ``metrics()``'s TTFT and token-latency p50/p99 held against the exact
   quantiles (the histogram's rank rule, ``ceil(q * n)``) of the tickets'
   own stamps of the same run (``first_token_at - submitted_at``,
   ``per_token_s``), within the histogram's bucket error (a factor
   ``sqrt(2**0.25)``, 9.05%) plus 0.0005 ms (the summary's rounding);
   one EXEC span a task run; critpath's buckets over the run's spans,
   with ``sum(buckets) + idle == window`` held for every request, beside
   the card's busy share from **trace llm_wide** (the exec bucket is the
   host's hand-off, not the card); ``runtime_report()``'s JSON bytes.
24. **control stall** — a server tenant whose pool cannot finish (a host
   body waits on an event): ``context.wait(timeout=1)`` must raise
   ``ContextWaitTimeout`` within 10 s, after one stall dump written to a
   temporary directory whose report names the tenant and its oldest
   trace, the card's ``debug_state`` and the queue depths; then the event
   is set, the server torn down abort-style, every worker joined.
25. **path multiproc_traced** (after **multiproc_comm_thread**) — the
   four-process Cholesky (n=8192, nb=1024, K1, ``comm_thread`` on) with
   the span recorder on in every rank: the GETs [6, 18, 22, 10] and the
   payload bytes by tier of **multiproc_cholesky**, the factor gates;
   each rank writes its spans, ``prof/tracemerge.py`` stitches them,
   every GET and activation flow matched across ranks, none left alone;
   critpath over the merged trace (the identity held) with its
   ``comm.get`` and ``comm.activate`` shares, and the wall beside
   **multiproc_comm_thread**'s runs with the thread on.
26. **path tuned_cholesky** (after the factorizations) — the closed-loop
   tuner on **dynamic_cholesky** (n=8192, fp32, ``default``, K1's
   ``mma_tf32`` NT and NT-subtract forms): the tile size seeded bad
   (nb=128, 64 x 64 tiles, 45,760 tasks) and moved by ``tune.search``
   over a log2 ``KnobSpec`` from 128 to 4096 (budget 8, one restart,
   seed 0, objective ``wall_s``), a size's first visit off the clock.
   ``tune_speedup`` (the seeded trial's wall over the winner's) must
   reach 1.2, the winner's nb 512, its factor the TF32 gates; the winner
   must be in the tuning DB under the pool's ``workload_signature``, and
   every trial in the perf ledger.  Both files live in a temporary
   directory for the whole script (``tune_db_path``, ``perfdb_path``,
   exported to every rank process), so no file left on the machine steers
   a ``Context`` the script starts.
27. **path lowered_cache** (after **lowered_gemm**) — the headline GEMM
   (N=16384, nb=512, bf16 A/B, fp32 C) lowered from two freshly built
   pools: the first a miss, the second a hit returning the same step;
   ``warm()`` launches nothing; the same pool submitted twice through
   ``RuntimeServer.submit_lowered``, each result's C (host tensors)
   within 2e-2 of a float64 product, one ``wgmma_bf16`` launch each;
   ``lower_s`` of the miss and the hit, ``warm()``'s seconds and each
   submission's wall.
28. **path llm_wide_adaptive** (after **slo llm_wide_slo**) — the
   ``llm_wide`` backlog (seed 11, 32 new tokens) with ``tune_adaptive``
   on, through ``server.submit_stream``: tenant0's vector
   (``llm_steps_per_pool`` 1) is put in the tuning DB first, the
   server's consult seeds its controller, tenant1 starts at 8.  Every
   stream equal to the oracle, each controller starting where it
   should, every adoption written back exactly once; tokens/s, ITL
   p50/p99, each tenant's k trajectory, probes and adoptions.
29. **path llm_sharded** (after **llm_tiers**) — a
   ``ShardedRuntimeServer`` over four rank threads sharing the card
   (``run_multirank(4, nb_cores=1)``), each rank's batcher on K2 at the
   ``llm_wide`` width and pinned to its rank: 16 streams of 16 new
   tokens, 8 sharing a 1024-token system prompt (seed 29).  Every stream
   equal to the oracle; the shared-prompt streams after the first placed
   on its rank (residency); ``metrics()`` equal to the bucket-merge of
   the four planes, each count the ranks' sum.  **control
   llm_sharded_fail_rank**: the 8 own-prompt streams again with 32 new
   tokens, rank 2 killed with ``fail_rank`` once it shipped a token: its
   live streams requeue on survivors as prompt plus shipped tokens and
   finish oracle-exact, and the zombie's late deltas land nothing.
30. **path region_cholesky** (after **tuned_cholesky**) — the JAX bench's
   ``region_cholesky`` stage (``bench.py:591-650``) at its size: n=8192,
   nb=512 (816 tasks), fp32 from ``make_spd_fast``, ``lower_regions``
   at the default ``lowering_region_max_tasks`` (256): the regions
   prepared under a 90 s budget, then the region pool on a ``Context``
   timed as the bench times it (K1 ``mma_tf32`` in the SYRK, GEMM and
   TRSM groups); again on a cold cache under a budget half the first
   region's preparation, so the later regions shed to the eager path;
   and the whole-pool ``lower_taskpool`` at the same n.  The three
   factors within the TF32 tile gate of each other and of the float64
   factor; regions, prepared and shed, ``compile_s``, seconds, GFLOPS
   and K1's launches by form.
31. **path llm_wide_regions** (after **llm_sharded**) — the llm_wide
   width (ToyLM with 32 heads of 128), 8 streams of 16 new tokens from
   seed 11, with ``llm_lower_regions`` on: every decode superpool
   lowered to regions, its ATTN on K2 through the ``ragged_attn_page``
   traceable; every stream equal to the oracle, beside the same streams
   with the option off (off, on, on, off): superpools lowered and fallen
   back, regions a superpool, K2 launches and tokens/s.
32. **commcheck** (after **multiproc_traced**) — commcheck over the
   four-rank GEMM, Cholesky and LU pools of phase 16 (2 x 2 grid,
   n=8192, nb=1024): each pool's predicted cross-rank activation bytes
   held against the payload its GETs landed in phase 16 (not run again),
   within 15% (the JAX package's agreement gate); the GEMM's predicted
   collection reads of A and B are printed apart (the rank bodies build
   their inputs on every rank, so they cross no wire).  Then
   ``predict_collective_traffic(4)`` against one four-process run of
   ``comm/collectives.py:_mp_collective_body`` (a 4 MiB broadcast and a
   64-element reduction over the socket fabric): its framed bytes sent,
   under the same gate.
33. **path jdf_gemm** (after the earlier phases) — phase 3's GEMM built
   from JDF text (:data:`JDF_GEMM`, ``tests/test_jdf.py``'s GEMM with a
   ``BODY [type = cuda dyld = gemm]`` ahead of its Python body) at
   n=8192, nb=1024, fp32: all 512 tasks on the card through K1, none on
   the Python body, K1's launches by variant equal to phase 3's, C
   within phase 3's TF32 gate; the wall beside phase 3's, and the JDF's
   parse and build seconds beside the DSL builder's.
34. **path multirank_stencil_ptg, multirank_stencil_jdf** — the 1-D
   stencil on 4 rank threads (host bodies, as in the JAX package) at
   the lowered stencil's width, n=2^24, mb=2^18, R=4, 8 iterations,
   float64: through ``stencil_1d_ptg``, then through the port's
   ``examples/jdf/stencil_1D.jdf`` on 1-row tiles, whose halos to another
   rank ship the ``LR`` wire region.  Each within 1e-12 of
   ``stencil_reference``; each run's landed payload equal to commcheck's
   predicted activation bytes; every JDF halo exactly ``1 * R * 8``
   bytes.  Wall, tasks and bytes by rank.
35. **path multiproc_legacy_wire** — phase 16's four-process Cholesky
   with ``comm_wire_binary`` off (the legacy pickle framing, a GET's
   payload whole) and on, in turns (off, on, on, off): the factors equal
   to every digit, GETs and payload bytes equal to phase 16's; the
   framed bytes and the wall of each.
36. **control resume_get** — 4 rank engines sharing the card (the device
   fabric): a 4 MiB tile pulled by two children from its staging parent
   in 256 KiB fragments; the parent dies after one window, a zombie
   fragment of it lands late, and both resume from the grandparent:
   each copy equal to the root's, each offset landed once.
37. **path examples** — the port's ladder (Ex00–Ex07, Ex10–Ex12), each
   ``main()`` self-checking; Ex12 serves on the card through K2.

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


def _path_mats(n: int, nb: int, seed: int) -> tuple:
    """Phase ``path``'s A, B (seeded fp32 tiles) and C (zeros), every
    host tile made before the clock; and the seconds that took."""
    import numpy as np

    from parsec_tpu_torch.data_dist.matrix import TiledMatrix

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
    return A, B, C, time.perf_counter() - t_gen


def phase_path(card: str, torch, n: int = 8192, nb: int = 1024,
               seed: int = 0, checked: dict | None = None) -> dict:
    """The dynamic-runtime tiled GEMM through the entry points.  Given
    ``checked`` (phase ``path``'s record), the same run again as
    ``path_checked``, under the enqueue gate with the task profiler and
    the SDE module on (see :func:`_observed`)."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    params.set("gemm_precision", "default")    # whatever the environment says
    A, B, C, t_gen = _path_mats(n, nb, seed)
    dev = init_cuda_devices()[0]
    tp = tiled_gemm_ptg(A, B, C)
    chores = [c.device_type for c in tp.task_classes[0].chores]
    cpu = registry.get(0)
    cpu_before = cpu.executed_tasks

    before = dict(tasks=dev.executed_tasks, bytes_in=dev.bytes_in)
    _k1_reset(tg)                        # counts from here are the path's
    with _observed(checked is not None) as obs:
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
    ran = dev.executed_tasks - before["tasks"]
    _check(ran == ntasks == 512,
           f"{ran} tasks ran on the card, expected 512")
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
    if checked is not None:
        return _path_checked(card, checked, obs, t0, wall, worst, launches,
                             by_variant, ran, dev.bytes_in - before["bytes_in"])
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
               d2h_mb=dev.bytes_out / 1e6,
               h2d_MBps=(dev.bytes_in / 1e6 / s["t_stage_in"]
                         if s["t_stage_in"] > 0 else None),
               cache_hits=dev.cache_hits, cache_misses=dev.cache_misses,
               host_tile_gen_s=t_gen, max_abs_err=worst)
    _emit(card, phase="path", **rec)
    return rec


class _observed:
    """With ``on``: the ``analysis_check`` gate, the task profiler and the
    SDE module for the contexts built inside, a fresh trace and fresh SDE
    counters, and PINS callbacks that sum the DEVICE_STAGE_IN payloads and
    stamp the TASKPOOL_INIT fire (the gate runs before it); restored at
    exit.  Off, it changes nothing."""

    def __init__(self, on: bool) -> None:
        self.on = on
        self.staged = 0
        self.t_init: list[float] = []

    def _stage(self, es, nb) -> None:
        self.staged += nb

    def _init(self, es, tp) -> None:
        self.t_init.append(time.perf_counter())

    def __enter__(self) -> "_observed":
        if not self.on:
            return self
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.prof import pins, sde, trace_state
        from parsec_tpu_torch.prof.pins import PinsEvent
        self._saved = {k: params.get(k) for k in ("analysis_check", "pins")}
        params.set("analysis_check", True)
        params.set("pins", "task_profiler,sde")
        trace_state.fini()
        sde.reset()
        self._cbs = [(PinsEvent.DEVICE_STAGE_IN, self._stage),
                     (PinsEvent.TASKPOOL_INIT, self._init)]
        for ev, cb in self._cbs:
            pins.register(ev, cb)
        return self

    def __exit__(self, *exc) -> None:
        if not self.on:
            return
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.prof import pins
        for ev, cb in self._cbs:
            pins.unregister(ev, cb)
        for k, v in self._saved.items():
            params.set(k, v)


def _trace_records() -> tuple[list, int]:
    """The trace the task profiler wrote, through its file: the rows of
    the dumped and reloaded trace and the file's bytes; the trace is
    cleared after."""
    import tempfile

    from parsec_tpu_torch.prof import Profiling, trace_state
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.ptpb")
        trace_state.dump(path)
        size = os.path.getsize(path)
        recs = Profiling.load(path).to_records()
    trace_state.fini()
    return recs, size


def _path_checked(card: str, path: dict, obs: "_observed", t0: float,
                  wall: float, worst: float, launches: int,
                  by_variant: dict, ran: int, bytes_in: int) -> dict:
    """The ``path_checked`` line: the gate's seconds, the trace's EXEC
    spans, the SDE counters and the stage-in events against the device
    module's ``bytes_in``, beside ``path``'s wall and launches."""
    from parsec_tpu_torch.prof import sde
    from parsec_tpu_torch.prof.counters import TASKS_ENABLED, TASKS_RETIRED
    recs, size = _trace_records()
    execs = sum(r["name"] == "task_exec" for r in recs)
    retired = sde.get(TASKS_RETIRED)
    _check(len(obs.t_init) == 1, f"path_checked: {len(obs.t_init)} pools")
    _check(launches == path["gemm_launches"],
           f"path_checked: {launches} K1 launches, path {path['gemm_launches']}")
    _check(execs == ran == 512, f"path_checked: {execs} EXEC spans for "
           f"{ran} tasks")
    _check(retired == 512, f"path_checked: SDE retired {retired}")
    _check(obs.staged == bytes_in > 0, f"path_checked: DEVICE_STAGE_IN "
           f"summed {obs.staged}, bytes_in moved {bytes_in}")
    rec = dict(tasks=ran, wall_s=wall, path_wall_s=path["wall_s"],
               gate_s=obs.t_init[0] - t0, exec_spans=execs,
               trace_events=len(recs), trace_bytes=size,
               sde_retired=retired, sde_enabled=sde.get(TASKS_ENABLED),
               stage_in_event_bytes=obs.staged, bytes_in=bytes_in,
               gemm_launches=launches, gemm_launches_by_variant=by_variant,
               path_gemm_launches=path["gemm_launches"], max_abs_err=worst,
               path_max_abs_err=path["max_abs_err"])
    _emit(card, phase="path", name="path_checked", **rec)
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
        graph = _graphcheck(tp)        # the pool as it ran, off the clock
    finally:
        ctx.fini(timeout=60)
    dispatches = dev.dispatches_by_class["gemm"] - before["dispatches"]
    tasks = dev.tasks_by_class["gemm"] - before["tasks"]
    return dict(A=A, B=B, C=C, wall_s=wall, insert_s=insert_s, graph=graph,
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
    rec["graph"] = r["graph"]        # for phase analysis's line
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


def _pins_disabled_ns(iters: int = 200000) -> float:
    """One disabled PINS site (an index load and a falsy branch, the
    pattern the scheduling loop compiles in) in ns, over ``iters``, with
    the flight recorder's hook taken off the slots for the timing and put
    back after; the phase fails if the slot is not disabled then."""
    from parsec_tpu_torch.prof import pins
    saved = pins.recorder
    pins.recorder = None
    hooks = pins.hooks
    ev = int(pins.PinsEvent.EXEC_BEGIN)
    disabled = hooks[ev] is None
    payload = object()
    t0 = time.perf_counter()
    for _ in range(iters):
        h = hooks[ev]
        if h is not None:
            h(None, payload)
    ns = (time.perf_counter() - t0) / iters * 1e9
    pins.recorder = saved
    _check(disabled, "a PINS module is on during dispatch")
    return ns


class _FlightRecorderOff:
    """The flight recorder off for a block (``prof_flightrec_size`` 0, the
    recorder uninstalled, so the contexts built inside install none), and
    the installed one put back after."""

    def __enter__(self):
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.prof import flight_recorder
        self.saved = (params.get("prof_flightrec_size"),
                      flight_recorder.recorder)
        flight_recorder.uninstall()
        params.set("prof_flightrec_size", 0)
        return self

    def __exit__(self, *exc) -> None:
        from parsec_tpu_torch.core.params import params
        from parsec_tpu_torch.prof import flight_recorder, pins
        size, rec = self.saved
        params.set("prof_flightrec_size", size)
        flight_recorder.recorder = rec
        pins.recorder = rec.note if rec is not None else None


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

    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.prof import flight_recorder

    _check(native.available(),
           f"the native core did not build: {native.build_error}")
    ctx = Context(nb_cores=0)
    native_deps = ctx.deps.native_enabled
    ctx.fini()
    _check(native_deps, "the native dep table is off")
    nt = 50
    builder = ep_pool(nt, ntasks // nt)

    def sweep() -> tuple[float, dict]:
        us, engaged = _drain_us(builder, ntasks, reps, compiled=True)
        _check(engaged, "the EP pool did not run on the compiled DAG")
        dynamic = {}
        for name in ("lfq", "ap", "spq", "ip", "gd", "rnd", "ll", "llp",
                     "pbq", "ltq", "lhq"):
            dyn_us, dyn_engaged = _drain_us(builder, ntasks, reps,
                                            compiled=False, scheduler=name)
            _check(not dyn_engaged, f"{name}: the dynamic run was compiled")
            dynamic[name] = dyn_us
        return us, dynamic

    rec_size = params.get("prof_flightrec_size")
    _check(flight_recorder.recorder is not None and rec_size > 0,
           "the flight recorder is off at its default")
    us, dynamic = sweep()
    with _FlightRecorderOff():
        off_us, off_dynamic = sweep()
        pins_ns = _pins_disabled_ns()
    _check(flight_recorder.recorder is not None,
           "the flight recorder was not put back")

    def median(d: dict) -> float:
        return sorted(d.values())[len(d) // 2]

    rec = dict(ntasks=ntasks, reps=reps, dispatch_us=us,
               dispatch_path="compiled", dynamic_dispatch_us=dynamic,
               dynamic_median_us=median(dynamic),
               flightrec_size=rec_size,
               recorder_off=dict(flightrec_size=0, dispatch_us=off_us,
                                 dynamic_dispatch_us=off_dynamic,
                                 dynamic_median_us=median(off_dynamic)),
               pins_disabled_ns=pins_ns,
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
              label: str = "llm", wide: bool = False,
              served=None, via_server: bool = False) -> dict:
    """LLM decode serving through the entry points, on the card.  With
    ``wide``, the llm_wide backlog through a ``ContinuousBatcher`` of its
    own on the server (the model is not the server's default); with
    ``via_server`` that batcher is the server's own and the streams go
    through ``server.submit_stream`` (its per-tenant tuning consult too).
    ``served(server, tickets, results)`` runs once every stream is done,
    before the server drains; its result is the record's ``served``."""
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
    with RuntimeServer(nb_cores=2,
                       llm_model=model if via_server else None) as server:
        batcher = ContinuousBatcher(server, model=model) \
            if wide and not via_server else None
        submit = batcher.submit_stream if batcher is not None \
            else server.submit_stream
        tickets = []
        for prompt, tenant, fork_of, eos in backlog:
            tickets.append(submit(
                prompt, max_new_tokens=max_new, tenant=tenant, eos=eos,
                fork_from=None if fork_of is None else tickets[fork_of]))
        results = [tk.result(timeout=600) for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        extra = served(server, tickets, results) if served else None
        if batcher is not None:
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
               d2h_mb=delta("bytes_out") / 1e6,
               min_oracle_margin=min(min(m) for m in margins))
    _emit(card, phase="path", name=label, **rec)
    if served is not None:
        rec["served"] = extra
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


def _serving_card():
    """The registered CUDA device the serving phases ran on: a card."""
    from parsec_tpu_torch.device import registry
    devs = registry.by_type("cuda")
    _check(len(devs) == 1 and devs[0].is_cuda,
           f"the serving path ran on {[d.name for d in devs]}, not a card")
    return devs[0]


def _quantile(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[int(q * (len(xs) - 1))]


class _Params:
    """Set port parameters for a phase and put the old values back."""

    def __init__(self, **kw) -> None:
        self.kw = kw

    def __enter__(self):
        from parsec_tpu_torch.core.params import params
        self.saved = {k: params.get(k) for k in self.kw}
        for k, v in self.kw.items():
            params.set(k, v)
        return self

    def __exit__(self, *exc) -> None:
        from parsec_tpu_torch.core.params import params
        for k, v in self.saved.items():
            params.set(k, v)


def _serve_wave(torch, server, batcher, dev, prompts: list, max_new: int,
                want: list) -> dict:
    """One wave of streams through ``batcher`` on ``server``: each held to
    its oracle tokens; returns the wave's wall, TTFTs, tokens and the
    device's task counts by class over the wave."""
    before = dict(dev.tasks_by_class)
    t0 = time.perf_counter()
    tks = [batcher.submit_stream(p, max_new_tokens=max_new,
                                 tenant=f"tenant{i % 2}")
           for i, p in enumerate(prompts)]
    res = [tk.result(timeout=600)["tokens"] for tk in tks]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, (got, w) in enumerate(zip(res, want)):
        _check(got == w, f"stream {i} differs from the oracle: got "
                         f"{got}, want {w}")
    tasks = {c: n - before.get(c, 0) for c, n in dev.tasks_by_class.items()
             if n - before.get(c, 0)}
    ntok = sum(len(r) for r in res)
    ttft = [tk.first_token_at - tk.submitted_at for tk in tks]
    return dict(wall_s=wall, tokens=ntok, tokens_per_s=ntok / wall,
                ttft_ms_p50=1e3 * _quantile(ttft, 0.5),
                ttft_ms_p99=1e3 * _quantile(ttft, 0.99),
                tasks_by_class=tasks, tickets=tks)


def _wide_model():
    from parsec_tpu_torch.llm import ToyLM
    return ToyLM(num_heads=32, head_dim=128)


def _prefix_backlog(model, seed: int, n: int = 16, sys_len: int = 1024):
    """16 streams sharing a system prompt of ``sys_len`` tokens (64 pages
    of 16), each with a seeded suffix of 16-64 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    system = [int(t) for t in rng.integers(0, model.vocab, sys_len)]
    return system, [system + [int(t) for t in rng.integers(
        0, model.vocab, int(rng.integers(16, 65)))] for _ in range(n)]


def phase_llm_prefix(card: str, torch, seed: int = 13, max_new: int = 16,
                     first: int = 2) -> dict:
    """The prefix cache at Llama-2-7B's attention width: a first wave of
    ``first`` streams retires and donates its prompt pages, the other
    streams adopt the shared system prompt and prefill their tails only;
    the same second wave again with the cache off is the control."""
    from parsec_tpu_torch.llm import ContinuousBatcher
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve import RuntimeServer

    model = _wide_model()
    system, prompts = _prefix_backlog(model, seed)
    want = [model.reference_generate(p, max_new) for p in prompts]
    P = 16
    sys_pages = len(system) // P
    tail_pages = sum(-(-(len(p) - 1 - sys_pages * P) // P)
                     for p in prompts[first:])
    full_pages = sum(-(-(len(p) - 1) // P) for p in prompts[first:])
    runs = {}
    for cache in (True, False):
        label = "llm_prefix" if cache else "llm_prefix_control"
        with _Params(llm_prefix_cache=cache):
            with RuntimeServer(nb_cores=2) as server:
                b = ContinuousBatcher(server, model=model)
                dev = _serving_card()
                if cache:
                    ra.attn_page_update.launches = 0
                    w1 = _serve_wave(torch, server, b, dev, prompts[:first],
                                     max_new, want[:first])
                    w1["launches"] = ra.attn_page_update.launches
                s1 = b.stats()
                # both runs count K2 over the same wave of streams
                ra.attn_page_update.launches = 0
                w2 = _serve_wave(torch, server, b, dev, prompts[first:],
                                 max_new, want[first:])
                s2 = b.stats()
                b.stop()
            launches = ra.attn_page_update.launches
        hits = s2["kv"]["prefix_hits"] - s1["kv"]["prefix_hits"]
        skipped = s2["prefill_tokens_skipped"] - s1["prefill_tokens_skipped"]
        pf = w2["tasks_by_class"].get("PF", 0)
        nwave = len(prompts) - first
        if cache:
            _check(hits == nwave, f"{label}: {hits} prefix hits, want "
                                  f"{nwave}")
            _check(skipped == nwave * len(system),
                   f"{label}: {skipped} prefill tokens skipped, want "
                   f"{nwave * len(system)}")
            _check(pf == tail_pages, f"{label}: {pf} PF tasks, want the "
                                     f"{tail_pages} tail pages")
        else:
            _check(hits == 0 and pf == full_pages,
                   f"{label}: {hits} hits, {pf} PF tasks (want 0 and "
                   f"{full_pages})")
        _check(launches > 0, f"{label}: no ragged_attn_page launch")
        rec = dict(streams=nwave, system_tokens=len(system),
                   prefix_hits=hits, prefill_tokens_skipped=skipped,
                   pf_tasks=pf, wall_s=w2["wall_s"], tokens=w2["tokens"],
                   tokens_per_s=w2["tokens_per_s"],
                   ttft_ms_p50=w2["ttft_ms_p50"],
                   ttft_ms_p99=w2["ttft_ms_p99"],
                   tasks_by_class=w2["tasks_by_class"],
                   ragged_attn_page_launches=launches)
        if cache:
            rec.update(first_wave_wall_s=w1["wall_s"],
                       first_wave_ragged_attn_page_launches=w1["launches"],
                       donations=s2["prefix"]["donations"],
                       prefix_evictions=s2["prefix"]["evictions"])
        _emit(card, phase="path", name=label, **rec)
        runs[label] = rec
    return runs


def _spec_backlog(model, seed: int, n: int = 8):
    """``n`` streams: half repeat a short seeded cycle (so the n-gram
    drafter proposes), half are seeded at random; prompts of 64-192
    tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(64, 193))
        if i % 2 == 0:
            cycle = [int(t) for t in rng.integers(0, model.vocab,
                                                  int(rng.integers(2, 5)))]
            out.append((cycle * length)[:length])
        else:
            out.append([int(t) for t in rng.integers(0, model.vocab,
                                                     length)])
    return out


def _spec_superpool_direct(card: str, torch, model, seed: int,
                           n: int = 4, positions: int = 7) -> dict:
    """One ``spec_superpool_ptg`` pool seeded directly (oracle drafts, so
    every position is accepted) on a KV cache of its own, through
    ``Context``: ATTN on K2, the emitted tokens the oracle's."""
    import numpy as np

    from parsec_tpu_torch.data.datatype import TileType
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
    from parsec_tpu_torch.llm import decode as dec
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.runtime import Context

    H, D = model.num_heads, model.head_dim
    rng = np.random.default_rng(seed)
    prompts = {f"s{i}": [int(t) for t in rng.integers(
        0, model.vocab, int(rng.integers(40, 200)))] for i in range(n)}
    ref = {s: model.reference_generate(p, positions)
           for s, p in prompts.items()}
    kv = PagedKVCollection("specKV", page_size=16, num_heads=H, head_dim=D)
    colls = [DictCollection(name, dtt=TileType(shape)) for name, shape in (
        ("specDRAFT", (3, H, D)), ("specO", (H, D)), ("specSTOK", (4,)),
        ("specDTOK", (1,)),
        ("specEMB", tuple(model.q3_table().shape)))]
    DRAFT, O, STOK, DTOK, EMB = colls
    npos = dec.seed_spec_superpool(
        model, kv, DRAFT, DTOK, STOK, EMB, prompts,
        {s: r[:positions - 1] for s, r in ref.items()})
    tp = dec.spec_superpool_ptg(kv, DRAFT, O, STOK, DTOK, EMB,
                                list(prompts), [npos[s] for s in prompts])
    dev = _serving_card()
    before = dict(dev.tasks_by_class)
    ra.attn_page_update.launches = 0
    t0 = time.perf_counter()
    with Context(nb_cores=2) as ctx:
        ctx.add_taskpool(tp)
        ctx.wait(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ra.attn_page_update.launches
    got = dec.read_spec_chains(STOK, npos)
    for s in prompts:
        _check(got[s][0] == ref[s], f"llm_spec_superpool {s}: {got[s][0]} "
                                    f"against the oracle's {ref[s]}")
    tasks = {c: m - before.get(c, 0) for c, m in dev.tasks_by_class.items()
             if m - before.get(c, 0)}
    _check(set(tasks) == {"ATTN", "OUT", "VERIFY"},
           f"llm_spec_superpool: classes on the card {sorted(tasks)}")
    _check(launches > 0, "llm_spec_superpool: ATTN launched no K2 kernel")
    rec = dict(streams=n, positions=positions, wall_s=wall,
               tasks_by_class=tasks, ragged_attn_page_launches=launches,
               tokens=sum(len(v[0]) for v in got.values()))
    _emit(card, phase="path", name="llm_spec_superpool", **rec)
    return rec


def _sattn_body(card: str, torch, batch: int, S: int) -> dict:
    """SATTN's batched body (``spec_attn_page_tiles``, PyTorch ops, no
    Pallas kernel behind it in the JAX package) at the spec path's shape:
    time per call beside the least time its bytes take."""
    from parsec_tpu_torch.ops import ragged_attention as ra
    P, H, D = 16, 32, 128
    g = torch.Generator(device="cuda").manual_seed(5)
    qs = torch.randn(batch, S, 3, H, D, device="cuda", generator=g)
    page = torch.randn(batch, 3, P, H, D, device="cuda", generator=g)
    lim = torch.randint(0, P + 1, (batch, S), device="cuda",
                        generator=g).float()
    acc = torch.zeros(batch, S, H, D + 2, device="cuda")
    lists = [list(x.unbind(0)) for x in (qs, page, lim, acc)]
    ms = _time_ms(torch, lambda: ra.spec_attn_page_tiles(*lists), 20)
    # from empty states, each position's finalized output is the float64
    # softmax attention over its first lim slots
    out = ra.finalize_acc(torch.stack(ra.spec_attn_page_tiles(*lists)))
    err = 0.0
    for b in range(batch):
        for t in range(S):
            n = int(lim[b, t])
            want = ra.ragged_attention_reference(
                qs[b, t, 0].cpu(), page[b, 0, :n].cpu(),
                page[b, 1, :n].cpu())
            err = max(err, float((out[b, t].cpu() - want).abs().max()))
    _check(err < 1e-4, f"llm_spec_attn: {err} from the float64 oracle")
    nbytes = 4 * (qs[:, :, 0].numel() + page[:, :2].numel() + lim.numel()
                  + 2 * acc.numel())
    bound_ms, bound_by = _bound(0.0, nbytes, "float32")
    rec = dict(shape=f"{batch}x(S={S}, page (3,{P},{H},{D})) fp32",
               ms=ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               share_of_bound=bound_ms / ms, max_abs_err=err)
    _emit(card, phase="body", name="llm_spec_attn", **rec)
    return rec


def phase_llm_spec(card: str, torch, seed: int = 17, max_new: int = 64,
                   spec_k: int = 6) -> dict:
    """Speculative decode at Llama-2-7B's attention width through the
    entry points (``llm_spec_k=6``), and the same backlog with it off as
    the control, in turns (spec, control, control, spec: each side once
    early and once late in the process); then one per-position spec
    superpool seeded directly, and SATTN's body timed.  Each line's
    counts are its first run's."""
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.llm import ContinuousBatcher
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve import RuntimeServer

    model = _wide_model()
    prompts = _spec_backlog(model, seed)
    margins: list[float] = []
    want = [model.reference_generate(p, max_new, margins=margins)
            for p in prompts]
    cpu = registry.by_type("cpu")[0]
    runs: dict = {}
    for k in (spec_k, 0, 0, spec_k):
        label = "llm_spec" if k else "llm_spec_control"
        cpu_before = cpu.executed_tasks
        with _Params(llm_spec_k=k):
            ra.attn_page_update.launches = 0
            with RuntimeServer(nb_cores=2) as server:
                b = ContinuousBatcher(server, model=model)
                dev = _serving_card()
                w = _serve_wave(torch, server, b, dev, prompts, max_new,
                                want)
                st = b.stats()
                b.stop()
            launches = ra.attn_page_update.launches
        _check(cpu.executed_tasks == cpu_before, f"{label}: a task ran on "
                                                 f"the CPU")
        # the streams whose drafts miss converge to the plain superpool
        _check(launches > 0, f"{label}: no ragged_attn_page launch")
        tasks = w["tasks_by_class"]
        if k:
            _check(st["spec_submits"] > 0 and st["spec_drafts_accepted"] > 0,
                   f"{label}: spec_submits {st['spec_submits']}, accepted "
                   f"{st['spec_drafts_accepted']}")
            _check(tasks.get("SATTN", 0) > 0 and tasks.get("SVERIFY", 0) > 0,
                   f"{label}: SATTN/SVERIFY not on the card: {tasks}")
        else:
            _check(st["spec_submits"] == 0 and "SATTN" not in tasks,
                   f"{label}: speculated with llm_spec_k=0")
        if label in runs:
            runs[label]["tokens_per_s_runs"].append(w["tokens_per_s"])
            runs[label]["wall_s_runs"].append(w["wall_s"])
            continue
        runs[label] = dict(
            streams=len(prompts), spec_k=k, wall_s_runs=[w["wall_s"]],
            tokens=w["tokens"], tokens_per_s_runs=[w["tokens_per_s"]],
            ttft_ms_p50=w["ttft_ms_p50"], spec_submits=st["spec_submits"],
            spec_accept_rate=st.get("spec_accept_rate"),
            spec_tokens_per_submit=st.get("spec_tokens_per_submit"),
            tail_rollbacks=st["kv"]["tail_rollbacks"],
            slots_rolled_back=st["kv"]["slots_rolled_back"],
            decode_submits=st["decode_submits"], tasks_by_class=tasks,
            ragged_attn_page_launches=launches,
            min_oracle_margin=min(margins))
    for label, rec in runs.items():
        _emit(card, phase="path", name=label, **rec)
    runs["llm_spec_superpool"] = _spec_superpool_direct(card, torch, model,
                                                        seed)
    runs["sattn"] = _sattn_body(card, torch, batch=4, S=spec_k + 1)
    return runs


def phase_llm_tiers(card: str, torch, seed: int = 19, max_new: int = 24,
                    n: int = 6, budget_pages: int = 24,
                    host_tier_pages: int = 8) -> dict:
    """The KV tiers at Llama-2-7B's attention width: the card's tile
    budget set below the live KV (``budget_pages`` pages of 768 KiB), a
    host tier of ``host_tier_pages`` pages past which cold pages spill
    to a ``PeerKVStore`` on the second rank of an in-process
    ``DeviceFabric`` (two ranks, one card), and the batcher prefetching
    them back one superpool ahead."""
    import numpy as np

    from parsec_tpu_torch.comm.device_fabric import DeviceFabric
    from parsec_tpu_torch.data_dist.kv_tiers import PeerKVStore
    from parsec_tpu_torch.llm import ContinuousBatcher
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve import RuntimeServer

    model = _wide_model()
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(0, model.vocab, int(
        rng.integers(256, 513)))] for _ in range(n)]
    want = [model.reference_generate(p, max_new) for p in prompts]
    page_bytes = 3 * 16 * model.num_heads * model.head_dim * 4
    dev = _serving_card()
    fab = DeviceFabric(2, devices=[dev.torch_device] * 2)
    e0, e1 = fab.attach(0), fab.attach(1)
    store = PeerKVStore(e1)
    saved_budget = dev._mem_budget
    live_pages = sum(-(-(len(p) + max_new) // 16) for p in prompts)
    with _Params(kv_host_tier_bytes=host_tier_pages * page_bytes):
        dev.flush_cache()
        dev._mem_budget = budget_pages * page_bytes
        before = dev.stats()
        ra.attn_page_update.launches = 0
        try:
            with RuntimeServer(nb_cores=2) as server:
                b = ContinuousBatcher(server, model=model)
                b.tiers.attach_peer(e0, 1)
                w = _serve_wave(torch, server, b, dev, prompts, max_new,
                                want)
                st = b.stats()
                b.stop()
        finally:
            dev._mem_budget = saved_budget
        launches = ra.attn_page_update.launches
    tiers = st["tiers"]
    after = dev.stats()
    _check(tiers["spills"] > 0, f"llm_tiers: no spill ({tiers})")
    _check(tiers["prefetched_pages"] > 0, f"llm_tiers: nothing prefetched "
                                          f"({tiers})")
    _check(tiers["peer_fetches"] > 0 and e0.prefetch_gets > 0,
           f"llm_tiers: no peer round trip ({tiers}, prefetch_gets "
           f"{e0.prefetch_gets})")
    _check(launches > 0, "llm_tiers: no ragged_attn_page launch")
    _check(after["spill_hook_failures"] == before["spill_hook_failures"],
           "llm_tiers: a spill hook raised")
    rec = dict(streams=n, live_kv_pages=live_pages,
               tile_budget_pages=budget_pages,
               host_tier_budget_pages=host_tier_pages,
               wall_s=w["wall_s"], tokens=w["tokens"],
               tokens_per_s=w["tokens_per_s"], tiers=tiers,
               peer_store=store.stats(), prefetch_gets=e0.prefetch_gets,
               peer_bytes_got=e0.bytes_got,
               deferred_evictions=after["deferred_evictions"]
               - before["deferred_evictions"],
               h2d_copied_mb=(after["bytes_copied_in"]
                              - before["bytes_copied_in"]) / 1e6,
               d2h_mb=(after["bytes_out"] - before["bytes_out"]) / 1e6,
               tasks_by_class=w["tasks_by_class"],
               ragged_attn_page_launches=launches)
    _emit(card, phase="path", name="llm_tiers", **rec)
    return rec


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
    # the tuner's winning tile on the dynamic Cholesky (phase
    # tuned_cholesky, nb=2048): a panel's 3 TRSM and 3 SYRK/GEMM tiles
    tuned3 = (3, 2048, 2048, 2048)
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
             ("nn-noc", rank4, tile_list, "default", 5),
             ("nt-sub", tuned3, tile_list, "default", 5),
             ("nt-noc", tuned3, tile_list, "default", 5)]
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
                   d2h_mb=delta("bytes_out") / 1e6,
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
                   d2h_mb=(s["bytes_out"] - before["bytes_out"]) / 1e6,
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


def _mp_launch(torch, kinds, n: int, nb: int, seed: int,
               extra: dict | None = None) -> tuple[list, float]:
    """One 4-process ``run_multiproc`` launch of ``mp_bodies:pool_body``
    on the card (``distributed=True``) running ``kinds`` at n, nb, each
    after its warm-up, with ``extra`` more environment; returns the
    ranks' results and the launch's seconds."""
    from parsec_tpu_torch.comm import run_multiproc
    from parsec_tpu_torch.device.cuda import init_cuda_devices

    dev = init_cuda_devices()[0]
    dev.flush_cache()
    torch.cuda.empty_cache()       # the ranks' contexts share the card
    env = {"PARSEC_MP_KINDS": ",".join(kinds), "PARSEC_MP_N": str(n),
           "PARSEC_MP_NB": str(nb), "PARSEC_MP_SEED": str(seed),
           "PARSEC_MP_CHORES": "cuda", "PARSEC_MP_WARMUP": "1",
           "PARSEC_MCA_gemm_precision": "default", **(extra or {})}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        res = run_multiproc(MR_RANKS,
                            "parsec_tpu_torch.comm.mp_bodies:pool_body",
                            timeout=420, transport="device",
                            distributed=True)
        return res, time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_multiproc(card: str, torch, multirank: dict, n: int = 8192,
                    nb: int = 1024, seed: int = 0) -> dict:
    """GEMM, Cholesky and LU across 4 rank processes on the card (see
    the module docstring, phase 16): one ``run_multiproc`` launch with
    ``distributed=True``; returns each kind's path record."""
    from parsec_tpu_torch.comm.mp_bodies import factor_input, gemm_dense
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops

    res, launch_s = _mp_launch(torch, MP_KINDS, n, nb, seed)
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
        dense = _mp_dense(recs, n, nb)
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
               d2h_mb=(s["bytes_out"] - before["bytes_out"]) / 1e6,
               max_abs_err=err)
    _emit(card, phase="path", name=name, **rec)
    dev.flush_cache()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# graphcheck, PINS and the comm thread (phases 19-22 of the docstring)
# ---------------------------------------------------------------------------


def _graph_summary(report, seconds: float) -> dict:
    """A graphcheck report as a line's fields."""
    from collections import Counter
    return dict(pool=report.name, nodes=report.ntasks, edges=report.nedges,
                errors=sorted({f.code for f in report.errors}),
                warnings=dict(Counter(f.code for f in report.warnings)),
                truncated=report.truncated, check_s=seconds)


def _graphcheck(tp, nb_ranks: int | None = None) -> dict:
    from parsec_tpu_torch.analysis import check_taskpool
    t0 = time.perf_counter()
    report = check_taskpool(tp, nb_ranks=nb_ranks)
    return _graph_summary(report, time.perf_counter() - t0)


class _PoolChecker:
    """A TASKPOOL_INIT callback that checks every PTG pool as it is
    enqueued (the pool's state then is what its gate would see), and
    sums the reports by pool kind (the name without its serial number).  It never raises into the enqueue: a
    failure is kept and the phase fails after the run."""

    def __init__(self) -> None:
        self.by_name: dict[str, dict] = {}
        self.failures: list[str] = []

    def __call__(self, es, tp) -> None:
        from parsec_tpu_torch.ptg.dsl import PTGTaskpool
        if not isinstance(tp, PTGTaskpool):
            return
        try:
            g = _graphcheck(tp)
        except Exception as e:     # noqa: BLE001 — kept, fails the phase
            self.failures.append(f"{tp.name}: {e!r}")
            return
        kind = tp.name.rstrip("0123456789")
        agg = self.by_name.setdefault(kind, dict(
            pools=0, nodes=0, edges=0, max_nodes=0, errors=set(),
            warnings=0, check_s=0.0, max_check_s=0.0))
        agg["pools"] += 1
        agg["nodes"] += g["nodes"]
        agg["edges"] += g["edges"]
        agg["max_nodes"] = max(agg["max_nodes"], g["nodes"])
        agg["errors"] |= set(g["errors"])
        agg["warnings"] += sum(g["warnings"].values())
        agg["check_s"] += g["check_s"]
        agg["max_check_s"] = max(agg["max_check_s"], g["check_s"])


def _spec_pools_at_width(model, seed: int = 23) -> list:
    """The speculative pools at the ``llm_spec`` phase's shapes, built on
    KV caches of their own and seeded on the host (the checks run no
    body): ``spec_superpool_ptg`` over 4 streams of 7 positions (the
    ``llm_spec_superpool`` run's), and the batcher's
    ``spec_batched_ptg`` over 8 streams of ``llm_spec_k`` = 6 drafts."""
    import numpy as np

    from parsec_tpu_torch.data.datatype import TileType
    from parsec_tpu_torch.data_dist.collection import DictCollection
    from parsec_tpu_torch.data_dist.paged_kv import PagedKVCollection
    from parsec_tpu_torch.llm import decode as dec

    H, D = model.num_heads, model.head_dim
    rng = np.random.default_rng(seed)

    def prompts(n):
        return {f"s{i}": [int(t) for t in rng.integers(
            0, model.vocab, int(rng.integers(40, 200)))] for i in range(n)}

    p4 = prompts(4)
    kv = PagedKVCollection("gcKV", page_size=16, num_heads=H, head_dim=D)
    DRAFT, O, STOK, DTOK, EMB = (
        DictCollection(name, dtt=TileType(shape)) for name, shape in (
            ("gcDRAFT", (3, H, D)), ("gcO", (H, D)), ("gcSTOK", (4,)),
            ("gcDTOK", (1,)), ("gcEMB", tuple(model.q3_table().shape))))
    npos = dec.seed_spec_superpool(model, kv, DRAFT, DTOK, STOK, EMB, p4,
                                   {s: p[:6] for s, p in p4.items()})
    sp = dec.spec_superpool_ptg(kv, DRAFT, O, STOK, DTOK, EMB, list(p4),
                                [npos[s] for s in p4])
    p8 = prompts(8)
    pad = 7
    kv2 = PagedKVCollection("gcKVb", page_size=16, num_heads=H, head_dim=D)
    QS, LIM, DTOKS, VOUT = (
        DictCollection(name, dtt=TileType(shape)) for name, shape in (
            ("gcQS", (pad, 3, H, D)), ("gcLIM", (pad,)),
            ("gcDTOKS", (pad + 2,)), ("gcVOUT", (pad + 2,))))
    npos_b, pad = dec.seed_spec_batched_pool(
        model, kv2, QS, LIM, DTOKS, EMB, p8,
        {s: p[:6] for s, p in p8.items()}, pad=pad)
    sb = dec.spec_batched_ptg(kv2, QS, LIM, DTOKS, VOUT, EMB, list(p8),
                              [npos_b[s] for s in p8], pad=pad)
    return [("llm_spec_superpool", sp), ("llm_spec", sb)]


def phase_analysis(card: str, torch, dtd: dict) -> dict:
    """Graphcheck over every pool the script runs, at the size it runs
    (the DTD GEMM's after its run; the prefill and decode pools of
    ``llm_wide`` in phase ``llm_wide_pins``), one line a pool; then the
    gate's control: the dynamic GEMM with one input arrow dropped,
    enqueued under ``analysis_check``, must raise ``GraphCheckError``
    naming ``missing-input-edge`` before any K1 launch and leave the
    context without a pool."""
    from parsec_tpu_torch.analysis import GraphCheckError
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                                   TiledMatrix,
                                                   TwoDimBlockCyclic,
                                                   VectorTwoDimCyclic)
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.stencil import stencil_1d_ptg
    from parsec_tpu_torch.models.stencil2d import stencil_2d_ptg
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    def gemm(n, nb, dtype=torch.float32, grid=None):
        cls = TwoDimBlockCyclic if grid else TiledMatrix
        kw = grid or {}
        return tiled_gemm_ptg(cls("A", n, n, nb, nb, dtype=dtype, **kw),
                              cls("B", n, n, nb, nb, dtype=dtype, **kw),
                              cls("C", n, n, nb, nb, **kw))

    def factor(kind, n, nb, grid=None):
        cls = SymTwoDimBlockCyclic if kind == "cholesky" \
            else (TwoDimBlockCyclic if grid else TiledMatrix)
        return _factor_ptg(kind, cls("A", n, n, nb, nb, **(grid or {})))

    grid = _mr_grid(0)               # rank 0's view of the 2 x 2 grid
    pools = [
        ("gemm", gemm(8192, 1024), None),
        ("lowered_gemm", gemm(16384, 512, torch.bfloat16), None),
        ("lowered_stencil", stencil_1d_ptg(
            VectorTwoDimCyclic("V", lm=1 << 24, mb=1 << 18, P=1),
            [1.0 / 9] * 9, 64), None),
        ("lowered_stencil2d", stencil_2d_ptg(
            TiledMatrix("M", 8192, 8192, 1024, 1024),
            (0.5, 0.15, 0.15, 0.1, 0.1), 16), None),
        ("dynamic_cholesky", factor("cholesky", 8192, 1024), None),
        ("dynamic_lu", factor("lu", 8192, 1024), None),
        ("lowered_cholesky", factor("cholesky", 16384, 512), None),
        ("lowered_lu", factor("lu", 8192, 512), None),
        *((name, tp, None) for name, tp in _spec_pools_at_width(
            _wide_model())),
        ("multirank_gemm", gemm(8192, 1024, grid=grid), MR_RANKS),
        ("multirank_cholesky", factor("cholesky", 8192, 1024, grid),
         MR_RANKS),
        ("multirank_lu", factor("lu", 8192, 1024, grid), MR_RANKS)]
    lines = {"dtd_gemm": dtd["graph"]}
    for name, tp, nb_ranks in pools:
        lines[name] = _graphcheck(tp, nb_ranks)
    for name, g in lines.items():
        _check(not g["errors"], f"analysis {name}: {g['errors']}")
        _check(not g["truncated"], f"analysis {name}: truncated")
        _emit(card, phase="analysis", name=name, ranks=(
            MR_RANKS if name.startswith("multirank") else 1), **g)

    # the gate's control
    dev = init_cuda_devices()[0]
    bad = gemm(8192, 1024)
    fC = next(f for f in bad.task_class("GEMM").flows if f.name == "C")
    fC.deps_in = [d for d in fC.deps_in if d.target_class is None]
    k1, ran = tg.gemm_update.launches, dev.executed_tasks
    saved = params.get("analysis_check")
    params.set("analysis_check", True)
    ctx = Context(nb_cores=0)
    raised = None
    t0 = time.perf_counter()
    try:
        ctx.add_taskpool(bad)
    except GraphCheckError as e:
        raised = e
    finally:
        gate_s = time.perf_counter() - t0
        params.set("analysis_check", saved)
    _check(raised is not None, "analysis control: the gate let the "
           "malformed pool in")
    hit = next((f for f in raised.findings
                if f.code == "missing-input-edge"), None)
    _check(hit is not None, f"analysis control: {raised}")
    _check((hit.task_class, hit.flow) == ("GEMM", "C")
           and hit.instance is not None,
           f"analysis control: provenance {hit!r}")
    _check(tg.gemm_update.launches == k1 and dev.executed_tasks == ran,
           "analysis control: K1 launched before the gate raised")
    _check(ctx.test() and not ctx._active_taskpools and bad.context is None,
           "analysis control: the context holds the rejected pool")
    ctx.fini()
    _emit(card, phase="control", name="analysis_gate",
          finding=hit.code, task_class=hit.task_class, flow=hit.flow,
          instance=hit.instance, count=hit.count,
          errors=len(raised.report.errors), gate_s=gate_s,
          k1_launches_during=tg.gemm_update.launches - k1,
          pools_in_context=len(ctx._active_taskpools))
    return lines


def phase_llm_wide_pins(card: str, torch) -> dict:
    """The traced ``llm_wide`` run's backlog (seed 11, 8 new tokens, 32
    heads of 128, K2) with the task profiler on, and every prefill and
    decode pool checked as it is enqueued: every stream equal to the
    oracle (``phase_llm``), one EXEC span a task run, no pool with an
    error."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.prof import pins, trace_state
    from parsec_tpu_torch.prof.pins import PinsEvent

    checker = _PoolChecker()
    saved = params.get("pins")
    params.set("pins", "task_profiler")
    trace_state.fini()
    pins.register(PinsEvent.TASKPOOL_INIT, checker)
    try:
        rec = phase_llm(card, torch, seed=11, max_new=8,
                        label="llm_wide_pins", wide=True)
    finally:
        pins.unregister(PinsEvent.TASKPOOL_INIT, checker)
        params.set("pins", saved)
    recs, size = _trace_records()
    execs = sum(r["name"] == "task_exec" for r in recs)
    ran = sum(rec["tasks_by_class"].values())
    _check(not checker.failures, f"llm_wide_pins: {checker.failures}")
    _check(execs == ran, f"llm_wide_pins: {execs} EXEC spans for {ran} "
           f"tasks")
    for name, agg in checker.by_name.items():
        _check(not agg["errors"], f"analysis llm_wide {name}: "
               f"{sorted(agg['errors'])}")
        _emit(card, phase="analysis", name=f"llm_wide {name}",
              **{k: sorted(v) if isinstance(v, set) else v
                 for k, v in agg.items()})
    _check({"llm_prefill", "llm_decode"} <= set(checker.by_name),
           f"llm_wide_pins checked {sorted(checker.by_name)}")
    out = dict(tasks=ran, exec_spans=execs, trace_events=len(recs),
               trace_bytes=size, wall_s=rec["wall_s"],
               ragged_attn_page_launches=rec["ragged_attn_page_launches"],
               pools_checked={k: v["pools"]
                              for k, v in checker.by_name.items()})
    _emit(card, phase="pins", name="llm_wide_pins", **out)
    return rec


def phase_multiproc_comm_thread(card: str, torch, multiproc: dict,
                                n: int = 8192, nb: int = 1024,
                                seed: int = 0) -> dict:
    """The four-process Cholesky of ``multiproc_cholesky`` with
    ``comm_thread`` off, on, on, off, a launch each: the factor gates in
    every run, and every run's GETs and bytes by tier equal to the first
    off run's; each line carries the wall, ``get_ms_mean`` and the hops'
    host seconds.  Returns the four runs' K1 counts as one path."""
    from parsec_tpu_torch.comm.mp_bodies import factor_input

    a = factor_input("cholesky", n)
    runs, first = [], None
    for on in (False, True, True, False):
        res, launch_s = _mp_launch(torch, ("cholesky",), n, nb, seed, {
            "PARSEC_MCA_comm_thread": "1" if on else "0"})
        _check([r["comm_thread"] for r in res] == [on] * MR_RANKS,
               f"multiproc_comm_thread: threads {[r['comm_thread'] for r in res]}")
        recs = [r["kinds"]["cholesky"] for r in res]
        dense = _mp_dense(recs, n, nb)
        checks = _factor_check(torch, "cholesky", dense, a, nb, "default")
        del dense
        gets = [r["gets"] for r in recs]
        tiers = [{k: r["tiers"][k] for k in ("payload_in", "payload_out")}
                 for r in recs]
        if first is None:
            first = (gets, tiers)
            _check(gets == multiproc["multiproc_cholesky"]["gets_by_rank"],
                   f"multiproc_comm_thread: GETs {gets}")
        _check((gets, tiers) == first, f"multiproc_comm_thread: GETs "
               f"{gets} and bytes {tiers}, first run {first}")
        launches = sum(r["k1"] for r in recs)
        run = dict(comm_thread=on,
                   wall_s=max(r["t_wait"] for r in recs)
                   - min(r["t_add"] for r in recs),
                   launch_s=launch_s, gets_by_rank=gets,
                   payload_in_by_rank=[t["payload_in"] for t in tiers],
                   get_ms_mean=(sum(r["tier_s"]["get_s"] for r in recs)
                                / max(1, sum(gets)) * 1e3),
                   tier_seconds={hop: [r["tier_s"][hop] for r in recs]
                                 for hop in ("d2h_s", "send_s", "recv_s",
                                             "h2d_s", "get_s")},
                   manager_s_by_rank=[r["dev"]["t_manager"] for r in recs],
                   gemm_launches=launches,
                   gemm_launches_by_variant=_by_variant(_sum_counts(
                       r["k1_by_variant"] for r in recs)), **checks)
        _emit(card, phase="path", name="multiproc_comm_thread", **run)
        runs.append(run)
    return dict(gemm_launches=sum(r["gemm_launches"] for r in runs),
                gemm_launches_by_variant=_sum_counts(
                    r["gemm_launches_by_variant"] for r in runs),
                walls_on=[r["wall_s"] for r in runs if r["comm_thread"]])


# the SLO histograms' bucket error: a reported quantile is its bucket's
# geometric midpoint, within a factor sqrt(growth) of every value in the
# bucket; the summary rounds to 3 decimals
SLO_REL = (2 ** 0.25) ** 0.5
SLO_ABS_MS = 5e-4


def _rank_quantile(xs: list, q: float) -> float:
    """The q-quantile by the histograms' rank rule: the ``ceil(q * n)``-th
    smallest value."""
    xs = sorted(xs)
    return xs[min(len(xs), max(1, math.ceil(q * len(xs)))) - 1]


def _slo_held(got: float, want: float) -> bool:
    return (want / SLO_REL - SLO_ABS_MS <= got
            <= want * SLO_REL + SLO_ABS_MS)


def _critpath_identity(rep: dict, what: str) -> None:
    """``sum(buckets) + idle == window`` for every request of a critpath
    report (to 1e-6 ms: the sums of ns in ms floats)."""
    for key, rq in rep["requests"].items():
        gap = sum(rq["buckets_ms"].values()) - rq["window_ms"]
        _check(abs(gap) < 1e-6, f"{what}: critpath buckets of {key} miss "
               f"its window by {gap} ms")


def phase_llm_wide_slo(card: str, torch, busy: dict,
                       max_spans: int = 1 << 20) -> dict:
    """The ``llm_wide`` backlog (seed 11, 32 new tokens) through a
    ``RuntimeServer`` with the span recorder on (phase 23 of the module
    docstring); ``busy`` is **trace llm_wide**'s record."""
    from parsec_tpu_torch.prof import runtime_report, spans
    from parsec_tpu_torch.prof.critpath import attribute, normalize

    def served(server, tickets, results):
        by_tenant: dict = {}
        for tk, r in zip(tickets, results):
            d = by_tenant.setdefault(tk.tenant, {"ttft": [], "tok": []})
            d["ttft"].append((tk.first_token_at - tk.submitted_at) * 1e3)
            d["tok"].extend(x * 1e3 for x in r["per_token_s"])
        # the report while the server's SLO plane and the spans live
        return server.metrics(), by_tenant, runtime_report()

    _check(spans.recorder is None, "the span recorder is already on")
    with _Params(prof_spans=True, prof_spans_max=max_spans):
        rec = phase_llm(card, torch, seed=11, max_new=32,
                        label="llm_wide_slo", wide=True, served=served)
    rcd = spans.recorder
    _check(rcd is not None, "llm_wide_slo: the server installed no recorder")
    raw = list(rcd.spans)
    dropped = rcd.dropped
    spans.uninstall()
    metrics, by_tenant, report = rec["served"]
    tenants = {}
    for tenant, own in sorted(by_tenant.items()):
        m = metrics["tenants"][tenant]
        row = {}
        for metric, xs in (("ttft_ms", own["ttft"]),
                           ("tok_latency_ms", own["tok"])):
            _check(m[f"{metric}_count"] == len(xs), f"llm_wide_slo "
                   f"{tenant}: {m[f'{metric}_count']} {metric} samples, "
                   f"the tickets hold {len(xs)}")
            for q in (0.5, 0.99):
                key = f"{metric}_p{int(q * 100)}"
                want = _rank_quantile(xs, q)
                _check(_slo_held(m[key], want), f"llm_wide_slo {tenant}: "
                       f"{key} {m[key]} against the stamps' {want}")
                row[key] = m[key]
                row[f"{key}_exact"] = want
        row["latency_ms_count"] = m.get("latency_ms_count", 0)
        tenants[tenant] = row
    _check(dropped == 0, f"llm_wide_slo: {dropped} spans dropped")
    execs = sum(sp[0] == "exec" for sp in raw)
    ran = sum(rec["tasks_by_class"].values())
    _check(execs == ran, f"llm_wide_slo: {execs} EXEC spans for {ran} "
           f"tasks")
    cp = attribute(normalize(raw))
    _critpath_identity(cp, "llm_wide_slo")
    bk = cp["buckets_ms"]
    window = sum(bk.values())
    _check({"slo", "serve", "llm", "critpath"} <= set(report),
           f"llm_wide_slo: runtime_report blocks {sorted(report)}")
    out = dict(tokens=rec["tokens"], wall_s=rec["wall_s"], tenants=tenants,
               slo_rel_bound=SLO_REL, slo_abs_ms=SLO_ABS_MS,
               tasks=ran, exec_spans=execs, spans=len(raw),
               span_names={n: sum(sp[0] == n for sp in raw)
                           for n in sorted({sp[0] for sp in raw})},
               ragged_attn_page_launches=rec["ragged_attn_page_launches"],
               critpath_traces=cp["traces"], critpath_buckets_ms=bk,
               critpath_shares={b: v / window for b, v in bk.items()}
               if window else {},
               traced_busy_share=1.0 - busy["idle_share"],
               traced_max_new=8,
               runtime_report_blocks=sorted(report),
               runtime_report_bytes=len(json.dumps(report)))
    _emit(card, phase="slo", name="llm_wide_slo", **out)
    return rec


def _stuck_pool(gate, lanes: int = 4, depth: int = 4):
    """A CTL pool of ``lanes`` chains of ``depth`` tasks whose host body
    waits on ``gate``."""
    from parsec_tpu_torch import ptg
    p = ptg.PTGBuilder("stuckpool", NT=lanes, DEPTH=depth)
    t = p.task("EP", d=ptg.span(0, lambda g, l: g.DEPTH - 1),
               n=ptg.span(0, lambda g, l: g.NT - 1))
    f = t.flow("ctl", ptg.CTL)
    f.input(pred=("EP", "ctl", lambda g, l: {"d": l.d - 1, "n": l.n}),
            guard=lambda g, l: l.d > 0)
    f.output(succ=("EP", "ctl", lambda g, l: {"d": l.d + 1, "n": l.n}),
             guard=lambda g, l: l.d < g.DEPTH - 1)
    t.body(lambda es, task, g, l: (gate.wait(60), None)[1])
    return p.build()


def phase_stall(card: str, torch, timeout: float = 1.0) -> dict:
    """The stall control on the card's machine (phase 24 of the module
    docstring)."""
    import tempfile
    import threading

    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.prof import flight_recorder
    from parsec_tpu_torch.runtime.context import ContextWaitTimeout
    from parsec_tpu_torch.serve import RuntimeServer

    gate = threading.Event()
    with tempfile.TemporaryDirectory(prefix="flightrec_") as d, \
            _Params(prof_flightrec_dir=d):
        server = RuntimeServer(nb_cores=1)
        tk = server.submit(_stuck_pool(gate), tenant="stuck")
        t0 = time.perf_counter()
        raised = None
        try:
            server.context.wait(timeout=timeout)
        except ContextWaitTimeout as e:
            raised = e
        waited = time.perf_counter() - t0
        report = server.context.last_stall_report
        artifact = os.path.join(d, "flightrec-0.json")
        on_disk = os.path.exists(artifact)
        gate.set()
        server.__exit__(type(raised), raised, None)
    _check(raised is not None, "stall: the wait did not time out")
    _check(waited < timeout + 9.0, f"stall: the wait took {waited} s")
    _check(report is not None and on_disk, "stall: no stall dump written")
    sec = [v for k, v in (report.get("sections") or {}).items()
           if k.startswith("serve")]
    stuck = sec[0].get("stuck") if sec else None
    _check(stuck is not None and stuck["inflight"] == 1
           and stuck["oldest_trace_id"] == format(tk.trace.trace_id, "x"),
           f"stall: the dump does not name the tenant ({sec})")
    cards = [dv for dv in report.get("devices") or []
             if isinstance(dv, dict) and dv.get("name") == "cuda(0)"]
    _check(len(cards) == 1 and "lru_tiles" in cards[0],
           f"stall: the dump holds no card state ({report.get('devices')})")
    depths = report.get("queue_depths")
    _check(isinstance(depths, dict) and depths.get("fair.stuck", 0) > 0,
           f"stall: queue depths {depths}")
    alive = [t.name for t in server.context._threads if t.is_alive()]
    _check(not alive, f"stall: workers still alive: {alive}")
    _check(not any(k.startswith("serve") for k in (flight_recorder
           .build_stall_report(None, "after").get("sections") or {})),
           "stall: the server's section outlived it")
    out = dict(timeout_s=timeout, waited_s=waited,
               reason=report["reason"][:120], tenant=stuck,
               queue_depths=depths, card_state=cards[0] if cards else None,
               workers=sorted(report["workers"]),
               devices=[dv.get("name") for dv in report["devices"]],
               ticket_state=tk.state, n_devices=len(registry.devices))
    _emit(card, phase="control", name="stall", **out)
    return out


def phase_multiproc_traced(card: str, torch, multiproc: dict,
                           comm_thread: dict, n: int = 8192,
                           nb: int = 1024, seed: int = 0) -> dict:
    """The four-process Cholesky with spans on in every rank (phase 25 of
    the module docstring)."""
    import tempfile

    from parsec_tpu_torch.comm.mp_bodies import factor_input
    from parsec_tpu_torch.prof import tracemerge
    from parsec_tpu_torch.prof.critpath import attribute, from_chrome

    base = multiproc["multiproc_cholesky"]
    with tempfile.TemporaryDirectory(prefix="mp_traced_") as d:
        res, launch_s = _mp_launch(torch, ("cholesky",), n, nb, seed, {
            "PARSEC_MCA_comm_thread": "1", "PARSEC_MCA_prof_spans": "1",
            "PARSEC_MCA_prof_spans_max": str(1 << 20),
            "PARSEC_MP_TRACE_DIR": d})
        recs = [r["kinds"]["cholesky"] for r in res]
        paths = [os.path.join(d, f"trace-cholesky-rank{r}.json")
                 for r in range(MR_RANKS)]
        merged = os.path.join(d, "merged.json")
        t0 = time.perf_counter()
        stats = tracemerge.merge_traces(paths, merged)
        merge_s = time.perf_counter() - t0
        with open(merged) as f:
            events = json.load(f)["traceEvents"]
    _check([r["comm_thread"] for r in res] == [True] * MR_RANKS,
           "multiproc_traced: the comm thread is off")
    gets = [r["gets"] for r in recs]
    tiers = [{k: r["tiers"][k] for k in ("payload_in", "payload_out")}
             for r in recs]
    _check(gets == base["gets_by_rank"], f"multiproc_traced: GETs {gets}")
    _check([t["payload_in"] for t in tiers] == base["payload_in_by_rank"]
           and [t["payload_out"] for t in tiers]
           == base["payload_out_by_rank"],
           f"multiproc_traced: bytes by tier {tiers}")
    dense = _mp_dense(recs, n, nb)
    checks = _factor_check(torch, "cholesky", dense,
                           factor_input("cholesky", n), nb, "default")
    del dense
    _check(all(r["spans_dropped"] == 0 for r in recs),
           "multiproc_traced: spans dropped")
    sides: dict = {}
    for ev in events:
        a = ev.get("args") or {}
        if a.get("flow") and a.get("flow_side") in ("emit", "recv"):
            sides.setdefault(a["flow"], set()).add(a["flow_side"])
    unmatched = sorted(k for k, v in sides.items() if len(v) < 2)
    # a hop records comm.activate on both of its ranks
    acts = sum(r["spans"].get("comm.activate", 0) for r in recs) // 2
    by_kind = stats["flows_by_kind"]
    _check(not unmatched, f"multiproc_traced: {len(unmatched)} flows "
           f"unmatched ({unmatched[:4]})")
    _check(by_kind.get("get", 0) == sum(gets),
           f"multiproc_traced: {by_kind} against {sum(gets)} GETs")
    _check(by_kind.get("act", 0) == acts > 0
           and stats["cross_rank_flows"] == stats["flows_matched"]
           == len(sides), f"multiproc_traced: flows {stats}")
    cp = attribute(from_chrome(events))
    _critpath_identity(cp, "multiproc_traced")
    bk = cp["buckets_ms"]
    window = sum(bk.values())
    launches = sum(r["k1"] for r in recs)
    wall = max(r["t_wait"] for r in recs) - min(r["t_add"] for r in recs)
    out = dict(n=n, nb=nb, ranks=MR_RANKS, comm_thread=True, wall_s=wall,
               comm_thread_walls_on=comm_thread["walls_on"],
               launch_s=launch_s, gets_by_rank=gets,
               payload_in_by_rank=[t["payload_in"] for t in tiers],
               get_ms_mean=(sum(r["tier_s"]["get_s"] for r in recs)
                            / max(1, sum(gets)) * 1e3),
               spans_by_rank=[r["spans"] for r in recs],
               flows_matched=stats["flows_matched"],
               cross_rank_flows=stats["cross_rank_flows"],
               flows_by_kind=by_kind, unmatched_flows=len(unmatched),
               merged_events=stats["events"], merge_s=merge_s,
               critpath_buckets_ms=bk,
               critpath_shares={b: v / window for b, v in bk.items()}
               if window else {},
               comm_get_share=bk["comm.get"] / window if window else 0.0,
               comm_activate_share=(bk["comm.activate"] / window
                                    if window else 0.0),
               overlap_efficiency=cp["overlap_efficiency"],
               top_overlap_lost=cp["top_overlap_lost"],
               # each comm edge class: spans, their mean and the part of
               # their flight no task hid (a GET's request to landing,
               # its owner's serve, an activation hop, a CTRL landing)
               edges={c: dict(count=e["count"],
                              mean_ms=e["total_ms"] / e["count"],
                              overlap_lost_ms=e["overlap_lost_ms"])
                      for c, e in sorted(cp["edges"].items())},
               gemm_launches=launches,
               gemm_launches_by_variant=_by_variant(_sum_counts(
                   r["k1_by_variant"] for r in recs)), **checks)
    _emit(card, phase="path", name="multiproc_traced", **out)
    return out


def _mp_dense(recs: list, n: int, nb: int):
    """The whole result from the ranks' own tiles."""
    import numpy as np
    dense = np.zeros((n, n), np.float32)
    for r in recs:
        for (i, j), tile in r["tiles"].items():
            dense[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = tile
    return dense


# ---------------------------------------------------------------------------
# the tuner, the lowering cache, adaptive k and the sharded server
# ---------------------------------------------------------------------------

# the tuner's trial budget and tile-size domain on the dynamic Cholesky
TUNE_BUDGET = 8
TUNE_SPEEDUP_MIN = 1.2       # the JAX package's perf-smoke gate


def _tune_dirs() -> str:
    """A fresh temporary directory for the run's tuning DB and perf
    ledger: the port's ``tune_db_path`` and ``perfdb_path`` point there
    (and every rank process inherits them), so no file left on the card's
    machine steers a ``Context`` the script starts."""
    import tempfile

    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.prof import perfdb  # noqa: F401 — registers
    from parsec_tpu_torch.tune import db  # noqa: F401 — the two paths
    d = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    for name, leaf in (("tune_db_path", "tunedb.jsonl"),
                       ("perfdb_path", "perfdb.jsonl")):
        os.environ[f"PARSEC_MCA_{name}"] = os.path.join(d, leaf)
        params.set(name, os.path.join(d, leaf))
    return d


def phase_tuned_cholesky(card: str, torch, n: int = 8192,
                         nb_bad: int = 128) -> dict:
    """The closed-loop tuner on the dynamic Cholesky (the JAX bench's
    ``tuned_cholesky`` stage, ``bench.py:303-400``) at full size: the
    tile size is seeded bad (nb=128, 64 x 64 tiles) and ``tune.search``
    moves it over a log2 domain from 128 to 4096 (budget 8, one restart,
    seed 0, objective ``wall_s``).  A trial's first visit to a tile size
    runs once off the clock.  The winner's factor passes the TF32 gates,
    sits in the tuning DB under the pool's signature, and every trial is
    in the perf ledger."""
    from parsec_tpu_torch.core.params import KnobSpec
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.cholesky import make_spd_fast
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.prof.perfdb import PerfDB, make_key
    from parsec_tpu_torch.tune import TuneDB, workload_signature
    from parsec_tpu_torch.tune.search import search

    a = make_spd_fast(n)
    dev = init_cuda_devices()[0]

    def one(nb: int):
        A = _factor_matrix("cholesky", a, nb)
        tp = _factor_ptg("cholesky", A)
        t0 = time.perf_counter()
        _run_pool(tp)
        dev.sync()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev.flush_cache()
        return wall, A

    warmed: set = set()

    def run_once(knobs: dict) -> float:
        # a tile size's first visit sets up the library's handles and
        # the wrapper's buffers for its shapes: off the clock, as in the
        # JAX stage
        nb = int(knobs["nb"])
        if nb not in warmed:
            warmed.add(nb)
            one(nb)
        return one(nb)[0]

    sig = workload_signature(_factor_ptg("cholesky", _factor_matrix(
        "cholesky", a, nb_bad)), size_hint=n)
    space = {"nb": KnobSpec(name="nb", lo=128, hi=4096, scale="log2")}
    _k1_reset(tg)                        # counts from here are the path's
    t0 = time.perf_counter()
    out = search(run_once, signature=sig, space=space, budget=TUNE_BUDGET,
                 restarts=1, objective="wall_s", seed=0,
                 start={"nb": nb_bad})
    search_s = time.perf_counter() - t0
    launches = tg.gemm_update.launches
    by_variant = dict(tg.gemm_update.launches_by_variant)
    by_form = dict(tg.gemm_update.launches_by_form)
    trials = [{"nb": t["knobs"]["nb"], "wall_s": t["score"]}
              for t in out["trials"]]
    # search takes a raising trial for a non-move; here every visited
    # tile size must have been scored on the card
    _check(not out["failed"], f"tuned_cholesky: trials raised "
           f"{out['failed']}")
    _check(trials and trials[0]["nb"] == nb_bad,
           f"tuned_cholesky: the first trial is {trials[:1]}, not the "
           f"seeded nb={nb_bad}")
    baseline_s = trials[0]["wall_s"]
    best = out["best"]
    tuned_s = float(out["best_score"])
    speedup = baseline_s / tuned_s
    _check(out["evals"] <= TUNE_BUDGET, f"tuned_cholesky: {out['evals']} "
           f"trials past the budget {TUNE_BUDGET}")
    _check(speedup >= TUNE_SPEEDUP_MIN, f"tuned_cholesky: tune_speedup "
           f"{speedup} below {TUNE_SPEEDUP_MIN} (trials {trials})")
    _check(best["nb"] >= 512, f"tuned_cholesky: the winner's nb "
           f"{best['nb']} is below 512")
    _check(launches > 0 and by_variant["mma_tf32"] == launches,
           f"tuned_cholesky: K1 ran {by_variant}, expected mma_tf32 only")
    _check(set(by_form) == K1_FORMS["cholesky"],
           f"tuned_cholesky: K1 forms {by_form}")
    rec_db = TuneDB().best(sig, objective="wall_s")
    _check(rec_db is not None and rec_db["knobs"] == best,
           f"tuned_cholesky: the tuning DB holds {rec_db} for {sig}")
    perf = PerfDB()
    for t in out["trials"]:
        hist = perf.history(make_key(f"tune.{sig}", "wall_s",
                                     knobs=t["knobs"]))
        _check(t["score"] in hist, f"tuned_cholesky: trial {t['knobs']} "
               f"is not in the perf ledger ({hist})")
    # correctness is not negotiable for a tuner: the winner's factor
    wall, A = one(int(best["nb"]))
    rec = dict(n=n, nb_bad=nb_bad, best_nb=int(best["nb"]),
               tune_speedup=speedup, baseline_s=baseline_s,
               tuned_s=tuned_s, check_wall_s=wall, trials=trials,
               evals=out["evals"], pruned=out["pruned"],
               search_s=search_s, signature=sig,
               db_path=out.get("db_path", ""),
               ledger_records=len(perf.records()),
               gemm_launches=launches, gemm_launches_by_variant=by_variant,
               gemm_launches_by_form=by_form,
               **_factor_check(torch, "cholesky", A.to_dense(), a,
                               int(best["nb"]), "default"))
    _emit(card, phase="path", name="tuned_cholesky", **rec)
    return rec


def phase_lowered_cache(card: str, torch, n: int = 16384,
                        nb: int = 512) -> dict:
    """The lowering cache at the headline GEMM (N=16384, nb=512, bf16 A/B,
    fp32 C): two freshly built pools lowered in turn, the second a hit on
    the first's step; ``warm()`` with no launch; then one pool submitted
    twice through ``RuntimeServer.submit_lowered``, each result's C held
    to the **lowered_gemm** phase's float64 check with one ``wgmma_bf16``
    launch each."""
    from parsec_tpu_torch.data_dist.matrix import TiledMatrix
    from parsec_tpu_torch.models.tiled_gemm import tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.ptg.lowering import lower_taskpool, lowering_cache
    from parsec_tpu_torch.serve import RuntimeServer

    g = torch.Generator(device="cuda").manual_seed(601)
    a_dev = torch.randn(n, n, device="cuda", generator=g).bfloat16()
    b_dev = torch.randn(n, n, device="cuda", generator=g).bfloat16()
    a_host, b_host = a_dev.cpu(), b_dev.cpu()

    def pool():
        return tiled_gemm_ptg(TiledMatrix.from_dense("A", a_host, nb, nb),
                              TiledMatrix.from_dense("B", b_host, nb, nb),
                              TiledMatrix("C", n, n, nb, nb,
                                          dtype=torch.float32))

    lowering_cache.clear()      # the headline phase lowered it already
    tp1, tp2 = pool(), pool()
    t0 = time.perf_counter()
    low1 = lower_taskpool(tp1)
    miss_s = time.perf_counter() - t0
    _check((lowering_cache.hits, lowering_cache.misses) == (0, 1),
           "lowered_cache: the first lowering was not a miss")
    t0 = time.perf_counter()
    low2 = lower_taskpool(tp2)
    hit_s = time.perf_counter() - t0
    _check((lowering_cache.hits, lowering_cache.misses) == (1, 1),
           "lowered_cache: the second lowering was not a hit")
    _check(low2.step_fn is low1.step_fn and low2.signature == low1.signature,
           "lowered_cache: the hit returned another step")
    _check(low2.mode == "chain-collapse", f"lowered_cache mode {low2.mode}")
    _k1_reset(tg)                        # counts from here are the path's
    warm = low2.warm()
    _check(tg.gemm_update.launches == 0,
           f"lowered_cache: warm() launched K1 {tg.gemm_update.launches}x")
    ref = a_dev.double() @ b_dev.double()
    subs = []
    with RuntimeServer(nb_cores=1) as server:
        for i in range(2):
            t0 = time.perf_counter()
            out = server.submit_lowered(tp1).result(timeout=600)
            wall = time.perf_counter() - t0
            c = out["C"]
            _check(c.device.type == "cpu" and c.shape == (n, n)
                   and c.dtype == torch.float32,
                   f"lowered_cache: C is {c.device} {tuple(c.shape)} "
                   f"{c.dtype}")
            got = c.cuda()
            _check(bool(torch.isfinite(got).all()),
                   "lowered_cache: C is not finite")
            err = (got.double() - ref).abs().max().item()
            _check(err <= 2e-2, f"lowered_cache: submission {i} max abs "
                   f"err {err} above 2e-2")
            by_variant = dict(tg.gemm_update.launches_by_variant)
            _check(tg.gemm_update.launches == i + 1
                   and by_variant["wgmma_bf16"] == i + 1,
                   f"lowered_cache: K1 ran {by_variant} after submission "
                   f"{i}, expected {i + 1} wgmma_bf16")
            subs.append(dict(wall_s=wall, max_abs_err=err))
            del out, c, got
        stats = server.stats()
    _check(lowering_cache.hits == 3 and lowering_cache.misses == 1,
           f"lowered_cache: {lowering_cache.hits} hits, "
           f"{lowering_cache.misses} misses after the submissions")
    rec = dict(n=n, nb=nb, mode=low2.mode, lower_miss_s=miss_s,
               lower_hit_s=hit_s, warm=warm, submissions=subs,
               cache_hits=lowering_cache.hits,
               cache_misses=lowering_cache.misses,
               served_completed=stats["completed"],
               gemm_launches=tg.gemm_update.launches,
               gemm_launches_by_variant=dict(
                   tg.gemm_update.launches_by_variant))
    _emit(card, phase="path", name="lowered_cache", **rec)
    del a_dev, b_dev, ref
    torch.cuda.empty_cache()
    return rec


def phase_llm_wide_adaptive(card: str, torch, seed: int = 11,
                            max_new: int = 32, seeded_k: int = 1) -> dict:
    """The ``llm_wide`` backlog with adaptive k (``tune_adaptive``): one
    tenant's vector (``llm_steps_per_pool`` = ``seeded_k``) is put in the
    tuning DB before the server starts, and the server's consult at that
    tenant's first stream seeds its controller; the other tenant starts
    at the default 8.  Every stream must equal the oracle (adaptation
    moves batching, never tokens), the seeded controller must start from
    its seed, and every adoption must be written back exactly once."""
    from parsec_tpu_torch.tune import TuneDB, ambient_signature

    seeded = "tenant0"
    db = TuneDB()
    db.note(ambient_signature(f"tenant:{seeded}"),
            {"llm_steps_per_pool": seeded_k}, 1e9,
            objective="tok_latency_ms", source="seed")

    def served(server, tickets, results):
        llm = server.stats()["llm"]
        ctl = llm.get("adaptive_k", {})
        return ({t: {k: v for k, v in c.items() if k != "start"}
                 for t, c in ctl.items()},
                {t: c["start"] for t, c in ctl.items()},
                llm.get("adaptive_k_seed", {}))

    with _Params(tune_adaptive=True):
        rec = phase_llm(card, torch, seed=seed, max_new=max_new,
                        label="llm_wide_adaptive", wide=True, served=served,
                        via_server=True)
    ctl, starts, seeds = rec["served"]
    _check(seeds == {seeded: seeded_k}, f"llm_wide_adaptive: the consult "
           f"seeded {seeds}, expected {{{seeded!r}: {seeded_k}}}")
    _check(starts == {"tenant0": seeded_k, "tenant1": 8},
           f"llm_wide_adaptive: the controllers started at {starts}")
    recs = [r for r in TuneDB().records() if r.get("source") == "adaptive"]
    trajectories = {}
    for tenant, st in sorted(ctl.items()):
        mine = [r["knobs"]["llm_steps_per_pool"] for r in recs
                if r["sig"] == ambient_signature(f"tenant:{tenant}")]
        _check(len(mine) == st["adoptions"], f"llm_wide_adaptive "
               f"{tenant}: {len(mine)} writebacks for {st['adoptions']} "
               f"adoptions")
        _check(not mine or mine[-1] == st["incumbent"],
               f"llm_wide_adaptive {tenant}: the last writeback {mine} is "
               f"not the incumbent {st['incumbent']}")
        trajectories[tenant] = [starts[tenant]] + mine
    out = dict(tokens=rec["tokens"], wall_s=rec["wall_s"],
               tokens_per_s=rec["tokens_per_s"],
               itl_ms_p50=rec["itl_ms_p50"], itl_ms_p99=rec["itl_ms_p99"],
               ttft_ms_p50=rec["ttft_ms_p50"],
               decode_submits=rec["decode_submits"],
               seeded_tenant=seeded, seeded_k=seeded_k,
               k_trajectories=trajectories, controllers=ctl,
               writebacks=len(recs),
               ragged_attn_page_launches=rec["ragged_attn_page_launches"])
    _emit(card, phase="path", name="llm_wide_adaptive_k", **out)
    rec.update(out)
    return rec


def _sharded_backlog(model, seed: int, sys_len: int = 1024):
    """16 streams at the ``llm_wide`` width: 8 share a ``sys_len``-token
    system prompt with seeded 16-64-token suffixes (as ``llm_prefix``),
    8 have their own prompts of 64-512 tokens."""
    import numpy as np
    _system, shared = _prefix_backlog(model, seed, n=8, sys_len=sys_len)
    rng = np.random.default_rng(seed + 1)
    own = [[int(t) for t in rng.integers(0, model.vocab,
                                         int(rng.integers(64, 513)))]
           for _ in range(8)]
    return shared, own


def _plane_run(nranks: int, model, frontend_fn, timeout: float = 600):
    """``run_multirank`` rank threads sharing the card, one
    ``ShardedRuntimeServer`` each, every rank's batcher at ``model``'s
    width and pinned to its rank; rank 0 runs ``frontend_fn(srv,
    peers)``, the others serve until its SHUTDOWN."""
    import threading

    from parsec_tpu_torch.comm.multirank import run_multirank
    from parsec_tpu_torch.serve import ShardedRuntimeServer

    bar = threading.Barrier(nranks)
    peers: dict = {}

    def body(ctx, rank, nranks):
        # the model is not the server's default: each rank's batcher
        # decodes at its width, pinned to the rank
        srv = ShardedRuntimeServer(ctx, llm_model=model)
        peers[rank] = srv
        bar.wait()
        if rank == 0:
            try:
                return frontend_fn(srv, peers)
            finally:
                srv.shutdown(timeout=timeout)
                bar.wait()
        try:
            srv.serve_forever(idle_timeout=timeout)
        finally:
            srv.close(timeout=timeout)
            bar.wait()
        return None

    return run_multirank(nranks, body, nb_cores=1, timeout=timeout)[0]


class _SLOTap:
    """Every sample the process's SLO planes record while open, raw, so
    that a bucket-merged summary can be held against one histogram of
    the union of the samples (``summary(n)``, over the first ``n``)."""

    def __enter__(self):
        from parsec_tpu_torch.prof.histogram import SLOPlane
        self._cls, orig = SLOPlane, SLOPlane.observe
        self._orig = orig
        self.samples: list = []
        samples = self.samples

        def observe(plane, tenant, metric, value):
            samples.append((tenant, metric, float(value)))
            orig(plane, tenant, metric, value)

        SLOPlane.observe = observe
        return self

    def __exit__(self, *exc):
        self._cls.observe = self._orig

    def summary(self, n: int) -> dict:
        from parsec_tpu_torch.prof.histogram import LogHistogram
        hists: dict = {}
        for tenant, metric, v in self.samples[:n]:
            hists.setdefault((tenant, metric), LogHistogram()).record(v)
        out: dict = {}
        for (tenant, metric), h in hists.items():
            d = out.setdefault(tenant, {})
            for q in (0.5, 0.99):
                d[f"{metric}_p{int(q * 100)}"] = round(h.quantile(q), 3)
            d[f"{metric}_count"] = h.count
        return out


def phase_llm_sharded(card: str, torch, seed: int = 29, max_new: int = 16,
                      nranks: int = 4, control_new: int = 32) -> dict:
    """One serving plane over four rank threads sharing the card
    (``ShardedRuntimeServer``), each rank's batcher decoding on K2 at the
    ``llm_wide`` width: 16 streams, 8 sharing a 1024-token system prompt.
    Every stream must equal the oracle; the shared-prompt streams after
    the first must follow its residency to its rank; ``metrics()`` must
    equal the bucket-merge of the four ranks' planes, with each count the
    sum of the ranks', and its quantiles must be those of one histogram
    of every sample the four planes recorded (:class:`_SLOTap`).  The
    control (the 8 own prompts, ``control_new``
    tokens each, so a stream is still live after its first burst) kills
    rank 2 once it shipped a token (``fail_rank``): its live streams
    finish on survivors, oracle-exact, with no duplicate token."""
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve.sharded import merge_planes

    model = _wide_model()
    shared, own = _sharded_backlog(model, seed)
    want_shared = [model.reference_generate(p, max_new) for p in shared]
    want_own = [model.reference_generate(p, max_new) for p in own]
    dev = _serving_card()
    before = dict(dev.tasks_by_class)

    def frontend(srv, peers):
        t0 = time.perf_counter()
        # an own prompt first (rank 0), then the first shared one (the
        # least-loaded rank), then the rest, alternating
        hs = [srv.submit_stream(own[0], max_new_tokens=max_new,
                                tenant="tenant1")]
        hs_shared = [srv.submit_stream(shared[0], max_new_tokens=max_new,
                                       tenant="tenant0")]
        for p_sh, p_own in zip(shared[1:], own[1:]):
            hs_shared.append(srv.submit_stream(p_sh, max_new_tokens=max_new,
                                               tenant="tenant0"))
            hs.append(srv.submit_stream(p_own, max_new_tokens=max_new,
                                        tenant="tenant1"))
        srv.wait(hs + hs_shared, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for h, w in zip(hs_shared + hs, want_shared + want_own):
            _check(h.result(timeout=1)["tokens"] == w,
                   f"llm_sharded: stream {h.sid} on rank {h.rank} differs "
                   f"from the oracle")
        home = hs_shared[0].rank
        _check(home != 0 and all(h.rank == home for h in hs_shared[1:]),
               f"llm_sharded: the shared-prompt streams went to "
               f"{[h.rank for h in hs_shared]}, not all to rank {home}")
        # a pool's latency sample lands just after its ticket resolves:
        # read metrics() when no sample landed while it was gathered
        for _ in range(100):
            n = len(tap.samples)
            m = srv.metrics(timeout=60)
            if len(tap.samples) == n:
                break
            time.sleep(0.05)
        union = tap.summary(n)
        hist_keys = {t: {k for k in d if k.endswith(("_p50", "_p99",
                                                     "_count"))}
                     for t, d in m["tenants"].items()}
        _check({t: ks for t, ks in hist_keys.items() if ks}
               == {t: set(d) for t, d in union.items()},
               f"llm_sharded: metrics() has the histograms {hist_keys}, "
               f"the samples make {sorted(union)}")
        for t, d in union.items():
            got = {k: m["tenants"][t][k] for k in d}
            _check(got == d, f"llm_sharded: {t} merged {got}, the union "
                   f"of the samples gives {d}")
        raw = [peers[r]._plane_dict() for r in sorted(peers)]
        _check(m["tenants"] == merge_planes(raw),
               "llm_sharded: metrics() is not the merge of the planes")
        counts = {}
        for t, d in sorted(m["tenants"].items()):
            for key, v in d.items():
                if not key.endswith("_count"):
                    continue
                metric = key[:-len("_count")]
                ranks = [plane[t][metric]["count"] for plane in raw
                         if metric in plane.get(t, {})]
                _check(v == sum(ranks), f"llm_sharded: {t} {key} {v} is "
                       f"not the ranks' sum {ranks}")
                counts[f"{t}.{key}"] = ranks
        return dict(wall_s=wall, ranks=[h.rank for h in hs_shared + hs],
                    home=home, tenants=m["tenants"], counts=counts,
                    union_samples=n,
                    tokens=sum(len(h.tokens) for h in hs + hs_shared))

    ra.attn_page_update.launches = 0     # counts from here are the path's
    with _SLOTap() as tap:
        run = _plane_run(nranks, model, frontend)
    launches = ra.attn_page_update.launches
    tasks = {c: k - before.get(c, 0) for c, k in dev.tasks_by_class.items()
             if k - before.get(c, 0)}
    _check(launches > 0, "llm_sharded: no ragged_attn_page launch")
    _check({"ATTN", "OUT", "SAMPLE", "PF"} <= set(tasks),
           f"llm_sharded: task classes on the card {sorted(tasks)}")
    rec = dict(streams=16, ranks_used=sorted(set(run["ranks"])),
               tokens=run["tokens"], wall_s=run["wall_s"],
               tokens_per_s=run["tokens"] / run["wall_s"],
               shared_home=run["home"], placement=run["ranks"],
               metric_counts_by_rank=run["counts"],
               union_samples=run["union_samples"],
               tenants=run["tenants"], tasks_by_class=tasks,
               ragged_attn_page_launches=launches)
    _emit(card, phase="path", name="llm_sharded", **rec)

    # the control: rank 2 dies mid-run; its streams requeue on survivors
    want_ctl = [model.reference_generate(p, control_new) for p in own]

    def killed(srv, peers):
        hs = [srv.submit_stream(p, max_new_tokens=control_new,
                                tenant=f"tenant{i % 2}")
              for i, p in enumerate(own)]
        on2 = [h for h in hs if h.rank == 2]
        _check(on2, "control llm_sharded: no stream on rank 2")
        deadline = time.monotonic() + 300
        while not any(h.tokens for h in on2):
            srv.step()
            _check(time.monotonic() < deadline,
                   "control llm_sharded: rank 2 shipped no token")
            time.sleep(0.002)
        peers[2].zombie = True
        victims = [h for h in on2 if not h.done()]
        _check(victims, "control llm_sharded: rank 2's streams finished "
               "before the kill")
        shipped = {h.sid: len(h.tokens) for h in victims}
        srv.fail_rank(2)
        _check(all(h.rank != 2 and h.requeues == 1 for h in victims),
               "control llm_sharded: a stream of rank 2 did not requeue")
        srv.wait(hs, timeout=600)
        for h, w in zip(hs, want_ctl):
            got = h.result(timeout=1)["tokens"]
            _check(got == w, f"control llm_sharded: stream {h.sid} "
                   f"(ranks {h.ranks}) differs from the oracle")
        peers[2].zombie = False
        deadline = time.monotonic() + 120
        while peers[2]._live and time.monotonic() < deadline:
            srv.step()
            time.sleep(0.005)
        srv.step()
        for h, w in zip(hs, want_ctl):
            _check(h.tokens == w, f"control llm_sharded: stream {h.sid} "
                   f"re-landed a token")
        return dict(victims=[h.sid for h in victims], shipped=shipped,
                    requeued_to=[h.rank for h in victims],
                    dup_tokens=sum(h.dup_tokens for h in victims))

    ra.attn_page_update.launches = 0
    ctl = _plane_run(nranks, model, killed)
    ctl_launches = ra.attn_page_update.launches
    _emit(card, phase="control", name="llm_sharded_fail_rank",
          ragged_attn_page_launches=ctl_launches, **ctl)
    rec["control"] = ctl
    rec["control_ragged_attn_page_launches"] = ctl_launches
    return rec


# the megakernel regions: the region Cholesky of the JAX bench's
# ``region_cholesky`` stage (bench.py:591-650)
REGION_BUDGET_S = 90.0


def _region_run(torch, plan, budget_s: float) -> dict:
    """Prepare ``plan`` under ``budget_s`` (the notes kept), then run its
    region pool to completion on a Context, timed as the JAX bench times
    it: the table's materialization is set-up, the write-back rides the
    pool's completion listener inside the clock."""
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    notes: list = []
    t0 = time.perf_counter()
    plan.compile(budget_s=budget_s, note=lambda **kw: notes.append(
        dict(kw, at_s=time.perf_counter() - t0)))
    prep_wall = time.perf_counter() - t0
    table = plan.materialize_table()
    torch.cuda.synchronize()
    _k1_reset(tg)                        # counts from here are the path's
    ctx = Context(nb_cores=0)
    try:
        t0 = time.perf_counter()
        ctx.add_taskpool(plan.taskpool(table))
        ctx.wait(timeout=600)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        ctx.fini(timeout=60)
    plan.finalize(table)                 # a no-op: the listener ran
    del table
    st = plan.stats()
    return dict(st, seconds=seconds, prepare_wall_s=prep_wall,
                notes=notes, gemm_launches=tg.gemm_update.launches,
                gemm_launches_by_variant=dict(
                    tg.gemm_update.launches_by_variant),
                gemm_launches_by_form=dict(tg.gemm_update.launches_by_form))


def _pair_error(torch, d1, d2, nb: int) -> float:
    """The tile error of one factor (on the host) against another, in
    float64 on the card: how far two incarnations disagree."""
    from parsec_tpu_torch.ops.factor import tile_error
    a = torch.tril(torch.from_numpy(d1).cuda().double())
    b = torch.tril(torch.from_numpy(d2).cuda().double())
    err = tile_error(a, b, nb)
    del a, b
    torch.cuda.empty_cache()
    return err


def phase_region_cholesky(card: str, torch, n: int = 8192,
                          nb: int = 512) -> dict:
    """The Cholesky lowered to megakernel regions on the card (the JAX
    bench's ``region_cholesky`` stage at its size), three ways: prepared
    under the 90 s budget; with a budget so small that the regions after
    the first shed to the eager path (a cold cache); and the whole-pool
    ``lower_taskpool`` at the same n.  The three factors must agree with
    each other and with the float64 factor under the TF32 gate."""
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.models.cholesky import cholesky_flops
    from parsec_tpu_torch.ptg.lowering import (lower_regions, lower_taskpool,
                                               lowering_cache)
    from parsec_tpu_torch.ops import gemm as tg

    params.set("gemm_precision", "default")
    nt = n // nb
    want_tasks = sum(_expected_tasks("cholesky", nt).values())
    flops = cholesky_flops(n)
    a, A = _factor_input("cholesky", n, nb)
    t0 = time.perf_counter()
    plan = lower_regions(_factor_ptg("cholesky", A))
    lower_s = time.perf_counter() - t0
    _check(plan.stats()["ntasks"] == want_tasks,
           f"region_cholesky: {plan.stats()['ntasks']} tasks, expected "
           f"{want_tasks}")
    run = _region_run(torch, plan, REGION_BUDGET_S)
    data = sum(r.step_fn is not None for r in plan.regions)
    _check(run["regions_compiled"] == data and run["regions_eager"] == 0,
           f"region_cholesky: {run['regions_compiled']} of {data} regions "
           f"prepared under {REGION_BUDGET_S} s")
    _check(run["xla_calls"] == data,
           f"region_cholesky: {run['xla_calls']} prepared-step calls for "
           f"{data} regions")
    launches = run["gemm_launches"]
    _check(launches > 0
           and run["gemm_launches_by_variant"]["mma_tf32"] == launches,
           f"region_cholesky: K1 ran {run['gemm_launches_by_variant']}")
    _check(set(run["gemm_launches_by_form"]) == K1_FORMS["cholesky"],
           f"region_cholesky: K1 forms {run['gemm_launches_by_form']}")
    dense = A.to_dense()
    checks = _factor_check(torch, "cholesky", dense, a, nb, "default")
    del A

    # the same structure on a cold cache, under a budget that admits the
    # first (smallest) region and that its preparation overruns, so the
    # rate it measures sheds the rest: the cost of the first region's
    # cache probe (timed here, twice for the sort) plus half the least
    # preparation of a later region in the run above (the first one's
    # also loaded the kernel libraries)
    starts = [x["at_s"] for x in run["notes"] if x.get("compiling")]
    preps = [x["compile_s"] for x in run["notes"] if "compile_s" in x
             and not x.get("cached")]
    lowering_cache.clear()
    A2 = _factor_matrix("cholesky", a, nb)
    plan2 = lower_regions(_factor_ptg("cholesky", A2))
    smallest = min(plan2.regions, key=lambda r: r.ntasks)
    t0 = time.perf_counter()
    lowering_cache.peek(plan2._cache_key(smallest))
    probe = time.perf_counter() - t0
    budget = 2 * probe + 0.5 * min(preps[1:] or preps)
    shed = _region_run(torch, plan2, budget)
    _check(shed["regions_eager"] >= 1
           and shed["regions_compiled"] + shed["regions_eager"] == data,
           f"region_cholesky shed: {shed['regions_compiled']} prepared, "
           f"{shed['regions_eager']} eager of {data} under {budget} s")
    eager_flags = [bool(x.get("eager")) for x in shed["notes"]
                   if "compiling" not in x]
    _check(eager_flags == sorted(eager_flags),
           f"region_cholesky shed: shedding not monotone {eager_flags}")
    dense_shed = A2.to_dense()
    shed_checks = _factor_check(torch, "cholesky", dense_shed, a, nb,
                                "default")
    del A2

    A3 = _factor_matrix("cholesky", a, nb)
    low = lower_taskpool(_factor_ptg("cholesky", A3))
    _k1_reset(tg)
    t0 = time.perf_counter()
    low.execute()
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    whole_launches = tg.gemm_update.launches
    dense_whole = A3.to_dense()
    whole_checks = _factor_check(torch, "cholesky", dense_whole, a, nb,
                                 "default")
    del A3, low
    pairs = {"compiled_vs_shed": _pair_error(torch, dense, dense_shed, nb),
             "compiled_vs_whole": _pair_error(torch, dense, dense_whole,
                                              nb),
             "shed_vs_whole": _pair_error(torch, dense_shed, dense_whole,
                                          nb)}
    for what, err in pairs.items():
        _check(err <= FACTOR_TOL["default"],
               f"region_cholesky: {what} tile error {err} above "
               f"{FACTOR_TOL['default']}")
    del dense, dense_shed, dense_whole
    rec = dict(n=n, nb=nb, tasks=want_tasks,
               region_max_tasks=params.get("lowering_region_max_tasks"),
               regions=run["regions"], regions_compiled=run[
                   "regions_compiled"], regions_eager=run["regions_eager"],
               region_tasks=[r.ntasks for r in plan.regions],
               region_preds=[sorted(r.preds) for r in plan.regions],
               lower_s=lower_s, compile_s=run["compile_s"],
               trace_s=run["trace_s"], prepare_wall_s=run["prepare_wall_s"],
               budget_s=REGION_BUDGET_S, xla_calls=run["xla_calls"],
               seconds=run["seconds"], gflops=flops / run["seconds"] / 1e9,
               gemm_launches=launches,
               gemm_launches_by_variant=run["gemm_launches_by_variant"],
               gemm_launches_by_form=run["gemm_launches_by_form"],
               **checks,
               prepare_s_by_region=preps, prepare_start_s=starts,
               shed=dict(budget_s=budget, probe_s=probe,
                         prepare_start_s=[x["at_s"] for x in shed["notes"]
                                          if x.get("compiling")],
                         regions_compiled=shed["regions_compiled"],
                         regions_eager=shed["regions_eager"],
                         compile_s=shed["compile_s"],
                         eager_runs=shed["eager_runs"],
                         xla_calls=shed["xla_calls"],
                         seconds=shed["seconds"],
                         gflops=flops / shed["seconds"] / 1e9,
                         gemm_launches=shed["gemm_launches"],
                         gemm_launches_by_form=shed["gemm_launches_by_form"],
                         tile_error=shed_checks["tile_error"]),
               whole_pool=dict(execute_s=whole_s,
                               gflops=flops / whole_s / 1e9,
                               gemm_launches=whole_launches,
                               tile_error=whole_checks["tile_error"]),
               pair_tile_errors=pairs)
    _emit(card, phase="path", name="region_cholesky", **rec)
    return rec


def _wide_serve(torch, model, backlog: list, max_new: int) -> tuple:
    """The backlog through a ``ContinuousBatcher`` of the wide model on a
    ``RuntimeServer(nb_cores=2)``: the results, the wall, the batcher's
    stats and K2's launches."""
    from parsec_tpu_torch.llm import ContinuousBatcher
    from parsec_tpu_torch.ops import ragged_attention as ra
    from parsec_tpu_torch.serve import RuntimeServer

    ra.attn_page_update.launches = 0
    t0 = time.perf_counter()
    with RuntimeServer(nb_cores=2) as server:
        batcher = ContinuousBatcher(server, model=model)
        tickets = [batcher.submit_stream(p, max_new_tokens=max_new,
                                         tenant=t)
                   for p, t, _f, _e in backlog]
        results = [tk.result(timeout=600) for tk in tickets]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = batcher.stats()
        batcher.stop()
    return results, wall, stats, ra.attn_page_update.launches


def phase_llm_wide_regions(card: str, torch, seed: int = 11, n: int = 8,
                           max_new: int = 16) -> dict:
    """The llm_wide width (ToyLM with 32 heads of 128) with
    ``llm_lower_regions`` on: 8 streams, 16 new tokens, every decode pool
    lowered to regions (its ATTN on K2 through the ``ragged_attn_page``
    traceable); every stream the oracle's, beside the same streams with
    the option off (off, on, on, off)."""
    from parsec_tpu_torch.core.params import params

    model, backlog = _wide_backlog(seed, n=n)
    want = [model.reference_generate(p, max_new) for p, *_ in backlog]
    runs = {}
    for i, on in enumerate((False, True, True, False)):
        params.set("llm_lower_regions", on)
        try:
            results, wall, stats, launches = _wide_serve(
                torch, model, backlog, max_new)
        finally:
            params.set("llm_lower_regions", False)
        for j, (r, w) in enumerate(zip(results, want)):
            _check(r["tokens"] == w,
                   f"llm_wide_regions ({'on' if on else 'off'}): stream {j} "
                   f"differs from the oracle")
        ntok = sum(len(r["tokens"]) for r in results)
        runs.setdefault("on" if on else "off", []).append(dict(
            wall_s=wall, tokens=ntok, tokens_per_s=ntok / wall,
            ragged_attn_page_launches=launches,
            decode_submits=stats["decode_submits"],
            regions=stats.get("regions")))
    on = runs["on"]
    for r in on:
        reg = r["regions"] or {}
        _check(reg.get("pools", 0) == r["decode_submits"] > 0
               and reg.get("fallbacks", 1) == 0,
               f"llm_wide_regions: region pools {reg}, decode submits "
               f"{r['decode_submits']}")
        _check(r["ragged_attn_page_launches"] > 0,
               "llm_wide_regions: the region pools launched no K2")
    first = on[0]
    rec = dict(streams=n, heads=model.num_heads, head_dim=model.head_dim,
               max_new=max_new, tokens=first["tokens"],
               superpools_lowered=first["regions"]["pools"],
               superpools_fallback=first["regions"]["fallbacks"],
               regions=first["regions"]["regions"],
               regions_per_superpool=first["regions"]["regions"]
               / first["regions"]["pools"],
               ragged_attn_page_launches=first["ragged_attn_page_launches"],
               wall_s=[r["wall_s"] for r in on],
               tokens_per_s=[r["tokens_per_s"] for r in on],
               off_wall_s=[r["wall_s"] for r in runs["off"]],
               off_tokens_per_s=[r["tokens_per_s"] for r in runs["off"]],
               off_ragged_attn_page_launches=[
                   r["ragged_attn_page_launches"] for r in runs["off"]],
               order="off, on, on, off")
    _emit(card, phase="path", name="llm_wide_regions", **rec)
    return rec


COMM_AGREE_RELERR_MAX = 0.15     # the JAX package's agreement gate


def _grid_pool(kind: str, n: int, nb: int):
    """The pool of ``mp_bodies`` for ``kind`` on rank 0's view of the
    2 x 2 grid, no tile made: commcheck reads geometry and owners."""
    from parsec_tpu_torch.data_dist.matrix import (SymTwoDimBlockCyclic,
                                                   TwoDimBlockCyclic)
    kw = dict(P=MR_P, Q=MR_Q, myrank=0)
    if kind == "gemm":
        mats = [TwoDimBlockCyclic(x, n, n, nb, nb, **kw) for x in "ABC"]
    else:
        cls = SymTwoDimBlockCyclic if kind == "cholesky" \
            else TwoDimBlockCyclic
        mats = [cls("A", n, n, nb, nb, **kw)]
    from parsec_tpu_torch.comm.mp_bodies import _pool
    return _pool(kind, tuple(mats), "cuda")


def phase_commcheck(card: str, torch, multiproc: dict, n: int = 8192,
                    nb: int = 1024) -> dict:
    """commcheck over the four-rank GEMM, Cholesky and LU pools of the
    ``multiproc_*`` phases (2 x 2 grid, their sizes), each pool's
    predicted cross-rank bytes held against the payload bytes those runs
    landed through their GETs (not run again); then
    ``predict_collective_traffic(4)`` against one four-process run of the
    collectives' body (its framed bytes on the wire, as the JAX bench
    compares them).  The gate is the JAX agreement gate, 15% relative."""
    from parsec_tpu_torch.analysis.commcheck import (
        agreement_rel_err, check_comm, predict_collective_traffic)
    from parsec_tpu_torch.comm import run_multiproc

    out = {}
    for kind in MP_KINDS:
        t0 = time.perf_counter()
        cr = check_comm(_grid_pool(kind, n, nb), nb_ranks=MR_RANKS)
        check_s = time.perf_counter() - t0
        measured = multiproc[f"multiproc_{kind}"]["payload_in_by_rank"]
        pred_by_rank = [sum(b for (_s, d), b in cr.rank_bytes.items()
                            if d == r) for r in range(MR_RANKS)]
        # the rank bodies build their input tiles on every rank (SPMD),
        # so only activations cross: the GEMM's collection reads of A and
        # B stay on each rank
        err = agreement_rel_err(cr.activation_bytes, sum(measured))
        _check(cr.ok, f"commcheck {kind}: {[repr(f) for f in cr.errors]}")
        _check(err <= COMM_AGREE_RELERR_MAX,
               f"commcheck {kind}: predicted {cr.activation_bytes} "
               f"activation bytes, the run landed {sum(measured)} "
               f"(rel err {err})")
        rec = dict(kind=kind, ranks=MR_RANKS, grid=[MR_P, MR_Q], n=n,
                   nb=nb, tasks=cr.ntasks, pattern=cr.pattern,
                   compared="payload", predicted_bytes=cr.total_bytes,
                   predicted_activation_bytes=cr.activation_bytes,
                   predicted_read_bytes=cr.read_bytes,
                   predicted_bytes_by_rank=pred_by_rank,
                   measured_payload_bytes=sum(measured),
                   measured_payload_by_rank=measured,
                   rel_err=err, edge_classes=dict(cr.edge_bytes),
                   recommended_tree=cr.to_dict()["recommended_tree"],
                   check_s=check_s)
        _emit(card, phase="commcheck", name=f"multiproc_{kind}", **rec)
        out[kind] = rec
    pred = predict_collective_traffic(MR_RANKS)
    t0 = time.perf_counter()
    res = run_multiproc(
        MR_RANKS, "parsec_tpu_torch.comm.collectives:_mp_collective_body",
        timeout=240, nb_cores=1)
    launch_s = time.perf_counter() - t0
    _check(len({r["digest"] for r in res}) == 1,
           "commcheck collectives: the broadcast's copies differ")
    _check(res[0]["reduce0"] == float(sum(range(1, MR_RANKS + 1))),
           f"commcheck collectives: the reduction gave {res[0]['reduce0']}")
    observed = sum(d["bytes"] for r in res
                   for d in r["peer_stats"]["tx"].values())
    err = agreement_rel_err(pred["total_bytes"], observed)
    _check(err <= COMM_AGREE_RELERR_MAX,
           f"commcheck collectives: predicted {pred['total_bytes']}, the "
           f"wire carried {observed} (rel err {err})")
    coll = dict(ranks=MR_RANKS, compared="framed", predicted=pred,
                observed_tx_bytes=observed, rel_err=err,
                root_tx_bytes=sum(d["bytes"] for d in
                                  res[0]["peer_stats"]["tx"].values()),
                bcast_s=max(r["bcast_s"] for r in res),
                reduce_s=max(r["reduce_s"] for r in res),
                launch_s=launch_s, tree=res[0]["tree"])
    _emit(card, phase="commcheck", name="collectives", **coll)
    out["collectives"] = coll
    return out


# ---------------------------------------------------------------------------
# the JDF front-end, the multi-rank stencils, the legacy framing, the
# mid-tree fault path and the examples ladder
# ---------------------------------------------------------------------------

# ``tests/test_jdf.py``'s GEMM_JDF with a CUDA body ahead of its Python
# body (``tests/test_torch_jdf.py`` holds the two texts together)
JDF_GEMM = """
%{
import numpy as np
%}
A [type = data]
B [type = data]
C [type = data]
MT [type = int]
NT [type = int]
KT [type = int]

GEMM(m, n, k)
  m = 0 .. MT-1
  n = 0 .. NT-1
  k = 0 .. KT-1
  : C(m, n)
  READ X <- A(m, k)
  READ Y <- B(k, n)
  RW   Z <- (k == 0) ? C(m, n) : Z GEMM(m, n, k-1)
        -> (k < KT-1) ? Z GEMM(m, n, k+1) : C(m, n)
  ; KT - k
BODY [type = cuda dyld = gemm]
END
BODY
  Z += X @ Y
END
"""


def phase_jdf_gemm(card: str, torch, path: dict, n: int = 8192,
                   nb: int = 1024, seed: int = 0) -> dict:
    """Phase ``path``'s GEMM built from JDF text (:data:`JDF_GEMM`): the
    CUDA body runs every task through K1, the Python body none; C within
    the TF32 gate of the float64 product, K1's launches by variant equal
    to ``path``'s.  The JDF's parse and build seconds beside the DSL
    builder's."""
    from parsec_tpu_torch import ptg
    from parsec_tpu_torch.core.params import params
    from parsec_tpu_torch.device import registry
    from parsec_tpu_torch.device.cuda import init_cuda_devices
    from parsec_tpu_torch.models.tiled_gemm import gemm_flops, tiled_gemm_ptg
    from parsec_tpu_torch.ops import gemm as tg
    from parsec_tpu_torch.runtime import Context

    params.set("gemm_precision", "default")
    A, B, C, _ = _path_mats(n, nb, seed)
    t0 = time.perf_counter()
    jdf = ptg.parse_jdf(JDF_GEMM, "jdf_gemm")
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = jdf.build(A=A, B=B, C=C, MT=C.mt, NT=C.nt, KT=A.nt)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiled_gemm_ptg(A, B, C)           # the DSL's build, for scale only
    dsl_build_s = time.perf_counter() - t0
    chores = [c.device_type for c in tp.task_class("GEMM").chores]
    _check(chores == ["cuda", "cpu"], f"jdf_gemm: chores {chores}")
    python_ran = []
    cpu_chore = tp.task_class("GEMM").chores[1]
    inner = cpu_chore.hook

    def counted(es, task):
        python_ran.append(task.key)
        return inner(es, task)
    cpu_chore.hook = counted
    dev = init_cuda_devices()[0]
    cpu = registry.get(0)
    cpu_before, dev_before = cpu.executed_tasks, dev.executed_tasks
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
    ran = dev.executed_tasks - dev_before
    _check(ran == 512, f"jdf_gemm: {ran} tasks on the card, expected 512")
    _check(not python_ran and cpu.executed_tasks == cpu_before,
           f"jdf_gemm: the Python body ran {len(python_ran)} tasks")
    _check(by_variant == path["gemm_launches_by_variant"],
           f"jdf_gemm: K1 ran {by_variant}, path "
           f"{path['gemm_launches_by_variant']}")
    worst = _check_c(torch, C.to_dense(), A.to_dense(), B.to_dense(), nb,
                     "jdf_gemm")
    rec = dict(n=n, nb=nb, tasks=ran, python_body_tasks=len(python_ran),
               wall_s=wall, path_wall_s=path["wall_s"],
               gflops=gemm_flops(n, n, n) / wall / 1e9,
               parse_s=parse_s, build_s=build_s, dsl_build_s=dsl_build_s,
               gemm_launches=launches, gemm_launches_by_variant=by_variant,
               max_abs_err=worst)
    _emit(card, phase="path", name="jdf_gemm", **rec)
    return rec


STENCIL_JDF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "parsec_tpu_torch", "examples", "jdf",
                           "stencil_1D.jdf")


def phase_multirank_stencil(card: str, torch, n: int = 1 << 24,
                            mb: int = 1 << 18, radius: int = 4,
                            iterations: int = 8, seed: int = 5) -> dict:
    """The 1-D stencil on 4 rank threads (host bodies, as in the JAX
    package), twice: ``stencil_1d_ptg`` on a float64 vector of n in
    segments of mb, then the port's ``stencil_1D.jdf`` on 1-row tiles of
    mb interior columns and 2R ghosts, whose halos to another rank ship
    the ``LR`` wire region (R columns).  Each against
    ``stencil_reference`` in float64; the JDF run's every halo payload
    is ``rows * R * itemsize`` bytes and its landed total equals
    commcheck's predicted activation bytes (the ptg run's too)."""
    import numpy as np

    from parsec_tpu_torch import ptg
    from parsec_tpu_torch.analysis.commcheck import check_comm
    from parsec_tpu_torch.comm import run_multirank
    from parsec_tpu_torch.data_dist.matrix import (TwoDimBlockCyclic,
                                                   VectorTwoDimCyclic)
    from parsec_tpu_torch.models.stencil import (stencil_1d_ptg,
                                                 stencil_flops,
                                                 stencil_reference)

    R, nt, nranks = radius, n // mb, MR_RANKS
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n)
    w = rng.random(2 * R + 1)
    w /= w.sum()
    want = stencil_reference(torch.from_numpy(base).cuda(),
                             torch.from_numpy(w).cuda(), iterations)
    nbj, rows = mb + 2 * R, 1

    def vector(rank):
        return VectorTwoDimCyclic(
            "V", lm=n, mb=mb, P=nranks, myrank=rank, dtype=torch.float64,
            init_fn=lambda m, size: base[m * mb:m * mb + size])

    def desc(rank):
        def init(m, j, shape):
            tile = np.zeros(shape)
            if m == 0:
                tile[:, R:R + mb] = base[j * mb:(j + 1) * mb]
            return tile
        return TwoDimBlockCyclic("descA", lm=2 * rows, ln=nt * nbj, mb=rows,
                                 nb=nbj, P=1, Q=nranks, myrank=rank,
                                 dtype=torch.float64, init_fn=init)

    def jdf_pool(d):
        return ptg.load_jdf(STENCIL_JDF).build(
            descA=d, iter=iterations, R=R, W=w, LMT=2, LNT=nt)

    def body(kind):
        def fn(ctx, rank, nranks_):
            coll = vector(rank) if kind == "ptg" else desc(rank)
            tiles = ([(i,) for i in range(coll.mt)] if kind == "ptg"
                     else [(0, j) for j in range(nt)])
            for key in tiles:
                if coll.rank_of(*key) == rank:
                    coll.data_of(*key)        # set-up, off the clock
            tp = (stencil_1d_ptg(coll, w, iterations) if kind == "ptg"
                  else jdf_pool(coll))
            seen = []
            eng = ctx.comm_engine
            inner = eng._complete_incoming

            def landed(tp_, src, msg, payloads):
                # each remote halo's payload, as it lands
                seen.extend(int(v.numel() * v.element_size())
                            for v in payloads.values())
                return inner(tp_, src, msg, payloads)
            eng._complete_incoming = landed
            t_add = time.perf_counter()
            ctx.add_taskpool(tp)
            ntasks = tp.nb_local_tasks()
            ctx.wait(timeout=600)
            t_wait = time.perf_counter()
            ctx.comm_barrier()
            if kind == "ptg":
                out = {i: coll.data_of(i).newest_copy().value.clone()
                       for i in range(coll.mt) if coll.rank_of(i) == rank}
            else:
                m = iterations % 2
                out = {j: coll.data_of(m, j).newest_copy().value[
                    0, R:R + mb].clone()
                    for j in range(nt) if coll.rank_of(m, j) == rank}
            return dict(out=out, tasks=ntasks, t_add=t_add, t_wait=t_wait,
                        staged=eng.payload_bytes_staged,
                        received=eng.payload_bytes_received,
                        landed=seen)
        return fn

    out = {}
    for kind in ("ptg", "jdf"):
        res = run_multirank(nranks, body(kind), timeout=900)
        got = torch.cat([r["out"][j] for j in range(nt) for r in res
                         if j in r["out"]]).cuda()
        _check(got.shape == (n,) and got.dtype == torch.float64,
               f"multirank_stencil {kind}: result {tuple(got.shape)} "
               f"{got.dtype}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        _check(err <= 1e-12 * max(scale, 1.0),
               f"multirank_stencil {kind}: max abs err {err} from the "
               f"float64 reference")
        cc = check_comm(stencil_1d_ptg(vector(0), w, iterations)
                        if kind == "ptg" else jdf_pool(desc(0)),
                        nb_ranks=nranks)
        received = [r["received"] for r in res]
        landed = [x for r in res for x in r["landed"]]
        _check(cc.ok and cc.activation_bytes == sum(received),
               f"multirank_stencil {kind}: commcheck predicts "
               f"{cc.activation_bytes} activation bytes, the ranks landed "
               f"{received}")
        if kind == "jdf":
            region = rows * R * 8
            _check(landed and set(landed) == {region},
                   f"multirank_stencil jdf: halo payloads "
                   f"{sorted(set(landed))} bytes, the LR region is "
                   f"{region}")
            _check(sum(received) == len(landed) * region,
                   f"multirank_stencil jdf: {received} bytes landed for "
                   f"{len(landed)} halos")
        wall = max(r["t_wait"] for r in res) - min(r["t_add"] for r in res)
        rec = dict(kind=kind, n=n, mb=mb, radius=R, iterations=iterations,
                   ranks=nranks, wall_s=wall,
                   gflops=stencil_flops(n, R, iterations) / wall / 1e9,
                   tasks_by_rank=[r["tasks"] for r in res],
                   staged_bytes_by_rank=[r["staged"] for r in res],
                   landed_bytes_by_rank=received, halos=len(landed),
                   halo_bytes=sorted(set(landed)),
                   commcheck_activation_bytes=cc.activation_bytes,
                   commcheck_pattern=cc.pattern, max_abs_err=err)
        _emit(card, phase="path", name=f"multirank_stencil_{kind}", **rec)
        out[kind] = rec
    return out


def phase_multiproc_legacy_wire(card: str, torch, multiproc: dict,
                                n: int = 8192, nb: int = 1024,
                                seed: int = 0) -> dict:
    """The four-process Cholesky of ``multiproc_cholesky`` with
    ``comm_wire_binary`` off (the legacy length-prefixed pickle framing,
    a GET's payload whole) and on, in turns (off, on, on, off), a launch
    each: the legacy factor equal to the binary one to every digit, GETs
    and payload bytes equal; the framed bytes and the wall of each."""
    from parsec_tpu_torch.comm.mp_bodies import factor_input

    a = factor_input("cholesky", n)
    runs, dense0 = [], {}
    for binary in (False, True, True, False):
        res, launch_s = _mp_launch(torch, ("cholesky",), n, nb, seed, {
            "PARSEC_MCA_comm_wire_binary": "1" if binary else "0"})
        recs = [r["kinds"]["cholesky"] for r in res]
        dense = _mp_dense(recs, n, nb)
        checks = _factor_check(torch, "cholesky", dense, a, nb, "default")
        if binary not in dense0:
            dense0[binary] = dense
        else:
            _check(bool((dense == dense0[binary]).all()),
                   f"multiproc_legacy_wire: binary={binary} factors differ "
                   f"between runs")
            del dense
        gets = [r["gets"] for r in recs]
        tiers = [{k: r["tiers"][k] for k in ("payload_in", "payload_out")}
                 for r in recs]
        _check(gets == multiproc["multiproc_cholesky"]["gets_by_rank"],
               f"multiproc_legacy_wire: GETs {gets}")
        _check([t["payload_in"] for t in tiers]
               == multiproc["multiproc_cholesky"]["payload_in_by_rank"],
               f"multiproc_legacy_wire: payload {tiers}")
        frags = [r["frags_in"] for r in recs]
        # a legacy GET comes back whole, in one pickled reply
        _check(binary or not sum(frags),
               f"multiproc_legacy_wire: the legacy framing landed {frags} "
               f"fragments")
        launches = sum(r["k1"] for r in recs)
        run = dict(comm_wire_binary=binary,
                   wall_s=max(r["t_wait"] for r in recs)
                   - min(r["t_add"] for r in recs),
                   launch_s=launch_s, gets_by_rank=gets,
                   payload_in_by_rank=[t["payload_in"] for t in tiers],
                   wire_sent_by_rank=[r["tiers"]["wire_total_sent"]
                                      for r in recs],
                   frags_in_by_rank=frags,
                   get_ms_mean=(sum(r["tier_s"]["get_s"] for r in recs)
                                / max(1, sum(gets)) * 1e3),
                   tier_seconds={hop: [r["tier_s"][hop] for r in recs]
                                 for hop in ("d2h_s", "send_s", "recv_s",
                                             "h2d_s", "get_s")},
                   gemm_launches=launches,
                   gemm_launches_by_variant=_by_variant(_sum_counts(
                       r["k1_by_variant"] for r in recs)), **checks)
        _emit(card, phase="path", name="multiproc_legacy_wire", **run)
        runs.append(run)
    _check(bool((dense0[False] == dense0[True]).all()),
           "multiproc_legacy_wire: the legacy factor differs from the "
           "binary one")
    return dict(gemm_launches=sum(r["gemm_launches"] for r in runs),
                gemm_launches_by_variant=_sum_counts(
                    r["gemm_launches_by_variant"] for r in runs),
                walls={"legacy": [r["wall_s"] for r in runs
                                  if not r["comm_wire_binary"]],
                       "binary": [r["wall_s"] for r in runs
                                  if r["comm_wire_binary"]]})


def phase_resume_get(card: str, torch, nb: int = 1024,
                     device: str = "cuda") -> dict:
    """The mid-tree fault path on 4 rank engines sharing the card (the
    device fabric): rank 0 holds a 4 MiB tile, rank 1 (the staging
    parent) a staged copy; ranks 2 and 3 pull it from rank 1 in 256 KiB
    fragments, two in flight.  Rank 1 dies after its first window; a
    zombie fragment of it lands late at rank 2; both resume from rank 0
    (the grandparent), which serves only the missing offsets.  Gates:
    each copy equal to the root's, each offset landed exactly once."""
    from parsec_tpu_torch.comm.device_fabric import DeviceFabric
    from parsec_tpu_torch.comm.engine import AM_TAG_GET_FRAG
    from parsec_tpu_torch.core.params import params

    frag, window = 256 << 10, 2
    saved = {k: params.get(k) for k in ("comm_get_frag_bytes",
                                        "comm_get_window")}
    params.set("comm_get_frag_bytes", frag)
    params.set("comm_get_window", window)
    try:
        dev0 = torch.device(device, 0) if device == "cuda" \
            else torch.device(device)
        fabric = DeviceFabric(MR_RANKS, [dev0] * MR_RANKS)
        eng = [fabric.attach(r) for r in range(MR_RANKS)]
        g = torch.Generator(device=dev0).manual_seed(3)
        tile = torch.randn(nb, nb, device=dev0, generator=g)
        nfrags = tile.numel() * 4 // frag
        h0 = eng[0].mem_register(tile, refcount=2)
        h1 = eng[1].mem_register(tile, refcount=2)
        got, gids = {}, {}
        for r in (2, 3):
            gids[r] = eng[r].get(h1.wire(),
                                 lambda v, r=r: got.__setitem__(r, v))
        eng[1].progress()                 # the parent serves one window
        for r in (2, 3):
            eng[r].progress()             # each child lands it
        partial = {}
        for r in (2, 3):
            with eng[r]._frag_lock:
                partial[r] = sorted(eng[r]._landing[gids[r]].landed)
        _check(all(len(p) == window for p in partial.values()) and not got,
               f"resume_get: partial windows {partial}, done {sorted(got)}")
        # a zombie fragment the dead parent had already sent
        off = partial[2][0]
        zombie = tile.reshape(-1)[off // 4:(off + frag) // 4].clone()
        fabric.deliver(2, AM_TAG_GET_FRAG, 1,
                       (gids[2], off, frag, None, zombie))
        eng[2].progress()
        t0 = time.perf_counter()
        for r in (2, 3):
            _check(eng[r].resume_get(h0.wire(), gids[r]),
                   f"resume_get: rank {r} had nothing to resume")
            eng[r].on_peer_failed(1)
        for _ in range(4 * nfrags):
            for r in (0, 2, 3):
                eng[r].progress()
            if len(got) == 2:
                break
        if dev0.type == "cuda":
            torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        _check(sorted(got) == [2, 3], f"resume_get: landed {sorted(got)}")
        for r in (2, 3):
            _check(torch.equal(got[r], tile),
                   f"resume_get: rank {r}'s copy differs from the root's")
            _check(eng[r].frags_in == nfrags,
                   f"resume_get: rank {r} landed {eng[r].frags_in} "
                   f"fragments of {nfrags}")
        _check(eng[2].dup_frags == 1 and eng[3].dup_frags == 0,
               f"resume_get: deduplicated {eng[2].dup_frags}, "
               f"{eng[3].dup_frags}")
        resumed = eng[0].frags_out
        _check(resumed == 2 * (nfrags - window),
               f"resume_get: the grandparent served {resumed} fragments, "
               f"expected {2 * (nfrags - window)}")
        for r in (2, 3):
            with eng[r]._frag_lock:
                _check(gids[r] not in eng[r]._landing,
                       f"resume_get: rank {r}'s zone did not retire")
        rec = dict(ranks=MR_RANKS, tile_bytes=tile.numel() * 4,
                   frag_bytes=frag, window=window, fragments=nfrags,
                   landed_before_death=partial,
                   resumed_fragments=resumed,
                   dedup_fragments=eng[2].dup_frags + eng[3].dup_frags,
                   frags_in_by_rank=[e.frags_in for e in eng],
                   resume_s=resume_s)
        _emit(card, phase="control", name="resume_get", **rec)
        for e in eng:
            e.fini()
        return rec
    finally:
        for k, v in saved.items():
            params.set(k, v)


EXAMPLES = ("Ex00_StartStop", "Ex01_HelloWorld", "Ex02_Chain",
            "Ex03_ChainMPI", "Ex04_ChainData", "Ex05_Broadcast", "Ex06_RAW",
            "Ex07_RAW_CTL", "Ex10_WireHalo", "Ex11_Serve", "Ex12_LLMServe")


def phase_examples(card: str, torch) -> dict:
    """The port's examples ladder on the card machine, each ``main()``
    self-checking; Ex12 serves its streams on the card through K2."""
    import contextlib
    import importlib
    import io

    from parsec_tpu_torch.ops import ragged_attention as ra

    seconds, k2 = {}, 0
    for name in EXAMPLES:
        mod = importlib.import_module(f"parsec_tpu_torch.examples.{name}")
        if name == "Ex12_LLMServe":
            ra.attn_page_update.launches = 0     # counts from here: Ex12's
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = mod.main()
        seconds[name] = time.perf_counter() - t0
        if name == "Ex12_LLMServe":
            k2 = ra.attn_page_update.launches
            llm = result["llm"]
            _check(llm["tokens_generated"] == 32 and k2 > 0,
                   f"examples: Ex12 made {llm['tokens_generated']} tokens "
                   f"with {k2} K2 launches")
    rec = dict(examples=list(EXAMPLES), seconds=seconds,
               ragged_attn_page_launches=k2)
    _emit(card, phase="path", name="examples", **rec)
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
    import shutil
    tune_dir = _tune_dirs()
    try:
        return _run(torch)
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def _run(torch) -> int:
    card = _card()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    phase_build(card)
    main_rec, k1_recs = phase_kernel(card, torch)
    path = phase_path(card, torch)
    dtd = phase_dtd_gemm(card, torch, path)
    checked = phase_path(card, torch, checked=path)
    phase_analysis(card, torch, dtd)
    phase_dispatch(card)
    attn_recs = phase_attn_kernel(card, torch)
    attn_rec = attn_recs[0]
    llm = phase_llm(card, torch)
    phase_llm_trace(card, torch)
    wide = phase_llm(card, torch, seed=11, max_new=32, label="llm_wide",
                     wide=True)
    wide_trace = phase_llm_trace(card, torch, max_new=8, wide=True)
    wide_pins = phase_llm_wide_pins(card, torch)
    wide_slo = phase_llm_wide_slo(card, torch, wide_trace)
    adaptive = phase_llm_wide_adaptive(card, torch)
    phase_stall(card, torch)
    prefix = phase_llm_prefix(card, torch)
    spec = phase_llm_spec(card, torch)
    tiers = phase_llm_tiers(card, torch)
    sharded = phase_llm_sharded(card, torch)
    wide_regions = phase_llm_wide_regions(card, torch)
    k2_paths = {"llm": llm, "llm_wide": wide, "llm_wide_pins": wide_pins,
                "llm_wide_slo": wide_slo, "llm_wide_adaptive": adaptive,
                "llm_sharded": sharded, "llm_wide_regions": wide_regions,
                "llm_sharded_control": {
                    "ragged_attn_page_launches":
                        sharded["control_ragged_attn_page_launches"]},
                **prefix,
                "llm_spec": spec["llm_spec"],
                "llm_spec_control": spec["llm_spec_control"],
                "llm_spec_superpool": spec["llm_spec_superpool"],
                "llm_tiers": tiers}
    sten_rec = phase_stencil_kernel(card, torch)
    sten = phase_lowered_stencil(card, torch)
    phase_lowered_stencil2d(card, torch)
    lgemm = phase_lowered_gemm(card, torch)
    lcache = phase_lowered_cache(card, torch)
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
    tuned = phase_tuned_cholesky(card, torch)
    region = phase_region_cholesky(card, torch)
    multirank = {
        "multirank_gemm": phase_multirank(card, torch, "gemm", path),
        "multirank_cholesky": phase_multirank(
            card, torch, "cholesky", factor_paths["dynamic_cholesky"]),
        "multirank_lu": phase_multirank(card, torch, "lu",
                                        factor_paths["dynamic_lu"])}
    multiproc = phase_multiproc(card, torch, multirank)
    comm_thread = phase_multiproc_comm_thread(card, torch, multiproc)
    traced = phase_multiproc_traced(card, torch, multiproc, comm_thread)
    phase_commcheck(card, torch, multiproc)
    mr_dtd = phase_multirank_dtd(card, torch)
    jdf_gemm = phase_jdf_gemm(card, torch, path)
    phase_multirank_stencil(card, torch)
    legacy = phase_multiproc_legacy_wire(card, torch, multiproc)
    phase_resume_get(card, torch)
    examples = phase_examples(card, torch)
    k2_paths["examples"] = examples
    k1_paths = {"gemm": path, "dtd_gemm": dtd, "path_checked": checked,
                "lowered_gemm": lgemm, "lowered_cache": lcache,
                **factor_paths, "tuned_cholesky": tuned,
                "region_cholesky": region, **multirank,
                **multiproc, "multiproc_comm_thread": comm_thread,
                "multiproc_traced": traced,
                "multirank_dtd_gemm": mr_dtd, "jdf_gemm": jdf_gemm,
                "multiproc_legacy_wire": legacy}
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
                "launches": sum(p["ragged_attn_page_launches"]
                                for p in k2_paths.values()),
                "launches_by_path": {
                    name: p["ragged_attn_page_launches"]
                    for name, p in k2_paths.items()},
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
