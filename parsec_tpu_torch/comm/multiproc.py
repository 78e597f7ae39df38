"""N-process harness over the socket fabric: the ``mpiexec -np N`` analog.

Port of ``parsec_tpu/comm/multiproc.py``.  Where
:func:`~parsec_tpu_torch.comm.multirank.run_multirank` runs ranks as
threads over an in-process fabric, :func:`run_multiproc` starts each rank
as a process of its own (its own interpreter, GIL, CUDA context and
device module), connected by the TCP socket fabric
(:mod:`.socket_fabric`), and collects their results.

The body must be importable (``"pkg.module:function"`` or
``"path/to/file.py:function"``) with the ``fn(ctx, rank, nranks) ->
picklable`` signature of ``run_multirank``; a body's result crosses
through a pickle file, so it returns host values (numpy, numbers), never
CUDA tensors.  Sizes and choices reach a body through the environment,
which every rank inherits.

Left out: the JAX package's ``JAX_PLATFORMS``/TPU environment handling
(nothing hides the card from a rank here) and the autotuner's knobs.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any

# the comm params every rank of a fabric must agree on, forwarded to the
# ranks as PARSEC_MCA_* (an explicit one in the caller's environment wins)
_FORWARDED = ("comm_get_frag_bytes", "comm_get_window",
              "comm_codec_pickle_fallback",
              "comm_bcast_tree", "comm_short_limit", "comm_coll_bench_bytes")

# the directory that holds the package, put on the ranks' import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port_base(nranks: int) -> int:
    """A base port whose whole range [base, base+nranks) binds (probed
    port by port: the range cannot be reserved at once, so callers still
    retry on a lost race)."""
    for _attempt in range(50):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        if base + nranks >= 65000:
            continue
        ok = True
        for r in range(nranks):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", base + r))
            except OSError:
                ok = False
                break
            finally:
                s.close()
        if ok:
            return base
    raise RuntimeError("no free port range found")


def run_multiproc(nranks: int, target: str, timeout: float = 180.0,
                  nb_cores: int = 0, transport: str = "socket",
                  distributed: bool = False,
                  device: str | None = None) -> list[Any]:
    """Run ``target`` on ``nranks`` rank processes; returns the per-rank
    results.  Retries once on a lost port-range race (a bind collision
    shows as one rank failing, or as a timeout of the others), so a
    body runs at least once: on the retry, every rank runs it again.

    ``transport``: ``"socket"`` (host payloads) or ``"device"``: each rank
    binds one device, registered payloads live there, and GETs land on
    the consumer's device (:mod:`.device_socket`).  The device is
    ``cuda:{rank % device_count}``; without a card this raises here,
    before any rank starts, unless ``device="cpu"`` asks for the host
    stand-in.  ``distributed=True`` (device transport only) joins the
    ranks in a gloo ``torch.distributed`` group first, its coordinator on
    127.0.0.1.  Each rank's output goes to a log file of its own; a
    failed rank's tail is in the error."""
    if transport not in ("socket", "device"):
        raise ValueError(f"unknown transport {transport!r}")
    if distributed and transport != "device":
        raise ValueError("distributed=True requires transport='device'")
    if device is not None and transport != "device":
        raise ValueError("device= applies to transport='device' only")
    if transport == "device" and device is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_multiproc(transport='device'): no CUDA device is "
                "visible (torch.cuda.is_available() is False); pass "
                "device='cpu' to run the device tier on the host")
    try:
        return _run_multiproc(nranks, target, timeout, nb_cores, transport,
                              distributed, device)
    except (RuntimeError, TimeoutError) as e:
        if "Address already in use" not in str(e):
            raise
        return _run_multiproc(nranks, target, timeout, nb_cores, transport,
                              distributed, device)


def _rank_env(nranks: int, target: str, timeout: float, nb_cores: int,
              transport: str, device: str | None, base: int,
              distributed: bool) -> dict:
    from ..core.params import params
    from . import codec, collectives, remote_dep, socket_fabric  # noqa: F401
    env = dict(os.environ)
    # all ranks are local: a multi-host spec must not leak in
    env.pop("PARSEC_TPU_HOSTS", None)
    for name in _FORWARDED:
        env.setdefault(f"PARSEC_MCA_{name}", str(params.get(name)))
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = _ROOT + (os.pathsep + path if path else "")
    env.update(PARSEC_MP_NRANKS=str(nranks), PARSEC_MP_TARGET=target,
               PARSEC_MP_BASE_PORT=str(base),
               PARSEC_MP_NB_CORES=str(nb_cores),
               PARSEC_MP_TIMEOUT=str(timeout),
               PARSEC_MP_TRANSPORT=transport,
               PARSEC_MP_DEVICE=device or "")
    if distributed:
        env["PARSEC_TPU_COORDINATOR"] = f"127.0.0.1:{base + nranks}"
        env["PARSEC_TPU_NUM_PROCS"] = str(nranks)
    else:
        env.pop("PARSEC_TPU_COORDINATOR", None)
    return env


def _run_multiproc(nranks: int, target: str, timeout: float, nb_cores: int,
                   transport: str, distributed: bool,
                   device: str | None) -> list[Any]:
    # one port more for the process group's coordinator when asked
    base = _free_port_base(nranks + (1 if distributed else 0))
    tmp = tempfile.mkdtemp(prefix="parsec_mp_")
    env = _rank_env(nranks, target, timeout, nb_cores, transport, device,
                    base, distributed)
    procs: list[subprocess.Popen] = []
    logs: list[str] = []
    try:
        for r in range(nranks):
            e = dict(env, PARSEC_MP_RANK=str(r),
                     PARSEC_MP_RESULT=os.path.join(tmp, f"rank{r}.pkl"))
            if distributed:
                e["PARSEC_TPU_PROC_ID"] = str(r)
            log = os.path.join(tmp, f"rank{r}.log")
            logs.append(log)
            with open(log, "wb") as lf:
                # log files, not pipes: a chatty rank must never block on
                # a pipe the parent is not draining
                procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     "from parsec_tpu_torch.comm.multiproc import "
                     "_rank_main; _rank_main()"],
                    env=e, cwd=os.getcwd(), stdout=lf,
                    stderr=subprocess.STDOUT))
        # one shared deadline, polled: the first failure kills the others
        # (they would wait for the dead rank until their own deadlines)
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed or all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                hung = [r for r, c in enumerate(codes) if c is None]
                _kill(procs)
                raise TimeoutError(
                    f"rank(s) {hung} did not finish within {timeout}s\n"
                    + _tails(logs))
            time.sleep(0.05)
        if failed:
            _kill(procs)
            raise RuntimeError(f"rank(s) {failed} failed:\n"
                               + _tails([logs[r] for r in failed]))
        results: list[Any] = []
        for r in range(nranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _kill(procs: list[subprocess.Popen]) -> None:
    """Kill and reap every rank still running (no zombies, no strays)."""
    for q in procs:
        if q.poll() is None:
            q.kill()
    for q in procs:
        q.wait()


def _tails(logs: list[str], nbytes: int = 2000) -> str:
    out = []
    for log in logs:
        try:
            with open(log, "rb") as f:
                data = f.read()[-nbytes:]
            out.append(f"--- {os.path.basename(log)} ---\n"
                       + data.decode(errors="replace"))
        except OSError:
            pass
    return "\n".join(out)


def _load_target(spec: str):
    mod_name, fn_name = spec.rsplit(":", 1)
    if mod_name.endswith(".py"):    # file-path form: "dir/bodies.py:fn"
        mspec = importlib.util.spec_from_file_location("_mp_target",
                                                       mod_name)
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name)


def _rank_main() -> None:
    """Rank process entry: build the socket-backed runtime, run the body,
    drain, and write the result."""
    from ..runtime.context import Context
    from .remote_dep import RemoteDepEngine
    from .socket_fabric import SocketCommEngine, SocketFabric

    rank = int(os.environ["PARSEC_MP_RANK"])
    nranks = int(os.environ["PARSEC_MP_NRANKS"])
    timeout = float(os.environ["PARSEC_MP_TIMEOUT"])
    transport = os.environ["PARSEC_MP_TRANSPORT"]
    fn = _load_target(os.environ["PARSEC_MP_TARGET"])
    distributed = False
    if transport == "device":
        from .device_socket import maybe_init_distributed
        distributed = maybe_init_distributed()
    fabric = SocketFabric(nranks, rank,
                          base_port=int(os.environ["PARSEC_MP_BASE_PORT"]))
    ctx = Context(nb_cores=int(os.environ["PARSEC_MP_NB_CORES"]),
                  nb_ranks=nranks, my_rank=rank)
    if transport == "device":
        from .device_socket import DeviceSocketCommEngine
        ce = DeviceSocketCommEngine(
            fabric, device=os.environ["PARSEC_MP_DEVICE"] or None)
    else:
        ce = SocketCommEngine(fabric)
    eng = RemoteDepEngine(ctx, ce)
    ctx.start()
    result = fn(ctx, rank, nranks)
    # every rank stays responsive until the fabric is silent, then tears
    # down (the run_multirank discipline)
    eng.quiesce(timeout=timeout / 2)
    ctx.fini()
    if distributed:
        import torch.distributed as dist
        dist.destroy_process_group()
    with open(os.environ["PARSEC_MP_RESULT"], "wb") as f:
        pickle.dump(result, f)
