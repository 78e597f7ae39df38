"""CPU cache topology: the hwloc distance-matrix role.

Port of ``parsec_tpu/core/topology.py`` (nothing left out): the slice of
hwloc the scheduler ladder consumes
(``parsec_hwloc_distance`` / ``parsec_hwloc_master_id``, ``parsec_hwloc.c``):
which cores share a last-level cache, and how topologically far two cores
are.  Read from Linux sysfs
(``/sys/devices/system/cpu/cpu*/cache/index*/shared_cpu_list``); platforms
without it degrade to one flat group — exactly the no-hwloc build of the
reference.

Consumers: the **lhq** scheduler's stream→group rung (streams sharing an
LLC share a group buffer) and the **pbq/lhq** steal order (nearest cores
first).
"""

from __future__ import annotations

import functools
import glob
import os
import re


# process affinity snapshot taken at import (the main thread, before any
# worker binds itself to a single core): with runtime_bind_threads on, a
# worker's own mask shrinks to one cpu and would poison every distance
try:
    _ALLOWED = sorted(os.sched_getaffinity(0))
except AttributeError:          # non-Linux
    _ALLOWED = list(range(os.cpu_count() or 1))


def _parse_cpu_list(s: str) -> frozenset[int]:
    out: set[int] = set()
    for part in s.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(part))
    return frozenset(out)


@functools.lru_cache(maxsize=1)
def llc_groups() -> tuple[frozenset[int], ...]:
    """Groups of cpu ids sharing their last-level cache (deduplicated,
    sorted by smallest member).  Fallback: one group of every online cpu.
    """
    groups: set[frozenset[int]] = set()
    for cpudir in glob.glob("/sys/devices/system/cpu/cpu[0-9]*"):
        idx = sorted(glob.glob(os.path.join(cpudir, "cache", "index*")),
                     key=lambda p: int(re.search(r"index(\d+)", p).group(1)))
        if not idx:
            continue
        try:
            with open(os.path.join(idx[-1], "shared_cpu_list")) as f:
                groups.add(_parse_cpu_list(f.read()))
        except OSError:
            continue
    if not groups:
        try:
            cpus = frozenset(os.sched_getaffinity(0))
        except AttributeError:
            cpus = frozenset(range(os.cpu_count() or 1))
        groups = {cpus}
    return tuple(sorted(groups, key=min))


def llc_group_of(cpu: int) -> int:
    """Index (into :func:`llc_groups`) of the group containing ``cpu``."""
    for i, g in enumerate(llc_groups()):
        if cpu in g:
            return i
    return 0


def core_of_stream(th_id: int) -> int:
    """The core a worker stream maps to: round-robin over the process
    affinity mask as of process start (see ``_ALLOWED``), the mapping
    the JAX package's ``Context._bind_worker`` binds by.  The port's
    context binds no thread; the schedulers use the mapping alone."""
    return _ALLOWED[max(th_id, 0) % len(_ALLOWED)]


def distance(cpu_a: int, cpu_b: int) -> int:
    """Topological distance: 0 same core, 1 same LLC, 2 otherwise (the
    2-level slice of hwloc's distance matrix the schedulers consume)."""
    if cpu_a == cpu_b:
        return 0
    return 1 if llc_group_of(cpu_a) == llc_group_of(cpu_b) else 2
