"""Virtual-process maps (the reference's ``vpmap.c``).

Port of ``parsec_tpu/runtime/vpmap.py``: a spec assigns each execution
stream of a context to a virtual process; streams steal work only from
streams of their own virtual process.  The grammar:

- ``""``: round-robin over ``runtime_nb_vp`` virtual processes;
- ``flat``: one virtual process holding every stream;
- ``rr:N``: N virtual processes, streams dealt round-robin;
- ``list:a,b,c``: explicit sizes;
- ``file:PATH``: one size per line of PATH (``#`` starts a comment line).

Extra streams past the listed sizes are dealt round-robin.
"""

from __future__ import annotations

from ..core.params import params as _params

_params.register("runtime_vpmap", "",
                 "virtual-process map spec: flat | rr:N | list:a,b,c | "
                 "file:PATH (empty = round-robin over runtime_nb_vp)")
_params.register("runtime_nb_vp", 1, "number of virtual processes")


def parse_vpmap(spec: str, nstreams: int, nb_vp: int) -> list[int]:
    """The virtual-process index of each of ``nstreams`` streams."""
    spec = (spec or "").strip()
    if not spec:
        nvp = max(1, nb_vp)
        return [i % nvp for i in range(nstreams)]
    if spec == "flat":
        return [0] * nstreams
    if spec.startswith("rr:"):
        nvp = max(1, int(spec[3:]))
        return [i % nvp for i in range(nstreams)]
    if spec.startswith("list:"):
        sizes = [int(s) for s in spec[5:].split(",") if s.strip()]
    elif spec.startswith("file:"):
        with open(spec[5:]) as f:
            sizes = [int(s) for s in (line.strip() for line in f)
                     if s and not s.startswith("#")]
    else:
        raise ValueError(f"bad runtime_vpmap spec {spec!r}")
    if not sizes or any(s <= 0 for s in sizes):
        raise ValueError(f"runtime_vpmap sizes must be positive: {sizes}")
    out: list[int] = []
    for v, size in enumerate(sizes):
        out.extend([v] * size)
    if len(out) < nstreams:
        out.extend(i % len(sizes) for i in range(nstreams - len(out)))
    return out[:nstreams]


def nb_vps(assignment: list[int]) -> int:
    return (max(assignment) + 1) if assignment else 1
