"""Workload signatures: what a stored knob vector is FOR.

Port of ``parsec_tpu/tune/signature.py``.  Two kinds, both plain strings
(the tuning DB's first key column, :mod:`.db`):

- **structural** (:func:`workload_signature`): the lowering's
  cross-process fingerprint
  (:func:`parsec_tpu_torch.ptg.lowering.structural_fingerprint`: the
  task-class table, the wavefront shape, store rows when lowered) plus a
  power-of-two **size bucket**, digested to a short stable hex.  The
  fingerprint equals the JAX package's on the same pool, so the two
  packages sign one program alike; the backend triple stays OUT of the
  signature (it is the DB key's second column), so "same structure,
  other backend" is a key miss, not a false hit.

- **ambient** (:func:`ambient_signature`): a tag for vectors applied
  before any workload structure exists: ``ambient:context`` at
  :class:`~parsec_tpu_torch.runtime.context.Context` start,
  ``ambient:tenant:<t>`` at a RuntimeServer tenant's first stream.

Nothing is left out.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def size_bucket(n: float | int) -> int:
    """Power-of-two bucket of a workload size (task count, matrix n,
    token count...): vectors tuned at n=8192 apply at n=8192+epsilon,
    never at n=64."""
    n = int(n)
    return 0 if n <= 1 else n.bit_length() - 1


def fingerprint(obj) -> dict:
    """The structural fingerprint dict (see
    :func:`parsec_tpu_torch.ptg.lowering.structural_fingerprint`) — exposed
    here so signature consumers need not import the lowering module."""
    from ..ptg.lowering import structural_fingerprint
    return structural_fingerprint(obj)


def workload_signature(obj: Any, size_hint: float | None = None) -> str:
    """Structural signature of a Taskpool / LoweredTaskpool.

    ``size_hint`` overrides the bucketed size axis (default: the
    fingerprint's total task count) — callers whose task count hides
    the real scale (one decode pool per iteration, say) pass tokens or
    matrix n instead."""
    fp = fingerprint(obj)
    bucket = size_bucket(size_hint if size_hint is not None
                         else fp.get("ntasks", 0))
    blob = json.dumps({"fp": fp, "bucket": bucket}, sort_keys=True,
                      separators=(",", ":")).encode()
    digest = hashlib.blake2b(blob, digest_size=10).hexdigest()
    # a human-scannable prefix (first class name) + the discriminating
    # digest: `--history`-style tooling stays readable
    head = fp["classes"][0][0] if fp.get("classes") else "empty"
    return f"wl:{head}:b{bucket}:{digest}"


def ambient_signature(tag: str) -> str:
    return f"ambient:{tag}"
