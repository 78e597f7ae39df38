"""Binary event tracing: dictionary-keyed begin/end streams and readers.

Port of ``parsec_tpu/prof/profiling.py`` (the reference's two-level trace
design, ``profiling.h`` and ``parsec_binary_profile.h``):

- a global **dictionary** maps event-class names to paired (start, end)
  keys with a display color and an *info* schema (field names);
- each thread owns a **profiling stream** of events appended without a
  lock: (key, event_id, object_id, timestamp_ns, info); the device
  manager, which fires its events with ``es=None``, writes to the stream
  of whichever thread runs it, like any other thread;
- streams dump into one **binary file** (magic ``PTPB``, struct-packed)
  in the JAX package's byte format, so either package's reader
  (:meth:`Profiling.load`) loads either package's file;
  :meth:`Profiling.to_records` matches begin/end pairs into one row per
  event instance, and :meth:`Profiling.to_chrome_trace` writes them for
  a trace viewer.

The :mod:`task_profiler <parsec_tpu_torch.prof.task_profiler>` PINS module
bridges runtime events into these streams.

Left out: ``to_pandas`` (pandas is not installed beside the card; the
rows of ``to_records`` are what it would frame).
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
from typing import Iterable

_MAGIC = b"PTPB\x01"

KEY_START = 0
KEY_END = 1


class EventClass:
    __slots__ = ("name", "keyword_id", "color", "info_fields")

    def __init__(self, name: str, keyword_id: int, color: str,
                 info_fields: tuple[str, ...]) -> None:
        self.name = name
        self.keyword_id = keyword_id
        self.color = color
        self.info_fields = info_fields

    @property
    def start_key(self) -> int:
        return self.keyword_id * 2 + KEY_START

    @property
    def end_key(self) -> int:
        return self.keyword_id * 2 + KEY_END


class ProfilingStream:
    """One thread's append-only event buffer (cf. profiling thread
    streams); events are (key, event_id, object_id, ts_ns, info dict)."""

    __slots__ = ("name", "stream_id", "events")

    def __init__(self, name: str, stream_id: int) -> None:
        self.name = name
        self.stream_id = stream_id
        self.events: list[tuple] = []

    def trace(self, key: int, event_id: int, object_id: int,
              info: dict | None = None) -> None:
        self.events.append((key, event_id, object_id,
                            time.perf_counter_ns(), info))


class Profiling:
    """Global trace state: dictionary + streams + dump/load."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dictionary: dict[str, EventClass] = {}
        self.streams: list[ProfilingStream] = []
        self._tls = threading.local()
        self.enabled = False

    # -- lifecycle (parsec_profiling_init / _dbp_start analogs) --------------
    def init(self) -> None:
        self.enabled = True

    def fini(self) -> None:
        self.enabled = False
        with self._lock:
            self.streams = []
            self.dictionary = {}
        self._tls = threading.local()

    # -- dictionary ----------------------------------------------------------
    def add_dictionary_keyword(self, name: str, color: str = "#888888",
                               info_fields: Iterable[str] = ()) \
            -> tuple[int, int]:
        """Register an event class; returns its (start_key, end_key)
        (``parsec_profiling_add_dictionary_keyword``)."""
        with self._lock:
            ec = self.dictionary.get(name)
            if ec is None:
                ec = EventClass(name, len(self.dictionary), color,
                                tuple(info_fields))
                self.dictionary[name] = ec
            return ec.start_key, ec.end_key

    # -- streams -------------------------------------------------------------
    def stream_init(self, name: str) -> ProfilingStream:
        """(``parsec_profiling_stream_init``) — one per thread."""
        with self._lock:
            s = ProfilingStream(name, len(self.streams))
            self.streams.append(s)
            return s

    def thread_stream(self) -> ProfilingStream:
        s = getattr(self._tls, "stream", None)
        if s is None:
            s = self.stream_init(threading.current_thread().name)
            self._tls.stream = s
        return s

    def trace(self, key: int, event_id: int = 0, object_id: int = 0,
              info: dict | None = None) -> None:
        if self.enabled:
            self.thread_stream().trace(key, event_id, object_id, info)

    # -- binary dump / load --------------------------------------------------
    def dump(self, path: str) -> None:
        """Write the whole trace (dictionary + streams) as one binary file."""
        with self._lock, open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(self.dictionary)))
            for ec in self.dictionary.values():
                _w_str(f, ec.name)
                _w_str(f, ec.color)
                f.write(struct.pack("<I", len(ec.info_fields)))
                for fld in ec.info_fields:
                    _w_str(f, fld)
            f.write(struct.pack("<I", len(self.streams)))
            for s in self.streams:
                _w_str(f, s.name)
                # snapshot the count: trace() appends locklessly and a dump
                # during live tracing must not outgrow its declared length
                n = len(s.events)
                f.write(struct.pack("<I", n))
                for key, ev, obj, ts, info in s.events[:n]:
                    f.write(struct.pack("<IqqQ", key, ev, obj, ts))
                    fields = () if info is None else tuple(info.items())
                    f.write(struct.pack("<I", len(fields)))
                    for k, v in fields:
                        _w_str(f, k)
                        _w_str(f, json.dumps(v, default=str))

    @staticmethod
    def load(path: str) -> "Profiling":
        p = Profiling()
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{path}: not a parsec-tpu trace")
            (nd,) = struct.unpack("<I", f.read(4))
            for _ in range(nd):
                name = _r_str(f)
                color = _r_str(f)
                (nf,) = struct.unpack("<I", f.read(4))
                fields = tuple(_r_str(f) for _ in range(nf))
                p.add_dictionary_keyword(name, color, fields)
            (ns,) = struct.unpack("<I", f.read(4))
            for _ in range(ns):
                s = p.stream_init(_r_str(f))
                (ne,) = struct.unpack("<I", f.read(4))
                for _ in range(ne):
                    key, ev, obj, ts = struct.unpack("<IqqQ", f.read(28))
                    (ni,) = struct.unpack("<I", f.read(4))
                    info = {_r_str(f): json.loads(_r_str(f))
                            for _ in range(ni)} or None
                    s.events.append((key, ev, obj, ts, info))
        return p

    # -- analysis (pbt2ptt / profile2h5 analog) ------------------------------
    def to_records(self) -> list[dict]:
        """Match begin/end pairs into one record per event instance."""
        by_key = {ec.start_key: ec for ec in self.dictionary.values()}
        open_ev: dict[tuple, tuple] = {}
        records = []
        for s in self.streams:
            for key, ev, obj, ts, info in s.events:
                kw = key // 2
                ec = by_key.get(kw * 2)
                if ec is None:
                    continue
                tag = (s.stream_id, kw, ev)
                if key % 2 == KEY_START:
                    open_ev[tag] = (ts, info)
                else:
                    begin = open_ev.pop(tag, None)
                    if begin is None:
                        continue
                    rec = {"stream": s.name, "stream_id": s.stream_id,
                           "name": ec.name, "event_id": ev,
                           "object_id": obj, "begin_ns": begin[0],
                           "end_ns": ts,
                           "duration_ns": ts - begin[0]}
                    if begin[1]:
                        rec.update({f"info.{k}": v
                                    for k, v in begin[1].items()})
                    records.append(rec)
        records.sort(key=lambda r: r["begin_ns"])
        return records

    def to_chrome_trace(self, path: str | None = None) -> dict:
        """Export as Chrome trace-event JSON (the standard-viewer export —
        the role ``profiling_otf2.c`` plays in the reference; Perfetto /
        chrome://tracing consume this directly).

        Complete events (``ph: X``) carry begin/duration in microseconds;
        one process, one tid per profiling stream, stream names attached
        as thread-name metadata.  Returns the trace dict; writes JSON to
        ``path`` when given.
        """
        events: list[dict] = []
        seen_streams: dict[int, str] = {}
        for rec in self.to_records():
            tid = rec["stream_id"]
            seen_streams.setdefault(tid, rec["stream"])
            ec = self.dictionary.get(rec["name"])
            ev = {
                "name": rec["name"],
                "cat": "parsec",
                "ph": "X",
                "ts": rec["begin_ns"] / 1e3,
                "dur": rec["duration_ns"] / 1e3,
                "pid": 0,
                "tid": tid,
                "args": {k.removeprefix("info."): v
                         for k, v in rec.items()
                         if k.startswith("info.")} | {
                             "object_id": rec["object_id"],
                             "event_id": rec["event_id"]},
            }
            # the dictionary's display color rides in args: trace-event
            # 'cname' only accepts the viewer's reserved color names, and
            # legacy chrome://tracing rejects traces with unknown ones
            if ec is not None and ec.color:
                ev["args"]["color"] = ec.color
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": name}}
                for tid, name in sorted(seen_streams.items())]
        trace = {"traceEvents": meta + events,
                 "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def validate(self) -> list[str]:
        """Well-formedness checks (the check-async.py analog): every begin
        has a matching end on the same stream, timestamps are ordered."""
        problems = []
        for s in self.streams:
            open_ev: dict[tuple, int] = {}
            last_ts = 0
            for key, ev, obj, ts, info in s.events:
                if ts < last_ts:
                    problems.append(
                        f"{s.name}: timestamp regression at event {ev}")
                last_ts = ts
                tag = (key // 2, ev)
                if key % 2 == KEY_START:
                    if tag in open_ev:
                        problems.append(
                            f"{s.name}: nested begin for {tag}")
                    open_ev[tag] = ts
                else:
                    if open_ev.pop(tag, None) is None:
                        problems.append(
                            f"{s.name}: end without begin for {tag}")
            for tag in open_ev:
                problems.append(f"{s.name}: unterminated event {tag}")
        return problems


def _w_str(f: io.IOBase, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<I", len(b)))
    f.write(b)


def _r_str(f: io.IOBase) -> str:
    (n,) = struct.unpack("<I", f.read(4))
    return f.read(n).decode()


# process-global instance (cf. the reference's global profiling state)
profiling = Profiling()
