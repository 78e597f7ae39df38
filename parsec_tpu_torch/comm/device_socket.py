"""Device-resident multi-process transport: the socket tier with payloads
on the card.

Port of ``parsec_tpu/comm/device_socket.py`` onto ``torch.device``\\ s:

- **Each process binds one device**: rank *r* takes ``cuda:{r %
  device_count}``, and the engine raises when no card is visible.  The
  host stand-in (``device="cpu"``) applies only when the caller asks for
  it, as ``run_multiproc(..., transport="device", device="cpu")`` does.
- **Registration is residency**: ``mem_register`` places the payload on
  the rank's device (a device-side snapshot when it lies there already),
  then records an event on the current stream: the registered tensor is
  complete when that event has run.
- **A GET moves device -> host -> wire -> host -> device**: ``_serve_value``
  is the D2H of the registered tensor on a copy stream of its own that
  first waits for the registration's event (never a device-wide
  synchronize on the progress thread), into pinned memory; the binary
  frames carry the flat bytes; ``_land_value`` is the H2D onto the
  consumer's device, asynchronous from pinned memory (PyTorch's caching
  host allocator keeps the buffer until the copy's event has run) and
  enqueued on the landing thread's current stream, which the kernels that
  read the tile run after.  A whole reply's tensor is decoded into pinned
  memory by the fabric's receive thread; a fragmented GET lands in a
  pinned zone.
- **Bytes are counted per tier**: :meth:`tier_bytes` gives the payload
  bytes served (D2H) and landed (H2D) beside the fabric's framed total,
  and :meth:`tier_seconds` the host seconds of each hop: the D2H (to its
  event), the frames' sending and receiving, the H2D's enqueue, and the
  GETs from request to landing.

:func:`maybe_init_distributed` joins the ranks in a ``torch.distributed``
process group over gloo from the environment the launcher sets
(``PARSEC_TPU_COORDINATOR``, ``PARSEC_TPU_NUM_PROCS``,
``PARSEC_TPU_PROC_ID``), the role ``jax.distributed`` plays in the JAX
package: discovery only, nothing collective rides the group.

Left out: an NCCL process group (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import torch

from ..data.data import nbytes_of
from ..data.datatype import to_tensor
from .engine import MemHandle
from .socket_fabric import SocketCommEngine, SocketFabric

__all__ = ["DeviceSocketCommEngine", "maybe_init_distributed"]


def maybe_init_distributed() -> bool:
    """Join the process group described by the environment (a gloo group
    over ``tcp://<coordinator>``) if a coordinator is set; returns whether
    it did."""
    coord = os.environ.get("PARSEC_TPU_COORDINATOR")
    if not coord:
        return False
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coord}",
        world_size=int(os.environ["PARSEC_TPU_NUM_PROCS"]),
        rank=int(os.environ["PARSEC_TPU_PROC_ID"]))
    return True


class DeviceSocketCommEngine(SocketCommEngine):
    """The comm-engine vtable over TCP with device-resident payloads."""

    def __init__(self, fabric: SocketFabric, device: Any = None) -> None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device socket engine: no CUDA device is visible "
                    "(torch.cuda.is_available() is False); pass device="
                    "'cpu' to run the device tier on the host")
            device = torch.device("cuda",
                                  fabric.rank % torch.cuda.device_count())
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", 0)
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"device socket engine: unsupported device "
                             f"{device}")
        super().__init__(fabric)
        self.device = device
        self.is_cuda = device.type == "cuda"
        # whole replies land pinned like fragments, so every H2D is async
        fabric.pin_tensors = self.is_cuda
        self._d2h_stream = torch.cuda.Stream(device) if self.is_cuda \
            else None
        self.payload_bytes_out = 0    # payload bytes served (D2H)
        self.payload_bytes_in = 0     # payload bytes landed (H2D)
        self.d2h_s = 0.0              # serving: D2H start to its event
        self.h2d_s = 0.0              # landing: the H2D's enqueue
        self.get_s = 0.0              # GETs: request to landing, summed

    # -- registration is residency -------------------------------------------
    def mem_register(self, value: Any, refcount: int = 1,
                     owned: bool = False,
                     peers: set[int] | None = None) -> MemHandle:
        value = to_tensor(value)
        if value.device != self.device:
            value = value.to(self.device)
        elif not owned:
            value = value.clone()
        h = super().mem_register(value, refcount, owned=True, peers=peers)
        if self.is_cuda:
            h.ready = torch.cuda.Event()
            h.ready.record(torch.cuda.current_stream(self.device))
        return h

    def get(self, rwire: tuple[int, int],
            on_complete: Callable[[Any], None],
            trace: int | None = None) -> int:
        t0 = time.perf_counter()

        def landed(value: Any) -> None:
            self.get_s += time.perf_counter() - t0
            on_complete(value)
        return super().get(rwire, landed, trace=trace)

    # -- the payload path: flat bytes and metadata, no object graph ----------
    def _serve_value(self, h: MemHandle) -> Any:
        """The D2H: a host tensor of the registered value, which the
        frames then ship as raw segments or DATA fragments."""
        t0 = time.perf_counter()
        v = h.value
        if self.is_cuda and isinstance(v, torch.Tensor) and v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            with torch.cuda.stream(self._d2h_stream):
                if h.ready is not None:
                    self._d2h_stream.wait_event(h.ready)
                host.copy_(v, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._d2h_stream)
            done.synchronize()     # this copy only, not the whole card
            v = host
        with self._mem_lock:
            self.payload_bytes_out += nbytes_of(v)
            self.d2h_s += time.perf_counter() - t0
        return v

    def _host_buffer(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.is_cuda)

    def _land_value(self, value: Any) -> Any:
        """The H2D onto this rank's device."""
        if isinstance(value, torch.Tensor):
            t0 = time.perf_counter()
            if value.device != self.device:
                value = value.to(self.device, non_blocking=True)
            self.payload_bytes_in += nbytes_of(value)
            self.h2d_s += time.perf_counter() - t0
        return value

    def tier_bytes(self) -> dict:
        """Bytes by tier: payload served and landed, the fabric's framed
        total, and the control traffic (total less payload served)."""
        total = self.fabric.bytes_sent
        return {"payload_out": self.payload_bytes_out,
                "payload_in": self.payload_bytes_in,
                "wire_total_sent": total,
                "control_sent": max(0, total - self.payload_bytes_out)}

    def tier_seconds(self) -> dict:
        """Host seconds by hop: D2H (each to its event), frames sent and
        received by the fabric, H2D enqueued, and the GETs' latency summed
        from request to landing."""
        return {"d2h_s": self.d2h_s, "send_s": self.fabric.send_s,
                "recv_s": self.fabric.recv_s, "h2d_s": self.h2d_s,
                "get_s": self.get_s}
