"""Device-backed comm transport: per-rank devices, device-side payloads.

Port of ``parsec_tpu/comm/device_fabric.py`` (the TPU counterpart of the
reference's MPI transport, ``parsec_mpi_funnelled.c``) onto
``torch.device``\\ s, behind the same comm-engine vtable:

- **Each rank owns one device.**  ``mem_register`` places the payload on
  the owner rank's device: a tensor already there is snapshotted there
  (a device-side ``clone``), one elsewhere is copied there; either copy
  is counted in ``bytes_put``.
- **A GET lands on the consumer's device.**  The owner serves each
  consumer a tensor of its own (a copy while other consumers remain, the
  registered snapshot to the last one, as :mod:`.engine` does); the
  consumer moves it to its device if it lies elsewhere and counts the
  landed bytes in ``bytes_got``.  Ranks that share one card (``devices=
  [cuda:0] * 4``) thus move each payload by one device-to-device copy a
  hop, on the card.
- **Large payloads move as device-side fragments** of
  ``comm_get_frag_bytes``, each its own message under the credit window,
  reassembled on the consumer's device with one ``torch.cat``.
- **Active messages stay on the host** (activations are small control
  records).

Copies are issued on the current CUDA stream of the thread that makes
them.  The device module launches its kernels on the current stream of
the thread that manages the card, and the activation that registers a
task's output runs on that thread right after the launch, so the
snapshot is ordered after the kernel that wrote the tile; the device
module's H2D copy stream is never used here.

**A deliberate departure from the JAX package**, whose registration
aliases a device array (immutable, so safe): a tensor on the card is
mutable, and a local successor may update a registered tile in place, so
the port pays one device-side copy for each registration.

With no ``devices``, every visible card is used, one a rank; the fabric
raises when no card is visible, or when there are fewer devices than
ranks.  A caller that wants ranks to share a card, or to run on the
CPU, passes ``devices`` explicitly (``[torch.device("cuda", 0)] * 4``,
``[torch.device("cpu")] * 2``).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.params import params as _params
from ..data.data import nbytes_of
from ..data.datatype import to_tensor
from .codec import dtype_name
from .engine import InprocCommEngine, InprocFabric, MemHandle, _LandingZone


class DeviceFabric(InprocFabric):
    """N ranks, each pinned to one ``torch.device``."""

    def __init__(self, nranks: int, devices: list | None = None) -> None:
        super().__init__(nranks)
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device fabric: no CUDA device is visible "
                    "(torch.cuda.is_available() is False); pass devices= "
                    "explicitly to run the device transport on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [self._normalize(d) for d in devices]
        if len(devices) < nranks:
            raise ValueError(f"device fabric needs {nranks} devices, "
                             f"found {len(devices)} (pass devices= to "
                             f"put several ranks on one device)")
        self.devices = devices[:nranks]

    @staticmethod
    def _normalize(d: Any) -> torch.device:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device fabric: {d} requested but no "
                                   f"CUDA device is visible")
            if d.index is None:
                d = torch.device("cuda", 0)
        elif d.type != "cpu":
            raise ValueError(f"device fabric: unsupported device {d}")
        return d

    @property
    def ranks_per_device(self) -> int:
        """The most ranks that share one device."""
        return max(self.devices.count(d) for d in set(self.devices))

    def attach(self, rank: int) -> "DeviceCommEngine":
        return DeviceCommEngine(self, rank)


class DeviceCommEngine(InprocCommEngine):
    """The comm-engine vtable over per-rank devices."""

    def __init__(self, fabric: DeviceFabric, rank: int) -> None:
        super().__init__(fabric, rank)
        self.device = fabric.devices[rank]
        self.bytes_put = 0      # registered on this rank's device
        self.bytes_got = 0      # landed on this rank's device by GETs

    def mem_register(self, value: Any, refcount: int = 1,
                     owned: bool = False,
                     peers: set[int] | None = None) -> MemHandle:
        """Place ``value`` on this rank's device and publish it: a copy
        there when it lies elsewhere, a device-side snapshot when it lies
        there already, unless ``owned``."""
        value = to_tensor(value)
        if value.device != self.device:
            value = value.to(self.device)
        elif not owned:
            value = value.clone()
        with self._mem_lock:     # registrations come from several threads
            self.bytes_put += nbytes_of(value)
        # the copy above settled the ownership
        return super().mem_register(value, refcount, owned=True,
                                    peers=peers)

    def _land_value(self, value: Any) -> Any:
        """Land the payload on MY device."""
        if isinstance(value, torch.Tensor):
            if value.device != self.device:
                value = value.to(self.device)
            self.bytes_got += nbytes_of(value)
        return value

    # -- windowed fragments of large device payloads --------------------------
    def _plan_frags(self, value: Any) -> tuple[list, dict] | None:
        """A tensor above the fragment size moves as device-side slices
        of its flat view: each fragment is its own message, landed on
        arrival, and the consumer concatenates them on its device."""
        fb = _params.get("comm_get_frag_bytes")
        if not fb or not isinstance(value, torch.Tensor) \
                or nbytes_of(value) <= fb:
            return None
        per = max(int(fb) // value.element_size(), 1)
        flat = value.reshape(-1)
        pieces = []
        for e0 in range(0, flat.numel(), per):
            piece = flat[e0:e0 + per]
            pieces.append((e0 * value.element_size(), nbytes_of(piece),
                           piece))
        meta = {"shape": tuple(value.shape),
                "dtype": dtype_name(value.dtype), "nbytes": nbytes_of(value),
                "nfrags": len(pieces), "tier": "device"}
        return pieces, meta

    def _zone_write(self, zone: _LandingZone, offset: int,
                    data: torch.Tensor) -> None:
        if zone.frags is None:
            super()._zone_write(zone, offset, data)
            return
        zone.frags[offset] = data.to(self.device)

    def _zone_finish(self, zone: _LandingZone) -> torch.Tensor:
        if zone.frags is None:
            return super()._zone_finish(zone)
        parts = [zone.frags[off] for off in sorted(zone.frags)]
        # a new tensor on this device: the consumer owns it
        return torch.cat(parts).reshape(zone.meta["shape"])
