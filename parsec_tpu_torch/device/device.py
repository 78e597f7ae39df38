"""Device registry, statistics and best-device selection.

Port of ``parsec_tpu/device/device.py`` (the reference's
``parsec/mca/device/device.c``): devices register with the process-global
registry; each carries transfer/execution statistics and per-precision gflops
ratings; ``best_device`` is ``parsec_get_best_device`` = argmin over the
task's time estimate.

Left out: the load accumulator (``load_add``, which nothing calls, so
the load was always 0), the process-wide XLA dispatch ledger (the CUDA
device counts its own ``kernel_launches``) and the info-object arrays.
"""

from __future__ import annotations

import threading
from typing import Any


class Device:
    """Base device module (cf. ``parsec_device_module_t``)."""

    def __init__(self, name: str, device_type: str) -> None:
        self.name = name
        self.type = device_type
        self.device_index = -1
        self.enabled = True
        self.executed_tasks = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.gflops_fp16 = 1.0
        self.gflops_fp32 = 1.0
        self.gflops_fp64 = 1.0

    def flush_cache(self) -> None:
        pass

    def stats(self) -> dict[str, float]:
        return {"executed_tasks": self.executed_tasks,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out}


class CPUDevice(Device):
    """Host device: chores run inline on the worker thread."""

    def __init__(self) -> None:
        super().__init__("cpu", "cpu")


class DeviceRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.devices: list[Device] = []

    def add(self, dev: Device) -> Device:
        with self._lock:
            dev.device_index = len(self.devices)
            self.devices.append(dev)
        return dev

    def by_type(self, device_type: str) -> list[Device]:
        return [d for d in self.devices if d.type == device_type and d.enabled]

    def get(self, index: int) -> Device:
        return self.devices[index]

    def best_device(self, task: Any,
                    device_type: str | None = None) -> Device | None:
        """``parsec_get_best_device``: min time_estimate."""
        cands = [d for d in self.devices
                 if d.enabled and (device_type is None or d.type == device_type)]
        if not cands:
            return None
        te = task.task_class.time_estimate
        if te is None:
            return cands[0]
        return min(cands, key=lambda d: te(task, d))


registry = DeviceRegistry()
registry.add(CPUDevice())
