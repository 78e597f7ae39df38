"""Device layer: registry, kernel incarnations, the CUDA device module."""

from .device import CPUDevice, Device, DeviceRegistry, registry

__all__ = ["CPUDevice", "Device", "DeviceRegistry", "registry"]
