"""Schedulers (port of ``parsec_tpu/sched``: all eleven modules)."""

from .api import SchedulerModule
from .modules import open_scheduler

__all__ = ["SchedulerModule", "open_scheduler"]
