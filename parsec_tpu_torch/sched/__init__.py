"""Schedulers (port of ``parsec_tpu/sched``; LFQ only for now)."""

from .api import SchedulerModule
from .modules import LFQModule, open_scheduler

__all__ = ["LFQModule", "SchedulerModule", "open_scheduler"]
