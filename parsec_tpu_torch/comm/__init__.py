"""Communication: the comm-engine abstraction and the remote-dep protocol.

Port of ``parsec_tpu/comm`` (the reference's communication stack), its
in-process part:

- :mod:`.engine`: the transport-neutral comm-engine vtable (active
  messages, registered memory, one-sided GETs with fragments under a
  credit window, progress, barrier) and the in-process fabric;
- :mod:`.device_fabric`: the same vtable over per-rank ``torch.device``\\ s
  (payloads registered and landed on the ranks' devices);
- :mod:`.remote_dep`: the activation protocol (short-message inlining,
  rendezvous GETs, binomial/chain/star trees, per-peer coalescing,
  termdet pending actions);
- :mod:`.termdet_fourcounter`: the distributed wave detector, registered
  as ``fourcounter`` on import;
- :mod:`.collectives`: broadcast and reduction taskpools;
- :mod:`.multirank`: N ranks as threads of one process, one context
  each (``run_multirank``).

Left out until the multi-process slice: ``run_multiproc``, the socket
fabric, the wire codec and the device socket engine.
"""

from .collectives import (bcast_taskpool, reduce_op, reduce_taskpool,
                          register_reduce_op)
from .device_fabric import DeviceCommEngine, DeviceFabric
from .engine import (AM_TAG_ACTIVATE, AM_TAG_GET_ACK, AM_TAG_TERMDET,
                     CommEngine, InprocCommEngine, InprocFabric, MemHandle)
from .multirank import run_multirank
from .remote_dep import (TREE_KINDS, RemoteDepEngine, RemoteDeps,
                         resolve_tree_kind, tree_children, tree_parent)
from .termdet_fourcounter import FourCounterTermDet  # registers the detector

__all__ = [
    "AM_TAG_ACTIVATE", "AM_TAG_GET_ACK", "AM_TAG_TERMDET", "CommEngine",
    "DeviceCommEngine", "DeviceFabric", "FourCounterTermDet",
    "InprocCommEngine", "InprocFabric", "MemHandle", "RemoteDepEngine",
    "RemoteDeps", "TREE_KINDS", "bcast_taskpool", "reduce_op",
    "reduce_taskpool", "register_reduce_op", "resolve_tree_kind",
    "run_multirank", "tree_children", "tree_parent",
]
