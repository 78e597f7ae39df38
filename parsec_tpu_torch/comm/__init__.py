"""Communication: the comm-engine abstraction and the remote-dep protocol.

Port of ``parsec_tpu/comm`` (the reference's communication stack):

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
  each (``run_multirank``);
- :mod:`.codec`: the binary wire encoding (the JAX package's bytes for
  every structured value and numpy array, and a tensor tag);
- :mod:`.socket_fabric`: ranks as processes over TCP (``SocketFabric``,
  ``SocketCommEngine``: seq, cumulative acks, reconnect and replay);
- :mod:`.device_socket`: the socket tier with payloads on each rank's
  card (``DeviceSocketCommEngine``: D2H, wire, H2D);
- :mod:`.multiproc`: N ranks as processes (``run_multiproc``, the
  ``mpiexec -np N`` analog), with the rank bodies the tests and
  ``chip_smoke.py`` share in :mod:`.mp_bodies`.

Left out: the legacy pickle framing of the socket fabric, trace spans,
resumed and prefetch GETs (``resume_get``, ``prefetch_get``) and an
NCCL process group (``run_multiproc(distributed=True)`` joins gloo).
"""

from .collectives import (bcast_taskpool, reduce_op, reduce_taskpool,
                          register_reduce_op)
from .device_fabric import DeviceCommEngine, DeviceFabric
from .device_socket import DeviceSocketCommEngine
from .engine import (AM_TAG_ACTIVATE, AM_TAG_GET_ACK, AM_TAG_TERMDET,
                     CommEngine, InprocCommEngine, InprocFabric, MemHandle)
from .multiproc import run_multiproc
from .multirank import run_multirank
from .remote_dep import (TREE_KINDS, RemoteDepEngine, RemoteDeps,
                         resolve_tree_kind, tree_children, tree_parent)
from .socket_fabric import SocketCommEngine, SocketFabric
from .termdet_fourcounter import FourCounterTermDet  # registers the detector

__all__ = [
    "AM_TAG_ACTIVATE", "AM_TAG_GET_ACK", "AM_TAG_TERMDET", "CommEngine",
    "DeviceCommEngine", "DeviceFabric", "DeviceSocketCommEngine",
    "FourCounterTermDet", "InprocCommEngine", "InprocFabric", "MemHandle",
    "RemoteDepEngine", "RemoteDeps", "SocketCommEngine", "SocketFabric",
    "TREE_KINDS", "bcast_taskpool", "reduce_op", "reduce_taskpool",
    "register_reduce_op", "resolve_tree_kind", "run_multiproc",
    "run_multirank", "tree_children", "tree_parent",
]
