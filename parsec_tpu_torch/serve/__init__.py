"""The serving layer (port of ``parsec_tpu/serve``): a resident runtime
server with admission control and weighted-fair tenants, and the
sharded server that spans one serving plane over ranks."""

from .admission import (AdmissionController, AdmissionRejected,
                        DeadlineExceeded, TicketCancelled)
from .fair import FairScheduler
from .server import RuntimeServer, Ticket
from .sharded import ShardedRuntimeServer, ShardedStreamTicket

__all__ = ["RuntimeServer", "Ticket", "FairScheduler",
           "AdmissionController", "AdmissionRejected", "DeadlineExceeded",
           "TicketCancelled", "ShardedRuntimeServer",
           "ShardedStreamTicket"]
