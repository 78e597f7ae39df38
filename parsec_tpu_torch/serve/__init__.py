"""The serving layer (port of ``parsec_tpu/serve``): a resident runtime
server with admission control and weighted-fair tenants."""

from .admission import (AdmissionController, AdmissionRejected,
                        DeadlineExceeded, TicketCancelled)
from .fair import FairScheduler
from .server import RuntimeServer, Ticket

__all__ = ["AdmissionController", "AdmissionRejected", "DeadlineExceeded",
           "FairScheduler", "RuntimeServer", "Ticket", "TicketCancelled"]
