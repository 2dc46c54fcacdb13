"""The serving runtime and the fleet's transports.

:mod:`.runtime` is the one-process multi-tenant runtime (admission,
isolation, the shared drain lane, kill-safe cancellation);
:mod:`.wire` the framed fleet transport (Unix and TCP, CRC32 trailers,
deadlines, network fault probes); :mod:`.data_plane` the zero-copy
result plane (memfd + SCM_RIGHTS, binary frames, or capped base64,
epoch- and CRC-verified); :mod:`.journal` the supervisor's write-ahead
session journal.  The multi-process fleet (front door, workers,
launchers, autoscaler, result cache) is ROADMAP item 16c.
"""

from .data_plane import (
    DataPlaneCorruption,
    DataPlaneOverflow,
    DataPlaneStale,
)
from .journal import (
    JournalCorruption,
    JournalState,
    SessionJournal,
)
from .runtime import (
    AdmissionTicket,
    QueryCancelled,
    QueryTimeout,
    ServeError,
    ServeRuntime,
    TenantSession,
    admission_tickets_issued,
)
from .wire import (
    TcpTransport,
    Transport,
    UnixTransport,
    WireDesync,
    WireError,
)

__all__ = [
    "AdmissionTicket",
    "DataPlaneCorruption",
    "DataPlaneOverflow",
    "DataPlaneStale",
    "JournalCorruption",
    "JournalState",
    "QueryCancelled",
    "QueryTimeout",
    "ServeError",
    "ServeRuntime",
    "SessionJournal",
    "TcpTransport",
    "TenantSession",
    "Transport",
    "UnixTransport",
    "WireDesync",
    "WireError",
    "admission_tickets_issued",
]
