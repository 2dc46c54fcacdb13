"""The serving runtime and the serving fleet.

:mod:`.runtime` is the one-process multi-tenant runtime (admission,
isolation, the shared drain lane, kill-safe cancellation);
:mod:`.frontdoor` the supervisor of executor worker processes
(:mod:`.worker`: crash and wedge detection, session re-placement,
load shedding, reconnect supervision with partition-safe self-fencing);
:mod:`.launcher` and :mod:`.elastic` how workers come to exist and where
they and their sessions go; :mod:`.wire` the framed fleet transport
(Unix and TCP, CRC32 trailers, deadlines, network fault probes);
:mod:`.data_plane` the zero-copy result plane (memfd + SCM_RIGHTS,
binary frames, or capped base64, epoch- and CRC-verified);
:mod:`.journal` the supervisor's write-ahead session journal.  The
front door's autoscaling, quotas, result cache and crash adoption are
ROADMAP item 16d.
"""

from .data_plane import (
    DataPlaneCorruption,
    DataPlaneOverflow,
    DataPlaneStale,
)
from .elastic import (
    AutoScaler,
    Placement,
)
from .frontdoor import (
    AdmissionShed,
    FrontDoor,
    FrontDoorSession,
    WorkerLost,
    fleet_metrics,
)
from .journal import (
    JournalCorruption,
    JournalState,
    SessionJournal,
)
from .launcher import (
    LaunchedWorker,
    Launcher,
    LocalLauncher,
    RemoteLauncher,
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
    "AdmissionShed",
    "AdmissionTicket",
    "AutoScaler",
    "DataPlaneCorruption",
    "DataPlaneOverflow",
    "DataPlaneStale",
    "FrontDoor",
    "FrontDoorSession",
    "JournalCorruption",
    "JournalState",
    "LaunchedWorker",
    "Launcher",
    "LocalLauncher",
    "Placement",
    "QueryCancelled",
    "QueryTimeout",
    "RemoteLauncher",
    "ServeError",
    "ServeRuntime",
    "SessionJournal",
    "TcpTransport",
    "TenantSession",
    "Transport",
    "UnixTransport",
    "WireDesync",
    "WireError",
    "WorkerLost",
    "admission_tickets_issued",
    "fleet_metrics",
]
