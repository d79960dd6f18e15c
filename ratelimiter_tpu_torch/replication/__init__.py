"""Live state replication and failover, flat (counterpart of
``ratelimiter_tpu/replication/``, one engine a storage).

The availability layer Redis AOF/replication gave the reference: the
primary's engine journals dirty slots per dispatched batch — a bitmap on
the engine's device (engine/state.py:DeviceSlotJournal) marked from the
dispatch's own uploaded lanes, or the host-side ``SlotJournal`` — a
``ReplicationLog`` coalesces them into epoch-stamped frames
(replication/wire.py, the reference's bytes), an async ``Replicator``
ships the frames off the decision path behind a byte-bounded in-flight
queue, and a ``StandbyReceiver`` applies them to a shadow storage through
``engine.write_rows`` (the row scatter on the card) that can be promoted
on failover with decisions equal to ``semantics/oracle.py`` for every key
at or before the last replicated epoch.  The control-plane RPC
(replication/control.py: PROBE / FENCE / LEASE / PROMOTE / RESTORE /
SHIP over length-prefixed JSON) exposes a node's fence, serving-lease and
promotion authority.

Still to port, with their ROADMAP items:

- ``sharded.py`` (per-shard epoch streams, ``ShardFailoverRouter``): A5,
  with the sharded engine;
- ``orchestrator.py`` (the autonomous failover state machine) and
  ``remote.py`` / ``hostproc.py`` (the cross-host topology in separate
  processes): A6 d;
- ``control.py``'s ``ControllerSeat`` / ``controller_handlers``: with
  ``control/`` (A7).

Wiring (service/wiring.py) is config-gated and OFF by default:

    replication.enabled     = true
    replication.role        = primary | standby
    replication.target      = standby-host:7401        (primary)
    replication.listen_port = 7401                     (standby)
    replication.interval_ms = 200                      (primary)
    ratelimiter.control.port = 7402                    (either role)
"""

from ratelimiter_tpu_torch.replication.control import (
    ControlClient,
    ControlError,
    ControlServer,
    LeaseMailbox,
    mux_handlers,
    primary_handlers,
    standby_handlers,
)
from ratelimiter_tpu_torch.replication.log import (
    ReplicationLog,
    device_journal_elected,
    engine_state_fingerprint,
    make_journal,
    read_rows_padded,
)
from ratelimiter_tpu_torch.replication.replicator import Replicator
from ratelimiter_tpu_torch.replication.standby import (
    ReplicationStateError,
    StandbyReceiver,
)
from ratelimiter_tpu_torch.replication.transport import (
    FrameArchive,
    InProcessSink,
    ReplicationServer,
    SocketSink,
    TeeSink,
)
from ratelimiter_tpu_torch.replication.wire import (
    DEFAULT_FRAME_BUDGET,
    chunk_frames,
    decode_frame,
    encode_frame,
)

__all__ = [
    "ControlClient",
    "ControlError",
    "ControlServer",
    "DEFAULT_FRAME_BUDGET",
    "FrameArchive",
    "InProcessSink",
    "LeaseMailbox",
    "ReplicationLog",
    "ReplicationServer",
    "ReplicationStateError",
    "Replicator",
    "SocketSink",
    "StandbyReceiver",
    "TeeSink",
    "chunk_frames",
    "decode_frame",
    "device_journal_elected",
    "encode_frame",
    "engine_state_fingerprint",
    "make_journal",
    "mux_handlers",
    "primary_handlers",
    "read_rows_padded",
    "standby_handlers",
]
