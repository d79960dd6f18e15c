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

The topology spans PROCESSES (control.py + remote.py + hostproc.py): the
control-plane RPC lets the ``FailoverOrchestrator`` (orchestrator.py)
drive shard primaries and standbys running as separate OS processes —
several of them on one card — with a DISTRIBUTED fence: the
orchestrator grants each serving backend an epoch lease and renews it
while probes answer (relayed through the standby's mailbox when only
the orchestrator's own link is partitioned), a primary whose lease
expires SELF-FENCES within one TTL, and a promoted replacement always
carries a strictly higher epoch.  ``storage/chaos.py:
cross_host_failover_drill`` proves it with real subprocesses under
injected partitions.  Every role also serves the fleet controller's
ops (``ControllerSeat`` / ``controller_handlers``).

A sharded engine replicates per shard (sharded.py): one epoch stream a
shard into an ordinary flat standby of ``slots_per_shard`` slots, a
``ShardStandbySet`` of such standbys, and a ``ShardFailoverRouter`` that
serves a failed shard's keys from its promoted standby while the other
shards serve from the primary.  The in-process orchestrator
(``ratelimiter.orchestrator.*``) runs that N+1 topology under the
``FailoverOrchestrator``; ``storage/chaos.py``'s ``shard_failover_drill``,
``orchestrated_failover_drill`` and ``orchestrator_flap_drill`` prove it.

Wiring (service/wiring.py) is config-gated and OFF by default:

    replication.enabled     = true
    replication.role        = primary | standby
    replication.target      = standby-host:7401        (primary)
    replication.targets     = host:port,host:port,...  (sharded primary,
                                                        one a shard)
    replication.listen_port = 7401                     (standby)
    replication.interval_ms = 200                      (primary)
    ratelimiter.control.port = 7402                    (either role)
    ratelimiter.orchestrator.enabled = true            (sharded engine)
"""

from ratelimiter_tpu_torch.replication.control import (
    ControlClient,
    ControlError,
    ControllerSeat,
    ControlServer,
    LeaseMailbox,
    controller_handlers,
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
from ratelimiter_tpu_torch.replication.orchestrator import (
    BackendLeaseChannel,
    FailoverOrchestrator,
    OrchestratorConfig,
)
from ratelimiter_tpu_torch.replication.remote import (
    FanoutLeaseChannel,
    RemoteBackend,
    RemoteReceiver,
    RemoteShardDirectory,
    RemoteStandbySet,
    parse_ready,
    standby_witness,
)
from ratelimiter_tpu_torch.replication.replicator import Replicator
from ratelimiter_tpu_torch.replication.sharded import (
    ShardedReplicationLog,
    ShardedReplicator,
    ShardFailoverRouter,
    ShardStandbySet,
)
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
    "BackendLeaseChannel",
    "ControlClient",
    "ControlError",
    "ControlServer",
    "ControllerSeat",
    "DEFAULT_FRAME_BUDGET",
    "FailoverOrchestrator",
    "FanoutLeaseChannel",
    "FrameArchive",
    "InProcessSink",
    "LeaseMailbox",
    "OrchestratorConfig",
    "RemoteBackend",
    "RemoteReceiver",
    "RemoteShardDirectory",
    "RemoteStandbySet",
    "ReplicationLog",
    "ReplicationServer",
    "ReplicationStateError",
    "Replicator",
    "ShardFailoverRouter",
    "ShardStandbySet",
    "ShardedReplicationLog",
    "ShardedReplicator",
    "SocketSink",
    "StandbyReceiver",
    "TeeSink",
    "chunk_frames",
    "controller_handlers",
    "decode_frame",
    "device_journal_elected",
    "encode_frame",
    "engine_state_fingerprint",
    "make_journal",
    "mux_handlers",
    "parse_ready",
    "primary_handlers",
    "read_rows_padded",
    "standby_handlers",
    "standby_witness",
]
