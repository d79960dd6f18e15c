#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``ratelimiter_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the build of every kernel from ``ratelimiter_tpu_torch/ops/cuda/*.cu``
   (one nvcc per source, all started together) and of the C slot index
   from ``native/slot_index.cpp`` (g++, beside them).
2. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes and, for the solver and the two step write-backs, at
   edge layouts too (segments of 31-33 and 1023-1025 lanes, dead and
   weightless lanes inside live segments, one key over 8192 lanes, an
   all-dead batch, 1, 8191 and 2^15 + 3 lanes; for the scatter, the
   admin reset's one zero row, at a live and at a dead slot,
   ``engine.write_rows``' 32 and 8192 rows, and layouts off the main
   paths: L = 3 and 5, lane counts no multiple of a block's 256, an
   L = 6 state view one row in (8-byte aligned), rows one element in,
   slots -1, -7, S, S + 5 and 2^40 under a set mask, live duplicates
   with identical rows, an all-dead batch);
   results must be bit-equal (for the write-backs, the relay step and
   the scatter: the whole state).  Each kernel's median time (CUDA
   events) beside the launch floor (an empty kernel's device time), its
   bound, its plain version's time and, for the scatter, the time of
   ``index_put_`` on the same live rows (a yardstick the port never
   calls) and the sector figure: the 32-byte sectors the live rows touch,
   at 3.35 TB/s.
3. Micro-batch route: ``GpuBatchedStorage(num_slots=1 << 20)`` on the card
   with the service's api / auth / burst limiters on a deterministic
   clock; a few thousand ``try_acquire`` calls (Zipf(1.1) keys over 1M,
   token bucket permits in [1, 100], the clock crossing window boundaries
   and stepping backward once), admin resets of hot keys, and 8192-lane
   ``try_acquire_many`` bursts.  Every decision is checked against
   ``semantics/oracle.py``.  Each step must launch one solver and one
   write-back and no row scatter; the resets launch the row scatter once
   each; the relay step must not run.  The storage's
   ``ratelimiter.time.backward_clamp`` counter must equal its
   ``backward_clamps``.
4. Where a micro step's time goes, for the token bucket and the sliding
   window: host enqueue, device time and drain of one staged step at 32
   and 8192 lanes and of 4097 requests in the 8192-lane bucket; the
   solver's and the write-back's device time inside the step, from event
   pairs behind a backlog and from the profiler's CUDA activity; the
   step's top-level torch op count.
5. Relay stream route, the headline deployment (a 1M-key token bucket,
   100 permits per minute refilled at 50/s, under bounded Zipf(1.1)
   traffic, ``GpuBatchedStorage(num_slots=2_000_128)``):
   (a) 2^21 token-bucket and 2^20 sliding-window requests through
   ``try_acquire_stream_ids`` in four calls each, the clock advanced
   between calls, every decision checked against the oracle in arrival
   order; (b) three timed passes of 2^24 requests, with decisions/s per
   pass, a per-chunk breakdown and the device's idle share, and one more
   pass under the torch profiler for the card's device time.  The relay
   step's launch counter must grow for both algorithms.  The first timed
   pass prints the stream stage timers' records and seconds
   (``ratelimiter.stream.*``): index, layout, enqueue and fetch must have
   both, and their seconds together must fit the pass's wall time.
6. The permit stream route at full width (``try_acquire_stream_ids`` with
   a permits lane or a lid array, ``batch = 2^19, subbatches = 8``, on
   ``GpuBatchedStorage(num_slots=2_000_128)``): (a) bench.py's scenario 5,
   a token bucket of 100 permits per minute refilled at 100/s over 1M
   uniform keys, permits uniform in [1, 100] (the weighted relay's
   rank-major mode); (b) the same over the bounded Zipf(1.1) keys (its
   flat fallback, 2^19-lane flat steps); (c) as (b) with each key's
   permits fixed at 1 + key % 100 (coalesced); (d) scenario 4's 100K
   token-bucket tenants with scenario 5's permits lane, a lid array per
   request (the flat step and its K-step scan: 8 steps of 2^19 lanes per
   2^22-request super-batch); (e) a sliding window of 100/min under (b).
   Each: 2^20 requests in two calls, the clock moving between them, every
   decision checked against the oracle (one per tenant in (d)), each
   chunk's mode asserted, and the launch counters of the kernels the mode
   runs; then three timed passes of 2^22 requests (decisions/s, per-chunk
   breakdown, the device's idle share) and one under the profiler.
   Phase 2 holds the solver and both write-backs at (b)'s 2^19-lane flat
   batch on the 2_000_128-row state, and the row scatter at the weighted
   relay's unsorted lanes.
7. The relay's words mode and resident digest (unit permits,
   ``acquire_stream_ids``): (f) bench.py's scenario 4 at full size, 100K
   token-bucket tenants with 8 keys each and a lid per request on
   ``align_slots(800_000)`` slots — a warm pass over a disjoint key
   population, a churn pass (every chunk ``resident``, with lid uploads)
   whose decisions, state and lid map must equal the same calls on a
   ``device="cpu"`` storage, 2^20 steady-state decisions against the
   oracle, and three timed steady passes (every lid resident); (g)
   bench.py's scenario 3, a sliding window of 100/min over 10M uniform
   keys on ``align_slots(12_500_000)`` slots — every chunk ``words``, a
   warm pass and three timed passes, and 2^20 decisions of a fresh
   storage against the oracle; then words mode past uint16 counts (a
   limit of 70_000, one limiter and a lid array), every decision against
   the oracle.  Passes are 2^22 requests (bench.py runs three or four),
   each with a per-chunk breakdown (mode, requests, uniques, lid uploads,
   C walk, layout, enqueue, drain), decisions/s and one pass under the
   profiler for the idle share.  Each run must launch the row scatter and
   no other kernel.  Phase 2 holds the row scatter at these modes' lanes:
   (g)'s 2^22 per-request lanes on the 12_500_224-row state and (f)'s
   2^19 slot-sorted unique lanes on the 800_000-row state.

8. String keys (bench/profile_stream_r5.py's ``strs`` deployment): the
   headline's token bucket over its 1M bounded-Zipf keys written as
   ``f"k{i}"`` on 2_000_128 slots, through
   ``TokenBucketRateLimiter.try_acquire_many``, which must take
   ``acquire_stream_strs``: 2^20 decisions in two calls against the
   oracle, three timed passes of 2^21 requests (per chunk: mode, the
   hashing's seconds, C walk, enqueue, drain) and one under the
   profiler; then a sliding window of 100/min over the same keys, 2^20
   decisions against the oracle.  The relay step must launch.
9. Eviction under partitions: a 2^20-slot storage on 8 partitions takes
   a churn stream (1.25x more keys than partition 0 holds, routed there
   by the port's routing, in calls of 2^16 requests, then the first and
   the last of them again) under a token bucket of one permit; its
   decisions and final state must equal a ``device="cpu"`` storage's on
   the same calls, and evictions must have happened.
10. The storage as ``service/wiring.py`` composes it, at
   ``application.properties``' settings: ``GpuBatchedStorage(num_slots=
   2^20)`` wrapped as retry(breaker(chaos(storage))) (``breaker.*``:
   threshold 8, open 5000 ms, one probe; retries 3 attempts at 10 ms
   linear backoff), the degraded host limiter subscribed to policy
   updates, phase 3's trio over it: 2000 ``try_acquire`` against the
   oracle, a live ``set_policy`` the fallback must hear, and a 2^15-key
   ``try_acquire_many`` of the cache-less auth limiter that must take
   ``acquire_stream_strs`` (the relay step).  (a) The legacy contract:
   the ten methods through the stack against a plain ``InMemoryStorage``,
   the sliding-window log over the stack against a list of admission
   times, the compat trio over a bare ``InMemoryStorage`` against the
   oracle; no kernel may launch.  (b) ``storage/chaos.py:outage_drill``
   on a 2^20-slot storage, 2048 keys in waves of 512: healthy and
   post-resync decisions equal to the oracle, no backend call while the
   breaker is open, admission per key and window at most
   ``max_permits``, no degraded decision while no fault is injected, and
   the resync's row-scatter launches equal to its device clears.  (c)
   The hybrid serving tier (``ratelimiter.cache.hybrid.*``: ttl 50 ms,
   65536 keys, 64 unconfirmed, guard 5 ms) on a second 2^20-slot storage:
   3000 trio ``try_acquire`` over Zipf keys and hot keys against the
   oracle, divergence 0, no pending confirmation at the end; the
   host-served share beside the micro steps' launches.  (d) The
   ``ratelimiter.storage.latency`` p50 / p99 of (b)'s and (c)'s micro
   dispatches.  Every kernel must launch in phase 10.
11. The service as users start it (``service/app.py`` over
   ``service/wiring.py:build_app``, ``application.properties`` as the
   repo ships it, ``server.port=0``; with several visible cards
   ``parallel.shard=off``, printed): (a) ``python -m
   ratelimiter_tpu_torch`` spawned from a fresh copy of the package,
   ``native/`` and the properties, timed from the spawn until
   ``/api/health`` answers (its C index and kernels build from source),
   one decision and ``/actuator/health`` UP, then stopped; and
   ``build_app`` in this process: the chain retry -> breaker -> the
   device storage with the degraded limiter subscribed, its warmup
   launching the solver and both write-backs; (b) over loopback, checks
   no wall clock can upset: a fresh user's 12 logins inside one window
   answer 10 x 200 then 2 x 429 with the body and ``X-RateLimit-*``
   headers, both admin reset paths (each launching the row scatter once
   per cleared slot), ``/actuator/health`` UP and ``/actuator/prometheus``
   carrying ``ratelimiter_storage_latency``; (c) the app over
   ``GpuBatchedStorage(num_slots=2^20)`` on a manual clock: 3072 HTTP
   requests (``/api/data``, ``/api/login``, ``/api/batch``) from 8 client
   threads over Zipf(1.1) users, each user's requests sent in order by
   one thread, the clock stepping only between rounds; every status
   against the oracle; (d) ``ratelimiter.overload.max_pending=64`` under
   32 concurrent clients with 4 requests in flight each while the card's
   next dispatch is held: 429 Overloaded with ``Retry-After`` for every
   shed, ``shed_total > 0``, health SHEDDING; (e) the client's p50 / p99
   of ``GET /api/data`` in (c) beside the storage's
   ``ratelimiter.storage.latency`` p50 / p99 and the batcher's stage
   histograms (``ratelimiter.latency.*``), and one client alone on the
   same app.
12. Token leases, at ``application.properties``' ``ratelimiter.lease.*``
   and ``ratelimiter.edge.*`` with both turned on: (a) 200 seeded reserve
   and credit calls at 1, 32 and 8192 lanes (duplicates, padding, zero
   and negative amounts, window rollover, a step back, stale windows,
   buckets at capacity) through a 2^20-slot engine on the card and one on
   the CPU: outputs and the whole packed state equal after every call;
   (b) 8 threads, each with a ``LeaseClient`` per limiter (the service's
   burst and api) over ``DirectTransport`` on its own share of 4096
   leased keys, beside per-decision traffic on other keys and a
   ``direct_fallback`` contender on leased keys, on a manual clock that
   steps between rounds (``GpuBatchedStorage(num_slots=2^20)``, the
   manager from the properties): every state-changing storage call,
   replayed in order against the oracle, must equal what the card
   answered, ``manager.ops`` must equal the lease calls made, every key's
   ``available_many`` the oracle's after ``release_all``, the row
   scatter must launch once a lease step, and ``over_admission`` must be
   0; frames per decision printed; (c) a 2^16-slot storage on its
   elected partitions filled by a 2^17-key string stream, then 4096
   fresh-key grants, each (and every eighth key's availability) equal to
   the oracle's; (d) ``build_app`` with both tiers on: 8 edge-session
   clients on 64 shared hot keys, ``/actuator/edge`` and
   ``/actuator/tenants`` over loopback, every live pool conserving its
   permits after ``release_all``; (e) the p50 / p99 of
   ``storage.lease_reserve`` / ``lease_credit`` on one key and of the
   manager's grant and renew, a reserve step's host enqueue, device work
   and torch-op count at 1 and 8192 lanes, local decisions/s on 1 and 8
   threads, a 64-pool portfolio renewal's wall time, and the row
   scatter's launches.  Phase 2 holds the row scatter at an 8192-lane
   reserve's rows (L = 4 and 6, taken from the step on 2^20-row states).

13. Durability and fencing, at ``application.properties``' storage (2^20
   slots, 8 partitions elected on the card's host): (a) the trio's micro
   traffic through ``acquire`` / ``acquire_many`` (24 bursts of 8192
   Zipf(1.1) keys over 1M and 600 singles, token bucket permits in [1,
   100]) and a stream of 900_000 distinct int keys, ``save_checkpoint``
   (wall time, bytes on disk), ``restore_checkpoint`` into a fresh card
   storage (into the resident tensors, not rebinding them) and into a
   ``device="cpu"`` one; state and index equal to the saved storage's,
   ``read_rows`` of every live slot equal, then the next 2^16 decisions
   on all three equal to each other and to the oracle; (b) the headline's
   2_000_128-slot table after one 2^24-request relay pass, saved and
   restored, then one more pass on both: decisions and state equal; (c) a
   checkpoint of a ``device="cpu"`` storage restored on the card, the next
   stream and micro decisions and the state equal; (d) ``export_keys`` of
   (a)'s storage imported into a flat 2^21-slot storage: its
   ``rl_scatter_rows`` launches (one an algorithm, ~1M rows) held
   bit-equal against the plain version on a clone of the state before
   them and the larger timed beside ``index_put_`` and its bytes and
   sectors figures; the next 2^16 stream decisions equal; a keyed export
   of a ``checkpointable=True`` 2^14-slot storage imported into 2^16
   slots, the next decisions equal; (e) after ``fence``, past an expired
   serving lease on the manual clock and during a gated
   ``promote_from_replica``, every decision surface (the lease calls
   included) refuses (``FencedError``, ``PromotionInProgressError``); a
   stale fence and a stale lift raise ``ValueError``; a ``LeaseManager``
   over the storage revokes on an epoch advance; (f) a bit flip, a
   truncated ``state.npz`` and an edited manifest are each refused with
   ``CheckpointCorruptError``, the state untouched.  Checkpoints go to
   ``build/durability/``, removed at the phase's end.

14. Flat replication and the control plane, at ``application.properties``'
   storage (2^20 slots, the partitions the host elects): (a) a primary
   and a standby storage on the card, the primary journaled by the
   device journal (``make_journal("auto")`` on CUDA), the standby with no
   limiter registered (the frames register them); waves of the trio's
   micro traffic (6 bursts of 8192 Zipf(1.1) keys over 1M and 120
   singles, against the oracle), a 2^22-request relay pass of the
   headline's keys (burst bucket), a 2^19-request weighted pass (api
   window, permits in [1, 100]), a lease reserve / credit round of 128
   keys on two limiters and admin resets, each followed by a cut applied
   to the standby and ``engine_state_fingerprint`` of both equal byte for
   byte; then a loss wave, ``close()`` on the primary, ``promote()`` and
   post-failover micro waves against the oracle rolled back to the
   promoted epoch; (b) the bootstrap cut (every slot: two tb sub-frames
   of 699050 and 349526 rows, two sw ones of 524288): sub-frames, bytes,
   the wall time of the cut (drain, row read, index dump), encode,
   decode and apply; each apply's ``rl_scatter_rows`` launch held
   bit-equal to the plain version, the largest of each algorithm timed
   beside ``index_put_`` and its bytes bound; (c) each delta cut's dirty
   rows, wall time and ``last_cut_lag_ms``, and the device journal's
   cost on the decision path: host enqueue and top-level torch ops of an
   8192-lane token-bucket micro step with the journal attached and
   detached, 12 alternating pairs; (d) two storages, one journaled on
   the card and one on the host, the same traffic: equal dirty sets
   after every call; (e) ``SocketSink`` -> ``ReplicationServer`` on
   loopback: a bootstrap's bytes/s and the heartbeat round; (f) two
   ``build_app`` contexts on loopback ports and a manual clock (the
   standby, then a primary with ``replication.target``, each with
   ``ratelimiter.control.port``): logins, batches and ``GET /api/data``
   through the primary against the oracle, ``SHIP`` over the control
   port, ``GET /actuator/replication`` on both, PROBE, FENCE (the raw
   storage refuses, the HTTP tier fails open as the reference's does),
   LEASE refused while fenced, RESTORE, LEASE; ``POST
   /actuator/replication/promote`` on the standby, then its decisions
   against the oracle rolled back to the shipped epoch.
15. The decision sidecar (``service/sidecar.py``, wire v1-v6): ``build_app``
   of ``application.properties`` with ``ratelimiter.sidecar.enabled``,
   ``ratelimiter.lease.enabled``, the listeners on port 0 and a manual
   clock (2^20 slots, the elected partitions, ``batcher.max_batch`` 8192,
   the shipped frame, key, pipeline and deadline bounds): (a) 8 threads,
   each its own ``SidecarClient`` (v2 and v4 by turns, v4 with trace
   ids), pipelined TRY_ACQUIRE bursts 64 deep on the burst bucket, keys
   disjoint per thread (Zipf(1.1) over 1M), permits in [1, 100], every
   answer against the oracle; frames/s, a burst's round trip p50 / p99,
   micro steps per frame and, for one round under the profiler, the
   device's idle share; (b) v5 BATCH frames of as many rows as the
   4096-byte cap admits for 13-byte keys, on the app's storage (8
   partitions: ``acquire_async_many``) and on a second card storage with
   ``host_parallel=0`` (``acquire_async_block``), both against the
   oracle and each other, decisions/s and the columnar assign's time;
   (c) ``LeaseClient``s over the sidecar, RESET frames, then ``python -m
   ratelimiter_tpu_torch.edge.edgeproc`` as a subprocess in front of it
   (its ready line, BULK_RENEW upstream, exit 0 on stdin EOF), each
   key's permits on the card equal to the oracle's after every release,
   frames per decision; (d) ``GET /api/data`` and a sidecar AVAILABLE
   frame on one counter; (e) ``ingress_drill`` on the card and a client
   killed mid-pipeline (the batcher's queue and waiters back to 0); (f)
   the solver's and both write-backs' launches grew with (a)-(b), the
   row scatter's with (c) and its RESET frames.
16. The cross-host topology (``replication/hostproc.py`` nodes as child
   processes of this script on the one card, ``--device cuda``, each
   with its stdin a pipe this script holds, its stdout drained by a
   thread, its stderr a temporary file; stopped by closing stdin, killed
   by its own pid): (a) ``storage/chaos.py:cross_host_failover_drill``
   at the reference's defaults (the orchestrator in this process, every
   link through a ``FaultInjectingProxy``): the witness veto under a
   control partition, the isolated primary's self-fence within one
   lease TTL plus the drill's 0.75 s slack, one promotion at a higher
   epoch, every decision equal to the oracle; (b) a primary and a
   standby node at ``application.properties``' 2^20 slots (the elected
   8 partitions), order-only token-bucket and sliding-window limiters:
   2^18 keys a limiter and 2^14 of them again through v5 BATCH frames
   from 4 sidecar connections against the oracle (decisions/s), SHIP,
   SIGKILL of the primary; the orchestrator (fence lease 1.2 s, witness
   0.5 s) fences, promotes and re-points; the times from the kill to
   the reaped process, SUSPECT, FENCING (from the reaping, within the
   detection budget plus one probe interval), PROMOTING and promoted,
   the promotion RPC, the promoted
   sidecar's first answer; 4096 sampled preloaded keys and 1024 fresh
   ones asked of the promoted sidecar against the oracle; the nodes'
   ready times and kernel launches (each node prints its counts on its
   clean exit; the killed primary's die with it).  The script builds
   every kernel before it spawns a node, so the nodes load them from
   ``build/kernels/``.
17. The sharded engine (``parallel/sharded.py``): 4 shards, on ``cuda:0``
   or over the visible cards in turn when there are several, each with
   its own stream.  (a) The micro route on 2^20 slots in all: the trio's
   traffic (6 ``acquire_many`` bursts of 8192 Zipf(1.1) keys over 1M,
   1200 single decisions, token bucket permits in [1, 100]) on the
   sharded storage and on a flat one of the same slots, every decision
   equal to the other's and to the oracle, admin resets (the row
   scatter), each shard's micro steps (one solver and one write-back a
   step); a staged 8192-lane tb step on each storage: host enqueue,
   device span, drain, top-level torch ops, the idle share.  (b) The
   headline deployment (2_000_128 slots) sharded: the headline's first
   2^19 requests against the oracle (the per-shard digest) and a flat
   storage, uniform keys (words mode), scenario 5's permit mix (uniform
   and Zipf keys with permits in [1, 100], a 64-tenant lid array in
   2^22-request super-batches: the flat step on every shard), a 2^20-key
   string stream, each equal to the flat storage's; three timed 2^22
   headline passes (decisions/s, each chunk's per-shard requests, modes
   and lane drain times) and one under the profiler.  (c) ``build_app``
   of ``application.properties`` as shipped (``parallel.shard=auto``):
   flat on one visible card, sharded over several, ``GET /api/data``
   answering.
18. Sharded replication, the shard failover router and the in-process
   orchestrator (``replication/sharded.py``), the shards as in 17, the
   standbys on the card.  First a negative token-bucket permit on seven
   surfaces of the card's flat and sharded storages raises
   ``ValueError`` as on a ``device="cpu"`` one, rows unchanged, and
   permit 0 decides alike (ROADMAP C11).  (a) ``shard_failover_drill``
   at the reference's defaults, then at 2^20 slots (2^18 a shard) with
   2^18 keys, 2^18-request Zipf waves and 4096-key string batches: every
   decision against the oracle, every standby byte-equal to its shard
   after each cut; each shard's cuts (full or delta, rows, time, the row
   read's and the index dump's), the bootstrap, the promotion and the
   kill to the first answer, the drill's wall time bounded.  (b)
   ``orchestrated_failover_drill`` (2 cycles) and (c)
   ``orchestrator_flap_drill``: counts, the kill to MONITORING and each
   flap bounded, no promotion from a flap.  (d) ``build_app`` with
   ``ratelimiter.orchestrator.enabled=true`` over
   ``service/wiring.py:sharded_engine`` on the 4 shards:
   ``/actuator/orchestrator``; a shard failed before any cut goes
   FAILED (health 503 DOWN) and ``POST /actuator/orchestrator/unfence``
   recovers it; after a cut a failed shard reads DEGRADED, the breaker
   lists it, and the orchestrator promotes its standby; users' requests
   answered throughout.
19. Adaptive control and leases under failover.  (a)
   ``lease_failover_drill`` at the reference's defaults, then at 2^20
   slots (2^18 a shard) with 1024 leased keys an algorithm: the frames a
   decision, the dead client's strand, honor-or-revoke across the
   orchestrated promotion (over-admission equal to the burns on revoked
   leases, survivor leases unrevoked), the reserve / credit log replayed
   bit-identically against the oracle, the wall time bounded; (b)
   ``aggregator_failover_drill`` at the defaults: the collapse, the
   aggregator's death bounded by its bulk budgets, the scoped
   revocation; (c) ``overload_drill`` at the reference's fast arguments
   on the card's host (no kernel): the admitted p99 per load multiplier;
   (d) ``build_app`` of ``application.properties`` with
   ``ratelimiter.control.enabled``, ``ratelimiter.control.fleet.enabled``
   and a free ``ratelimiter.control.port`` on a manual clock: the fleet
   plane elects over the app's own control port, a Zipf unit-permit
   stream and micro bursts, a storm, one controller tick cutting the
   auth limiter at generation 1, the same traffic after it, every
   decision against the oracle rebuilt from ``policy_info`` rows, the pin
   over HTTP, ``/actuator/controller`` and the health blocks; (e) three
   storages on the card serving the control RPC and two candidate
   planes: ``ctrl-a``'s claim and broadcast, its lease expiring,
   ``ctrl-b`` seated at epoch 2 and converging, ``ctrl-a``'s stale-epoch
   writes refused with the policy rows on the card byte-equal.
20. The fleet tier and the chaos conductor.  (a) ``rolling_upgrade_drill``
   on nodes on the card (``fleet.LocalExecutor(device="cuda")``) at the
   shipped 2^20 slots (2^19 a shard of its 2-shard cell), 2^16 Zipf keys,
   2048 requests a wave, 2 waves a step: every decision against the
   oracle, 4 promotions, 4 respawns, 4 re-seeds, 2 upgrade steps, the
   kill to the promotion past half the serving lease, every live node at
   v2, N+1 on both shards; each node's boot, each re-seed job, and each
   node's kernel launches from its clean exit (the SIGKILLed node's are
   lost).  (b) ``partitioned_controller_drill`` on two card nodes of 2^20
   slots: the CPU test's claims, detection within its budget, the
   partition to the demotion and to the successor's convergence.  (c)
   ``chaos.run_plan`` of the faulted plan (seed 0, 14 steps, fault rate
   0.5) at ``DEFAULT_TOPOLOGY`` on the card, its report equal key for key
   to the same plan's on ``device="cpu"``; the same schedule shape at 4
   shards of 2^18 slots a cell and 4096 direct keys, without a
   violation; the planted ``epoch_rollback`` minimized on the card to the
   planted action and replayed from its artifact to the CPU's violation.
   The relay step's launches are printed with the stream chunks' modes.

Every storage of phases 3, 5-8, 10 and 12-15 builds the host slot index
its table elects on this host (``storage/gpu.py:elect_host_parallel``: 8
partitions on an 8-core host from 2^16 slots); the script prints the
cores and the partition count per storage and per stream chunk.  Phase
5 also runs the headline passes on one index over the same slots
(``host_parallel=0``) and prints both indexes' decisions/s and C walk
shares.

The line before the last is ``{"kernels": [...]}`` (each kernel's
launches summed over phases 3 and 5-20, phases 16's and 20's nodes'
from the node processes); the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20251016
NUM_SLOTS = 1 << 20
KEY_SPACE = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
L2_FLUSH_BYTES = 128 << 20       # more than the H100's 50 MB L2
ALU_OPS_PER_S = 67e12            # H100 SXM non-tensor fp32 peak, as the
                                 # stand-in for the integer ALU rate
# One step of the solver's dependent chain, in SM cycles: an int64 compare
# (two dependent 32-bit compares) and an int64 add (two dependent 32-bit
# adds, the carry first) issue side by side, then S is selected: three
# dependent integer instructions at about 4 cycles each.
WALK_STEP_CYCLES = 12
TRIO = {
    # name: (algo, RateLimitConfig kwargs) — service/wiring.py's trio.
    "api": ("sw", dict(max_permits=100, window_ms=60_000,
                       enable_local_cache=True, local_cache_ttl_ms=100)),
    "auth": ("sw", dict(max_permits=10, window_ms=60_000,
                        enable_local_cache=False)),
    "burst": ("tb", dict(max_permits=50, window_ms=60_000,
                         refill_rate=10.0)),
}
N_SINGLE = 3000
N_BURSTS = 6
BURST = 8192
# The relay route's headline deployment (bench.py's scenario 2): 1M keys
# under bounded Zipf(1.1), a 2M-slot table (align_slots(2 * 10**6): a
# 21-bit slot field, 10-bit counts, uint8 counts back), passes of 2^24
# requests cut by the stream into a 2^19 chunk and the rest.
STREAM_SLOTS = 2_000_128
STREAM_KEYS = 1_000_000
STREAM_PASS = 1 << 24
FIRST_CHUNK = 1 << 19
HEADLINE_TB = dict(max_permits=100, window_ms=60_000, refill_rate=50.0)
HEADLINE_SW = dict(max_permits=100, window_ms=60_000,
                   enable_local_cache=False)
# The checked stream calls: (requests per call, clock step before it, ms)
# for each algorithm; calls of 2^20 requests and more span two chunks.
STREAM_CHECKS = {"tb": ([1 << 20, 1 << 19, 1 << 18, 1 << 18],
                        [0, 7_000, 30_000, 61_000]),
                 "sw": ([1 << 19, 1 << 18, 1 << 17, 1 << 17],
                        [0, 20_000, 45_000, 61_000])}
# The permit stream route (phase 6): bench.py's B and K, passes of
# B * K requests, checked calls of 2^19 requests each (two per
# deployment), and scenario 4's tenants.
PERMIT_BATCH = 1 << 19
PERMIT_SUBBATCHES = 8
PERMIT_PASS = PERMIT_BATCH * PERMIT_SUBBATCHES
PERMIT_CHECKS = ((1 << 19, 0), (1 << 19, 7_000))
TENANT_CHECKS = ((3 << 18, 0), (1 << 18, 7_000))
BURST_TB = dict(max_permits=100, window_ms=60_000, refill_rate=100.0)
N_TENANTS = 100_000
KEYS_PER_TENANT = 8
FLAT_LANES = 1 << 19
# Integer operations of one live relay lane (decode, refill or roll, the
# decision, the row write), counting an int64 operation as two 32-bit
# ones: about 32 int64 operations.
RELAY_OPS_PER_LANE = 64
# Phase 7, the relay's words mode and resident digest.  (f) bench.py's
# scenario 4: 100K token-bucket tenants, 8 keys each, on
# align_slots(800_000) slots (a 20-bit slot field, 11-bit counts); (g)
# its scenario 3: a sliding window of 100/min over 10M uniform keys on
# align_slots(12_500_000) slots (24-bit slots, 7-bit counts).  Passes of
# 2^22 requests; WORDS_CHUNK is the second chunk of such a pass in words
# mode (the first is 2^19; the rest fits the words wire budget).
TENANT_SLOTS = 800_000
TENANT_PASS = 1 << 22
TENANT_CHECK_TENANTS = N_TENANTS // 8
WORDS_SLOTS = 12_500_224
WORDS_KEYS = 10_000_000
WORDS_PASS = 1 << 22
WORDS_CHUNK = WORDS_PASS - FIRST_CHUNK
WORDS_SW = dict(max_permits=100, window_ms=60_000, enable_local_cache=False)
# The words-mode check past uint16 counts: a limit no count dtype holds.
HUGE_SLOTS = 4096
HUGE_LIMIT = 70_000
# Phase 8, string keys (bench/profile_stream_r5.py's ``strs`` deployment:
# the headline's limiter and keys as f"k{i}"): passes of 2^21 requests,
# checked calls of 2^20 / 2.  Phase 9: a 2^20-slot table on 8 partitions,
# churned in calls of 2^16 requests.
STRS_PASS = 1 << 21
STRS_CHECK = 1 << 19
CHURN_SLOTS = 1 << 20
CHURN_CHUNK = 1 << 16
# Phase 10, the storage as service/wiring.py composes it, with
# application.properties' breaker.* and ratelimiter.cache.hybrid.*
# settings.  The drill runs 2048 keys in waves of 512 requests.
BREAKER = dict(failure_threshold=8, open_ms=5000.0, half_open_probes=1)
HYBRID = dict(serving_cache_ttl_ms=50.0, serving_cache_max_keys=65536,
              serving_cache_unconfirmed_cap=64, serving_cache_guard_ms=5.0)
COMPOSE_SINGLE = 1500
COMPOSE_STRS = 1 << 15
LEGACY_CALLS = 1000
DRILL_KEYS = 2048
DRILL_WAVE = 512
DRILL_WAVES = 2
HYBRID_SINGLE = 3000
# Phase 11: rounds of HTTP requests from client threads, the manual clock
# stepping between rounds.
SERVICE_THREADS = 8
SERVICE_ROUND = 512
SERVICE_ROUNDS = 6
SERVICE_SOLO = 300


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def host_index_line(label: str, storage) -> None:
    """The host slot index a storage built: the host's cores and the
    partition count (``host_parallel``, 0 for one index) elected for its
    table."""
    print(f"{label}: host index over {storage.engine.num_slots} slots, "
          f"{len(os.sched_getaffinity(0))} cores, host_parallel "
          f"{storage._host_parallel}")


def cuda_ms(fn, reps: int, rounds: int = 5):
    """Time per call of ``fn`` on the card: ``(device_ms, host_ms)``.

    ``host_ms`` is the host's time per call, enqueue included.
    ``device_ms`` is the median over ``rounds`` of CUDA events around
    ``reps`` back-to-back calls, divided by ``reps``; each round first
    enqueues a sleep kernel that outlasts the host's enqueue of the calls,
    so the card runs them back to back and the events time the card, not
    the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # Cycles at 2 GHz (above the H100's boost clock), with 50% headroom.
    sleep_cycles = int(host_s * 1.5 * 2e9) + 100_000
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), host_s / reps * 1e3


def cold_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn`` with the card's 50 MB L2 cache
    flushed before each call (a 128 MB write), as a stream chunk finds the
    state after the host's walk of the chunk: the median over ``reps``
    calls of CUDA events around the call alone, behind a sleep backlog."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.fill_(1)
    fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * reps
    torch.cuda._sleep(int(host_s * 1.5 * 2e9) + 100_000)
    events = []
    for _ in range(reps):
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def zipf_keys(rng, n: int) -> np.ndarray:
    return (rng.zipf(1.1, n) - 1) % KEY_SPACE


def zipf_stream(rng, num_keys: int, n: int, a: float = 1.1) -> np.ndarray:
    """Bounded Zipf(a) keys in [0, num_keys): key k with probability
    proportional to (k + 1)^-a (the repository's benchmark generator)."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(num_keys, size=n, p=probs)


def pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def walk_ms(steps: int, clock_hz: float) -> float:
    """Least time of a chain of ``steps`` dependent solver steps."""
    return steps * WALK_STEP_CYCLES / clock_hz * 1e3


def bound_ms(nbytes: float, ops: float, walk: float = 0.0):
    """The larger of the bytes term and the operations term; ``walk`` is
    the time of the longest dependent chain of operations, which bounds
    the operations term from below whatever the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ALU_OPS_PER_S * 1e3, walk)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2: kernels against their plain versions -------------------------
def solver_cases(rng):
    """(name, sorted slots, edit, timed) for the solver: the main path's
    shapes (``timed``: the plain version is timed too) and edge layouts.
    ``edit(rng, u, w)`` reshapes the algorithms' inputs, or is None."""
    def runs(lengths):
        return np.repeat(np.arange(len(lengths)), lengths)

    def kill(share):
        def edit(rng, u, w):
            return np.where(rng.random(len(u)) < share, -1, u), w
        return edit

    def weightless(rng, u, w):
        return u, np.where(rng.random(len(w)) < 0.3, 0, w)

    cases = [(f"zipf-{n}", np.sort(zipf_keys(rng, n)), None, True)
             for n in (32, 512, 8192)]
    cases.append(("one-key-8192", np.full(8192, 12345), None, True))
    live = 4097  # the 8192 bucket's longest padding run: 4095 lanes
    cases.append(("live-4097-of-8192", np.sort(np.concatenate(
        [np.full(8192 - live, -1), zipf_keys(rng, live)])), None, True))
    cases += [
        ("runs-31-32-33-1023-1024-1025",
         runs([31, 32, 33, 1023, 1024, 1025]), None, False),
        ("runs-at-256-multiples", runs([256, 32, 224, 1024, 1, 255, 512]),
         None, False),
        ("dead-in-live-8192", np.sort(zipf_keys(rng, 8192)), kill(0.25),
         False),
        ("one-key-dead-in-live-8192", np.full(8192, 7), kill(0.5), False),
        ("w0-8192", np.sort(zipf_keys(rng, 8192)), weightless, False),
        ("all-dead-8192", np.sort(zipf_keys(rng, 8192)), kill(1.0), False),
        ("n-1", np.array([42]), None, False),
        ("zipf-8191", np.sort(zipf_keys(rng, 8191)), None, False),
        ("zipf-32771", np.sort(zipf_keys(rng, (1 << 15) + 3)), None, False),
    ]
    return cases


def solver_inputs(rng, slots: np.ndarray, algo: str):
    """u, w (numpy) as the sliding-window and token-bucket steps build
    them."""
    from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE

    n = len(slots)
    valid = slots >= 0
    if algo == "tb":
        permits = rng.integers(1, 101, n)
        req = permits * TOKEN_FP_ONE
        v1 = rng.integers(0, 50 * TOKEN_FP_ONE + 1, n)
        u = np.where(valid & (permits <= 50), v1 - req, -1)
        w = req
    else:
        permits = rng.integers(1, 4, n)
        u = np.where(valid, 100 - rng.integers(0, 60, n) - permits, -1)
        w = np.ones(n, np.int64)
    return u, w


def segment_walks(slots: np.ndarray, u: np.ndarray):
    """(lanes, live lanes) of the solver's longest walk: the largest
    segment, and the segment with the most live (u >= 0) lanes — the only
    lanes the kernel walks."""
    seg = np.cumsum(np.r_[True, slots[1:] != slots[:-1]]) - 1
    return (int(np.bincount(seg).max()),
            int(np.bincount(seg, weights=u >= 0).max()))


def phase_kernels(rng, dev, floor_ms: float, clock_hz: float):
    from ratelimiter_tpu_torch.ops import segments
    from ratelimiter_tpu_torch.ops.cuda import solver

    results = {"solver": {"err": 0}, "block_scatter": {"err": 0}}
    for name, slots_np, edit, timed in solver_cases(rng):
        slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
        first = segments.first_occurrence(slots)
        n = len(slots_np)
        for algo in ("sw", "tb"):
            u_np, w_np = solver_inputs(rng, slots_np, algo)
            if edit is not None:
                u_np, w_np = edit(rng, u_np, w_np)
            u = torch.as_tensor(u_np, dtype=torch.int64, device=dev)
            w = torch.as_tensor(w_np, dtype=torch.int64, device=dev)
            got = solver.solve_cuda(u, w, first)
            want = segments.solve_threshold_recurrence(u, w, first)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            results["solver"]["err"] = max(results["solver"]["err"], err)
            check(err == 0, f"solver {name} {algo}: kernel != plain")
            k_ms, k_host = cuda_ms(lambda: solver.solve_cuda(u, w, first),
                                   reps=50)
            p_ms = (cuda_ms(
                lambda: segments.solve_threshold_recurrence(u, w, first),
                reps=2, rounds=3)[0] if timed else None)
            longest, live = segment_walks(slots_np, u_np)
            # The walk term counts the live lanes of the segment with the
            # most of them: a walk over dead lanes is not work these inputs
            # need.  The old term (every lane of the longest segment) is
            # printed beside it so that earlier rows can still be read.
            w_ms = walk_ms(live, clock_hz)
            b_ms, b_by = bound_ms(25 * n, 2 * n, w_ms)
            plain = f"{p_ms:.5f} ms" if timed else "not timed"
            print(f"solver {name:28s} {algo}: lanes {n} longest segment "
                  f"{longest} (old walk {walk_ms(longest, clock_hz):.7f} ms)"
                  f" most live in a segment {live}  kernel {k_ms:.5f} ms "
                  f"(host {k_host:.5f} ms per call)  floor {floor_ms:.5f} "
                  f"ms  plain {plain}  bound {b_ms:.7f} ms ({b_by}; walk "
                  f"{w_ms:.7f} ms, bytes "
                  f"{25 * n / HBM_BYTES_PER_S * 1e3:.7f} ms)  kernel/bound "
                  f"{k_ms / b_ms:.1f}  max_abs_err {err}")
            if name == "zipf-8192" and algo == "tb":
                results["solver"].update(ms=k_ms, plain_ms=p_ms,
                                         bound_ms=b_ms, bound_by=b_by,
                                         library_ms=None)

    # The main path's scatter is the admin reset (``tb_reset_p`` /
    # ``sw_reset_p``): one slot, or -1, a zero row and the mask
    # ``slots >= 0``.  B = 32 and 8192 are ``engine.write_rows``' shapes.
    for lanes in (4, 6):
        state0 = torch.randint(-(1 << 30), 1 << 30, (NUM_SLOTS, lanes),
                               dtype=torch.int32, device=dev)
        for n, kind in ((1, "reset"), (1, "reset-dead"), (32, "rows"),
                        (8192, "rows")):
            if kind == "rows":
                pad = n // 16
                slots_np = np.sort(np.concatenate(
                    [np.full(pad, -1), zipf_keys(rng, n - pad)]))
                mask_np = (slots_np >= 0) & np.r_[
                    slots_np[1:] != slots_np[:-1], True]
                rows = torch.randint(-(1 << 30), 1 << 30, (n, lanes),
                                     dtype=torch.int32, device=dev)
            else:
                slots_np = (np.array([-1]) if kind == "reset-dead"
                            else zipf_keys(rng, 1))
                mask_np = slots_np >= 0
                rows = torch.zeros((n, lanes), dtype=torch.int32, device=dev)
            slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
            mask = torch.as_tensor(mask_np, device=dev)
            t = time_scatter(results, f"{kind:10s} S={NUM_SLOTS} L={lanes} "
                             f"B={n:5d}", state0, slots, mask, rows,
                             floor_ms, reps=100, plain_reps=20,
                             plain_rounds=5)
            # The kernels line reads the shape the main path launches.
            if lanes == 6 and kind == "reset":
                results["block_scatter"].update(t)
    lease_scatter_cases(rng, dev, floor_ms, results)
    scatter_edge_cases(rng, dev, results)
    results.update(phase_writeback(rng, dev, floor_ms))
    return results


def lease_scatter_cases(rng, dev, floor_ms: float, results: dict) -> None:
    """The row scatter at the lease steps' shape (phase 12): the rows an
    8192-lane reserve writes — slot-sorted lanes with duplicates and
    padding, the mask on each segment's last live lane — taken from the
    step itself on random 2^20-row states, L = 4 (token bucket) and L = 6
    (sliding window)."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.ops import lease as lease_ops

    table = LimiterTable(device=dev)
    for _, cfg in LEASE_POLICIES:
        table.register(RateLimitConfig(**cfg))
    n = 8192
    for algo, lanes, lid in (("tb", 4, 3), ("sw", 6, 2)):
        slots_np = zipf_keys(rng, n)
        slots_np[rng.random(n) < 1 / 16] = -1
        slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
        lids = torch.full((n,), lid, dtype=torch.int64, device=dev)
        req = torch.as_tensor(rng.integers(0, 12, n), dtype=torch.int64,
                              device=dev)
        state0 = torch.randint(-(1 << 30), 1 << 30, (NUM_SLOTS, lanes),
                               dtype=torch.int32, device=dev)
        captured = []
        real = lease_ops.scatter_rows
        lease_ops.scatter_rows = (
            lambda state, s, m, r: captured.append((s, m, r)) or state)
        try:
            lease_ops.RESERVE_STEPS[algo](state0.clone(), table.device_arrays,
                                          slots, lids, req,
                                          1_760_000_100_000)
        finally:
            lease_ops.scatter_rows = real
        s, m, r = captured[0]
        time_scatter(results, f"lease      S={NUM_SLOTS} L={lanes} "
                     f"B={n:5d}", state0, s, m, r, floor_ms, reps=100,
                     plain_reps=20, plain_rounds=5)


def live_sectors(state: torch.Tensor, slots: torch.Tensor,
                 mask: torch.Tensor) -> int:
    """The 32-byte sectors of ``state``'s memory that the live rows'
    bytes touch: what random row writes cost the memory, which moves
    whole sectors (a row of 24 B lands on 1.5 of them on average)."""
    live = mask & (slots >= 0) & (slots < state.shape[0])
    row_bytes = 4 * state.shape[1]
    start = state.data_ptr() % 32 + slots[live] * row_bytes
    ends = [start + min(k * 32, row_bytes - 1)
            for k in range(row_bytes // 32 + 2)]
    return int(torch.unique(torch.cat(ends) // 32).numel())


def hold_scatter(results: dict, label: str, state0: torch.Tensor, slots,
                 mask, rows, start: int = 0) -> int:
    """The row scatter against its plain version on ``state0[start:]``
    (``start`` > 0: a view that begins inside the allocation): the whole
    of ``state0`` must come out bit-equal.  Returns the largest
    difference."""
    from ratelimiter_tpu_torch.ops import scatter
    from ratelimiter_tpu_torch.ops.cuda import block_scatter

    got, want = state0.clone(), state0.clone()
    block_scatter.scatter_rows(got[start:], slots, mask, rows)
    scatter.scatter_rows_plain(want[start:], slots, mask, rows)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    results["block_scatter"]["err"] = max(results["block_scatter"]["err"],
                                          err)
    check(err == 0, f"scatter {label}: kernel != plain")
    return err


def time_scatter(results: dict, label: str, state0: torch.Tensor, slots,
                 mask, rows, floor_ms: float, reps: int = 20,
                 plain_reps: int = 3, plain_rounds: int = 3) -> dict:
    """Holds the row scatter to its plain version, then times it beside
    the plain version and ``index_put_`` on the same live rows, and
    prints the line: the bytes bound (every lane's slot and mask read,
    each live row read and written) and the sector figure (the 32-byte
    sectors the live rows touch, at the memory's rate), which says how far
    random row writes sit above the bytes.  Returns the kernels line's
    numbers."""
    from ratelimiter_tpu_torch.ops import scatter
    from ratelimiter_tpu_torch.ops.cuda import block_scatter

    err = hold_scatter(results, label, state0, slots, mask, rows)
    state = state0.clone()
    n, lanes = rows.shape
    live = int(mask.sum())
    live_slots, live_rows = slots[mask], rows[mask].contiguous()
    k_ms, k_host = cuda_ms(lambda: block_scatter.scatter_rows(
        state, slots, mask, rows), reps=reps)
    p_ms, _ = cuda_ms(lambda: scatter.scatter_rows_plain(
        state, slots, mask, rows), reps=plain_reps, rounds=plain_rounds)
    l_ms, _ = cuda_ms(
        lambda: state.index_put_((live_slots,), live_rows), reps=reps)
    b_ms, b_by = bound_ms(n * (8 + 1) + live * 8 * lanes, 0)
    sectors = live_sectors(state, slots, mask)
    sector_ms = sectors * 32 / HBM_BYTES_PER_S * 1e3
    print(f"scatter {label} live {live}: kernel {k_ms:.5f} ms (host "
          f"{k_host:.5f} ms per call)  floor {floor_ms:.5f} ms  plain "
          f"{p_ms:.5f} ms  index_put_ {l_ms:.5f} ms  bound {b_ms:.7f} ms "
          f"({b_by})  kernel/bound {k_ms / b_ms:.2f}  sectors {sectors} "
          f"({sector_ms:.7f} ms at 32 B)  kernel/index_put_ "
          f"{k_ms / l_ms:.3f}  max_abs_err {err}")
    del state
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=l_ms)


def scatter_edge_cases(rng, dev, results: dict) -> None:
    """The row scatter's layouts beyond the main paths', each of which
    must leave the whole state bit-equal to the plain version: lane
    counts without a vector width of their own (L = 3, 5), lane counts
    that are no multiple of a block's 256 lanes, an L = 6 state view that
    begins one row in (8-byte, not 16-byte aligned), rows that begin one
    element in (4-byte aligned: element by element), slots out of range
    (-1, -7, S, S + 5, 2^40) under a set mask, live duplicate slots
    carrying identical rows, and an all-dead batch.  Lanes arrive in
    random order; a lane's row is drawn per slot value, so duplicates
    agree."""
    S = 1 << 16

    def lanes_for(n, lanes, dup_keys=None, dead=0.3):
        hi = S if dup_keys is None else dup_keys
        slots_np = rng.integers(0, hi, n)
        odd = rng.random(n) < 0.05
        slots_np[odd] = rng.choice([-1, -7, S, S + 5, 1 << 40], odd.sum())
        table = torch.randint(-(1 << 30), 1 << 30, (S + 8, lanes),
                              dtype=torch.int32, device=dev)
        slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
        rows = table[slots.clamp(0, S + 7)].contiguous()
        mask = torch.as_tensor(rng.random(n) >= dead, device=dev)
        return slots, mask, rows

    cases = []
    for lanes in (3, 5):
        cases.append((f"generic-L{lanes}", lanes, 8191, {}))
    for lanes in (4, 6):
        cases += [(f"ragged-L{lanes}", lanes, (1 << 15) + 3, {}),
                  (f"duplicates-L{lanes}", lanes, 8191, dict(dup_keys=64)),
                  (f"all-dead-L{lanes}", lanes, 8191, dict(dead=1.0)),
                  (f"rows-off-16B-L{lanes}", lanes, 4099, dict(rows_in=1))]
    cases.append(("state-one-row-in-L6", 6, 8191, dict(start=1)))
    for name, lanes, n, how in cases:
        start, rows_in = how.pop("start", 0), how.pop("rows_in", 0)
        slots, mask, rows = lanes_for(n, lanes, **how)
        if rows_in:
            flat = torch.empty(n * lanes + rows_in, dtype=torch.int32,
                               device=dev)
            flat[rows_in:] = rows.reshape(-1)
            rows = flat[rows_in:].view(n, lanes)
            check(rows.data_ptr() % 16 != 0 and rows.is_contiguous(),
                  f"scatter {name}: rows not offset")
        state0 = torch.randint(-(1 << 30), 1 << 30, (S + start, lanes),
                               dtype=torch.int32, device=dev)
        if start:
            check(state0[start:].data_ptr() % 16 == 8,
                  f"scatter {name}: view not 8 bytes off 16")
        err = hold_scatter(results, name, state0, slots, mask, rows, start)
        print(f"scatter edge {name:22s} S={S} L={lanes} B={n} live "
              f"{int(mask.sum())} (mask and slot in range: "
              f"{int((mask & (slots >= 0) & (slots < S)).sum())}): "
              f"max_abs_err {err}")


def writeback_args(rng, dev, slots_np, inc, w_np, algo, per_lane):
    """The write-back's lane inputs after ``slots``: ``inc`` from the
    solver, for the token bucket ``req = w``, and seeded rows and clocks
    (old rows drawn apart from the state, so that a segment which allowed
    nothing still changes it).  With ``per_lane`` the sliding window's
    ``win`` and ``curr_ws`` are int64[B] (limiter ids per lane), else 0-d
    (one tenant)."""
    from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE

    n = len(slots_np)
    t_now = 1_760_000_000_000 + int(rng.integers(0, 120_000))

    def col(values):
        return torch.as_tensor(values, dtype=torch.int64, device=dev)

    s = col(slots_np)
    now = col(t_now)
    if algo == "tb":
        return (s, inc, col(w_np),
                col(rng.integers(0, 50 * TOKEN_FP_ONE + 1, n)),
                col(rng.integers(0, 50 * TOKEN_FP_ONE + 1, n)),
                col(t_now - rng.integers(0, 200_000, n)), now)
    win_ms = 60_000
    ws = t_now - t_now % win_ms
    win = col(np.full(n, win_ms)) if per_lane else col(win_ms)
    curr_ws = col(np.full(n, ws)) if per_lane else col(ws)
    ws_old = ws - win_ms * rng.integers(0, 3, n)
    return (s, inc, col(rng.integers(0, 101, n)), col(rng.integers(0, 101, n)),
            col(np.where(rng.random(n) < 0.2, 0,
                         ws + rng.integers(-win_ms, win_ms, n))),
            col(ws_old), col(ws_old + rng.integers(0, 2 * win_ms, n)),
            win, curr_ws, now)


def phase_writeback(rng, dev, floor_ms: float):
    """Both write-back kernels against their plain versions over the
    whole state, on the solver's layouts."""
    from ratelimiter_tpu_torch.ops import segments, sliding_window, token_bucket
    from ratelimiter_tpu_torch.ops.cuda import block_scatter

    kernels = {"tb": block_scatter.tb_writeback,
               "sw": block_scatter.sw_writeback}
    plains = {"tb": token_bucket.tb_writeback_plain,
              "sw": sliding_window.sw_writeback_plain}
    results = {f"{algo}_writeback": {"err": 0} for algo in kernels}
    for i, (name, slots_np, edit, timed_) in enumerate(solver_cases(rng)):
        slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
        first = segments.first_occurrence(slots)
        n = len(slots_np)
        writes = int(((slots_np >= 0)
                      & np.r_[slots_np[1:] != slots_np[:-1], True]).sum())
        for algo in ("tb", "sw"):
            lanes = 4 if algo == "tb" else 6
            u_np, w_np = solver_inputs(rng, slots_np, algo)
            if edit is not None:
                u_np, w_np = edit(rng, u_np, w_np)
            inc = segments.solve_threshold_recurrence(
                torch.as_tensor(u_np, dtype=torch.int64, device=dev),
                torch.as_tensor(w_np, dtype=torch.int64, device=dev), first)
            args = writeback_args(rng, dev, slots_np, inc, w_np, algo,
                                  per_lane=i % 2 == 0)
            state0 = torch.randint(-(1 << 30), 1 << 30, (NUM_SLOTS, lanes),
                                   dtype=torch.int32, device=dev)
            got = kernels[algo](state0.clone(), *args)
            want = plains[algo](state0.clone(), *args)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            entry = results[f"{algo}_writeback"]
            entry["err"] = max(entry["err"], err)
            check(err == 0, f"writeback {algo} {name}: kernel != plain")
            state = state0.clone()
            k_ms, k_host = cuda_ms(lambda: kernels[algo](state, *args),
                                   reps=50)
            p_ms = (cuda_ms(lambda: plains[algo](state, *args), reps=3,
                            rounds=3)[0] if timed_ else None)
            # Every lane's slot and inc (and req) read to find the totals;
            # each written segment's row inputs read and its row written.
            lane_bytes = 8 * (3 if algo == "tb" else 2)
            row_in = 8 * (3 if algo == "tb"
                          else 5 + 2 * (args[-3].dim() == 1))
            b_ms, b_by = bound_ms(
                n * lane_bytes + writes * (row_in + 4 * lanes), 0)
            plain = f"{p_ms:.5f} ms" if timed_ else "not timed"
            print(f"writeback {algo} {name:28s}: lanes {n} rows written "
                  f"{writes}  kernel {k_ms:.5f} ms (host {k_host:.5f} ms "
                  f"per call)  floor {floor_ms:.5f} ms  plain {plain}  "
                  f"bound {b_ms:.7f} ms ({b_by})  kernel/bound "
                  f"{k_ms / b_ms:.1f}  max_abs_err {err}")
            if name == "zipf-8192":
                entry.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
    return results


def phase_flat_kernels(rng, dev, headline: np.ndarray, floor_ms: float,
                       clock_hz: float, results: dict) -> None:
    """The permit stream route's kernel shapes on the 2_000_128-row state:
    the solver and both write-backs at phase 6 (b)'s 2^19-lane flat step
    (the headline's Zipf keys, sorted, as slots; permits uniform in
    [1, 100] on a first touch: a full bucket of 100 tokens, an empty
    window), and the row scatter at the weighted relay's lanes (phase 6
    (a)'s first chunk, in the count-descending order the layout gives its
    unique slots, and 2^19 distinct slots in random order).  Kernels must
    be bit-equal to their plain versions (write-backs and scatter: the
    whole state)."""
    from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE
    from ratelimiter_tpu_torch.engine.native_index import (
        NativeSlotIndex,
        weighted_layout,
    )
    from ratelimiter_tpu_torch.ops import (
        relay,
        segments,
        sliding_window,
        token_bucket,
    )
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, solver
    from ratelimiter_tpu_torch.storage.gpu import _bucket_fine

    n = FLAT_LANES
    slots_np = np.sort(headline[:n])
    permits = rng.integers(1, 101, n)
    slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
    first = segments.first_occurrence(slots)
    writes = int(np.r_[slots_np[1:] != slots_np[:-1], True].sum())
    wb = {"tb": (block_scatter.tb_writeback, token_bucket.tb_writeback_plain),
          "sw": (block_scatter.sw_writeback,
                 sliding_window.sw_writeback_plain)}
    for algo in ("tb", "sw"):
        if algo == "tb":
            w_np = permits * TOKEN_FP_ONE
            u_np = 100 * TOKEN_FP_ONE - w_np
        else:
            w_np = np.ones(n, dtype=np.int64)
            u_np = 100 - permits
        u = torch.as_tensor(u_np, dtype=torch.int64, device=dev)
        w = torch.as_tensor(w_np, dtype=torch.int64, device=dev)
        got = solver.solve_cuda(u, w, first)
        inc = segments.solve_threshold_recurrence(u, w, first)
        torch.cuda.synchronize()
        err = int((got - inc).abs().max())
        results["solver"]["err"] = max(results["solver"]["err"], err)
        check(err == 0, f"solver flat-{n} {algo}: kernel != plain")
        k_ms, k_host = cuda_ms(lambda: solver.solve_cuda(u, w, first),
                               reps=5, rounds=3)
        p_ms, _ = cuda_ms(
            lambda: segments.solve_threshold_recurrence(u, w, first),
            reps=1, rounds=3)
        longest, live = segment_walks(slots_np, u_np)
        w_ms = walk_ms(live, clock_hz)
        b_ms, b_by = bound_ms(25 * n, 2 * n, w_ms)
        print(f"solver flat-{n} Zipf {algo}: longest segment {longest}, most "
              f"live in a segment {live}  kernel {k_ms:.5f} ms (host "
              f"{k_host:.5f} ms per call)  floor {floor_ms:.5f} ms  plain "
              f"{p_ms:.5f} ms  bound {b_ms:.7f} ms ({b_by}; walk "
              f"{w_ms:.7f} ms)  kernel/bound {k_ms / b_ms:.2f}  "
              f"max_abs_err {err}")

        lanes = 4 if algo == "tb" else 6
        args = writeback_args(rng, dev, slots_np, inc, w_np, algo,
                              per_lane=False)
        kernel, plain = wb[algo]
        state0 = torch.randint(-(1 << 30), 1 << 30, (STREAM_SLOTS, lanes),
                               dtype=torch.int32, device=dev)
        got = kernel(state0.clone(), *args)
        want = plain(state0.clone(), *args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        entry = results[f"{algo}_writeback"]
        entry["err"] = max(entry["err"], err)
        check(err == 0, f"writeback {algo} flat-{n}: kernel != plain")
        del got, want
        state = state0.clone()
        k_ms, k_host = cuda_ms(lambda: kernel(state, *args), reps=20)
        p_ms, _ = cuda_ms(lambda: plain(state, *args), reps=1, rounds=3)
        lane_bytes = 8 * (3 if algo == "tb" else 2)
        row_in = 8 * (3 if algo == "tb" else 5)
        b_ms, b_by = bound_ms(n * lane_bytes + writes * (row_in + 4 * lanes),
                              0)
        print(f"writeback {algo} flat-{n} Zipf S={STREAM_SLOTS}: rows "
              f"written {writes}  kernel {k_ms:.5f} ms (host {k_host:.5f} "
              f"ms per call)  floor {floor_ms:.5f} ms  plain {p_ms:.5f} ms  "
              f"bound {b_ms:.7f} ms ({b_by})  kernel/bound "
              f"{k_ms / b_ms:.1f}  max_abs_err {err}")
        del state, state0

    # The weighted relay's row write: phase 6 (a)'s first chunk laid out
    # as the storage lays it out.
    rb = 31 - STREAM_SLOTS.bit_length()
    index = NativeSlotIndex(STREAM_SLOTS)
    keys = rng.integers(0, STREAM_KEYS, n)
    uwords, uidx, rank, _ = index.assign_batch_ints_uniques(keys, 1, rb)
    u = len(uwords)
    r_b = pow2(max(int(rank.max()) + 1, 2))
    u_b = _bucket_fine(u)
    uw_sorted = np.full(u_b, 0xFFFFFFFF, dtype=np.uint32)
    weighted_layout(uwords, rb, uidx, rank,
                    rng.integers(1, 101, n).astype(np.int64), r_b, uw_sorted,
                    np.empty(u, np.int32), np.empty(r_b, np.int64),
                    np.zeros(_bucket_fine(n) + u_b, np.uint8))
    w_slot, _, w_valid = relay.decode_words(
        torch.as_tensor(uw_sorted.view(np.int32), device=dev), rb,
        STREAM_SLOTS)
    distinct = torch.as_tensor(rng.permutation(STREAM_SLOTS)[:n],
                               dtype=torch.int64, device=dev)
    for lanes in (4, 6):
        # The token bucket writes the segments that allowed something,
        # the sliding window every valid one.
        some = torch.as_tensor(rng.random(u_b) < 0.9, device=dev)
        cases = (("weighted-a", w_slot,
                  w_valid & some if lanes == 4 else w_valid),
                 (f"distinct-{n}", distinct,
                  torch.ones(n, dtype=torch.bool, device=dev)))
        state0 = torch.randint(-(1 << 30), 1 << 30, (STREAM_SLOTS, lanes),
                               dtype=torch.int32, device=dev)
        for name, sl, mask in cases:
            b = sl.shape[0]
            rows = torch.randint(-(1 << 30), 1 << 30, (b, lanes),
                                 dtype=torch.int32, device=dev)
            time_scatter(results, f"{name:14s} S={STREAM_SLOTS} L={lanes} "
                         f"B={b} (unsorted)", state0, sl, mask, rows,
                         floor_ms)


def scenario4_stream(rng, n: int):
    """bench.py's scenario 4 traffic: a tenant per request, uniform over
    ``N_TENANTS``, and one of its ``KEYS_PER_TENANT`` keys; returns (keys,
    tenant index).  Limiter ids are the tenant index + 1."""
    tenant = rng.integers(0, N_TENANTS, n)
    return tenant * KEYS_PER_TENANT + rng.integers(0, KEYS_PER_TENANT, n), \
        tenant


def phase_relay_mode_scatter(rng, dev, floor_ms: float,
                             results: dict) -> None:
    """The row scatter at the relay's other two modes, as phase 7's
    deployments give it its lanes: words mode's per-request lanes (a
    scenario 3 chunk of 3_670_016 uniform requests over 10M keys, padded
    to 2^22, written at each slot's last request) on the 12_500_224-row
    sliding-window state, and the resident digest's slot-sorted unique
    rows (a scenario 4 chunk of 2^19 tenant requests, padded to 2^19
    lanes) on the 800_000-row token-bucket state.  The kernel must leave
    the whole state bit-equal to its plain version."""
    from ratelimiter_tpu_torch.engine.native_index import (
        NativeSlotIndex,
        rebuild_words_into,
        sort_uniques,
    )

    cases = []
    rb = 31 - WORDS_SLOTS.bit_length()
    index = NativeSlotIndex(WORDS_SLOTS)
    n = WORDS_CHUNK
    uwords, uidx, rank, _ = index.assign_batch_ints_uniques(
        rng.integers(0, WORDS_KEYS, n), 1, rb)
    words = np.full(pow2(n), 0xFFFFFFFF, dtype=np.uint32)
    rebuild_words_into(uwords, uidx, rank, rb, words[:n])
    slot = (words >> np.uint32(rb + 1)).astype(np.int64)
    cases.append(("words", WORDS_SLOTS, 6, slot,
                  (slot < WORDS_SLOTS) & ((words & 1) == 1)))
    del index, uwords, uidx, rank, words

    rb = 31 - TENANT_SLOTS.bit_length()
    index = NativeSlotIndex(TENANT_SLOTS)
    keys, tenant = scenario4_stream(rng, FIRST_CHUNK)
    uwords, uidx, _, _ = index.assign_batch_ints_multi_uniques(
        keys, tenant + 1, rb)
    sort_uniques(uwords, rb, uidx)
    words = np.full(pow2(len(uwords)), 0xFFFFFFFF, dtype=np.uint32)
    words[:len(uwords)] = uwords
    slot = (words >> np.uint32(rb + 1)).astype(np.int64)
    cases.append(("resident", TENANT_SLOTS, 4, slot, slot < TENANT_SLOTS))
    del index

    for name, rows_n, lanes, slot_np, mask_np in cases:
        sl = torch.as_tensor(slot_np, device=dev)
        mask = torch.as_tensor(mask_np, device=dev)
        b = sl.shape[0]
        rows = torch.randint(-(1 << 30), 1 << 30, (b, lanes),
                             dtype=torch.int32, device=dev)
        state0 = torch.randint(-(1 << 30), 1 << 30, (rows_n, lanes),
                               dtype=torch.int32, device=dev)
        order = "sorted" if name == "resident" else "arrival order"
        time_scatter(results, f"{name:8s} S={rows_n} L={lanes} B={b} "
                     f"({order})", state0, sl, mask, rows, floor_ms)
        del state0, rows


def relay_words(headline: np.ndarray, rank_bits: int, lid: int):
    """The relay step's main-path inputs: the word lanes (slot | clamped
    count, padded with all ones to a power of two) of the headline pass's
    two chunks, as a fresh C slot index hands them out, sorted by slot
    (what the stream dispatches) and, for the big chunk, unsorted too.
    Hot keys saturate the count at the clamp."""
    from ratelimiter_tpu_torch.engine.native_index import (
        NativeSlotIndex,
        sort_uniques,
    )

    index = NativeSlotIndex(STREAM_SLOTS)
    cases = []
    for keys, orders in ((headline[:FIRST_CHUNK], (True,)),
                         (headline[FIRST_CHUNK:], (True, False))):
        uwords = index.assign_batch_ints_uniques(keys, lid, rank_bits)[0]
        u = len(uwords)
        for srt in orders:
            words = np.full(pow2(u), 0xFFFFFFFF, dtype=np.uint32)
            words[:u] = uwords
            if srt:
                sort_uniques(words[:u], rank_bits, np.zeros(0, np.int32))
            cases.append((f"U={len(words)} {'sorted' if srt else 'unsorted'}",
                          words, u))
    return cases


def phase_relay_kernel(dev, headline: np.ndarray):
    """The relay step's kernel against its plain version on the headline
    tables, at the stream's chunk shapes: a populated state is stepped by
    both to a later time in the same window and again in the next one;
    counts and the whole state must be bit-equal."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.ops import relay
    from ratelimiter_tpu_torch.ops.cuda import relay_step
    from ratelimiter_tpu_torch.ops.sliding_window import make_sw_packed
    from ratelimiter_tpu_torch.ops.token_bucket import make_tb_packed

    table = LimiterTable(device=dev)
    lids = {"tb": table.register(RateLimitConfig(**HEADLINE_TB)),
            "sw": table.register(RateLimitConfig(**HEADLINE_SW))}
    arrays = table.device_arrays
    rb = 31 - STREAM_SLOTS.bit_length()
    now0 = 1_760_000_000_000
    result = {"err": 0}
    main_lanes = 0
    for name, words_np, u in relay_words(headline, rb, lids["tb"]):
        words = torch.as_tensor(words_np.view(np.int32), device=dev)
        n = len(words_np)
        clamp = np.uint32((1 << rb) - 1)
        clamped = int((((words_np[:u] >> np.uint32(1)) & clamp)
                       == clamp).sum())
        for algo in ("tb", "sw"):
            lanes = 4 if algo == "tb" else 6
            plain = (relay.tb_relay_counts_plain if algo == "tb"
                     else relay.sw_relay_counts_plain)
            kernel = (relay_step.tb_relay_counts if algo == "tb"
                      else relay_step.sw_relay_counts)

            def step(fn, state, now):
                return fn(state, arrays, words, lids[algo], now,
                          rank_bits=rb, out_dtype=torch.uint8)

            state0 = (make_tb_packed if algo == "tb"
                      else make_sw_packed)(STREAM_SLOTS, dev)
            step(plain, state0, now0)
            s_k, s_p = state0.clone(), state0.clone()
            err = 0
            for now in (now0 + 1_500, now0 + 61_500):
                c_k, c_p = step(kernel, s_k, now), step(plain, s_p, now)
                torch.cuda.synchronize()
                err = max(err, int((c_k.to(torch.int64)
                                    - c_p.to(torch.int64)).abs().max()),
                          int((s_k.to(torch.int64) - s_p.to(torch.int64))
                              .abs().max()))
            result["err"] = max(result["err"], err)
            check(err == 0, f"relay {algo} {name}: kernel != plain")
            k_ms, k_host = cuda_ms(lambda: step(kernel, s_k, now0 + 62_000),
                                   reps=50)
            p_ms, _ = cuda_ms(lambda: step(plain, s_p, now0 + 62_000),
                              reps=3, rounds=3)
            c_ms = cold_ms(lambda: step(kernel, s_k, now0 + 62_000))
            # Each lane's word read and count written; each live lane's
            # row read and written.
            b_ms, b_by = bound_ms(n * 5 + u * 8 * lanes,
                                  u * RELAY_OPS_PER_LANE)
            print(f"relay {algo} S={STREAM_SLOTS} L={lanes} {name}: live "
                  f"{u} (clamped {clamped}, padding {n - u})  kernel "
                  f"{k_ms:.5f} ms (host {k_host:.5f} ms per call; L2 "
                  f"flushed {c_ms:.5f} ms)  plain "
                  f"{p_ms:.5f} ms  bound {b_ms:.7f} ms ({b_by})  "
                  f"kernel/bound {k_ms / b_ms:.1f}  max_abs_err {err}")
            if algo == "tb" and name.endswith(" sorted") and n > main_lanes:
                # The JSON line reports the headline's big chunk.
                main_lanes = n
                result.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None)
    return result


# -- phase 3: the main path ---------------------------------------------------
class Reference:
    """What one limiter must decide: the oracle, plus the sliding
    window's local negative cache where the limiter has one.

    ``stamp(now)`` gives the storage's batch timestamp — the running
    maximum of the clock over the calls that reach the storage — and is
    taken only by such calls (a cache hit or a client-side reject never
    dispatches)."""

    def __init__(self, algo, cfg, clock, stamp):
        from ratelimiter_tpu_torch.cache import TTLCache
        from ratelimiter_tpu_torch.semantics import (
            SlidingWindowOracle,
            TokenBucketOracle,
        )

        self.algo, self.cfg, self.clock, self.stamp = algo, cfg, clock, stamp
        self.oracle = (SlidingWindowOracle(cfg) if algo == "sw"
                       else TokenBucketOracle(cfg))
        self.cache = (TTLCache(cfg.local_cache_ttl_ms, 10_000, clock)
                      if algo == "sw" and cfg.enable_local_cache else None)

    def one(self, key, permits) -> bool:
        if self.cache is not None:
            cached = self.cache.get_if_present(key)
            if cached is not None and cached >= self.cfg.max_permits:
                return False
        if self.algo == "tb" and permits > self.cfg.max_permits:
            return False
        d = self.oracle.try_acquire(key, permits, self.stamp(self.clock()))
        if self.cache is not None:
            self.cache.put(key, d.remaining_hint if d.mutated
                           else d.observed)
        return d.allowed

    def reset(self, key) -> None:
        # The storage zeroes the slot.  The oracle drops the windows around
        # the time it is given; at no earlier than the clock and the last
        # stamp (``stamp(0)`` reads it without moving it), those are all
        # the windows a later decision can see.
        if self.cache is not None:
            self.cache.invalidate(key)
        self.oracle.reset(key, max(self.stamp(0), self.clock()))

    def many(self, keys, permits) -> np.ndarray:
        now = self.stamp(self.clock())
        out = [self.oracle.try_acquire(k, int(p), now)
               for k, p in zip(keys, permits)]
        if self.cache is not None:
            for k, d in zip(keys, out):
                self.cache.put(k, d.remaining_hint if d.mutated
                               else d.observed)
        return np.array([d.allowed for d in out], dtype=bool)


def phase_main_path(rng, card: str):
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, relay_step, solver
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_760_000_000_000}
    storage = GpuBatchedStorage(num_slots=NUM_SLOTS,
                                clock_ms=lambda: clock["t"])
    check(storage.device.type == "cuda", "storage is not on the card")
    host_index_line("micro route", storage)
    registry = MeterRegistry()
    limiters = {}
    for name, (algo, kw) in TRIO.items():
        cfg = RateLimitConfig(**kw)
        limiters[name] = (SlidingWindowRateLimiter(
            storage, cfg, registry, clock_ms=lambda: clock["t"])
            if algo == "sw" else TokenBucketRateLimiter(storage, cfg,
                                                        registry))
    names = list(TRIO)

    # Inputs, made up front so the timed drives run only the port.
    single = []
    for i in range(N_SINGLE):
        dt = int(rng.integers(0, 40))
        if i == N_SINGLE // 3:
            dt = 61_000                    # into the next window
        if i == 2 * N_SINGLE // 3:
            dt = -5_000                    # the clock steps backward once
        name = names[i % 3]
        permits = (int(rng.integers(1, 101)) if name == "burst"
                   else int(rng.integers(1, 4)))
        single.append((dt, name, f"user{zipf_keys(rng, 1)[0]}", permits))
    bursts = []
    for b in range(N_BURSTS):
        name = names[b % 3]
        keys = [f"user{k}" for k in zipf_keys(rng, BURST)]
        permits = (rng.integers(1, 101, BURST) if name == "burst"
                   else rng.integers(1, 4, BURST))
        bursts.append((int(rng.integers(1_000, 30_000)), name, keys,
                       permits))

    # Admin resets of hot keys between the singles and the bursts: the
    # row scatter's path (a step never launches it).
    resets = [(name, f"user{k}") for name in names for k in range(3)]

    solver.launches = block_scatter.launches = relay_step.launches = 0
    block_scatter.tb_writeback_launches = 0
    block_scatter.sw_writeback_launches = 0
    log = []  # (kind, name, keys/key, permits, clock) in drive order
    lat = []
    t_single = time.perf_counter()
    for dt, name, key, permits in single:
        clock["t"] += dt
        t0 = time.perf_counter()
        allowed = limiters[name].try_acquire(key, permits)
        lat.append(time.perf_counter() - t0)
        log.append(("one", name, key, permits, clock["t"], allowed))
    t_single = time.perf_counter() - t_single
    torch.cuda.synchronize()
    scatter_by_steps = block_scatter.launches
    for name, key in resets:
        limiters[name].reset(key)
        log.append(("reset", name, key, None, clock["t"], None))
    t_burst = time.perf_counter()
    for dt, name, keys, permits in bursts:
        clock["t"] += dt
        allowed = limiters[name].try_acquire_many(keys, permits)
        log.append(("many", name, keys, permits, clock["t"], allowed))
    torch.cuda.synchronize()
    t_burst = time.perf_counter() - t_burst
    launches = {"solver": solver.launches,
                "tb_writeback": block_scatter.tb_writeback_launches,
                "sw_writeback": block_scatter.sw_writeback_launches,
                "block_scatter": block_scatter.launches}
    check(min(launches.values()) > 0,
          f"a kernel was not launched on the main path: {launches}")
    check(launches["solver"] == launches["tb_writeback"]
          + launches["sw_writeback"], f"each micro step launches one solver "
          f"and one write-back: {launches}")
    check(scatter_by_steps == 0 and launches["block_scatter"] == len(resets),
          f"the row scatter ran {scatter_by_steps} times in the steps and "
          f"{launches['block_scatter']} times for {len(resets)} resets")
    check(relay_step.launches == 0, "the micro-batch route launched the "
          "relay step")

    # Replay through the reference, on the storage's monotonic stamps.
    replay = {"t": 0, "stamp": 0}

    def stamp(now):
        replay["stamp"] = max(replay["stamp"], now)
        return replay["stamp"]

    refs = {name: Reference(algo, RateLimitConfig(**kw),
                            lambda: replay["t"], stamp)
            for name, (algo, kw) in TRIO.items()}
    n_checked = n_allowed = 0
    for kind, name, keys, permits, now, allowed in log:
        replay["t"] = now
        if kind == "reset":
            refs[name].reset(keys)
        elif kind == "one":
            want = refs[name].one(keys, permits)
            check(allowed == want, f"try_acquire {name} {keys} x{permits} "
                  f"at {now}: port {allowed}, oracle {want}")
            n_checked += 1
            n_allowed += int(allowed)
        else:
            want = refs[name].many(keys, permits)
            bad = int((np.asarray(allowed) != want).sum())
            check(bad == 0, f"try_acquire_many {name}: {bad} decisions "
                  "differ from the oracle")
            n_checked += len(keys)
            n_allowed += int(np.sum(allowed))
    check(storage.backward_clamps >= 1, "the backward clock step was not "
          "absorbed by the stamp clamp")
    clamps = storage.registry.counter(
        "ratelimiter.time.backward_clamp").count()
    check(clamps == storage.backward_clamps,
          f"backward_clamp meter {clamps}, storage.backward_clamps "
          f"{storage.backward_clamps}")
    for name in names:
        for key in {k for _, nm, k, _ in single[:50] if nm == name}:
            got = limiters[name].get_available_permits(key)
            want = refs[name].oracle.get_available_permits(
                key, stamp(clock["t"]))
            check(got == want, f"available {name} {key}: {got} != {want}")
    lat_ms = np.array(lat) * 1e3
    print(f"main path ({card}): {N_SINGLE} try_acquire in {t_single:.3f} s "
          f"= {N_SINGLE / t_single:.1f} decisions/s, latency p50 "
          f"{np.percentile(lat_ms, 50):.4f} ms p99 "
          f"{np.percentile(lat_ms, 99):.4f} ms")
    print(f"main path ({card}): {N_BURSTS} try_acquire_many bursts of "
          f"{BURST} in {t_burst:.3f} s = "
          f"{N_BURSTS * BURST / t_burst:.1f} decisions/s")
    print(f"main path: {n_checked} decisions equal to the oracle "
          f"({n_allowed} allowed), {len(resets)} resets; launches "
          f"{launches}")
    return storage, launches


# -- phase 4: where a micro step's time goes ---------------------------------
def timed(fn, events):
    """``fn`` with CUDA events recorded around each call into ``events``.
    Behind a sleep backlog the pair times the call's device work and the
    gaps between its queued commands; on an idle card the span also holds
    the host's time to enqueue them."""
    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out
    return run


# The staged micro steps of phase 4: (algorithm, limiter id, permits).
STEP_KINDS = {"tb": (3, 101),   # the burst token bucket (registered third)
              "sw": (1, 4)}     # the api sliding window (registered first)
# Kernel names as the profiler's CUDA activity shows them.
STEP_KERNELS = {"solver": "solve_segments_kernel",
                "writeback": "_writeback_kernel"}


def phase_step_breakdown(storage, rng, card: str):
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch.engine.engine import MICRO_STAGE_ROWS
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, solver

    eng = storage.engine

    def staged_batch(algo, n):
        # The engine's staging layout: padding lanes (slot -1, limiter 0,
        # one permit) fill the power-of-two bucket past the n requests.
        lid, top = STEP_KINDS[algo]
        staged = np.empty((MICRO_STAGE_ROWS, max(pow2(n), 32)),
                          dtype=np.int64)
        staged[0], staged[1], staged[2] = -1, 0, 1
        staged[0, :n] = zipf_keys(rng, n)
        staged[1, :n] = lid
        staged[2, :n] = rng.integers(1, top, n)
        staged[3, 0] = 1_760_000_500_000
        return staged

    def step(algo, staged, n):
        eng.micro_staged_drain(
            algo, eng.micro_staged_dispatch(algo, staged, n), n)

    solve0 = solver.solve_cuda
    for algo in STEP_KINDS:
        wb_name = f"{algo}_writeback"
        writeback0 = getattr(block_scatter, wb_name)
        for n in (32, 4097, 8192):
            host, dev_t, drain, busy = [], [], [], []
            k_events = {"solver": [], "writeback": []}
            scatter0 = block_scatter.launches
            for rep in range(40):
                staged = staged_batch(algo, n)
                torch.cuda.synchronize()
                if rep >= 30:
                    # Behind a sleep backlog the card runs the step's
                    # kernels back to back: the events then time its
                    # device work alone, and each kernel's own pair its
                    # launch (gap included).
                    torch.cuda._sleep(
                        int(statistics.median(host) * 3e-3 * 2e9))
                    solver.solve_cuda = timed(solve0, k_events["solver"])
                    setattr(block_scatter, wb_name,
                            timed(writeback0, k_events["writeback"]))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                try:
                    t0 = time.perf_counter()
                    start.record()
                    handle = eng.micro_staged_dispatch(algo, staged, n)
                    end.record()
                    t1 = time.perf_counter()
                finally:
                    solver.solve_cuda = solve0
                    setattr(block_scatter, wb_name, writeback0)
                eng.micro_staged_drain(algo, handle, n)
                t2 = time.perf_counter()
                if rep >= 30:
                    busy.append(start.elapsed_time(end))
                    continue
                host.append((t1 - t0) * 1e3)
                drain.append((t2 - t1) * 1e3)
                dev_t.append(start.elapsed_time(end))
            k_ms = {name: statistics.median(a.elapsed_time(b) for a, b in ev)
                    for name, ev in k_events.items()}
            check(all(len(ev) == 10 for ev in k_events.values())
                  and block_scatter.launches == scatter0,
                  f"{algo} step at {n} lanes: one solver and one write-back "
                  f"launch per step expected, got "
                  f"{[len(ev) for ev in k_events.values()]}, and no row "
                  f"scatter, got {block_scatter.launches - scatter0}")
            # Host-side op count of one step (CPU activity only: torch ops
            # as the host issues them).
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                step(algo, staged, n)
            ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                      and not (e.cpu_parent is not None
                               and e.cpu_parent.name.startswith("aten::")))
            # Each kernel's device time inside the step, from the
            # profiler's CUDA activity over ten steps.
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    step(algo, staged, n)
            events = prof.key_averages()
            prof_us = {}
            for name, key in STEP_KERNELS.items():
                hits = [e for e in events if key in e.key]
                calls = sum(e.count for e in hits)
                prof_us[name] = (sum(e.self_device_time_total for e in hits)
                                 / calls if calls else None)
            step_us = sum(e.self_device_time_total for e in events) / 10
            if None in prof_us.values() or step_us <= 0:
                inside = ("profiler: no kernel device time recorded; not "
                          "measured")
            else:
                inside = (f"profiler (10 steps): solver "
                          f"{prof_us['solver'] / 1e3:.5f} ms, write-back "
                          f"{prof_us['writeback'] / 1e3:.5f} ms, all device "
                          f"work {step_us / 1e3:.4f} ms per step")
            work = statistics.median(busy)
            print(f"step breakdown ({card}) {algo} requests {n} in a "
                  f"{staged.shape[1]}-lane bucket: host enqueue "
                  f"{statistics.median(host):.4f} ms, device span "
                  f"{statistics.median(dev_t):.4f} ms, drain wait "
                  f"{statistics.median(drain):.4f} ms (medians of 30); "
                  f"device work behind a backlog {work:.4f} ms (median of "
                  f"10), event pairs: solver {k_ms['solver']:.5f} ms, "
                  f"write-back {k_ms['writeback']:.5f} ms; {inside}; {ops} "
                  f"top-level torch ops per step")


# -- phase 5: the relay stream route ----------------------------------------
def phase_stream(rng, card: str, headline: np.ndarray):
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, relay_step, solver
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_760_100_000_000}
    storage = GpuBatchedStorage(num_slots=STREAM_SLOTS,
                                clock_ms=lambda: clock["t"])
    check(storage.device.type == "cuda", "storage is not on the card")
    host_index_line("stream", storage)
    registry = MeterRegistry()
    tb_cfg, sw_cfg = (RateLimitConfig(**HEADLINE_TB),
                      RateLimitConfig(**HEADLINE_SW))
    limiters = {
        "tb": TokenBucketRateLimiter(storage, tb_cfg, registry),
        "sw": SlidingWindowRateLimiter(storage, sw_cfg, registry,
                                       clock_ms=lambda: clock["t"]),
    }
    eng = storage.engine
    check(eng.rank_bits == 31 - STREAM_SLOTS.bit_length()
          and eng.counts_dtype() is np.uint8,
          f"relay layout: rank_bits {eng.rank_bits}, counts "
          f"{eng.counts_dtype()}")

    # (a) Every decision against the oracle, in arrival order.
    oracles = {"tb": TokenBucketOracle(tb_cfg),
               "sw": SlidingWindowOracle(sw_cfg)}
    launches_by_algo = {}
    solver.launches = block_scatter.launches = relay_step.launches = 0
    block_scatter.tb_writeback_launches = 0
    block_scatter.sw_writeback_launches = 0
    for algo, (sizes, steps) in STREAM_CHECKS.items():
        before = relay_step.launches
        n_checked = n_allowed = 0
        for size, dt in zip(sizes, steps):
            clock["t"] += dt
            ids = zipf_stream(rng, STREAM_KEYS, size)
            got = limiters[algo].try_acquire_stream_ids(ids)
            oracle, now = oracles[algo], clock["t"]
            want = np.fromiter((oracle.try_acquire(k, 1, now).allowed
                                for k in ids.tolist()), dtype=bool,
                               count=size)
            bad = int((got != want).sum())
            check(bad == 0, f"stream {algo}: {bad} of {size} decisions "
                  "differ from the oracle")
            n_checked += size
            n_allowed += int(got.sum())
        launches_by_algo[algo] = relay_step.launches - before
        check(launches_by_algo[algo] > 0,
              f"stream {algo}: the relay step was not launched")
        print(f"stream {algo}: {n_checked} decisions equal to the oracle "
              f"({n_allowed} allowed); relay_step launches "
              f"{launches_by_algo[algo]}")

    # (b) Timed headline passes.  CUDA events around each chunk's
    # dispatch (upload + kernel) and around the kernel's launch.  The
    # card is idle when they are recorded, so each span also holds the
    # host's time to issue the work: the sum is an upper bound on the
    # device's busy time, and the idle share a lower bound.
    spans, kernels = [], []
    dispatch0 = eng.tb_relay_counts_dispatch
    kernel0 = relay_step.tb_relay_counts

    eng.tb_relay_counts_dispatch = timed(dispatch0, spans)
    relay_step.tb_relay_counts = timed(kernel0, kernels)
    rates, walks = [], []
    try:
        for p in range(3):
            clock["t"] += 1_000
            spans.clear()
            kernels.clear()
            stages0 = stage_snapshot(storage)
            t0 = time.perf_counter()
            allowed = limiters["tb"].try_acquire_stream_ids(headline)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rates.append(STREAM_PASS / wall)
            if p == 0:
                stage_line(f"stream pass 0 ({card})", storage, stages0,
                           wall)
            busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
            print(f"stream pass {p} ({card}): {STREAM_PASS} requests in "
                  f"{wall:.4f} s = {rates[-1]:.1f} decisions/s, "
                  f"{int(allowed.sum())} allowed; device busy (upload + "
                  f"kernel spans) {busy * 1e3:.4f} ms, idle share at least "
                  f"{1 - busy / wall:.6f}")
            walks.append(sum(c["assign_s"]
                             for c in storage.last_stream_chunks) / wall)
            for i, rec in enumerate(storage.last_stream_chunks):
                k_ms = kernels[i][0].elapsed_time(kernels[i][1])
                up_ms = spans[i][0].elapsed_time(spans[i][1])
                print(f"  chunk {i} (host_parallel "
                      f"{rec.get('host_parallel', 0)}): requests "
                      f"{rec['requests']} uniques "
                      f"{rec['uniques']}  assign (C walk) "
                      f"{rec['assign_s'] * 1e3:.3f} ms  sort "
                      f"{rec['sort_s'] * 1e3:.3f} ms  enqueue "
                      f"{rec['enqueue_s'] * 1e3:.3f} ms  kernel span "
                      f"{k_ms:.5f} ms (upload + kernel {up_ms:.5f} ms)  "
                      f"drain + relay_decide {rec['drain_s'] * 1e3:.3f} ms")
    finally:
        eng.tb_relay_counts_dispatch = dispatch0
        relay_step.tb_relay_counts = kernel0
    print(f"stream ({card}): median {statistics.median(rates):.1f} "
          f"decisions/s over 3 passes of {STREAM_PASS}")

    # One more pass under the profiler's CUDA activity: the device time
    # the card spent on the pass (kernels and copies), and the kernel's.
    clock["t"] += 1_000
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        limiters["tb"].try_acquire_stream_ids(headline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    kernel_us = sum(e.self_device_time_total for e in events
                    if "relay_kernel" in e.key)
    if busy_us > 0:
        print(f"stream pass under the profiler ({card}): {wall:.4f} s; "
              f"device time {busy_us / 1e3:.4f} ms (relay kernel "
              f"{kernel_us / 1e3:.4f} ms), idle share "
              f"{1 - busy_us / 1e6 / wall:.6f}")
    else:
        print("stream pass under the profiler: no device time recorded; "
              "device time not measured")
    storage.close()

    # The headline passes again on one index over the same slots (the
    # partitioned index off), same keys: a measurement beside the elected
    # index's passes above.
    clock["t"] += 1_000
    single = GpuBatchedStorage(num_slots=STREAM_SLOTS, host_parallel=0,
                               clock_ms=lambda: clock["t"])
    host_index_line("stream A/B", single)
    lim1 = TokenBucketRateLimiter(single, tb_cfg, registry)
    lim1.try_acquire_stream_ids(headline)
    rates1, walks1 = [], []
    for p in range(3):
        clock["t"] += 1_000
        t0 = time.perf_counter()
        lim1.try_acquire_stream_ids(headline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates1.append(STREAM_PASS / wall)
        walks1.append(sum(c["assign_s"] for c in single.last_stream_chunks)
                      / wall)
    single.close()
    for label, t, r, w in (("elected", storage._host_parallel, rates, walks),
                           ("one index", 0, rates1, walks1)):
        print(f"stream A/B ({card}) {label}, host_parallel {t}: "
              f"decisions/s {', '.join(f'{x:.1f}' for x in r)} (median "
              f"{statistics.median(r):.1f}); C walk share of the pass "
              f"{', '.join(f'{x:.4f}' for x in w)}")
    steps = (solver.launches + block_scatter.tb_writeback_launches
             + block_scatter.sw_writeback_launches)
    check(steps == 0, f"the stream route launched {steps} micro-step kernels")
    return relay_step.launches


# -- phase 6: the permit stream route --------------------------------------
# Kernels as the profiler's CUDA activity names them.
PERMIT_KERNELS = {"solver": "solve_segments_kernel",
                  "write-back": "_writeback_kernel",
                  "row scatter": "scatter_rows_kernel"}
KERNEL_COUNTERS = ("solver", "tb_writeback", "sw_writeback",
                   "block_scatter", "relay_step")


def launch_counts() -> dict:
    from ratelimiter_tpu_torch.ops import cuda

    return cuda.launch_counts()


def reset_launch_counts() -> None:
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, relay_step, solver

    solver.launches = block_scatter.launches = relay_step.launches = 0
    block_scatter.tb_writeback_launches = 0
    block_scatter.sw_writeback_launches = 0


def permit_deployments(rng, headline: np.ndarray):
    """(name, algo, what, inputs(rng, n) -> (keys, lids or None, permits),
    timed pass inputs, each checked call's chunk modes, the timed pass's
    modes, the kernels the route must launch)."""
    def uniform_keys(rng, n):
        return rng.integers(0, STREAM_KEYS, n), None, rng.integers(1, 101, n)

    def zipf_keys_(rng, n):
        return zipf_stream(rng, STREAM_KEYS, n), None, rng.integers(1, 101, n)

    def zipf_fixed(rng, n):
        keys = zipf_stream(rng, STREAM_KEYS, n)
        return keys, None, 1 + keys % 100

    def tenants(rng, n):
        keys, tenant = scenario4_stream(rng, n)
        # Limiter ids 1..N_TENANTS in registration order.
        return keys, tenant + 1, rng.integers(1, 101, n)

    zipf_pass = headline[:PERMIT_PASS]
    return [
        ("a", "tb", "weighted, 1M uniform keys", uniform_keys,
         uniform_keys(rng, PERMIT_PASS), [["weighted"]] * 2, {"weighted"},
         ("block_scatter",)),
        ("b", "tb", "weighted, Zipf keys", zipf_keys_,
         (zipf_pass, None, rng.integers(1, 101, PERMIT_PASS)),
         [["flat_fb"]] * 2, {"flat_fb"}, ("solver", "tb_writeback")),
        ("c", "tb", "coalesced, Zipf keys", zipf_fixed,
         (zipf_pass, None, 1 + zipf_pass % 100), [["weighted_coal"]] * 2,
         {"weighted_coal"}, ("block_scatter",)),
        ("d", "tb", f"{N_TENANTS} tenants, lid array", tenants,
         tenants(rng, PERMIT_PASS), [["scan"], ["flat"]], {"scan"},
         ("solver", "tb_writeback")),
        ("e", "sw", "sliding window, Zipf keys", zipf_keys_,
         (zipf_pass, None, rng.integers(1, 101, PERMIT_PASS)),
         [["flat_fb"]] * 2, {"flat_fb"}, ("solver", "sw_writeback")),
    ]


def phase_permit_stream(rng, card: str, headline: np.ndarray) -> dict:
    """Phase 6: each deployment on its own storage; returns the kernel
    launch counts of the checked calls, summed over the deployments."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    for (name, algo, what, inputs, timed_inputs, checked_modes, pass_modes,
         kernels) in permit_deployments(rng, headline):
        clock = {"t": 1_760_200_000_000}
        storage = GpuBatchedStorage(num_slots=STREAM_SLOTS,
                                    clock_ms=lambda: clock["t"])
        check(storage.device.type == "cuda", "storage is not on the card")
        host_index_line(f"permit stream ({name})", storage)
        registry = MeterRegistry()
        if name == "d":
            cfgs = [RateLimitConfig(max_permits=50 + i % 100,
                                    window_ms=60_000,
                                    refill_rate=float(5 + i % 20))
                    for i in range(N_TENANTS)]
            for i, cfg in enumerate(cfgs):
                check(storage.register_limiter("tb", cfg) == i + 1,
                      "tenant limiter ids")

            def acquire(keys, lids, permits):
                return storage.acquire_stream_ids(
                    "tb", lids, keys, permits, batch=PERMIT_BATCH,
                    subbatches=PERMIT_SUBBATCHES)
            cfg_of = dict(enumerate(cfgs, start=1))
        else:
            cfg = RateLimitConfig(**(BURST_TB if algo == "tb"
                                     else HEADLINE_SW))
            lim = (TokenBucketRateLimiter(storage, cfg, registry)
                   if algo == "tb" else SlidingWindowRateLimiter(
                       storage, cfg, registry, clock_ms=lambda: clock["t"]))

            def acquire(keys, lids, permits, lim=lim):
                return lim.try_acquire_stream_ids(
                    keys, permits, batch=PERMIT_BATCH,
                    subbatches=PERMIT_SUBBATCHES)
            cfg_of = {lim._lid: cfg}
        oracles = {}

        def oracle(lid):
            if lid not in oracles:
                oracles[lid] = (TokenBucketOracle if algo == "tb"
                                else SlidingWindowOracle)(cfg_of[lid])
            return oracles[lid]

        # Checked calls: every decision against the oracle.
        checks = TENANT_CHECKS if name == "d" else PERMIT_CHECKS
        n_checked = n_allowed = 0
        launches = dict.fromkeys(KERNEL_COUNTERS, 0)
        for (size, dt), modes_want in zip(checks, checked_modes):
            clock["t"] += dt
            keys, lids, permits = inputs(rng, size)
            reset_launch_counts()
            got = acquire(keys, lids, permits)
            torch.cuda.synchronize()
            for k, v in launch_counts().items():
                launches[k] += v
            modes = [c["mode"] for c in storage.last_stream_chunks]
            check(modes == modes_want, f"permit stream ({name}): chunk modes "
                  f"{modes}, expected {modes_want}")
            now = clock["t"]
            lid_lane = (lids.tolist() if lids is not None
                        else [next(iter(cfg_of))] * size)
            want = np.fromiter(
                (oracle(l).try_acquire(k, p, now).allowed for l, k, p in
                 zip(lid_lane, keys.tolist(), permits.tolist())),
                dtype=bool, count=size)
            bad = int((got != want).sum())
            check(bad == 0, f"permit stream ({name}): {bad} of {size} "
                  "decisions differ from the oracle")
            n_checked += size
            n_allowed += int(got.sum())
        for k in KERNEL_COUNTERS:
            totals[k] += launches[k]
        missing = [k for k in kernels if launches[k] == 0]
        check(not missing and launches["relay_step"] == 0,
              f"permit stream ({name}): launches {launches}")
        print(f"permit stream ({name}) {what} [{algo}]: {n_checked} decisions "
              f"equal to the oracle ({n_allowed} allowed); launches "
              f"{launches}")

        # Timed passes.  CUDA events around each device dispatch: on an
        # idle card each span also holds the host's time to issue the
        # work, so their sum bounds the device's busy time from above.
        eng = storage.engine
        names = [f"{algo}_{k}_dispatch" for k in
                 ("flat", "scan", "weighted", "weighted_counts")]
        originals = {nm: getattr(eng, nm) for nm in names}
        spans = []
        for nm in names:
            setattr(eng, nm, timed(originals[nm], spans))
        keys, lids, permits = timed_inputs
        rates = []
        try:
            for p in range(3):
                clock["t"] += 1_000
                spans.clear()
                t0 = time.perf_counter()
                allowed = acquire(keys, lids, permits)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rates.append(PERMIT_PASS / wall)
                busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
                chunks = storage.last_stream_chunks
                modes = {c["mode"] for c in chunks}
                check(modes == pass_modes, f"permit stream ({name}) pass: "
                      f"modes {modes}, expected {pass_modes}")
                print(f"permit stream ({name}) pass {p} ({card}): "
                      f"{PERMIT_PASS} requests in {wall:.4f} s = "
                      f"{rates[-1]:.1f} decisions/s, {int(allowed.sum())} "
                      f"allowed; {len(spans)} dispatches, device busy "
                      f"(dispatch spans) {busy * 1e3:.4f} ms, idle share at "
                      f"least {1 - busy / wall:.6f}")
                for i, rec in enumerate(chunks):
                    print(f"  chunk {i} {rec['mode']} (host_parallel "
                          f"{rec.get('host_parallel', 0)}): requests "
                          f"{rec['requests']} uniques "
                          f"{rec.get('uniques', 'n/a')}  assign (C walk) "
                          f"{rec['assign_s'] * 1e3:.3f} ms  layout "
                          f"{rec['layout_s'] * 1e3:.3f} ms  enqueue "
                          f"{rec['enqueue_s'] * 1e3:.3f} ms  drain "
                          f"{rec['drain_s'] * 1e3:.3f} ms")
        finally:
            for nm in names:
                setattr(eng, nm, originals[nm])
        print(f"permit stream ({name}) ({card}): median "
              f"{statistics.median(rates):.1f} decisions/s over 3 passes of "
              f"{PERMIT_PASS}")

        # One more pass under the profiler: the card's device time, and
        # the port's kernels in it.
        clock["t"] += 1_000
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            acquire(keys, lids, permits)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            parts = []
            for label, key in PERMIT_KERNELS.items():
                hits = [e for e in events if key in e.key]
                if hits:
                    parts.append(
                        f"{label} {sum(e.count for e in hits)} launches "
                        f"{sum(e.self_device_time_total for e in hits) / 1e3:.4f} ms")
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
            print(f"permit stream ({name}) pass under the profiler ({card}): "
                  f"{wall:.4f} s; device time {busy_us / 1e3:.4f} ms, idle "
                  f"share {1 - busy_us / 1e6 / wall:.6f}; "
                  f"{'; '.join(parts) or 'no port kernel'}; top: "
                  + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms"
                              for e in top))
        else:
            print(f"permit stream ({name}) pass under the profiler: no device "
                  "time recorded; device time not measured")
        storage.close()
    return totals


# -- phase 7: the relay's words mode and resident digest ------------------
def print_chunks(chunks) -> None:
    for i, rec in enumerate(chunks):
        print(f"  chunk {i} {rec['mode']} (host_parallel "
              f"{rec.get('host_parallel', 0)}): requests {rec['requests']} "
              f"uniques {rec['uniques']} deltas {rec['deltas']} (lanes "
              f"{rec['delta_lanes']})  assign (C walk) "
              f"{rec['assign_s'] * 1e3:.3f} ms"
              + (f" (hashing {rec['pack_s'] * 1e3:.3f} ms)"
                 if "pack_s" in rec else "")
              + f"  layout {rec['layout_s'] * 1e3:.3f} ms  enqueue "
              f"{rec['enqueue_s'] * 1e3:.3f} ms  drain "
              f"{rec['drain_s'] * 1e3:.3f} ms")


def profiled_pass(label: str, card: str, run) -> None:
    """One pass under the profiler's CUDA activity: the card's device
    time, the idle share it leaves, and the port's kernels in it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        print(f"{label} pass under the profiler: no device time recorded "
              f"({len(events)} events); device time not measured")
        return
    parts = []
    for name, key in PERMIT_KERNELS.items():
        hits = [e for e in events if key in e.key]
        if hits:
            parts.append(
                f"{name} {sum(e.count for e in hits)} launches "
                f"{sum(e.self_device_time_total for e in hits) / 1e3:.4f} ms")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    print(f"{label} pass under the profiler ({card}): {wall:.4f} s; device "
          f"time {busy_us / 1e3:.4f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall:.6f}; "
          f"{'; '.join(parts) or 'no port kernel'}; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms"
                      for e in top))


def timed_passes(label: str, card: str, storage, run, n: int, clock,
                 expect, dispatches=()) -> None:
    """Three timed passes of ``run`` (``n`` requests each, the clock a
    second later each time), each chunk's record checked by ``expect``
    and printed, then one pass under the profiler.  The engine methods
    named in ``dispatches`` get CUDA events around each call: on an idle
    card each span also holds the host's time to issue the work, so
    their sum bounds the device's busy time from above."""
    eng = storage.engine
    originals = {nm: getattr(eng, nm) for nm in dispatches}
    spans = []
    for nm in dispatches:
        setattr(eng, nm, timed(originals[nm], spans))
    rates = []
    for p in range(3):
        clock["t"] += 1_000
        spans.clear()
        t0 = time.perf_counter()
        allowed = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append(n / wall)
        chunks = storage.last_stream_chunks
        for rec in chunks:
            expect(rec)
        busy = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        print(f"{label} pass {p} ({card}): {n} requests in {wall:.4f} s = "
              f"{rates[-1]:.1f} decisions/s, {int(allowed.sum())} allowed"
              + (f"; device busy (dispatch spans) {busy * 1e3:.4f} ms, idle "
                 f"share at least {1 - busy / wall:.6f}" if spans else ""))
        print_chunks(chunks)
    for nm, fn in originals.items():
        setattr(eng, nm, fn)
    print(f"{label} ({card}): median {statistics.median(rates):.1f} "
          f"decisions/s over 3 passes of {n}")
    clock["t"] += 1_000
    profiled_pass(label, card, run)


def oracle_check(label: str, got, lids, keys, now, oracles, make) -> None:
    """Every decision of one call against the oracle of its limiter id
    (``make(lid)`` builds one), in arrival order at ``now``."""
    def oracle(lid):
        if lid not in oracles:
            oracles[lid] = make(lid)
        return oracles[lid]

    want = np.fromiter((oracle(l).try_acquire(k, 1, now).allowed
                        for l, k in zip(lids.tolist(), keys.tolist())),
                       dtype=bool, count=len(keys))
    bad = int((np.asarray(got) != want).sum())
    check(bad == 0, f"{label}: {bad} of {len(keys)} decisions differ from "
          "the oracle")


def lid_upload_bound(storage, keys, lids):
    """For a population of (lid, key) pairs that has been through the
    storage once: (how many pairs find no slot of their own in its host
    index, ``bound``).  Pairs route to partitions by key, as the index
    routes them; a partition holding more of the pairs than slots evicts
    among them by LRU, and only there can a pair lose its slot and need
    its lid uploaded again.  ``bound(keys, lids)`` counts the distinct
    pairs of a chunk in such partitions: the most lid uploads the chunk
    can take (0 where every partition holds its pairs)."""
    from ratelimiter_tpu_torch.engine.routing import shard_of_int_keys

    t = max(storage._host_parallel, 1)
    pairs = np.unique((keys.astype(np.int64) << 32) | lids)
    per_part = np.bincount(shard_of_int_keys(pairs >> 32, t), minlength=t)
    spare = per_part - storage.engine.num_slots // t
    crowded = spare > 0

    def bound(keys, lids) -> int:
        hit = crowded[shard_of_int_keys(keys, t)]
        return len(np.unique((keys[hit].astype(np.int64) << 32) | lids[hit]))
    return int(spare[crowded].sum()), bound


def counted(totals: dict, fn):
    """``fn()`` with every kernel's launch count set to 0 before it and
    added into ``totals`` after; returns (its result, its counts)."""
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    for k, v in got.items():
        totals[k] += v
    return out, got


def phase_relay_modes(rng, card: str) -> dict:
    """Phase 7.  (f) bench.py's scenario 4 at full size: a warm pass over
    a disjoint key population fills the table, then a churn pass (every
    request a first touch, evicting) whose decisions, state and lid map
    must equal the same calls on a ``device="cpu"`` storage, a check call
    of 2^20 requests of 1/8 of the tenants against the oracle and (its
    decisions and each chunk's lid uploads) the CPU storage, and steady
    passes whose chunks upload no lid but of pairs in partitions that
    hold fewer slots than pairs (:func:`lid_upload_bound`).  (g)
    bench.py's scenario 3: words
    mode in every chunk, timed passes after a warm one, and 2^20 decisions
    of a fresh storage against the oracle.  Then words mode past uint16
    counts, with one limiter and with a lid array, against the oracle.
    Returns the kernel launch counts of the card's runs."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import SlidingWindowRateLimiter
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)

    def only_scatter(label, counts):
        check(counts["block_scatter"] > 0
              and counts["block_scatter"] == sum(counts.values()),
              f"{label}: launches {counts}, expected the row scatter alone")

    # (f) scenario 4: 100K tenants on 800_000 slots.
    clock = {"t": 1_760_300_000_000}
    cfgs = [RateLimitConfig(max_permits=50 + i % 100, window_ms=60_000,
                            refill_rate=float(5 + i % 20))
            for i in range(N_TENANTS)]
    card_st = GpuBatchedStorage(num_slots=TENANT_SLOTS,
                                clock_ms=lambda: clock["t"])
    host_index_line("relay (f)", card_st)
    cpu_st = GpuBatchedStorage(num_slots=TENANT_SLOTS,
                               clock_ms=lambda: clock["t"], device="cpu",
                               host_parallel=card_st._host_parallel)
    for st in (card_st, cpu_st):
        for i, cfg in enumerate(cfgs):
            check(st.register_limiter("tb", cfg) == i + 1,
                  "tenant limiter ids")
    keys4, tenant4 = scenario4_stream(rng, TENANT_PASS)
    lids4 = tenant4 + 1

    def tenants(st, keys, lids):
        return lambda: st.acquire_stream_ids("tb", lids, keys)

    clock["t"] += 1_000
    for st in (card_st, cpu_st):
        tenants(st, keys4 + N_TENANTS * KEYS_PER_TENANT, lids4)()
    clock["t"] += 1_000
    t0 = time.perf_counter()
    got, counts = counted(totals, tenants(card_st, keys4, lids4))
    wall = time.perf_counter() - t0
    churn = card_st.last_stream_chunks
    want = tenants(cpu_st, keys4, lids4)()
    bad = int((got != want).sum())
    check(bad == 0, f"scenario 4 churn: {bad} decisions differ from the "
          "CPU storage's")
    check(torch.equal(card_st.engine.tb_packed.cpu(), cpu_st.engine.tb_packed)
          and torch.equal(card_st.engine.tb_lid_map.cpu(),
                          cpu_st.engine.tb_lid_map),
          "scenario 4 churn: the card's state or lid map differs from the "
          "CPU storage's")
    check(all(c["mode"] == "resident" and c["deltas"] > 0 for c in churn),
          f"scenario 4 churn: chunks {[(c['mode'], c['deltas']) for c in churn]}")
    only_scatter("scenario 4 churn", counts)
    print(f"relay (f) scenario 4 churn pass ({card}): {TENANT_PASS} "
          f"requests in {wall:.4f} s = {TENANT_PASS / wall:.1f} "
          f"decisions/s, {int(got.sum())} allowed; decisions, state and lid "
          f"map equal to the CPU storage's; launches {counts}")
    print_chunks(churn)

    # The steady slice: 2^20 requests of 1/8 of the tenants; the oracle
    # replays those tenants' churn requests first.  Every pair's lid stays
    # on the card unless its partition holds more of the pass's pairs
    # than slots: then LRU evicts within it, and an evicted pair's lid
    # goes up again at its next use.  The CPU storage takes the same call:
    # its decisions and every chunk's lid uploads must be the card's.
    overflow, upload_bound = lid_upload_bound(card_st, keys4, lids4)
    print(f"relay (f): pairs past their partition's slots: {overflow}")

    def resident(label, rec, keys, lids):
        bound = upload_bound(keys, lids)
        check(rec["mode"] == "resident" and rec["deltas"] <= bound
              and (bound or rec["delta_lanes"] == 8),
              f"{label}: chunk {rec}, at most {bound} lid uploads")
    sel = np.flatnonzero(tenant4 < TENANT_CHECK_TENANTS)
    pick = rng.choice(sel, 1 << 20)
    churn_now = clock["t"]
    clock["t"] += 7_000
    got, counts = counted(totals, tenants(card_st, keys4[pick],
                                          lids4[pick]))
    chunks = card_st.last_stream_chunks
    start = 0
    for rec in chunks:
        stop = start + rec["requests"]
        resident("scenario 4 steady slice", rec, keys4[pick][start:stop],
                 lids4[pick][start:stop])
        start = stop
    only_scatter("scenario 4 steady slice", counts)
    want = tenants(cpu_st, keys4[pick], lids4[pick])()
    uploads = [(c["requests"], c["deltas"]) for c in chunks]
    check(np.array_equal(got, want) and uploads == [
        (c["requests"], c["deltas"]) for c in cpu_st.last_stream_chunks],
          "scenario 4 steady slice: decisions or (requests, lid uploads) "
          f"per chunk {uploads} differ from the CPU storage's")
    cpu_st.close()
    oracles = {}

    def make_tb(lid):
        return TokenBucketOracle(cfgs[lid - 1])
    for l, k in zip(lids4[sel].tolist(), keys4[sel].tolist()):
        if l not in oracles:
            oracles[l] = make_tb(l)
        oracles[l].try_acquire(k, 1, churn_now)
    oracle_check("scenario 4 steady slice", got, lids4[pick], keys4[pick],
                 clock["t"], oracles, make_tb)
    print(f"relay (f) scenario 4 steady slice: {len(pick)} decisions equal "
          f"to the oracle ({int(got.sum())} allowed); decisions and lid "
          f"uploads per chunk {[d for _, d in uploads]} equal to the CPU "
          f"storage's; launches {counts}")

    # The timed passes' chunks come in order, pass after pass.
    at = {"start": 0}

    def steady(rec):
        start = at["start"]
        stop = start + rec["requests"]
        resident("scenario 4 steady", rec, keys4[start:stop],
                 lids4[start:stop])
        at["start"] = stop % TENANT_PASS
    _, counts = counted(totals, lambda: timed_passes(
        "relay (f) scenario 4 steady", card, card_st,
        tenants(card_st, keys4, lids4), TENANT_PASS, clock, steady))
    only_scatter("scenario 4 steady", counts)
    card_st.close()

    # (g) scenario 3: a sliding window over 10M uniform keys.
    clock = {"t": 1_760_400_000_000}
    sw_cfg = RateLimitConfig(**WORDS_SW)
    storage = GpuBatchedStorage(num_slots=WORDS_SLOTS,
                                clock_ms=lambda: clock["t"])
    host_index_line("relay (g)", storage)
    lim = SlidingWindowRateLimiter(storage, sw_cfg, MeterRegistry(),
                                   clock_ms=lambda: clock["t"])
    eng = storage.engine
    # Counts fit uint8, so words mode is the election's pick, not forced.
    check(eng.counts_dtype() is np.uint8 and eng.relay_usable(),
          f"scenario 3 layout: rank_bits {eng.rank_bits}, counts "
          f"{eng.counts_dtype()}")
    print(f"relay (g) scenario 3: {WORDS_SLOTS} slots, rank_bits "
          f"{eng.rank_bits}, counts {np.dtype(eng.counts_dtype()).name}")
    keys3 = rng.integers(0, WORDS_KEYS, WORDS_PASS)

    def words(rec):
        check(rec["mode"] == "words", f"scenario 3: chunk {rec}")
    lim.try_acquire_stream_ids(keys3)
    for rec in storage.last_stream_chunks:
        words(rec)
    _, counts = counted(totals, lambda: timed_passes(
        "relay (g) scenario 3", card, storage,
        lambda: lim.try_acquire_stream_ids(keys3), WORDS_PASS, clock,
        words))
    only_scatter("scenario 3", counts)
    storage.close()

    clock = {"t": 1_760_500_000_000}
    storage = GpuBatchedStorage(num_slots=WORDS_SLOTS,
                                clock_ms=lambda: clock["t"])
    lim = SlidingWindowRateLimiter(storage, sw_cfg, MeterRegistry(),
                                   clock_ms=lambda: clock["t"])
    keys = rng.integers(0, WORDS_KEYS, 1 << 20)
    got, counts = counted(totals, lambda: lim.try_acquire_stream_ids(keys))
    for rec in storage.last_stream_chunks:
        words(rec)
    only_scatter("scenario 3 checked call", counts)
    oracle_check("scenario 3", got, np.full(len(keys), lim._lid), keys,
                 clock["t"], {}, lambda lid: SlidingWindowOracle(sw_cfg))
    print(f"relay (g) scenario 3: {len(keys)} decisions of a fresh storage "
          f"equal to the oracle ({int(got.sum())} allowed); launches "
          f"{counts}")
    storage.close()

    # Words mode past uint16 counts, one limiter and a lid array.
    for algo in ("tb", "sw"):
        clock = {"t": 1_760_600_000_000}
        storage = GpuBatchedStorage(num_slots=HUGE_SLOTS,
                                    clock_ms=lambda: clock["t"])
        huge = dict(max_permits=HUGE_LIMIT, window_ms=60_000)
        small = dict(max_permits=9, window_ms=60_000)
        for kw in (huge, small):
            if algo == "tb":
                kw["refill_rate"] = 20_000.0
            else:
                kw["enable_local_cache"] = False
        cfg_of = {storage.register_limiter(algo, RateLimitConfig(**kw)):
                  RateLimitConfig(**kw) for kw in (huge, small)}
        check(storage.engine.counts_dtype() is None,
              "uint16 check: a count dtype fits")
        big, other = sorted(cfg_of)
        keys = rng.permutation(np.r_[np.full(HUGE_LIMIT + 1_000, 1),
                                     zipf_stream(rng, 50, 1_000)])
        oracles = {}

        def make(lid, algo=algo, cfg_of=cfg_of):
            return (TokenBucketOracle if algo == "tb"
                    else SlidingWindowOracle)(cfg_of[lid])
        n_allowed = 0
        for dt, lids in ((0, np.full(len(keys), big)),
                         (2_100, np.where((keys == 1) | (keys % 2 == 0),
                                          big, other))):
            clock["t"] += dt
            got, counts = counted(totals, lambda: storage.acquire_stream_ids(
                algo, lids if dt else big, keys))
            modes = {c["mode"] for c in storage.last_stream_chunks}
            check(modes == {"words"}, f"uint16 check: chunk modes {modes}")
            only_scatter(f"uint16 check {algo}", counts)
            oracle_check(f"uint16 check {algo}", got, lids, keys,
                         clock["t"], oracles, make)
            n_allowed += int(got.sum())
        print(f"relay words mode past uint16 counts [{algo}]: "
              f"{2 * len(keys)} decisions (one limiter of {HUGE_LIMIT}, "
              f"then a lid array) equal to the oracle ({n_allowed} "
              f"allowed)")
        storage.close()
    return totals


# -- phase 8: string keys ----------------------------------------------------
def phase_strings(rng, card: str, headline: np.ndarray) -> dict:
    """Phase 8, bench/profile_stream_r5.py's string deployment: the
    headline's token bucket over its 1M bounded-Zipf keys written as
    ``f"k{i}"``, on 2_000_128 slots with the elected host index, through
    ``TokenBucketRateLimiter.try_acquire_many`` (which must take
    ``acquire_stream_strs``).  2^20 decisions in two calls against the
    oracle, three timed passes of 2^21 requests and one under the
    profiler; then a sliding window of 100/min over the same keys, 2^19
    decisions against the oracle.  Returns the kernel launch counts."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    clock = {"t": 1_760_700_000_000}
    storage = GpuBatchedStorage(num_slots=STREAM_SLOTS,
                                clock_ms=lambda: clock["t"])
    host_index_line("strings", storage)
    streams = []
    real = storage.acquire_stream_strs

    def spy(*args, **kw):
        streams.append(len(args[2]))
        return real(*args, **kw)
    storage.acquire_stream_strs = spy
    tb_cfg, sw_cfg = (RateLimitConfig(**HEADLINE_TB),
                      RateLimitConfig(**HEADLINE_SW))
    registry = MeterRegistry()
    tb = TokenBucketRateLimiter(storage, tb_cfg, registry)
    sw = SlidingWindowRateLimiter(storage, sw_cfg, registry,
                                  clock_ms=lambda: clock["t"])
    t0 = time.perf_counter()
    keys = [f"k{i}" for i in headline[:STRS_PASS].tolist()]
    print(f"strings: {len(keys)} keys written in "
          f"{time.perf_counter() - t0:.3f} s")

    def only_relay(label, counts):
        check(counts["relay_step"] > 0
              and counts["solver"] == counts["tb_writeback"]
              == counts["sw_writeback"] == 0,
              f"{label}: launches {counts}")

    def strs_chunk(rec):
        check(rec["mode"] in ("relay", "words") and "pack_s" in rec
              and rec.get("host_parallel", 0) == storage._host_parallel,
              f"strings: chunk {rec}")

    oracle = TokenBucketOracle(tb_cfg)
    n_allowed = 0
    for half, dt in ((0, 0), (1, 7_000)):
        clock["t"] += dt
        part = keys[half * STRS_CHECK:(half + 1) * STRS_CHECK]
        got, counts = counted(totals, lambda: tb.try_acquire_many(part))
        check(streams == [len(part)], f"strings: stream calls {streams}")
        streams.clear()
        for rec in storage.last_stream_chunks:
            strs_chunk(rec)
        only_relay("strings checked call", counts)
        oracle_check("strings tb", got, np.zeros(len(part), dtype=np.int64),
                     np.asarray(part), clock["t"], {0: oracle},
                     lambda lid: oracle)
        n_allowed += int(got.sum())
    print(f"strings tb: {2 * STRS_CHECK} decisions through try_acquire_many "
          f"-> acquire_stream_strs equal to the oracle ({n_allowed} "
          f"allowed); chunk modes "
          f"{[c['mode'] for c in storage.last_stream_chunks]}")
    _, counts = counted(totals, lambda: timed_passes(
        "strings tb", card, storage, lambda: tb.try_acquire_many(keys),
        STRS_PASS, clock, strs_chunk,
        ("tb_relay_counts_dispatch", "tb_relay_dispatch")))
    only_relay("strings timed passes", counts)
    check(len(streams) == 4 and set(streams) == {STRS_PASS},
          f"strings: stream calls {streams}")
    streams.clear()

    clock["t"] += 1_000
    part = keys[:STRS_CHECK]
    got, counts = counted(totals, lambda: sw.try_acquire_many(part))
    check(streams == [len(part)], f"strings sw: stream calls {streams}")
    for rec in storage.last_stream_chunks:
        strs_chunk(rec)
    only_relay("strings sw", counts)
    oracle_check("strings sw", got, np.zeros(len(part), dtype=np.int64),
                 np.asarray(part), clock["t"], {},
                 lambda lid: SlidingWindowOracle(sw_cfg))
    print(f"strings sw: {len(part)} decisions equal to the oracle "
          f"({int(got.sum())} allowed); launches {counts}")
    print(f"strings: launches over the phase {totals}")
    storage.close()
    return totals


# -- phase 9: eviction under partitions ------------------------------------
def phase_partition_churn(rng, card: str) -> dict:
    """Phase 9: a 2^20-slot storage on 8 partitions takes a churn stream
    under a token bucket of one permit: 1.25x more keys than partition 0
    holds routed to it (by the port's routing), with keys of the other
    partitions between them, in chunks of 2^16 requests (each fits its
    partition), then the first (evicted: fresh state, allowed) and the
    last (held: denied) of them again.  Decisions and final state must
    equal a ``device="cpu"`` storage's on the same calls, and evictions
    must have happened.  Returns the kernel launch counts."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.engine.routing import shard_of_int_keys
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    clock = {"t": 1_760_800_000_000}
    made = [GpuBatchedStorage(num_slots=CHURN_SLOTS, host_parallel=8,
                              clock_ms=lambda: clock["t"], device=dev)
            for dev in (None, "cpu")]
    card_st, cpu_st = made
    host_index_line("partition churn", card_st)
    cleared = []
    clear0 = card_st._clear_slots

    def clear(algo, slots):
        cleared.append(len(slots))
        clear0(algo, slots)
    card_st._clear_slots = clear
    cfg = RateLimitConfig(max_permits=1, window_ms=60_000, refill_rate=0.001)
    lid = card_st.register_limiter("tb", cfg)
    check(cpu_st.register_limiter("tb", cfg) == lid, "limiter ids")
    cand = rng.permutation(1 << 23).astype(np.int64)
    part = shard_of_int_keys(cand, 8)
    hot = cand[part == 0][:CHURN_SLOTS // 8 * 5 // 4]
    rest = cand[part != 0][:len(hot)]
    stream = np.empty(2 * len(hot), dtype=np.int64)
    stream[0::2], stream[1::2] = hot, rest
    stream = np.r_[stream, hot[:CHURN_CHUNK // 2],
                   hot[-(CHURN_CHUNK // 2):]]
    n_allowed = 0
    t0 = time.perf_counter()
    for i in range(0, len(stream), CHURN_CHUNK):
        clock["t"] += 50
        chunk = stream[i:i + CHURN_CHUNK]
        got, _ = counted(totals, lambda: card_st.acquire_stream_ids(
            "tb", lid, chunk))
        want = cpu_st.acquire_stream_ids("tb", lid, chunk)
        bad = int((got != want).sum())
        check(bad == 0, f"partition churn: {bad} decisions of chunk "
              f"{i // CHURN_CHUNK} differ from the CPU storage's")
        n_allowed += int(got.sum())
    wall = time.perf_counter() - t0
    check(torch.equal(card_st.engine.tb_packed.cpu(), cpu_st.engine.tb_packed),
          "partition churn: the card's state differs from the CPU storage's")
    evictions = sum(cleared)
    check(evictions > 0, "partition churn: nothing was evicted")
    check(n_allowed == len(stream) - CHURN_CHUNK // 2,
          f"partition churn: {n_allowed} allowed of {len(stream)}, expected "
          f"all but the {CHURN_CHUNK // 2} held keys' repeats")
    print(f"partition churn ({card}): {len(stream)} requests ({len(hot)} "
          f"keys of partition 0, {CHURN_SLOTS // 8} slots each) in "
          f"{len(stream) // CHURN_CHUNK} calls, {wall:.3f} s with the CPU "
          f"storage's replay; {n_allowed} allowed; {evictions} evictions; "
          f"decisions and state equal to the CPU storage's; launches "
          f"{totals}")
    for st in made:
        st.close()
    return totals


# -- phase 10: the service's storage composition ---------------------------
def check_launches(cond, msg: str) -> None:
    """A check on kernel launch counts (a CPU rehearsal, where no kernel
    launches, replaces it)."""
    check(cond, msg)


def stage_snapshot(storage) -> dict:
    """Each stream stage timer's (record count, total us) now."""
    return {st: (t.count(), t.total_us())
            for st, t in storage._stage_timers.items()}


def stage_line(label: str, storage, before: dict, wall: float) -> None:
    """One pass's stage timers (the difference from ``before``): every
    stage the route records must have records and time, and their time
    together (``pack`` is part of ``index``) must fit the pass's wall."""
    after = stage_snapshot(storage)
    delta = {st: (after[st][0] - before[st][0],
                  (after[st][1] - before[st][1]) / 1e6) for st in after}
    print(f"{label} stage timers (records, seconds): "
          + ", ".join(f"{st} {n} {s:.6f}" for st, (n, s) in delta.items())
          + f"; pass wall {wall:.6f} s")
    for st in ("index", "layout", "enqueue", "fetch"):
        check(delta[st][0] > 0 and delta[st][1] > 0,
              f"{label}: stage {st} recorded nothing: {delta}")
    spent = sum(s for st, (_, s) in delta.items() if st != "pack")
    check(spent <= wall, f"{label}: stage timers sum to {spent:.6f} s, "
          f"more than the pass's {wall:.6f} s")


def legacy_calls(rng, n: int, t0: int):
    """``n`` seeded calls of the ten legacy methods over a few keys."""
    out = []
    for i in range(n):
        key = f"legacy{int(rng.integers(0, 8))}"
        op = int(rng.integers(0, 10))
        args = {
            0: ("increment_and_expire", key, int(rng.choice([5, 500]))),
            1: ("get", key),
            2: ("set", key, int(rng.integers(0, 9)), 40),
            3: ("compare_and_set", key, int(rng.integers(0, 3)),
                int(rng.integers(0, 9))),
            4: ("delete", key),
            5: ("z_add", key, float(i), f"m{int(rng.integers(0, 20))}"),
            6: ("z_remove_range_by_score", key, float("-inf"),
                float(i - 30)),
            7: ("z_count", key, float(i - 50), float("inf")),
            8: ("eval_script", "token_bucket", [key],
                [5 << 20, 3 << 10, int(rng.integers(1, 7)) << 20,
                 t0 + 10 * i, 3_000]),
            9: ("eval_script", "token_bucket_peek", [key],
                [5 << 20, 3 << 10, t0 + 10 * i]),
        }[op]
        out.append(args)
    return out


def phase_compose(rng, card: str) -> dict:
    """Phase 10, the storage as ``service/wiring.py`` composes it, with
    ``application.properties``' settings: ``GpuBatchedStorage(num_slots=
    2^20)`` wrapped as retry(breaker(chaos(storage))) (``breaker.*``:
    threshold 8, open 5000 ms, one probe; the default retry policy, 3
    attempts at 10 ms linear backoff) with the degraded host limiter
    subscribed to policy updates, phase 3's trio over it.  Checks:
    the trio through the stack against the oracle, with a live policy
    update the fallback hears, and a 2^15-key ``try_acquire_many`` of the
    cache-less auth limiter that must reach ``acquire_stream_strs``; (a)
    the legacy contract (the ten methods through the stack, the
    sliding-window log over it, the compat sw / tb limiters over a bare
    ``InMemoryStorage``) against plain models, launching no kernel; (b)
    the outage drill at this deployment's size; (c) the hybrid serving
    tier (``ratelimiter.cache.hybrid.*``) on a second storage under
    Zipf traffic; (d) the storage latency meter of (b) and (c).  Returns
    the kernel launch counts."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowLogRateLimiter,
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.ops.cuda import block_scatter
    from ratelimiter_tpu_torch.storage import (
        CircuitBreakerStorage,
        DegradedHostLimiter,
        FaultInjectingStorage,
        InMemoryStorage,
        RetryingStorage,
        RetryPolicy,
    )
    from ratelimiter_tpu_torch.storage.chaos import outage_drill
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    clock = {"t": 1_760_900_000_000}
    now = lambda: clock["t"]  # noqa: E731
    stamp_state = {"t": 0}

    def stamp(t):
        stamp_state["t"] = max(stamp_state["t"], t)
        return stamp_state["t"]

    registry = MeterRegistry()
    storage = GpuBatchedStorage(num_slots=NUM_SLOTS, clock_ms=now,
                                meter_registry=registry)
    check(storage.device.type == "cuda", "storage is not on the card")
    host_index_line("composition", storage)
    chaos = FaultInjectingStorage(storage)
    fallback = DegradedHostLimiter(clock_ms=now, registry=registry)
    breaker = CircuitBreakerStorage(chaos, clock_ms=now, fallback=fallback,
                                    registry=registry, **BREAKER)
    top = RetryingStorage(breaker, RetryPolicy())
    storage.add_policy_listener(fallback.update_policy)
    heard = []
    storage.add_policy_listener(lambda *a: heard.append(a))
    limiters, refs = {}, {}
    for name, (algo, kw) in TRIO.items():
        cfg = RateLimitConfig(**kw)
        cls = SlidingWindowRateLimiter if algo == "sw" else \
            TokenBucketRateLimiter
        limiters[name] = cls(top, cfg, registry, clock_ms=now)
        refs[name] = Reference(algo, cfg, now, stamp)
    check(all(lim._lid is not None for lim in limiters.values()),
          "the wrappers hid the device-batching storage from the limiters")
    names = list(TRIO)

    def trio_singles(n):
        bad = n_allowed = 0
        for i in range(n):
            clock["t"] += int(rng.integers(0, 40))
            name = names[i % 3]
            key = f"user{zipf_keys(rng, 1)[0]}"
            permits = (int(rng.integers(1, 101)) if name == "burst"
                       else int(rng.integers(1, 4)))
            got = limiters[name].try_acquire(key, permits)
            bad += got != refs[name].one(key, permits)
            n_allowed += got
        return bad, n_allowed

    (bad, n_allowed), counts = counted(
        totals, lambda: trio_singles(COMPOSE_SINGLE))
    check(bad == 0, f"composition: {bad} trio decisions through the stack "
          "differ from the oracle")
    # A live policy update through the stack: the fallback hears it.
    burst_lid = limiters["burst"]._lid
    new_burst = RateLimitConfig(**dict(TRIO["burst"][1], refill_rate=20.0))
    top.set_policy(burst_lid, new_burst)
    refs["burst"].oracle.reconfigure(new_burst)
    check(len(heard) == 1 and heard[0][0] == burst_lid
          and fallback._configs[burst_lid][1] is new_burst,
          f"composition: policy listeners heard {heard}")
    (bad2, n_allowed2), counts2 = counted(
        totals, lambda: trio_singles(COMPOSE_SINGLE // 3))
    check(bad2 == 0, f"composition: {bad2} decisions after set_policy "
          "differ from the oracle")
    clock["t"] += 1_000
    strs = [f"user{k}" for k in zipf_keys(rng, COMPOSE_STRS)]
    got, counts3 = counted(totals,
                           lambda: limiters["auth"].try_acquire_many(strs))
    want = refs["auth"].many(strs, [1] * len(strs))
    check(int((got != want).sum()) == 0, "composition: the auth string "
          "stream differs from the oracle")
    check(storage.last_stream_chunks and all(
        c["mode"] in ("relay", "words") for c in storage.last_stream_chunks),
        f"composition: the 2^15-key call took no string stream: "
        f"{storage.last_stream_chunks}")
    check_launches(counts3["relay_step"] > 0 and counts3["solver"] == 0,
                   f"composition: string stream launches {counts3}")
    check_launches(counts["solver"] > 0 and counts["solver"]
                   == counts["tb_writeback"] + counts["sw_writeback"],
                   f"composition: trio launches {counts}")
    print(f"composition ({card}): {COMPOSE_SINGLE + COMPOSE_SINGLE // 3} "
          f"trio try_acquire through retry(breaker(chaos(storage))) equal "
          f"to the oracle ({n_allowed + n_allowed2} allowed), set_policy "
          f"heard by the fallback; auth try_acquire_many of "
          f"{COMPOSE_STRS} -> acquire_stream_strs equal to the oracle "
          f"({int(got.sum())} allowed); breaker {breaker.state}; launches "
          f"{counts}, {counts2}, {counts3}")

    # (a) The legacy contract: host-side, no kernel.
    def legacy():
        t_a = clock["t"]
        plain = InMemoryStorage(clock_ms=now)
        n = 0
        for name, *args in legacy_calls(rng, LEGACY_CALLS, t_a):
            clock["t"] += int(rng.integers(0, 12))
            got, want = getattr(top, name)(*args), getattr(plain, name)(
                *args)
            check(got == want, f"legacy {name}{tuple(args)}: {got} != "
                  f"{want}")
            n += 1
        # The exact sliding-window log over the stack's zsets, against a
        # list of admission times per key.
        log_cfg = RateLimitConfig(max_permits=5, window_ms=1_000)
        log = SlidingWindowLogRateLimiter(top, log_cfg, registry,
                                          clock_ms=now)
        times: dict = {}
        for _ in range(LEGACY_CALLS):
            clock["t"] += int(rng.choice([0, 3, 40, 400, 1_100]))
            key = f"log{int(rng.integers(0, 16))}"
            permits = int(rng.choice([1, 1, 2, 5, 6]))
            live = [t for t in times.get(key, []) if t > clock["t"] - 1_000]
            want = len(live) + permits <= log_cfg.max_permits
            if want:
                live += [clock["t"]] * permits
            times[key] = live
            check(log.try_acquire(key, permits) == want,
                  f"sliding-window log {key} x{permits} at {clock['t']}")
            n += 1
        # The compat path: the trio over a bare memory storage.
        mem = InMemoryStorage(clock_ms=now)
        compat, crefs = {}, {}
        for name, (algo, kw) in TRIO.items():
            cfg = RateLimitConfig(**kw)
            cls = SlidingWindowRateLimiter if algo == "sw" else \
                TokenBucketRateLimiter
            compat[name] = cls(mem, cfg, MeterRegistry(), clock_ms=now)
            crefs[name] = Reference(algo, cfg, now, lambda t: t)
        check(all(lim._lid is None for lim in compat.values()),
              "compat limiters registered on a memory storage")
        for i in range(2 * LEGACY_CALLS):
            clock["t"] += int(rng.choice([0, 5, 300, 20_000]))
            name = names[i % 3]
            key = f"user{int(rng.integers(0, 24))}"
            permits = (int(rng.integers(1, 60)) if name == "burst"
                       else int(rng.integers(1, 4)))
            check(compat[name].try_acquire(key, permits)
                  == crefs[name].one(key, permits),
                  f"compat {name} {key} x{permits} at {clock['t']}")
            n += 1
        return n

    n_legacy, counts = counted(totals, legacy)
    check_launches(not any(counts.values()),
                   f"legacy contract launched kernels: {counts}")
    print(f"legacy ({card}): {n_legacy} calls (the ten methods through "
          f"the stack, the sliding-window log, the compat trio over "
          f"InMemoryStorage) equal to their models; launches {counts}")
    top.close()

    # (b) The outage drill on the card at this deployment's size; its
    # storage counts the resync's device clears and their launches.
    drill_reg = MeterRegistry()
    degraded_c = drill_reg.counter("ratelimiter.degraded.decisions")
    clears, resets, degraded_seen = [], [], []

    def factory(num_slots, clock_ms):
        st = GpuBatchedStorage(num_slots=num_slots, clock_ms=clock_ms,
                               meter_registry=drill_reg)
        check(st.device.type == "cuda", "drill storage is not on the card")
        host_index_line("outage drill", st)
        clear0, reset0, acquire0 = st._clear_slots, st.reset_key, st.acquire

        def acquire(*args, **kw):
            # The degraded decisions so far, at each decision the card
            # made.
            out = acquire0(*args, **kw)
            degraded_seen.append(degraded_c.count())
            return out

        def clear(algo, slots):
            clears.append(len(slots))
            clear0(algo, slots)

        def reset(algo, lid, key):
            launches0, cleared0 = block_scatter.launches, sum(clears)
            reset0(algo, lid, key)
            torch.cuda.synchronize()
            resets.append((block_scatter.launches - launches0,
                           sum(clears) - cleared0))
        st._clear_slots, st.reset_key, st.acquire = clear, reset, acquire
        return st

    t0 = time.perf_counter()
    report, counts = counted(totals, lambda: outage_drill(
        num_slots=NUM_SLOTS, n_keys=DRILL_KEYS, batch=DRILL_WAVE,
        healthy_waves=DRILL_WAVES, outage_waves=DRILL_WAVES + 2,
        post_waves=DRILL_WAVES, seed=SEED, max_retries=3,
        registry=drill_reg, storage_factory=factory,
        **{k: v for k, v in BREAKER.items() if k != "half_open_probes"}))
    drill_s = time.perf_counter() - t0
    degraded = degraded_c.count()
    check(report["mismatches"] == 0 and report["shorted_backend_calls"] == 0
          and report["over_admissions"] == 0, f"outage drill: {report}")
    # Every degraded decision fell between the card's last decision
    # before the faults and its first after them (the half-open probe):
    # none while no fault was injected.
    check(degraded >= report["degraded_decisions"] > 0
          and degraded_seen[0] == 0 and degraded_seen[-1] == degraded
          and set(degraded_seen) == {0, degraded},
          f"outage drill: {degraded} degraded decisions; counts seen at "
          f"the card's decisions {sorted(set(degraded_seen))}")
    resync_launches = sum(r[0] for r in resets)
    resync_clears = sum(r[1] for r in resets)
    check(len(resets) == report["touched_keys"] and resync_clears > 0,
          f"outage drill: {len(resets)} resets for {report['touched_keys']} "
          f"touched keys, {resync_clears} device clears")
    check_launches(resync_launches == resync_clears,
                   f"outage drill: {resync_launches} row-scatter launches "
                   f"for {resync_clears} resync clears")
    check_launches(counts["solver"] > 0 and counts["solver"]
                   == counts["tb_writeback"] + counts["sw_writeback"],
                   f"outage drill launches {counts}")
    print(f"outage drill ({card}): {NUM_SLOTS} slots, {DRILL_KEYS} keys, "
          f"waves of {DRILL_WAVE}, in {drill_s:.3f} s: {report['decisions']} "
          f"healthy and post-resync decisions equal to the oracle, breaker "
          f"open after {report['requests_to_open']} requests, "
          f"{degraded:.0f} degraded decisions ({report['degraded_decisions']}"
          f" checked waves and the retries of the request that opened it; "
          f"none while no fault was injected), 0 backend calls while open, 0 "
          f"over-admissions; resync reset {report['touched_keys']} keys: "
          f"{resync_clears} device clears, {resync_launches} row-scatter "
          f"launches; timeline {report['flight_timeline']}; launches "
          f"{counts}")

    # (c) The hybrid serving tier on a second storage.
    hy_reg = MeterRegistry()
    clock2 = {"t": 1_761_000_000_000}
    now2 = lambda: clock2["t"]  # noqa: E731
    stamp_state["t"] = 0
    hst = GpuBatchedStorage(num_slots=NUM_SLOTS, clock_ms=now2,
                            meter_registry=hy_reg, serving_cache=True,
                            **HYBRID)
    host_index_line("hybrid tier", hst)
    tier = hst._serving
    hlim, hrefs = {}, {}
    for name, (algo, kw) in TRIO.items():
        cfg = RateLimitConfig(**kw)
        cls = SlidingWindowRateLimiter if algo == "sw" else \
            TokenBucketRateLimiter
        hlim[name] = cls(hst, cfg, hy_reg, clock_ms=now2)
        hrefs[name] = Reference(algo, cfg, now2, stamp)

    def quiesce():
        hst.flush()
        deadline = time.monotonic() + 10.0
        while tier.pending_confirms() and time.monotonic() < deadline:
            time.sleep(0.0005)
        check(tier.pending_confirms() == 0, "hybrid: confirmations did not "
              "drain within 10 s")

    def hybrid():
        bad = 0
        hot = [f"user{k}" for k in range(8)]
        for i in range(HYBRID_SINGLE):
            dt = int(rng.choice([0, 0, 0, 1, 2, 10]))
            if dt:
                # A forwarded mutation must dispatch at the stamp its
                # host serve decided at: drain them before the clock moves.
                quiesce()
                clock2["t"] += dt
            name = names[i % 3]
            key = (hot[int(rng.integers(0, len(hot)))] if i % 2
                   else f"user{zipf_keys(rng, 1)[0]}")
            permits = (int(rng.integers(1, 51)) if name == "burst"
                       else int(rng.integers(1, 3)))
            got = hlim[name].try_acquire(key, permits)
            bad += got != hrefs[name].one(key, permits)
        quiesce()
        return bad

    t0 = time.perf_counter()
    bad, counts = counted(totals, hybrid)
    hybrid_s = time.perf_counter() - t0
    st = tier.stats()
    divergence = hy_reg.counter("ratelimiter.cache.hybrid.divergence").count()
    check(bad == 0, f"hybrid: {bad} decisions differ from the oracle")
    check(divergence == 0 and st["divergence"] == 0,
          f"hybrid: divergence {divergence}")
    check(tier.pending_confirms() == 0, "hybrid: confirmations pending")
    check(st["served"] > 0 and st["adopted"] > 0,
          f"hybrid: the tier served nothing: {st}")
    steps = counts["tb_writeback"] + counts["sw_writeback"]
    check_launches(counts["solver"] > 0 and counts["solver"] == steps,
                   f"hybrid launches {counts}")
    print(f"hybrid tier ({card}): {HYBRID_SINGLE} trio try_acquire in "
          f"{hybrid_s:.3f} s equal to the oracle; tier {st}; host-served "
          f"share of the calls {st['served'] / HYBRID_SINGLE:.4f} "
          f"(rejects {st['rejects_served']}); micro steps: solver "
          f"{counts['solver']}, write-back {steps}; divergence 0, no "
          f"pending confirmation; launches {counts}")

    # (d) Meters.
    for label, reg in (("outage drill", drill_reg), ("hybrid tier", hy_reg)):
        snap = reg.timer("ratelimiter.storage.latency").snapshot()
        check(snap["count"] > 0, f"{label}: no storage latency recorded")
        print(f"{label} ratelimiter.storage.latency ({card}): "
              f"{snap['count']} micro dispatches, p50 "
              f"{snap['p50_us'] / 1e3:.4f} ms, p99 "
              f"{snap['p99_us'] / 1e3:.4f} ms")
    hst.close()
    check_launches(min(totals.values()) > 0,
                   f"composition: a kernel of the path was not launched: "
                   f"{totals}")
    print(f"composition: phase 10 in {time.perf_counter() - t_phase:.3f} "
          f"s; launches {totals}")
    return totals


# -- phase 11: the service as users start it -------------------------------
def http_call(port: int, method: str, path: str, body=None, headers=None,
              timeout: float = 60.0):
    """One request to the app on ``port``: (status, JSON body or text,
    headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        try:
            data = json.loads(data)
        except ValueError:
            data = data.decode()
        return resp.status, data, dict(resp.getheaders())
    finally:
        conn.close()


def serve(ctx):
    """The app on a loopback port: (server, its thread, the port)."""
    import threading

    from ratelimiter_tpu_torch.service.app import make_server

    srv = make_server(ctx, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, srv.server_address[1]


def stop(srv, thread) -> None:
    srv.shutdown()
    thread.join(timeout=30)
    check(not thread.is_alive(), "the HTTP server thread did not stop")
    srv.server_close()
    srv.ctx.close()


def service_props(**overrides):
    """``application.properties`` as the repo ships it, with
    ``overrides``; on a host with several visible cards also
    ``parallel.shard=off``, so phases 11-15 check one card's engine
    (phase 17 (c) boots the shipped ``auto``)."""
    from ratelimiter_tpu_torch.service.props import AppProperties

    values = dict(AppProperties.load("application.properties")._values)
    values.update(overrides)
    if torch.cuda.device_count() > 1:
        values["parallel.shard"] = "off"
    return AppProperties(values)


def cold_boot(card: str) -> None:
    """``python -m ratelimiter_tpu_torch`` as a user starts it, from a copy
    of the package, ``native/`` and ``application.properties`` in a fresh
    directory (so its kernels and C index build from source there): the
    seconds from the spawn until ``/api/health`` answers, the kernels'
    first build included; then one decision and ``/actuator/health`` UP,
    and the process stopped."""
    import shutil
    import signal
    import socket

    root = os.path.join("build", "service_boot")
    shutil.rmtree(root, ignore_errors=True)
    skip = shutil.ignore_patterns("__pycache__", "*.so")
    shutil.copytree("ratelimiter_tpu_torch",
                    os.path.join(root, "ratelimiter_tpu_torch"),
                    ignore=skip)
    shutil.copytree("native", os.path.join(root, "native"), ignore=skip)
    shutil.copy("application.properties", root)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RATELIMITER_SERVER_PORT=str(port))
    if torch.cuda.device_count() > 1:
        env["RATELIMITER_PARALLEL_SHARD"] = "off"
    log_path = os.path.join(root, "service.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ratelimiter_tpu_torch"], cwd=root,
            env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        boot_s = None
        while time.perf_counter() - t0 < 600:
            check(proc.poll() is None, "python -m ratelimiter_tpu_torch "
                  f"exited with {proc.returncode}: "
                  f"{open(log_path).read()[-2000:]}")
            try:
                if http_call(port, "GET", "/api/health", timeout=5)[0] == 200:
                    boot_s = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.2)
        check(boot_s is not None, "the service did not answer in 600 s")
        status, body, headers = http_call(port, "GET", "/api/data",
                                          headers={"X-User-ID": "boot"})
        check(status == 200 and body["remaining"] == 99
              and headers["X-RateLimit-Remaining"] == "99",
              f"cold boot: /api/data answered {status} {body}")
        status, body, _ = http_call(port, "GET", "/actuator/health")
        check(status == 200 and body["status"] == "UP",
              f"cold boot: /actuator/health {status} {body}")
        built = sorted(os.listdir(os.path.join(root, "build", "kernels")))
        check(any(f.startswith("libsolver-") for f in built)
              and any(f.startswith("libblock_scatter-") for f in built),
              f"cold boot: the kernels were not built in the copy: {built}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    out = open(log_path).read().strip().splitlines()
    # Its lines up to the KeyboardInterrupt that SIGINT raises.
    out = out[:next((i for i, line in enumerate(out)
                     if line.startswith("Traceback")), len(out))]
    print(f"service cold boot ({card}): python -m ratelimiter_tpu_torch "
          f"answered /api/health {boot_s:.3f} s after the spawn (torch "
          f"import, C index and kernel builds from source, warmup); built "
          f"{[f for f in built if f.endswith('.so')]}; its output: "
          + " | ".join(out)[:600])


def wait_off_window_edge(window_ms: int = 60_000, margin_ms: int = 2_000):
    """Sleep past the next window boundary of the wall clock when it is
    under ``margin_ms`` away."""
    left = window_ms - (time.time_ns() // 1_000_000) % window_ms
    if left < margin_ms:
        time.sleep(left / 1000.0 + 0.05)


def service_round(port, work, latencies):
    """Each thread's requests in order, all threads at once; returns each
    thread's (request, status) list.  ``latencies`` gathers the client's
    seconds per ``GET /api/data``."""
    import threading

    results = [[] for _ in work]
    errors = []

    def client(i):
        try:
            for user, route, size in work[i]:
                t0 = time.perf_counter()
                if route == "data":
                    got = http_call(port, "GET", "/api/data",
                                    headers={"X-User-ID": user})
                    latencies.append(time.perf_counter() - t0)
                elif route == "login":
                    got = http_call(port, "POST", "/api/login",
                                    body={"username": user})
                else:
                    got = http_call(port, "POST", "/api/batch",
                                    body={"size": size},
                                    headers={"X-User-ID": user})
                results[i].append(((user, route, size), got))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(work))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"service clients failed: {errors[:3]}")
    return results


def phase_service(rng, card: str) -> dict:
    """Phase 11, the service as users start it: (a) ``python -m
    ratelimiter_tpu_torch`` from a fresh copy, and ``build_app`` from
    ``application.properties`` in this process (its warmup launches the
    solver and both write-backs); (b) loopback checks no wall clock can
    upset; (c) 8 client threads over Zipf(1.1) users on a manual clock
    against the oracle; (d) admission control under 32 concurrent
    clients; (e) latencies.  Returns the kernel launch counts."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.service.wiring import build_app
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    print(f"service: {torch.cuda.device_count()} visible CUDA device(s)"
          + ("; parallel.shard=off passed (phase 17 shards)"
             if torch.cuda.device_count() > 1 else ""))
    cold_boot(card)

    # (a) build_app from the repo's properties, in this process.
    t0 = time.perf_counter()
    ctx, counts = counted(totals, lambda: build_app(
        service_props(**{"server.port": "0"})))
    boot_s = time.perf_counter() - t0
    chain, inner = [], ctx.storage
    while inner is not None:
        chain.append(type(inner).__name__)
        inner = getattr(inner, "_inner", None)
    raw = ctx.storage._inner._inner
    check(chain == ["RetryingStorage", "CircuitBreakerStorage",
                    "GpuBatchedStorage"], f"service chain {chain}")
    check(raw.device.type == "cuda", "service storage is not on the card")
    check(ctx.breaker.fallback is not None
          and ctx.breaker.fallback.update_policy in raw._policy_listeners,
          "the degraded limiter is not subscribed to policy updates")
    check_launches(counts["solver"] > 0 and counts["tb_writeback"] > 0
                   and counts["sw_writeback"] > 0,
                   f"boot warmup launches {counts}")
    host_index_line("service", raw)
    print(f"service boot ({card}): build_app(application.properties) in "
          f"{boot_s:.3f} s (warmup {ctx.warmup_s:.3f} s; kernels built in "
          f"phase 1); chain {' -> '.join(chain)}, breaker "
          f"{ctx.breaker.status()}, {raw.engine.num_slots} slots, "
          f"max_pending {raw._batcher.max_pending}, queue deadline "
          f"{raw._batcher.deadline_ms} ms; warmup launches {counts}")

    # (b) Loopback checks no wall clock can upset.
    srv, thread, port = serve(ctx)

    def loopback():
        wait_off_window_edge()
        user = f"login{int(rng.integers(0, 1 << 30))}"
        got = [http_call(port, "POST", "/api/login", body={"username": user})
               for _ in range(12)]
        check([g[0] for g in got] == [200] * 10 + [429] * 2,
              f"12 logins: {[g[0] for g in got]}")
        check([g[1]["remaining_attempts"] for g in got[:10]]
              == list(range(9, -1, -1)), f"logins: {got[:10]}")
        for status, body, headers in got[10:]:
            check(body == {"error": "Rate limit exceeded",
                           "message": "Too many requests. Please try again "
                           "later.", "remaining": 0}
                  and headers["X-RateLimit-Limit"] == "10"
                  and headers["X-RateLimit-Remaining"] == "0",
                  f"login 429: {body} {headers}")
        status, body, _ = http_call(port, "GET", "/api/data",
                                    headers={"X-User-ID": user})
        check(status == 200, f"/api/data {status} {body}")
        resets = []
        for path in (f"/api/admin/reset/{user}", f"/admin/reset/{user}"):
            launches0 = launch_counts()["block_scatter"]
            status, body, _ = http_call(port, "DELETE", path)
            torch.cuda.synchronize()
            resets.append(launch_counts()["block_scatter"] - launches0)
            check(status == 200 and body == {
                "message": f"Rate limits reset for user: {user}"},
                f"{path}: {status} {body}")
            status, body, _ = http_call(port, "POST", "/api/login",
                                        body={"username": user})
            check(status == 200 and body["remaining_attempts"] == 9,
                  f"login after {path}: {status} {body}")
        status, body, _ = http_call(port, "GET", "/actuator/health")
        check(status == 200 and body["status"] == "UP"
              and "pallas" not in body, f"/actuator/health {status} {body}")
        status, text, headers = http_call(port, "GET",
                                          "/actuator/prometheus")
        check(status == 200 and "ratelimiter_storage_latency_seconds_count"
              in text and headers["Content-Type"].startswith("text/plain"),
              "/actuator/prometheus lacks ratelimiter_storage_latency")
        return resets, body

    (resets, health), counts = counted(totals, loopback)
    check_launches(counts["block_scatter"] == sum(resets) and
                   all(r >= 1 for r in resets),
                   f"admin resets launched {resets} row scatters "
                   f"({counts})")
    print(f"service loopback ({card}): 12 logins -> 10 x 200, 2 x 429 with "
          f"the body and X-RateLimit-* headers; both reset paths (row "
          f"scatter launches {resets}); health {health['status']} "
          f"{health['overload']}; /actuator/prometheus carries "
          f"ratelimiter_storage_latency; launches {counts}")
    stop(srv, thread)

    # (c) Many clients, a manual clock, the oracle.
    clock = {"t": 1_761_100_000_000}
    now = lambda: clock["t"]  # noqa: E731
    stamp_state = {"t": 0}

    def stamp(t):
        stamp_state["t"] = max(stamp_state["t"], t)
        return stamp_state["t"]

    reg = MeterRegistry()
    st = GpuBatchedStorage(num_slots=NUM_SLOTS, clock_ms=now,
                           meter_registry=reg)
    check(st.device.type == "cuda", "service storage is not on the card")
    ctx = build_app(service_props(**{"server.port": "0"}), storage=st)
    refs = {name: Reference(algo, RateLimitConfig(**kw), now, stamp)
            for name, (algo, kw) in TRIO.items()}
    route_of = {"data": "api", "login": "auth", "batch": "burst"}
    srv, thread, port = serve(ctx)
    latencies = []

    def clients():
        n = bad = 0
        mix = {}
        for rnd in range(SERVICE_ROUNDS):
            if rnd:
                clock["t"] += int(rng.choice([150, 1_500, 20_000, 61_000]))
                # The api limiter's local cache reads the wall clock: let
                # every entry of the last round expire.
                time.sleep(0.12)
            work = [[] for _ in range(SERVICE_THREADS)]
            for _ in range(SERVICE_ROUND):
                u = int(zipf_keys(rng, 1)[0])
                route = ("data", "login", "batch")[int(rng.integers(0, 3))]
                size = int(rng.integers(1, 31))
                work[u % SERVICE_THREADS].append((f"user{u}", route, size))
            for per_thread in service_round(port, work, latencies):
                for (user, route, size), (status, body, headers) in \
                        per_thread:
                    ref = refs[route_of[route]]
                    want = ref.one(user, size if route == "batch" else 1)
                    bad += (status == 200) != want or status not in (200,
                                                                     429)
                    mix[(route, status)] = mix.get((route, status), 0) + 1
                    n += 1
        return n, bad, mix

    (n, bad, mix), counts = counted(totals, clients)
    check(bad == 0, f"service: {bad} of {n} HTTP decisions differ from the "
          "oracle")
    check(n == SERVICE_ROUND * SERVICE_ROUNDS and all(
        mix.get((r, 429), 0) > 0
                            for r in ("login", "batch")),
          f"service: {n} requests, status mix {mix}")
    check_launches(counts["solver"] > 0 and counts["solver"]
                   == counts["tb_writeback"] + counts["sw_writeback"],
                   f"service launches {counts}")
    # One client alone on the same app: the HTTP round trip without the
    # other threads' contention.
    solo = []
    for i in range(SERVICE_SOLO):
        t0 = time.perf_counter()
        status = http_call(port, "GET", "/api/data",
                           headers={"X-User-ID": f"solo{i}"})[0]
        solo.append(time.perf_counter() - t0)
        check(status == 200, f"single client: /api/data {status}")
    snap = reg.timer("ratelimiter.storage.latency").snapshot()
    lat = np.sort(np.array(latencies)) * 1e3
    solo = np.array(solo) * 1e3
    stages = {st: reg.timer(f"ratelimiter.latency.{st}").snapshot()
              for st in ("queue_wait", "assembly", "device", "resolve",
                         "total")}
    print(f"service clients ({card}): {n} HTTP requests from "
          f"{SERVICE_THREADS} threads over Zipf(1.1) users in "
          f"{SERVICE_ROUNDS} rounds, each user's statuses equal to the "
          f"oracle; status mix {dict(sorted(mix.items()))}; launches "
          f"{counts}")
    print(f"service latency ({card}): client GET /api/data p50 "
          f"{float(np.percentile(lat, 50)):.4f} ms, p99 "
          f"{float(np.percentile(lat, 99)):.4f} ms over {len(lat)} requests "
          f"({SERVICE_THREADS} client threads); ratelimiter.storage.latency "
          f"p50 {snap['p50_us'] / 1e3:.4f} ms, p99 {snap['p99_us'] / 1e3:.4f}"
          f" ms over {snap['count']} micro dispatches; one client alone: "
          f"p50 {float(np.percentile(solo, 50)):.4f} ms, p99 "
          f"{float(np.percentile(solo, 99)):.4f} ms over {len(solo)} "
          f"requests; the batcher's stages (p50 / p99 ms, "
          f"ratelimiter.latency.*): " + ", ".join(
              f"{st} {v['p50_us'] / 1e3:.4f} / {v['p99_us'] / 1e3:.4f}"
              for st, v in stages.items()))
    stop(srv, thread)

    # (d) Admission control: max_pending=64 under 32 concurrent clients,
    # each with 4 requests in flight, while the card's next dispatch is
    # held back.
    import threading

    ctx = build_app(service_props(**{
        "server.port": "0", "ratelimiter.overload.max_pending": "64"}))
    raw = ctx.storage._inner._inner
    hold, entered = threading.Event(), threading.Event()
    staged = raw._batcher._dispatch_staged
    dispatch_sw = staged["sw"]
    held_n = []

    def held(buf, n):
        if not hold.is_set():
            held_n.append(n)
            entered.set()
            hold.wait(timeout=60)
        return dispatch_sw(buf, n)

    staged["sw"] = held
    srv, thread, port = serve(ctx)
    answers = []

    def client(conns):
        for i, conn in enumerate(conns):
            conn.request("GET", "/api/data",
                         headers={"X-User-ID": f"shed{id(conns)}-{i}"})
        for conn in conns:
            resp = conn.getresponse()
            answers.append((resp.status, json.loads(resp.read()),
                            dict(resp.getheaders())))
            conn.close()

    def overload():
        import http.client

        # The stdlib server listens with a backlog of 5, as the
        # reference's does: connect one socket at a time first, so no
        # connection waits out a dropped SYN, then send every request at
        # once.
        conns = []
        for _ in range(32 * 4):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.connect()
            conns.append(conn)
        clients_ = [threading.Thread(target=client,
                                     args=(conns[4 * i:4 * i + 4],))
                    for i in range(32)]
        for c in clients_:
            c.start()
        # Health right after the first shed, then wait until the batcher
        # holds, queues or has shed every request (a client reads its
        # answers in order, so a shed answer can wait behind a held one).
        b = raw._batcher
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not b.shed_total:
            time.sleep(0.002)
        health = http_call(port, "GET", "/actuator/health")
        while time.monotonic() < deadline and not (
                entered.is_set() and sum(held_n) + b.shed_total
                + b.deadline_total + b.queue_depth() == 32 * 4):
            time.sleep(0.005)
        sheds = (raw._batcher.shed_total, raw._batcher.deadline_total)
        hold.set()
        for c in clients_:
            c.join(timeout=120)
        check(not any(c.is_alive() for c in clients_),
              "overload clients hung")
        return health, sheds

    t0 = time.perf_counter()
    (health, (shed_total, expired)), counts = counted(totals, overload)
    overload_s = time.perf_counter() - t0
    shed = [a for a in answers if a[0] == 429]
    reasons = {}
    for _, body, _ in shed:
        reasons[body.get("reason")] = reasons.get(body.get("reason"), 0) + 1
    # Past ``max_pending`` a submit is shed (queue_full); a queued request
    # still waiting at its 1000 ms queue deadline is shed too (deadline).
    check(len(answers) == 128 and shed_total > 0
          and reasons.get("queue_full") == shed_total
          and len(shed) == shed_total + expired
          and all(a[0] == 200 for a in answers if a[0] != 429),
          f"overload: {len(answers)} answers, 429 reasons {reasons}, "
          f"shed_total {shed_total}, deadline expiries {expired}, "
          f"{overload_s:.3f} s")
    check(all(body["error"] == "Overloaded"
              and body["message"] == "Server is shedding load. Please "
              "retry later." and int(headers["Retry-After"]) >= 1
              for _, body, headers in shed), f"overload 429: {shed[:2]}")
    check(health[0] == 200 and health[1]["status"] == "SHEDDING"
          and 0 < health[1]["overload"]["shed_total"] <= shed_total,
          f"overload health: {health[:2]}")
    print(f"service overload ({card}): max_pending 64, 32 clients x 4 in "
          f"flight while one dispatch was held, {overload_s:.3f} s: "
          f"{len(shed)} x 429 Overloaded {reasons} (Retry-After "
          f"{shed[0][2]['Retry-After']} s), {len(answers) - len(shed)} x "
          f"200; health {health[1]['status']} {health[1]['overload']}; "
          f"launches {counts}")
    stop(srv, thread)
    print(f"service: phase 11 in {time.perf_counter() - t_phase:.3f} s; "
          f"launches {totals}")
    return totals


# -- phase 12: token leases ---------------------------------------------------
# The lease tier at application.properties' ratelimiter.lease.* and
# ratelimiter.edge.* (turned on) over 2^20-slot storages.  (a) the engine's
# steps on the card against a CPU engine; (b) lease clients from 8 threads
# beside per-decision traffic, against the oracle; (c) the eviction order on
# a full table; (d) build_app with both tiers; (e) latencies and rates.
LEASE_SLOTS = 1 << 20
LEASE_POLICIES = (  # lids 1-4 of the step check's tables
    ("sw", dict(max_permits=20, window_ms=1_000)),
    TRIO["api"],
    TRIO["burst"],
    ("tb", dict(max_permits=5, window_ms=1_000, refill_rate=2.5)),
)
LEASE_STEP_CALLS = 200
LEASE_STEP_LANES = (1, 32, 8192)
LEASE_KEYS = 4096
LEASE_THREADS = 8
LEASE_ROUNDS = 4
LEASE_BUDGET = 64
LEASE_CONTENDED = 256
LEASE_STEP_MS = 50
EVICT_SLOTS = 1 << 16
EVICT_STREAM = 1 << 17
EVICT_GRANTS = 4096
EDGE_CLIENTS = 8
EDGE_KEYS = 64
EDGE_DECISIONS = 2048
EDGE_ROUNDS = 8
LEASE_TIMED = 200
LOCAL_DECISIONS = 20_000


def lease_props(**overrides):
    """``application.properties`` with both lease tiers turned on."""
    return service_props(**{"ratelimiter.lease.enabled": "true",
                            "ratelimiter.edge.enabled": "true",
                            **overrides})


def lease_lanes(rng, algo: str, n: int, hot: int = 256):
    """(slots, lids) of ``n`` lanes of ``algo``'s limiters: Zipf(1.3) over
    ``hot`` slots (duplicates), a few slots never touched before, a few
    padding lanes (-1)."""
    lids = [lid for lid, (a, _) in enumerate(LEASE_POLICIES, 1) if a == algo]
    slots = ((rng.zipf(1.3, n) - 1) % hot) * 4099 % LEASE_SLOTS
    fresh = rng.random(n) < 0.05
    slots[fresh] = rng.integers(0, LEASE_SLOTS, int(fresh.sum()))
    if n > 1:
        slots[rng.random(n) < 0.03] = -1
    return slots.astype(np.int64), rng.choice(lids, n).astype(np.int64)


def lease_amounts(rng, lids) -> np.ndarray:
    """Requests or credits: zero, negative, around max_permits, small."""
    maxp = np.array([LEASE_POLICIES[l - 1][1]["max_permits"] for l in lids])
    n = len(lids)
    pick = rng.integers(0, 5, n)
    return np.select([pick == 0, pick == 1, pick == 2],
                     [np.zeros(n), -rng.integers(1, 4, n),
                      maxp + rng.integers(-1, 2, n)],
                     rng.integers(1, 12, n)).astype(np.int64)


def lease_engines():
    """A 2^20-slot engine on the card and one on the CPU, over the same
    limiter table."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.engine.engine import DeviceEngine
    from ratelimiter_tpu_torch.engine.state import LimiterTable

    out = []
    for dev in ("cuda", "cpu"):
        table = LimiterTable(device=dev)
        for _, cfg in LEASE_POLICIES:
            table.register(RateLimitConfig(**cfg))
        out.append(DeviceEngine(LEASE_SLOTS, table, device=dev))
    return out


def lease_step_check(rng, card_eng, cpu_eng) -> int:
    """(a) Seeded reserve and credit calls at 1, 32 and 8192 lanes through
    both engines: outputs and the whole packed state must be equal after
    every call.  Returns the calls made."""
    now = 1_760_000_000_000
    ws_seen = {"sw": {}, "tb": {}}
    for i in range(LEASE_STEP_CALLS):
        algo = ("sw", "tb")[i % 2]
        n = LEASE_STEP_LANES[(i // 2) % len(LEASE_STEP_LANES)]
        # Window rollover of the 1 s windows, now and then a step back.
        now += int(rng.choice([0, 3, 250, 999, 1000, 2500, -400]))
        slots, lids = lease_lanes(rng, algo, n)
        amounts = lease_amounts(rng, lids)
        if (i // 6) % 2 == 0:
            got = card_eng.lease_reserve(algo, slots, lids, amounts, now)
            want = cpu_eng.lease_reserve(algo, slots, lids, amounts, now)
            for s, w in zip(slots, got[1]):
                ws_seen[algo].setdefault(int(s), []).append(int(w))
        else:
            seen = ws_seen[algo]
            gws = np.array([(seen.get(int(s), [0])[-1]
                             - (1000 if rng.random() < 0.2 else 0))
                            for s in slots], dtype=np.int64)
            got = (card_eng.lease_credit(algo, slots, lids, amounts, gws,
                                         now),)
            want = (cpu_eng.lease_credit(algo, slots, lids, amounts, gws,
                                         now),)
        for g, w in zip(got, want):
            check(g.shape == (n,) and np.array_equal(g, w),
                  f"lease step call {i} ({algo}, {n} lanes): card != cpu")
        packed = "sw_packed" if algo == "sw" else "tb_packed"
        check(torch.equal(getattr(card_eng, packed).cpu(),
                          getattr(cpu_eng, packed)),
              f"lease step call {i} ({algo}, {n} lanes): state differs")
    return LEASE_STEP_CALLS


def lease_step_breakdown(eng, card: str) -> None:
    """(e) One reserve step: host enqueue, device work behind a backlog,
    top-level torch ops, at the storage's 1-lane call (bucket 32) and at
    8192 lanes."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch.ops import lease as lease_ops

    rng = np.random.default_rng(SEED + 12)
    for algo, lid in (("tb", 3), ("sw", 2)):
        step = lease_ops.RESERVE_STEPS[algo]
        packed = eng.sw_packed if algo == "sw" else eng.tb_packed
        for n, bucket in ((1, 32), (8192, 8192)):
            slots = torch.full((bucket,), -1, dtype=torch.int64, device="cuda")
            slots[:n] = torch.as_tensor(zipf_keys(rng, n), device="cuda")
            lids = torch.full((bucket,), lid, dtype=torch.int64,
                              device="cuda")
            req = torch.full((bucket,), 4, dtype=torch.int64, device="cuda")
            # The engine uploads the stamp with the lanes: a 0-d tensor
            # already on the card.
            now = torch.tensor(1_760_000_100_000, device="cuda")

            def run():
                return step(packed, eng.table.device_arrays, slots, lids,
                            req, now)

            host, work = [], []
            for rep in range(40):
                torch.cuda.synchronize()
                if rep >= 30:
                    torch.cuda._sleep(
                        int(statistics.median(host) * 3e-3 * 2e9))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                run()
                end.record()
                t1 = time.perf_counter()
                end.synchronize()
                if rep >= 30:
                    work.append(start.elapsed_time(end))
                else:
                    host.append((t1 - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                run()
                torch.cuda.synchronize()
            ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                      and not (e.cpu_parent is not None
                               and e.cpu_parent.name.startswith("aten::")))
            print(f"leases ({card}): {algo} reserve step, {n} lanes in a "
                  f"{bucket}-lane bucket: host enqueue "
                  f"{statistics.median(host):.4f} ms (median of 30), device "
                  f"work behind a backlog {statistics.median(work):.4f} ms "
                  f"(median of 10), {ops} top-level torch ops")


class LeaseLog:
    """The storage as the lease tier and the per-decision traffic reach
    it: every call that changes a key's state, logged when it returns.
    Each key is driven by one thread at a time, so the log holds each
    key's calls in the order the card ran them."""

    def __init__(self, storage, clock):
        self._storage, self._clock, self.log = storage, clock, []

    def acquire(self, algo, lid, key, permits, **kw):
        out = self._storage.acquire(algo, lid, key, permits, **kw)
        self.log.append(("acquire", lid, key, permits, self._clock["t"],
                         bool(out["allowed"])))
        return out

    def lease_reserve(self, algo, lid, key, requested):
        out = self._storage.lease_reserve(algo, lid, key, requested)
        self.log.append(("reserve", lid, key, requested, out["stamp"],
                         (out["granted"], out["ws"])))
        return out

    def lease_credit(self, algo, lid, key, credit, grant_ws):
        out = self._storage.lease_credit(algo, lid, key, credit, grant_ws)
        self.log.append(("credit", lid, key, (credit, grant_ws),
                         out["stamp"], out["credited"]))
        return out

    def __getattr__(self, name):
        return getattr(self._storage, name)


def replay(log, oracles) -> int:
    """Every logged call against the oracle, in log order; returns the
    calls checked."""
    for i, (kind, lid, key, arg, now, got) in enumerate(log):
        oracle = oracles[lid]
        if kind == "acquire":
            want = oracle.try_acquire(key, arg, now).allowed
        elif kind == "reserve":
            want = tuple(oracle.reserve(key, arg, now))
        else:
            check(now > 0, f"lease credit {i} found its key evicted")
            want = oracle.credit(key, arg[0], arg[1], now)
        check(got == want, f"lease log entry {i} {kind} {key!r}: got {got}, "
              f"oracle {want}")
    return len(log)


def lease_clients(rng, card: str, totals: dict):
    """(b) 8 threads, each with a LeaseClient per limiter (burst, api) on
    its own leased keys and per-decision traffic on its own other keys; a
    direct_fallback contender on leased burst keys between rounds; the
    clock steps between rounds.  Everything against the oracle.  Returns
    the storage, its manager and the limiters' lids for (e)."""
    import threading

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.leases import DirectTransport, LeaseClient
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service.wiring import _maybe_leases
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    # A window start plus a second: the api window does not roll inside
    # the phase, and no lease outlives its TTL between renewals.
    clock = {"t": 1_760_000_040_000 // 60_000 * 60_000 + 1_000}
    props = lease_props()
    registry = MeterRegistry()
    st = GpuBatchedStorage(num_slots=LEASE_SLOTS, clock_ms=lambda:
                           clock["t"], meter_registry=registry,
                           max_delay_ms=props.get_float(
                               "batcher.max_delay_ms", 0.5))
    check(st.device.type == "cuda", "lease storage is not on the card")
    cfgs = {name: TRIO[name] for name in ("burst", "api")}
    lids = {name: st.register_limiter(algo, RateLimitConfig(**cfg))
            for name, (algo, cfg) in cfgs.items()}
    oracles = {lids[name]: (TokenBucketOracle if algo == "tb"
                            else SlidingWindowOracle)(RateLimitConfig(**cfg))
               for name, (algo, cfg) in cfgs.items()}
    logged = LeaseLog(st, clock)
    mgr = _maybe_leases(logged, None, props, registry)
    check(mgr is not None and mgr.ttl_ms == 2000.0
          and mgr.default_budget == 64, "lease manager from the properties")
    mgr._record = True  # the wiring's manager, with its replay log on
    host_index_line("leases", st)

    per = LEASE_KEYS // LEASE_THREADS
    leased = [[(name, f"lease-{name}-{t}-{i}") for i in range(per)
               for name in ("burst", "api")][:per] for t in range(LEASE_THREADS)]
    plain = [[(name, f"plain-{name}-{t}-{i}") for i in range(per)
              for name in ("burst", "api")][:per]
             for t in range(LEASE_THREADS)]
    clients = [{name: LeaseClient(DirectTransport(mgr), lids[name],
                                  budget=LEASE_BUDGET,
                                  clock_ms=lambda: clock["t"],
                                  direct_fallback=False)
                for name in ("burst", "api")} for _ in range(LEASE_THREADS)]
    contender = LeaseClient(DirectTransport(mgr), lids["burst"],
                            budget=LEASE_BUDGET, clock_ms=lambda: clock["t"],
                            direct_fallback=True)
    contended = [k for t in range(LEASE_THREADS) for name, k in leased[t]
                 if name == "burst"][:LEASE_CONTENDED]
    plans = [[(rng.integers(1, 16, per), rng.integers(0, 3, per),
               rng.integers(1, 6, per)) for _ in range(LEASE_ROUNDS)]
             for _ in range(LEASE_THREADS)]
    errors = []

    def worker(t, r):
        try:
            burns, reps, permits = plans[t][r]
            futs = []
            for (name, key), rep, p in zip(plain[t], reps, permits):
                algo = cfgs[name][0]
                futs += [(lids[name], key, int(p), st.acquire_async(
                    algo, lids[name], key, int(p))) for _ in range(rep)]
            for (name, key), d in zip(leased[t], burns):
                cli = clients[t][name]
                for _ in range(d):
                    cli.try_acquire(key)
            for lid, key, p, fut in futs:
                logged.log.append(("acquire", lid, key, p, clock["t"],
                                   bool(fut.result(timeout=60)["allowed"])))
        except Exception as exc:  # noqa: BLE001 — re-raised in the main thread
            errors.append(exc)

    def drive():
        for r in range(LEASE_ROUNDS):
            threads = [threading.Thread(target=worker, args=(t, r))
                       for t in range(LEASE_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            check(not errors, f"lease worker failed: {errors[:1]}")
            for key in contended:
                contender.try_acquire(key)
            clock["t"] += LEASE_STEP_MS
        for per_thread in clients:
            for cli in per_thread.values():
                cli.release_all()
        contender.release_all()
        st.flush()

    t0 = time.perf_counter()
    _, counts = counted(totals, drive)
    wall = time.perf_counter() - t0
    log = logged.log
    lease_calls = sum(1 for e in log if e[0] != "acquire")
    check_launches(counts["block_scatter"] == lease_calls,
                   f"leases: {counts['block_scatter']} row-scatter launches "
                   f"for {lease_calls} lease steps")
    # The manager's replay log is the logged lease calls that reached the
    # card (reserve: every one; credit: those of unused budget).
    mine = sorted((("reserve", k, a, g[0], g[1], s) if kind == "reserve"
                   else ("credit", k, a[0], a[1], s))
                  for kind, _, k, a, s, g in log if kind != "acquire")
    theirs = sorted((op[0],) + tuple(op[3:]) for op in mgr.ops)
    check(mine == theirs, "manager.ops differ from the lease calls made")
    checked = replay(log, oracles)
    keys = {lid: sorted({e[2] for e in log if e[1] == lid}) for lid in oracles}
    now = clock["t"]
    for name, lid in lids.items():
        got = st.available_many(cfgs[name][0], lid, keys[lid])
        want = [oracles[lid].get_available_permits(k, now) for k in keys[lid]]
        check(list(got) == want, f"leases: available_many of {name} keys")
    status = mgr.status()
    check(status["over_admission"] == 0 and status["outstanding"] == 0,
          f"lease manager status {status}")
    every = [c for per_thread in clients for c in per_thread.values()]
    local = sum(c.local_decisions for c in every)
    frames = sum(c.wire_ops for c in every) + contender.wire_ops
    plain_n = sum(1 for e in log if e[0] == "acquire")
    decisions = local + plain_n
    print(f"leases ({card}): {LEASE_THREADS} threads x {per} leased keys "
          f"(burst and api), {LEASE_ROUNDS} rounds {LEASE_STEP_MS} ms apart; "
          f"{decisions} decisions ({local} local, {plain_n} per decision, "
          f"{contender.wire_ops} contender frames), {frames} lease and "
          f"fallback frames: {frames / max(decisions, 1):.4f} frames per "
          f"decision; {lease_calls} lease steps, {checked} calls equal to "
          f"the oracle, every key's availability equal; status {status}; "
          f"{wall:.3f} s; launches {counts}")
    return st, mgr, lids


def lease_latencies(st, mgr, lids, card: str) -> None:
    """(e) p50 / p99 of the storage's lease calls on one key (the flush
    included) and of the manager's grant and renew."""
    def pct(xs):
        xs = sorted(xs)
        return (f"p50 {xs[len(xs) // 2] * 1e3:.4f} ms, p99 "
                f"{xs[min(len(xs) - 1, len(xs) * 99 // 100)] * 1e3:.4f} ms")

    res, cred = [], []
    for _ in range(LEASE_TIMED):
        t0 = time.perf_counter()
        out = st.lease_reserve("tb", lids["burst"], "timed-key", 1)
        t1 = time.perf_counter()
        st.lease_credit("tb", lids["burst"], "timed-key", 1, out["ws"])
        t2 = time.perf_counter()
        res.append(t1 - t0)
        cred.append(t2 - t1)
    grant, renew = [], []
    for i in range(LEASE_TIMED):
        t0 = time.perf_counter()
        mgr.grant(lids["api"], f"timed-{i}", 8)
        t1 = time.perf_counter()
        mgr.renew(lids["api"], f"timed-{i}", used=1)
        t2 = time.perf_counter()
        mgr.release(lids["api"], f"timed-{i}", used=0)
        grant.append(t1 - t0)
        renew.append(t2 - t1)
    print(f"leases ({card}): storage.lease_reserve {pct(res)}; "
          f"storage.lease_credit {pct(cred)}; manager grant {pct(grant)}; "
          f"manager renew {pct(renew)} ({LEASE_TIMED} calls each)")


def local_rates(card: str) -> None:
    """(e) Local decisions/s of LeaseClients on 1 and 8 threads (distinct
    keys, a limiter whose budgets never run dry)."""
    import threading

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.leases import (
        DirectTransport,
        LeaseClient,
        LeaseManager,
    )
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    st = GpuBatchedStorage(num_slots=LEASE_SLOTS)
    try:
        lid = st.register_limiter("tb", RateLimitConfig(
            max_permits=1 << 30, window_ms=60_000, refill_rate=1e6))
        mgr = LeaseManager(st, max_budget=1024, ttl_ms=60_000.0)
        for n_threads in (1, 8):
            clients = [LeaseClient(DirectTransport(mgr), lid, budget=1024,
                                   direct_fallback=False, telemetry=False)
                       for _ in range(n_threads)]

            def burn(cli, t):
                for _ in range(LOCAL_DECISIONS):
                    cli.try_acquire(f"rate-{n_threads}-{t}")

            threads = [threading.Thread(target=burn, args=(c, t))
                       for t, c in enumerate(clients)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            n = n_threads * LOCAL_DECISIONS
            local = sum(c.local_decisions for c in clients)
            frames = sum(c.wire_ops for c in clients)
            for c in clients:
                c.release_all()
            check(local + frames >= n, "local decisions lost")
            print(f"leases ({card}): {n_threads} thread(s), {n} decisions "
                  f"in {wall:.4f} s: {n / wall:.1f} decisions/s, {local} "
                  f"local, {frames} lease frames")
    finally:
        st.close()


def eviction_at_size(card: str, totals: dict) -> None:
    """(c) A 2^16-slot storage on the partitions its table elects, filled
    by a stream of 2^17 string keys charged 90 of 100 permits each; then
    fresh keys reserve 64 each (each assignment evicts a charged key):
    every grant, and every eighth key's availability right after, equal
    to the oracle's."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import TokenBucketOracle
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_760_000_300_000}
    cfg = dict(max_permits=100, window_ms=60_000, refill_rate=10.0)
    st = GpuBatchedStorage(num_slots=EVICT_SLOTS, clock_ms=lambda:
                           clock["t"])
    try:
        host_index_line("leases eviction", st)
        lid = st.register_limiter("tb", RateLimitConfig(**cfg))
        oracle = TokenBucketOracle(RateLimitConfig(**cfg))

        def drive():
            # Calls of 2^13 keys: no partition's chunk outgrows its slots.
            for lo in range(0, EVICT_STREAM, 1 << 13):
                keys = [f"s{i}" for i in range(lo, lo + (1 << 13))]
                got = st.acquire_stream_strs(
                    "tb", lid, keys, np.full(len(keys), 90, dtype=np.int64))
                check(bool(got.all()),
                      "eviction stream: a fresh key was denied")
            for i in range(EVICT_GRANTS):
                clock["t"] += 1
                key = f"fresh{i}"
                out = st.lease_reserve("tb", lid, key, 64)
                want = oracle.reserve(key, 64, out["stamp"])
                check((out["granted"], out["ws"]) == want,
                      f"eviction: fresh key {i} granted {out}, oracle "
                      f"{want}")
                if i % 8 == 0:
                    avail = int(st.available_many("tb", lid, [key])[0])
                    want = oracle.get_available_permits(key, clock["t"])
                    check(avail == want, f"eviction: fresh key {i} "
                          f"available {avail}, oracle {want}")

        t0 = time.perf_counter()
        _, counts = counted(totals, drive)
        print(f"leases eviction ({card}): {EVICT_SLOTS} slots, a "
              f"{EVICT_STREAM}-key stream, then {EVICT_GRANTS} fresh-key "
              f"grants equal to the oracle (every eighth key's "
              f"availability too) in {time.perf_counter() - t0:.3f} s; "
              f"launches {counts}")
    finally:
        st.close()


def edge_service(card: str, totals: dict) -> None:
    """(d) ``build_app`` with both tiers on: 8 edge-session clients on 64
    shared hot keys of a token bucket roomy enough that no pool runs dry
    (a dry pool renews the whole portfolio on every grant), in rounds;
    ``/actuator/edge`` and ``/actuator/tenants`` over loopback; then every
    decision was allowed, every live pool conserves its permits, and every
    lease is returned.  The aggregator's clock is a manual one that steps
    past the flush interval between rounds: on the wall clock a portfolio
    renewal of 64 pools (a lease credit and reserve each) may outlast the
    shipped 50 ms interval, and then every session call renews the whole
    portfolio again.  One such renewal is timed on the wall clock."""
    import threading

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.leases import LeaseClient
    from ratelimiter_tpu_torch.service.wiring import build_app

    ctx, counts = counted(totals, lambda: build_app(
        lease_props(**{"server.port": "0"})))
    srv, thread, port = serve(ctx)
    try:
        check(ctx.leases is not None and ctx.edge is not None,
              "build_app: the lease and edge tiers are not on")
        raw = ctx.storage._inner._inner
        check(ctx.leases.storage is raw and raw.device.type == "cuda",
              "the lease manager is not over the card's storage")
        lid = raw.register_limiter("tb", RateLimitConfig(
            max_permits=100_000, window_ms=60_000, refill_rate=10_000.0))
        clients = [LeaseClient(ctx.edge.session(), lid,
                               budget=ctx.edge.slice_budget,
                               direct_fallback=False, telemetry=False)
                   for _ in range(EDGE_CLIENTS)]
        allowed = [0] * EDGE_CLIENTS
        clock = {"t": int(time.time() * 1000)}
        ctx.edge._clock_ms = lambda: clock["t"]
        ctx.edge._last_flush = clock["t"]
        per_round = EDGE_DECISIONS // EDGE_ROUNDS

        def burn(t, r):
            rng = np.random.default_rng(SEED + 100 * t + r)
            for k in rng.integers(0, EDGE_KEYS, per_round):
                allowed[t] += bool(clients[t].try_acquire(f"hot{k}"))

        def drive():
            t0 = time.perf_counter()
            for r in range(EDGE_ROUNDS):
                threads = [threading.Thread(target=burn, args=(t, r))
                           for t in range(EDGE_CLIENTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                clock["t"] += int(ctx.edge.flush_ms) + 10
            return time.perf_counter() - t0

        wall, c2 = counted(totals, drive)
        n_pools = len(ctx.edge._pools)
        t0 = time.perf_counter()
        ctx.edge.flush()
        flush_ms = (time.perf_counter() - t0) * 1e3
        status, edge_body, _ = http_call(port, "GET", "/actuator/edge")
        check(status == 200 and edge_body["enabled"] is True
              and edge_body["pools"] >= 1 and edge_body["subleases"] >= 1,
              f"/actuator/edge {status} {edge_body}")
        status, tenants, _ = http_call(port, "GET", "/actuator/tenants")
        check(status == 200 and tenants["leases"]["outstanding"] >= 1,
              f"/actuator/tenants {status} {tenants.get('leases')}")
        for cli in clients:
            cli.release_all()
        # Every live pool conserves its permits (a retired pool's books
        # close with its last burn report, as in the reference).
        pools = list(ctx.edge._pools.values())
        for pool in pools:
            pool.check_conservation()
        dead = len(ctx.edge._dead)
        ctx.edge.release_all()
        after = ctx.leases.status()
        check(after["outstanding"] == 0,
              f"edge: lease status after release {after}")
        check(sum(allowed) == EDGE_CLIENTS * per_round * EDGE_ROUNDS,
              f"edge: {sum(allowed)} of {EDGE_CLIENTS * EDGE_DECISIONS} "
              f"decisions allowed")
        print(f"leases edge ({card}): build_app with ratelimiter.lease.* "
              f"and ratelimiter.edge.* on ({counts['solver']} warmup solver "
              f"launches); {EDGE_CLIENTS} clients x {EDGE_DECISIONS} "
              f"decisions on {EDGE_KEYS} hot keys in {EDGE_ROUNDS} rounds, "
              f"{wall:.3f} s; one portfolio renewal of "
              f"{n_pools} pools {flush_ms:.3f} ms (wall; "
              f"the flush interval {ctx.edge.flush_ms} ms); "
              f"{sum(allowed)} allowed, {len(pools)} live pools conserved "
              f"({dead} retired); "
              f"/actuator/edge {edge_body}; leases after release {after}; "
              f"launches {c2}")
    finally:
        stop(srv, thread)


def phase_leases(rng, card: str) -> dict:
    """Phase 12, token leases: (a) the engine's lease steps on the card
    against a CPU engine; (b) lease clients from 8 threads with
    per-decision traffic and a contender, against the oracle; (c) the
    eviction order at size; (d) ``build_app`` with the lease and edge tiers
    on; (e) latencies, the reserve step's breakdown, local rates.  Returns
    the kernel launch counts of (b)-(d)."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    card_eng, cpu_eng = lease_engines()
    t0 = time.perf_counter()
    calls = lease_step_check(rng, card_eng, cpu_eng)
    print(f"leases ({card}): {calls} reserve and credit calls at "
          f"{LEASE_STEP_LANES} lanes, card engine equal to the CPU engine "
          f"(outputs and the whole {LEASE_SLOTS}-row state after every "
          f"call) in {time.perf_counter() - t0:.3f} s")
    lease_step_breakdown(card_eng, card)
    del card_eng, cpu_eng
    st, mgr, lids = lease_clients(rng, card, totals)
    try:
        lease_latencies(st, mgr, lids, card)
    finally:
        st.close()
    local_rates(card)
    eviction_at_size(card, totals)
    edge_service(card, totals)
    check_launches(totals["block_scatter"] > 0,
                   f"leases: no row-scatter launch in phase 12 {totals}")
    print(f"leases: phase 12 in {time.perf_counter() - t_phase:.3f} s; "
          f"launches over (b)-(d) {totals}")
    return totals


# -- phase 13: durability and fencing ----------------------------------------
DUR_SLOTS = 1 << 20        # application.properties' storage.num_slots
DUR_BURSTS = 24            # micro bursts of BURST lanes before the save
DUR_SINGLE = 600           # single decisions before the save
DUR_FILL = 900_000         # distinct int keys streamed into the table
DUR_NEXT = 1 << 16         # decisions after the restore
DUR_FLAT = 1 << 21         # the rebalance's flat target
DUR_CPU_STREAM = 1 << 16   # (c)'s int stream per call
KEYED_SLOTS = 1 << 14      # (d)'s keyed source; its target is 4x that
KEYED_KEYS = 4096
FENCE_SLOTS = 1 << 16


def dur_dir(name: str) -> str:
    """A fresh directory for one checkpoint under ``build/durability``
    (inside the checkout, emptied at the phase's end)."""
    import shutil

    path = os.path.join("build", "durability", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def dur_storage(num_slots: int, clock, device=None, **kw):
    """A storage of the trio's policies (lids 1-3, ``TRIO``'s order) on
    ``clock``; on the card unless ``device`` says otherwise."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    st = GpuBatchedStorage(num_slots=num_slots, clock_ms=lambda: clock["t"],
                           device=device, **kw)
    for lid, (algo, cfg) in enumerate(TRIO.values(), start=1):
        check(st.register_limiter(algo, RateLimitConfig(**cfg)) == lid,
              "limiter ids")
    return st


def trio_oracles():
    """Per limiter: (algo, lid, policy, oracle)."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )

    out = {}
    for lid, (name, (algo, kw)) in enumerate(TRIO.items(), start=1):
        cfg = RateLimitConfig(**kw)
        out[name] = (algo, lid, cfg, SlidingWindowOracle(cfg) if algo == "sw"
                     else TokenBucketOracle(cfg))
    return out


def micro_plan(rng, bursts: int, singles: int):
    """The trio's micro traffic (Zipf(1.1) keys over 1M as strings, token
    bucket permits in [1, 100], 1-3 elsewhere): (clock step, name, keys,
    permits) per call; a single decision is a call of one key."""
    names = list(TRIO)
    calls = []
    for i in range(bursts + singles):
        name = names[i % 3]
        n = BURST if i < bursts else 1
        keys = [f"user{k}" for k in zipf_keys(rng, n)]
        permits = (rng.integers(1, 101, n) if name == "burst"
                   else rng.integers(1, 4, n))
        calls.append((int(rng.integers(1, 400)), name, keys, permits))
    return calls


def drive_micro(storages, calls, clock, oracles, totals) -> int:
    """Each call on every storage at one clock through the micro route
    (``acquire`` for one key, ``acquire_many`` for a burst): allow bits
    equal across storages and to the oracle.  Launches of the first
    storage's calls go into ``totals``.  Returns the decisions checked."""
    n = 0
    for dt, name, keys, permits in calls:
        clock["t"] += dt
        algo, lid, cfg, orc = oracles[name]
        outs = []
        for i, st in enumerate(storages):
            def call(st=st):
                if len(keys) == 1:
                    return np.array([bool(st.acquire(
                        algo, lid, keys[0], int(permits[0]))["allowed"])])
                return np.asarray(st.acquire_many(
                    algo, [lid] * len(keys), keys,
                    [int(p) for p in permits])["allowed"])
            outs.append(counted(totals, call)[0] if i == 0 else call())
        want = np.array([False if algo == "tb" and p > cfg.max_permits
                         else orc.try_acquire(k, int(p), clock["t"]).allowed
                         for k, p in zip(keys, permits)])
        for st, got in zip(storages, outs):
            bad = int((got != want).sum())
            check(bad == 0, f"durability: {bad} of {len(keys)} {name} "
                  f"decisions of {st.device} differ from the oracle")
        n += len(keys)
    return n


def same_state(a, b, what: str) -> None:
    """Equal packed state (both algorithms) and equal index dumps."""
    from ratelimiter_tpu_torch.engine import checkpoint as ckpt

    for algo in ("sw", "tb"):
        pa = getattr(a.engine, f"{algo}_packed").cpu()
        pb = getattr(b.engine, f"{algo}_packed").cpu()
        check(torch.equal(pa, pb), f"{what}: {algo} state differs")
    da, db = ckpt.dump_slot_indexes(a), ckpt.dump_slot_indexes(b)
    for algo, pa in da["algos"].items():
        pb = db["algos"][algo]
        parts_a = pa.get("per_part", [pa])
        parts_b = pb.get("per_part", [pb])
        check(len(parts_a) == len(parts_b)
              and all(np.array_equal(x[f], y[f]) for x, y in zip(
                  parts_a, parts_b) for f in ("h1", "h2", "slots")),
              f"{what}: {algo} index differs")


def live_rows_equal(a, b, what: str) -> int:
    """``read_rows`` of every live slot of ``a`` equal on ``b``; returns
    the live slots read."""
    from ratelimiter_tpu_torch.engine import checkpoint as ckpt

    n = 0
    for algo, payload in ckpt.dump_slot_indexes(a)["algos"].items():
        slots = np.concatenate([p["slots"] + np.int32(j * (
            a.engine.num_slots // len(payload["per_part"])))
            for j, p in enumerate(payload["per_part"])]) \
            if "per_part" in payload else payload["slots"]
        check(np.array_equal(a.engine.read_rows(algo, slots),
                             b.engine.read_rows(algo, slots)),
              f"{what}: {algo} live rows differ")
        n += len(slots)
    return n


def stream_pair(storages, lid, keys, clock, totals, algo="tb"):
    """One int-key stream call on every storage at one clock: decisions
    equal; launches of the first storage's call go into ``totals``."""
    outs = [counted(totals, lambda st=st: st.acquire_stream_ids(
        algo, lid, keys))[0] if i == 0 else st.acquire_stream_ids(
        algo, lid, keys) for i, st in enumerate(storages)]
    for got in outs[1:]:
        bad = int((got != outs[0]).sum())
        check(bad == 0, f"durability: {bad} of {len(keys)} stream "
              "decisions differ between storages")
    return outs[0]


def capture_scatters(fn):
    """``fn()`` with every row-scatter launch's inputs captured (the state
    cloned before the launch): returns (its result, [(state0, slots,
    mask, rows)])."""
    from ratelimiter_tpu_torch.ops.cuda import block_scatter

    real = block_scatter.scatter_rows
    seen = []

    def spy(state, slots, mask, rows):
        seen.append((state.clone(), slots, mask, rows))
        return real(state, slots, mask, rows)
    block_scatter.scatter_rows = spy
    try:
        return fn(), seen
    finally:
        block_scatter.scatter_rows = real


def durability_checkpoint(rng, card, clock, totals):
    """(a) and (c)'s reverse: micro traffic of the trio and a fill stream,
    a save, restores on the card and on the CPU, and the next decisions
    on all three.  Returns (the saved storage, the card restore)."""
    oracles = trio_oracles()
    src = dur_storage(DUR_SLOTS, clock)
    check(src.device.type == "cuda", "storage is not on the card")
    host_index_line("durability", src)
    hp = src._host_parallel
    n = drive_micro([src], micro_plan(rng, DUR_BURSTS, DUR_SINGLE), clock,
                    oracles, totals)
    fill = rng.permutation(1 << 24)[:DUR_FILL].astype(np.int64)
    clock["t"] += 17
    got = stream_pair([src], 3, fill, clock, totals)
    check(bool(got.all()), "durability: a fill key was denied")
    path = dur_dir("a")
    t0 = time.perf_counter()
    src.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    size = dir_bytes(path)
    dst = dur_storage(DUR_SLOTS, clock, host_parallel=hp)
    held = (dst.engine.sw_packed, dst.engine.tb_packed)
    t0 = time.perf_counter()
    dst.restore_checkpoint(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check((dst.engine.sw_packed, dst.engine.tb_packed) == held,
          "durability: the restore rebound the state tensors")
    cpu = dur_storage(DUR_SLOTS, clock, device="cpu", host_parallel=hp)
    t0 = time.perf_counter()
    cpu.restore_checkpoint(path)
    cpu_restore_s = time.perf_counter() - t0
    same_state(src, dst, "durability restore")
    same_state(src, cpu, "durability restore on the CPU")
    live = live_rows_equal(src, dst, "durability restore")
    keys = len(src._index["sw"]) + len(src._index["tb"])
    print(f"durability ({card}): {n} micro decisions and {DUR_FILL} fill "
          f"keys on {DUR_SLOTS} slots ({hp} partitions, {keys} live keys); "
          f"save_checkpoint {save_s:.3f} s, {size} bytes on disk; "
          f"restore_checkpoint {restore_s:.3f} s on the card, "
          f"{cpu_restore_s:.3f} s on the CPU; {live} live rows equal")
    t0 = time.perf_counter()
    nxt = micro_plan(rng, DUR_NEXT // BURST, 0)
    n = drive_micro([src, dst, cpu], nxt, clock, oracles, totals)
    same_state(src, dst, "durability: after the next decisions")
    same_state(src, cpu, "durability: the CPU after the next decisions")
    live = live_rows_equal(src, dst, "durability: after the next decisions")
    print(f"durability: {n} next decisions equal on the saved storage, its "
          f"card restore and its CPU restore, and to the oracle; {live} "
          f"live rows equal ({time.perf_counter() - t0:.3f} s)")
    cpu.close()
    return src, dst


def durability_cpu_to_card(rng, card, clock, totals, hp):
    """(c): a checkpoint written on the CPU restores on the card; the
    decisions that follow are equal."""
    cpu = dur_storage(DUR_SLOTS, clock, device="cpu", host_parallel=hp)
    oracles = trio_oracles()
    keys = zipf_keys(rng, DUR_CPU_STREAM).astype(np.int64)
    clock["t"] += 5
    cpu.acquire_stream_ids("tb", 3, keys)
    drive_micro([cpu], micro_plan(rng, 3, 0), clock, oracles, totals)
    path = dur_dir("c")
    cpu.save_checkpoint(path)
    dev = dur_storage(DUR_SLOTS, clock, host_parallel=hp)
    t0 = time.perf_counter()
    dev.restore_checkpoint(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_state(cpu, dev, "CPU checkpoint on the card")
    clock["t"] += 900
    stream_pair([dev, cpu], 3, zipf_keys(rng, DUR_CPU_STREAM).astype(
        np.int64), clock, totals)
    drive_micro([dev, cpu], micro_plan(rng, 3, 0), clock, oracles, totals)
    same_state(cpu, dev, "CPU checkpoint on the card, after decisions")
    print(f"durability: a checkpoint of a device='cpu' storage restored on "
          f"the card in {restore_s:.3f} s; the next {DUR_CPU_STREAM} stream "
          f"and {3 * BURST} micro decisions and the state equal")
    for st in (cpu, dev):
        st.close()


def durability_stream(rng, card, headline, totals):
    """(b): a headline pass, a save, a restore, then one relay pass on
    both storages: decisions and state equal."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_761_100_000_000}
    made = [GpuBatchedStorage(num_slots=STREAM_SLOTS,
                              clock_ms=lambda: clock["t"])]
    src = made[0]
    lid = src.register_limiter("tb", RateLimitConfig(**HEADLINE_TB))
    try:
        counted(totals, lambda: src.acquire_stream_ids("tb", lid, headline))
        path = dur_dir("b")
        t0 = time.perf_counter()
        src.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        made.append(GpuBatchedStorage(num_slots=STREAM_SLOTS,
                                      clock_ms=lambda: clock["t"],
                                      host_parallel=src._host_parallel))
        dst = made[1]
        check(dst.register_limiter("tb", RateLimitConfig(**HEADLINE_TB))
              == lid, "limiter ids")
        t0 = time.perf_counter()
        dst.restore_checkpoint(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        clock["t"] += 700
        t0 = time.perf_counter()
        got = stream_pair([dst, src], lid, headline, clock, totals)
        wall = time.perf_counter() - t0
        same_state(src, dst, "headline restore")
        print(f"durability ({card}): headline pass on {STREAM_SLOTS} slots "
              f"({len(src._index['tb'])} keys) saved in {save_s:.3f} s "
              f"({dir_bytes(path)} bytes), restored in {restore_s:.3f} s; "
              f"one {len(headline)}-request relay pass on the restore and "
              f"the original ({wall:.3f} s for both, {int(got.sum())} "
              f"allowed): decisions and state equal")
    finally:
        for st in made:
            st.close()


def durability_rebalance(rng, card, clock, src, totals, kernels, floor_ms):
    """(d): the partitioned storage's export imported into a flat 2^21-slot
    storage (its row-scatter launches held against the plain version and
    timed), the next decisions equal; a keyed export into a storage of
    another size."""
    from ratelimiter_tpu_torch.ops.cuda import block_scatter

    t0 = time.perf_counter()
    dump = src.export_keys()
    export_s = time.perf_counter() - t0
    check({p["kind"] for p in dump["algos"].values()} == {"fp"},
          "durability: the partitioned export is not a fingerprint one")
    flat = dur_storage(DUR_FLAT, clock, host_parallel=0)
    t0 = time.perf_counter()
    (_, seen), got = counted(totals, lambda: capture_scatters(
        lambda: flat.import_keys(dump)))
    import_s = time.perf_counter() - t0
    check(got["block_scatter"] == len(seen) == len(dump["algos"]),
          f"durability: the import launched {got} for "
          f"{len(dump['algos'])} algorithms")
    results = {"block_scatter": {"err": 0}}
    for state0, slots, mask, rows in seen:
        label = (f"import     S={state0.shape[0]} L={state0.shape[1]} "
                 f"B={len(slots)}")
        if len(slots) == max(len(s[1]) for s in seen):
            time_scatter(results, label, state0, slots, mask, rows,
                         floor_ms, reps=20, plain_reps=5, plain_rounds=3)
        else:
            hold_scatter(results, label, state0, slots, mask, rows)
    kernels["block_scatter"]["err"] = max(kernels["block_scatter"]["err"],
                                          results["block_scatter"]["err"])
    rows = sum(len(p["h1"]) for p in dump["algos"].values())
    clock["t"] += 300
    stream_pair([flat, src], 3, zipf_keys(rng, DUR_NEXT).astype(np.int64),
                clock, totals)
    print(f"durability ({card}): export_keys {export_s:.3f} s ({rows} "
          f"rows), import_keys into {DUR_FLAT} flat slots {import_s:.3f} s "
          f"({len(seen)} row-scatter launches, bit-equal to the plain "
          f"version); the next {DUR_NEXT} stream decisions equal")
    flat.close()

    keyed = dur_storage(KEYED_SLOTS, clock, checkpointable=True)
    check(keyed._host_parallel == 0, "checkpointable elected partitions")
    other = None
    try:
        keys = [f"k{k}" for k in rng.integers(0, 3 * KEYED_KEYS, KEYED_KEYS)]
        for name in TRIO:
            algo, lid = TRIO[name][0], list(TRIO).index(name) + 1
            keyed.acquire_many(algo, [lid] * len(keys), keys,
                               [int(p) for p in rng.integers(1, 4, len(keys))])
        dump = keyed.export_keys()
        check(all(isinstance(e, list) for e in dump["algos"].values()),
              "durability: the keyed export carries no keys")
        other = dur_storage(4 * KEYED_SLOTS, clock)
        counted(totals, lambda: other.import_keys(dump))
        clock["t"] += 100
        nxt = keys[:1024]
        for name in TRIO:
            algo, lid = TRIO[name][0], list(TRIO).index(name) + 1
            a = keyed.acquire_many(algo, [lid] * len(nxt), nxt,
                                   [2] * len(nxt))["allowed"]
            b = other.acquire_many(algo, [lid] * len(nxt), nxt,
                                   [2] * len(nxt))["allowed"]
            check(np.array_equal(a, b), f"durability: keyed import {name} "
                  "decisions differ")
        n = sum(len(e) for e in dump["algos"].values())
        print(f"durability: keyed export of {n} keys from a "
              f"checkpointable {KEYED_SLOTS}-slot storage imported into "
              f"{4 * KEYED_SLOTS} slots ({other._host_parallel} "
              f"partitions); the next decisions equal")
    finally:
        keyed.close()
        if other is not None:
            other.close()


def durability_fences(card, totals):
    """(e): fences, the serving lease, the lease manager's revocation and
    the promotion window on the card."""
    import threading

    from ratelimiter_tpu_torch.engine import checkpoint as ckpt
    from ratelimiter_tpu_torch.leases import LeaseManager
    from ratelimiter_tpu_torch.storage.errors import (
        FencedError,
        PromotionInProgressError,
    )

    clock = {"t": 1_761_200_000_000}
    st = dur_storage(FENCE_SLOTS, clock)
    surfaces = [
        lambda: st.acquire("sw", 2, "a", 1),
        lambda: st.acquire_many("tb", [3], ["a"], [1]),
        lambda: st.acquire_many_ids("tb", 3, np.array([1]), np.array([1])),
        lambda: st.acquire_stream_ids("tb", 3, np.array([1, 2, 1])),
        lambda: st.acquire_stream_ids("sw", 2, np.array([1]), np.array([2])),
        lambda: st.acquire_stream_strs("sw", 2, ["a", "b"]),
        lambda: st.lease_reserve("tb", 3, "a", 4),
        lambda: st.lease_credit("tb", 3, "a", 2, 0),
    ]

    def refused(error, what):
        for i, call in enumerate(surfaces):
            try:
                call()
            except error:
                continue
            check(False, f"fences: surface {i} decided {what}")

    try:
        for call in surfaces:
            counted(totals, call)
        st.fence(3)
        refused(FencedError, "while fenced")
        check(st.fence_rejected == len(surfaces), "fences: rejected count")
        for bad in (lambda: st.fence(3), lambda: st.lift_fence(2)):
            try:
                bad()
                check(False, "fences: a stale fence or lift was taken")
            except ValueError:
                pass
        st.lift_fence(3)
        for call in surfaces:
            counted(totals, call)
        st.grant_serving_lease(4, 500.0)
        clock["t"] += 400
        st.acquire("tb", 3, "a", 1)
        clock["t"] += 200
        refused(FencedError, "past the serving lease")
        check(st.serving_lease_info()["self_fenced"], "fences: no self-fence")
        st.lift_fence(4)
        mgr = LeaseManager(st, default_budget=16, ttl_ms=10_000.0,
                           clock_ms=lambda: clock["t"])
        first = mgr.grant(3, "k", 16)
        st.fence(5)
        st.lift_fence(5)
        clock["t"] += 10
        renewed = mgr.renew(3, "k", used=4)
        again = mgr.grant(3, "k", 16)
        check(first.granted == 16 and first.epoch == 4 and renewed is None
              and again.granted == 16 and again.epoch == 5,
              f"fences: lease manager {first} {renewed} {again}")
        # The promotion window: a gated index rebuild on a thread.
        gate, go = threading.Event(), threading.Event()
        real = ckpt.restore_slot_indexes

        def slow(storage, dump):
            gate.set()
            go.wait(30)
            return real(storage, dump)
        ckpt.restore_slot_indexes = slow
        try:
            dump = ckpt.dump_slot_indexes(st)
            t = threading.Thread(target=st.promote_from_replica,
                                 args=(dump,))
            t.start()
            check(gate.wait(30), "fences: the promotion did not start")
            refused(PromotionInProgressError, "during a promotion")
            go.set()
            t.join(30)
            check(not t.is_alive(), "fences: the promotion hung")
        finally:
            ckpt.restore_slot_indexes = real
        for call in surfaces:
            counted(totals, call)
        print(f"fences ({card}): {len(surfaces)} decision surfaces refused "
              f"while fenced, past an expired serving lease and during a "
              f"promotion; stale fence and lift refused; the lease manager "
              f"revoked on the epoch advance (epochs {first.epoch} -> "
              f"{again.epoch})")
    finally:
        st.close()


def durability_corruption(card, totals):
    """(f): a bit flip, a truncated ``state.npz`` and an edited manifest
    are each refused with ``CheckpointCorruptError``."""
    import shutil

    from ratelimiter_tpu_torch.engine.checkpoint import CheckpointCorruptError

    clock = {"t": 1_761_300_000_000}
    st = dur_storage(FENCE_SLOTS, clock)
    try:
        st.acquire_stream_ids("tb", 3, np.arange(4096, dtype=np.int64))
        base = dur_dir("f")
        st.save_checkpoint(base)

        def flip(path):
            npz = os.path.join(path, "state.npz")
            blob = bytearray(open(npz, "rb").read())
            blob[len(blob) // 2] ^= 0xFF
            open(npz, "wb").write(bytes(blob))

        def truncate(path):
            npz = os.path.join(path, "state.npz")
            blob = open(npz, "rb").read()
            open(npz, "wb").write(blob[: len(blob) // 3])

        def edit(path):
            idx = os.path.join(path, "index.json")
            meta = json.load(open(idx))
            meta["num_slots"] = 999
            json.dump(meta, open(idx, "w"))

        before = st.engine.tb_packed.clone()
        for name, damage in (("bit flip", flip), ("truncated", truncate),
                             ("edited manifest", edit)):
            path = dur_dir(f"f-{name.replace(' ', '-')}")
            shutil.copytree(base, path)
            damage(path)
            try:
                st.restore_checkpoint(path)
                check(False, f"corruption: a {name} checkpoint restored")
            except CheckpointCorruptError:
                pass
        check(torch.equal(before, st.engine.tb_packed),
              "corruption: a refused restore changed the state")
        print(f"corruption ({card}): bit flip, truncated state.npz and "
              f"edited manifest each refused with CheckpointCorruptError, "
              f"the state untouched")
    finally:
        st.close()


def phase_durability(rng, card: str, headline: np.ndarray, kernels: dict,
                     floor_ms: float) -> dict:
    """Phase 13, durability and fencing: (a) checkpoint and restore on the
    card, (b) a relay pass on a restored headline state, (c) CPU to card
    and back, (d) rebalance, (e) fences, (f) corruption.  Returns the
    kernel launch counts."""
    import shutil

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    clock = {"t": 1_761_000_000_000}
    src = dst = None
    try:
        src, dst = durability_checkpoint(rng, card, clock, totals)
        durability_cpu_to_card(rng, card, clock, totals, src._host_parallel)
        durability_rebalance(rng, card, clock, src, totals, kernels,
                             floor_ms)
        durability_stream(rng, card, headline, totals)
        durability_fences(card, totals)
        durability_corruption(card, totals)
    finally:
        for st in (src, dst):
            if st is not None:
                st.close()
        shutil.rmtree(os.path.join("build", "durability"),
                      ignore_errors=True)
    check_launches(min(totals.values()) > 0,
                   f"durability: a kernel was not launched in phase 13 "
                   f"{totals}")
    print(f"durability: phase 13 in {time.perf_counter() - t_phase:.3f} s; "
          f"launches {totals}")
    return totals


# -- phase 14: flat replication and the control plane -----------------------
REPL_SLOTS = 1 << 20        # application.properties' storage.num_slots
REPL_BURSTS = 6             # micro bursts of BURST lanes a micro wave
REPL_SINGLE = 120           # single decisions a micro wave
REPL_STREAM = 1 << 22       # headline Zipf requests in the relay pass
REPL_PERMITS = 1 << 19      # the weighted pass (api sw, keys over 2^18)
REPL_PERMIT_KEYS = 1 << 18
REPL_LEASE_KEYS = 128       # keys a lease round reserves and credits
REPL_RESETS = 3             # hot keys reset a limiter
REPL_PAIRS = 12             # journal attached / detached step pairs
REPL_HEARTBEATS = 20
SERVICE_USERS = 48          # (f)'s users


def bootstrap_rows(num_slots: int, lanes: int) -> list:
    """Rows of each sub-frame a full cut of one algorithm ships at the
    wire's 16 MB budget (a row is 4 * lanes bytes plus its 8-byte
    slot)."""
    per = (16 << 20) // (4 * lanes + 8)
    return [min(per, num_slots - i) for i in range(0, num_slots, per)]


def bare_storage(num_slots: int, clock, host_parallel: int):
    """A storage with no limiter registered (a standby registers them
    from the frames) on the card."""
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    return GpuBatchedStorage(num_slots=num_slots,
                             clock_ms=lambda: clock["t"],
                             host_parallel=host_parallel)


def synced(primary, standby, what: str) -> None:
    """``engine_state_fingerprint`` of both storages equal byte for
    byte."""
    from ratelimiter_tpu_torch.replication import engine_state_fingerprint

    fp_p = engine_state_fingerprint(primary.engine)
    fp_s = engine_state_fingerprint(standby.engine)
    for algo in ("sw", "tb"):
        check(fp_p[algo].tobytes() == fp_s[algo].tobytes(),
              f"replication {what}: the standby's {algo} state differs")


def repl_resets(storages, clock, oracles, names=("api", "auth", "burst")):
    """Admin resets of each limiter's hottest micro keys on every storage,
    mirrored in the oracles."""
    for name in names:
        algo, lid, _, orc = oracles[name]
        for k in range(REPL_RESETS):
            key = f"user{k}"
            for st in storages:
                st.reset_key(algo, lid, key)
            orc.reset(key, clock["t"])


def repl_lease_round(storages, rng):
    """One lease reserve / credit round of REPL_LEASE_KEYS keys of the
    burst token bucket (lid 3) and the auth window (lid 2) on every
    storage; grants equal across storages."""
    for algo, lid in (("tb", 3), ("sw", 2)):
        want = rng.integers(1, 9, REPL_LEASE_KEYS)
        for k in range(REPL_LEASE_KEYS):
            outs = [st.lease_reserve(algo, lid, f"lease{k}", int(want[k]))
                    for st in storages]
            check(len({o["granted"] for o in outs}) == 1,
                  "replication: lease grants differ between storages")
            for st, o in zip(storages, outs):
                st.lease_credit(algo, lid, f"lease{k}", o["granted"] // 2,
                                o["ws"])


def repl_waves(rng, headline):
    """Phase 14's stream waves after the micro one: (label, fn(storage))."""
    stream = headline[:REPL_STREAM]
    pkeys = rng.integers(0, REPL_PERMIT_KEYS, REPL_PERMITS)
    permits = rng.integers(1, 101, REPL_PERMITS)
    return [
        ("relay", lambda st: st.acquire_stream_ids("tb", 3, stream), "relay"),
        ("weighted", lambda st: st.acquire_stream_ids(
            "sw", 1, pkeys, permits), "weighted"),
    ]


class _TimedJournal:
    """A journal with its drain timed into ``spent``."""

    def __init__(self, inner, timed):
        self.inner = inner
        self.drain = timed("drain", inner.drain)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def timed_cut(log):
    """``log.cut()`` with the wall time of its steps: the journal's drain,
    the row reads and the index dump.  Returns (frames, the cut's
    seconds, {step: seconds})."""
    from ratelimiter_tpu_torch.engine import checkpoint as ckpt

    spent = {"drain": 0.0, "read_rows": 0.0, "index_dump": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    journal, real_dump, eng = log.journal, ckpt.dump_slot_indexes, log.engine
    log.journal = _TimedJournal(journal, timed)
    eng.read_rows = timed("read_rows", eng.read_rows)
    ckpt.dump_slot_indexes = timed("index_dump", real_dump)
    try:
        t0 = time.perf_counter()
        frames = log.cut()
        return frames, time.perf_counter() - t0, spent
    finally:
        log.journal = journal
        del eng.read_rows
        ckpt.dump_slot_indexes = real_dump


def replication_failover(rng, card, headline, clock, totals, kernels,
                         floor_ms):
    """(a)-(c): a primary and a standby at full width on the card, the
    device journal, every wave cut and applied, the bootstrap broken
    down, then a loss wave, the kill, the promotion and the
    post-failover waves against the oracle rolled back."""
    import copy

    from ratelimiter_tpu_torch.replication import (
        ReplicationLog,
        StandbyReceiver,
        decode_frame,
        encode_frame,
    )

    oracles = trio_oracles()
    primary = dur_storage(REPL_SLOTS, clock)
    check(primary.device.type == "cuda", "storage is not on the card")
    hp = primary._host_parallel
    standby = bare_storage(REPL_SLOTS, clock, hp)
    host_index_line("replication", primary)
    log = ReplicationLog(primary)
    check(log.journal_kind == "device",
          f"auto journal on the card is {log.journal_kind}")
    receiver = StandbyReceiver(standby)
    try:
        n_dec = drive_micro([primary], micro_plan(rng, REPL_BURSTS,
                                                  REPL_SINGLE),
                            clock, oracles, totals)
        # (b) The bootstrap: every step of the first cut timed.
        frames, cut_s, spent = timed_cut(log)
        t0 = time.perf_counter()
        datas = [encode_frame(f) for f in frames]
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decs = [decode_frame(d) for d in datas]
        dec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, got = counted(totals, lambda: [receiver.apply(f) for f in decs])
        apply_s = time.perf_counter() - t0
        subs = {a: [len(f["algos"][a]["slots"]) for f in frames
                    if a in f["algos"]] for a in ("tb", "sw")}
        check(frames[0]["full"]
              and subs["tb"] == bootstrap_rows(REPL_SLOTS, 4)
              and subs["sw"] == bootstrap_rows(REPL_SLOTS, 6),
              f"bootstrap sub-frames {subs}")
        check_launches(got["block_scatter"] == len(frames),
                       f"bootstrap apply launched {got}")
        synced(primary, standby, "bootstrap")
        print(f"replication bootstrap ({card}): {len(frames)} sub-frames "
              f"(tb {subs['tb']}, sw {subs['sw']} rows), "
              f"{sum(map(len, datas))} bytes ({[len(d) for d in datas]}); "
              f"cut {cut_s:.3f} s (drain {spent['drain']:.3f}, row read "
              f"{spent['read_rows']:.3f}, index dump "
              f"{spent['index_dump']:.3f}), encode {enc_s:.3f} s, decode "
              f"{dec_s:.3f} s, apply {apply_s:.3f} s; {n_dec} micro "
              f"decisions before it; state equal")
        # Each apply's row-scatter launch against the plain version, the
        # largest of each algorithm timed.
        _, seen = capture_scatters(
            lambda: [receiver.apply(f) for f in decs])
        results = {"block_scatter": {"err": 0}}
        timed_l = set()
        for state0, slots, mask, rows in seen:
            label = (f"apply      S={state0.shape[0]} L={state0.shape[1]} "
                     f"B={len(slots)}")
            if state0.shape[1] not in timed_l:
                timed_l.add(state0.shape[1])
                time_scatter(results, label, state0, slots, mask, rows,
                             floor_ms, reps=20, plain_reps=3,
                             plain_rounds=3)
            else:
                hold_scatter(results, label, state0, slots, mask, rows)
        del seen
        kernels["block_scatter"]["err"] = max(
            kernels["block_scatter"]["err"], results["block_scatter"]["err"])
        check_launches(len(timed_l) == 2, "apply scatters of both algorithms")

        # (c) Steady delta cuts, one after each wave.
        def cut_apply(label):
            frames, cut_s, spent = timed_cut(log)
            rows = sum(len(p["slots"]) for f in frames
                       for p in f["algos"].values())
            _, got = counted(totals, lambda: [
                receiver.apply_bytes(encode_frame(f)) for f in frames])
            synced(primary, standby, label)
            print(f"replication cut after {label}: epoch {log.epoch}, "
                  f"{rows} dirty rows in {len(frames)} frames, cut "
                  f"{cut_s * 1e3:.3f} ms (drain "
                  f"{spent['drain'] * 1e3:.3f}, row read "
                  f"{spent['read_rows'] * 1e3:.3f}, index dump "
                  f"{spent['index_dump'] * 1e3:.3f}), last_cut_lag_ms "
                  f"{log.last_cut_lag_ms:.3f}, apply launches "
                  f"{got['block_scatter']}; state equal")

        for label, fn, mode in repl_waves(rng, headline):
            clock["t"] += 1_700
            counted(totals, lambda: fn(primary))
            modes = {c["mode"] for c in primary.last_stream_chunks}
            check(mode in modes, f"replication {label} wave took {modes}")
            cut_apply(f"the {label} wave ({sorted(modes)})")
        clock["t"] += 900
        counted(totals, lambda: repl_lease_round([primary], rng))
        cut_apply("a lease round")
        counted(totals, lambda: repl_resets([primary], clock, oracles))
        cut_apply("admin resets")
        clock["t"] += 1_300
        n_dec += drive_micro([primary], micro_plan(rng, REPL_BURSTS,
                                                   REPL_SINGLE),
                             clock, oracles, totals)
        cut_apply("a micro wave")
        promoted_epoch = log.epoch
        rolled_back = copy.deepcopy(oracles)
        # The loss wave: decided, never cut; it dies with the primary.
        clock["t"] += 400
        lost = drive_micro([primary], micro_plan(rng, 2, 40), clock,
                           oracles, totals)
    finally:
        log.detach()
        primary.close()                     # the kill
    t0 = time.perf_counter()
    check(receiver.promote() is standby, "promote returned another storage")
    promote_s = time.perf_counter() - t0
    check(receiver.last_epoch == promoted_epoch and receiver.consistent,
          "promoted epoch")
    try:
        clock["t"] += 2_100
        post = drive_micro([standby], micro_plan(rng, REPL_BURSTS,
                                                 REPL_SINGLE),
                           clock, rolled_back, totals)
        clock["t"] += 61_000
        post += drive_micro([standby], micro_plan(rng, 2, 40), clock,
                            rolled_back, totals)
    finally:
        standby.close()
    print(f"replication failover ({card}): {n_dec} micro decisions and "
          f"the stream waves replicated in {promoted_epoch} epochs, "
          f"{lost} loss-wave decisions, promotion {promote_s:.3f} s, "
          f"{post} post-failover decisions equal to the oracle rolled "
          f"back to epoch {promoted_epoch}")
    return hp


def replication_journals(rng, card, headline, clock, totals, hp):
    """(d)-(e) and (c)'s journal cost: the same traffic on two storages,
    one journaled on the card and one on the host, drained after every
    call; a TCP bootstrap of the first into a third; then the micro
    step's cost with the device journal attached and detached."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch.engine.engine import MICRO_STAGE_ROWS
    from ratelimiter_tpu_torch.replication import (
        ReplicationLog,
        ReplicationServer,
        Replicator,
        SocketSink,
        StandbyReceiver,
    )

    oracles = trio_oracles()
    dev_st = dur_storage(REPL_SLOTS, clock, host_parallel=hp)
    host_st = dur_storage(REPL_SLOTS, clock, host_parallel=hp)
    made = [dev_st, host_st]
    logs = [ReplicationLog(dev_st, journal_kind="device"),
            ReplicationLog(host_st, journal_kind="host")]
    try:
        def same_dirty(label):
            outs = []
            for st, lg in zip(made, logs):
                st.flush()
                ids, _, _ = lg.journal.drain()
                outs.append({a: v.tolist() for a, v in ids.items()})
            check(outs[0] == outs[1], f"journals: {label}: the device "
                  "journal's dirty set differs from the host journal's")
            return sum(len(v) for v in outs[0].values())

        n = [drive_micro(made, micro_plan(rng, 2, 40), clock, oracles,
                         totals)]
        sizes = [same_dirty("micro")]
        for label, fn, _ in repl_waves(rng, headline):
            clock["t"] += 1_100
            outs = [fn(st) for st in made]
            check(np.array_equal(outs[0], outs[1]),
                  f"journals: {label} decisions differ")
            sizes.append(same_dirty(label))
        repl_lease_round(made, rng)
        sizes.append(same_dirty("lease round"))
        repl_resets(made, clock, oracles)
        sizes.append(same_dirty("resets"))
        print(f"journals ({card}): device and host journals drained equal "
              f"dirty sets after each call ({sizes} slots; micro, relay, "
              f"weighted, lease round, resets)")

        # (e) TCP on loopback: the device-journaled storage bootstraps a
        # third storage through SocketSink -> ReplicationServer.
        logs[1].detach()
        tcp_st = bare_storage(REPL_SLOTS, clock, hp)
        made.append(tcp_st)
        receiver = StandbyReceiver(tcp_st)
        server = ReplicationServer(receiver, host="127.0.0.1").start()
        sink = SocketSink("127.0.0.1", server.port, ack_timeout=30.0)
        repl = Replicator(logs[0], sink)
        try:
            logs[0].request_full()
            t0 = time.perf_counter()
            frames = repl.ship_now()
            ship_s = time.perf_counter() - t0
            check(receiver.consistent and frames == len(
                bootstrap_rows(REPL_SLOTS, 4) + bootstrap_rows(REPL_SLOTS, 6)),
                f"TCP bootstrap: {frames} frames")
            synced(dev_st, tcp_st, "TCP bootstrap")
            beats = []
            for _ in range(REPL_HEARTBEATS):
                t0 = time.perf_counter()
                check(sink.heartbeat(), "TCP heartbeat not acked")
                beats.append((time.perf_counter() - t0) * 1e3)
            check(sink.link_state() == "up", "TCP link not up")
            print(f"replication TCP ({card}): bootstrap {frames} frames, "
                  f"{repl.bytes_shipped} bytes in {ship_s:.3f} s "
                  f"({repl.bytes_shipped / ship_s / 1e6:.1f} MB/s, cut, "
                  f"encode, loopback and apply), heartbeat round p50 "
                  f"{statistics.median(beats):.3f} ms (max "
                  f"{max(beats):.3f}); state equal")
        finally:
            sink.close()
            server.stop()

        # (c) The device journal's cost on the decision path: an
        # 8192-lane token-bucket micro step (raw slots) with the journal
        # attached and detached, in alternating pairs.
        eng = dev_st.engine
        journal = logs[0].journal

        def staged():
            buf = np.empty((MICRO_STAGE_ROWS, 8192), dtype=np.int64)
            buf[0] = zipf_keys(rng, 8192)
            buf[1], buf[2] = 3, rng.integers(1, 101, 8192)
            buf[3, 0] = clock["t"]
            return buf

        def one_step(attached):
            eng.journal = journal if attached else None
            buf = staged()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handle = eng.micro_staged_dispatch("tb", buf, 8192)
            t1 = time.perf_counter()
            eng.micro_staged_drain("tb", handle, 8192)
            return (t1 - t0) * 1e3

        def op_count(attached):
            eng.journal = journal if attached else None
            buf = staged()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng.micro_staged_drain(
                    "tb", eng.micro_staged_dispatch("tb", buf, 8192), 8192)
            return sum(1 for e in prof.events() if e.name.startswith(
                "aten::") and not (e.cpu_parent is not None
                                   and e.cpu_parent.name.startswith("aten::")))

        for attached in (True, False):
            one_step(attached)
        times = {True: [], False: []}
        for i in range(REPL_PAIRS):
            for attached in ((True, False) if i % 2 == 0
                             else (False, True)):
                times[attached].append(one_step(attached))
        ops = {a: op_count(a) for a in (True, False)}
        eng.journal = None
        journal.drain()
        on = statistics.median(times[True])
        off = statistics.median(times[False])
        print(f"device journal cost ({card}): tb micro step of 8192 lanes, "
              f"{REPL_PAIRS} alternating pairs: host enqueue {on:.4f} ms "
              f"attached / {off:.4f} ms detached (medians; ranges "
              f"{min(times[True]):.4f}-{max(times[True]):.4f} / "
              f"{min(times[False]):.4f}-{max(times[False]):.4f}); "
              f"{ops[True]} / {ops[False]} top-level torch ops per step")
    finally:
        for st in made:
            st.close()


def replication_service(rng, card, totals):
    """(f): a standby app, then a primary app replicating to it, both with
    a control port, over loopback on a manual clock."""
    import copy
    import functools
    import socket

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.replication import ControlClient
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import wiring
    from ratelimiter_tpu_torch.storage.errors import FencedError
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    clock = {"t": 1_761_500_000_000}
    real = wiring.GpuBatchedStorage
    # The apps' storages on the manual clock (build_app passes none).
    wiring.GpuBatchedStorage = functools.partial(
        GpuBatchedStorage, clock_ms=lambda: clock["t"])
    servers, clients = [], []
    try:
        common = {"server.port": "0", "storage.num_slots": str(REPL_SLOTS)}
        sb_ctx = wiring.build_app(service_props(**common, **{
            "replication.enabled": "true", "replication.role": "standby",
            "replication.listen_port": "0",
            "ratelimiter.control.port": str(free_port())}))
        servers.append(serve(sb_ctx))
        target = sb_ctx.replication.server.port
        pr_ctx = wiring.build_app(service_props(**common, **{
            "replication.enabled": "true", "replication.role": "primary",
            "replication.target": f"127.0.0.1:{target}",
            "replication.interval_ms": "600000",
            "ratelimiter.control.port": str(free_port())}))
        servers.append(serve(pr_ctx))
        sb_port, pr_port = servers[0][2], servers[1][2]
        sb_ctl = ControlClient("127.0.0.1", sb_ctx.control.port, timeout=60)
        pr_ctl = ControlClient("127.0.0.1", pr_ctx.control.port, timeout=60)
        clients += [sb_ctl, pr_ctl]
        auth = SlidingWindowOracle(RateLimitConfig(**TRIO["auth"][1]))
        burst = TokenBucketOracle(RateLimitConfig(**TRIO["burst"][1]))
        users = [f"svc{i}" for i in range(SERVICE_USERS)]

        def login(port, user):
            status = http_call(port, "POST", "/api/login",
                               {"username": user})[0]
            want = auth.try_acquire(user, 1, clock["t"]).allowed
            check(status == (200 if want else 429),
                  f"service replication: login {user} {status}")

        def batch(port, user, size):
            status = http_call(port, "POST", "/api/batch", {"size": size},
                               {"X-User-ID": user})[0]
            want = burst.try_acquire(user, size, clock["t"]).allowed
            check(status == (200 if want else 429),
                  f"service replication: batch {user} {status}")

        def traffic():
            n = 0
            for rnd in range(3):
                clock["t"] += 2_000
                for i, user in enumerate(users):
                    for _ in range(1 + (i + rnd) % 4):
                        login(pr_port, user)
                        n += 1
                    batch(pr_port, user, 5 + i % 20)
                    status = http_call(pr_port, "GET", "/api/data",
                                       headers={"X-User-ID": user})[0]
                    check(status == 200, f"/api/data {status}")
                    n += 2
            return n

        n, _ = counted(totals, traffic)
        probe = pr_ctl.call_ok("probe")
        check(probe["role"] == "primary" and probe["available"],
              f"primary probe {probe}")
        shipped = pr_ctl.call_ok("ship", timeout=120)["frames"]
        check(shipped == len(bootstrap_rows(REPL_SLOTS, 4)
                             + bootstrap_rows(REPL_SLOTS, 6)),
              f"ship over the control port: {shipped} frames")
        st_p = http_call(pr_port, "GET", "/actuator/replication")[1]
        st_s = http_call(sb_port, "GET", "/actuator/replication")[1]
        check(st_p["role"] == "primary" and st_p["epoch"] == 1
              and st_p["journal"] == "device" and st_p["errors"] == 0,
              f"primary /actuator/replication {st_p}")
        check(st_s["role"] == "standby" and st_s["applied_epoch"] == 1
              and st_s["consistent"] and not st_s["promoted"],
              f"standby /actuator/replication {st_s}")
        sprobe = sb_ctl.call_ok("probe")
        check(sprobe["last_epoch"] == 1 and "repl_rx_age_ms" in sprobe,
              f"standby probe {sprobe}")
        rolled = (copy.deepcopy(auth), copy.deepcopy(burst))
        # The loss wave: decided on the primary, never shipped.
        clock["t"] += 300
        for user in users[:8]:
            login(pr_port, user)
        # FENCE: the raw storage refuses; the HTTP tier fails open on the
        # storage error (ratelimiter.fail_open=true), as the reference's.
        check(pr_ctl.call_ok("fence", epoch=5)["epoch"] == 5, "fence")
        raw = pr_ctx.storage
        while hasattr(raw, "_inner"):
            raw = raw._inner
        try:
            raw.acquire("sw", 2, "fenced-user", 1)
            check(False, "a fenced storage decided")
        except FencedError:
            pass
        status = http_call(pr_port, "POST", "/api/login",
                           {"username": "fenced-user"})[0]
        check(status == 200, f"fenced login answered {status}")
        lease = pr_ctl.call("lease", epoch=6, ttl_ms=60_000.0)
        check(lease["ok"] is False, "a lease resurrected a fenced primary")
        pr_ctl.call_ok("restore", epoch=5)
        check(pr_ctl.call_ok("lease", epoch=6, ttl_ms=60_000.0)["epoch"]
              == 6, "lease after restore")
        check(pr_ctl.call_ok("probe")["lease"]["installed"], "lease probe")
        pr_ctl.call_ok("fence", epoch=7)     # the operator, before promoting
        t0 = time.perf_counter()
        status, body, _ = http_call(sb_port, "POST",
                                    "/actuator/replication/promote", {})
        promote_s = time.perf_counter() - t0
        check(status == 200 and body["promoted"]
              and body["applied_epoch"] == 1, f"promote {status} {body}")
        check(http_call(sb_port, "POST", "/actuator/replication/promote",
                        {})[0] == 409, "a second promotion was taken")
        auth, burst = rolled
        clock["t"] += 500

        def after():
            m = 0
            for i, user in enumerate(users):
                for _ in range(4):
                    login(sb_port, user)
                batch(sb_port, user, 5 + i % 20)
                m += 5
            return m

        m, _ = counted(totals, after)
        print(f"replication service ({card}): {n} requests through the "
              f"primary app, {shipped} frames shipped over the control "
              f"port's SHIP, /actuator/replication on both; fence (raw "
              f"storage refused, HTTP failed open), lease refused while "
              f"fenced, restore, lease; POST "
              f"/actuator/replication/promote {promote_s:.3f} s; {m} "
              f"requests to the promoted standby equal to the oracle "
              f"rolled back to epoch 1")
    finally:
        wiring.GpuBatchedStorage = real
        for client in clients:
            client.close()
        for srv, thread, _ in reversed(servers):
            stop(srv, thread)


def phase_replication(rng, card: str, headline: np.ndarray, kernels: dict,
                      floor_ms: float) -> dict:
    """Phase 14, flat replication and the control plane: (a)-(c) an
    in-process failover at full width with the bootstrap broken down and
    the delta cuts, (d)-(e) the journals against each other and TCP, the
    journal's cost on the micro step, (f) the service.  Returns the
    kernel launch counts."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    clock = {"t": 1_761_400_000_000}
    hp = replication_failover(rng, card, headline, clock, totals, kernels,
                              floor_ms)
    replication_journals(rng, card, headline, clock, totals, hp)
    replication_service(rng, card, totals)
    check_launches(min(totals.values()) > 0,
                   f"replication: a kernel was not launched in phase 14 "
                   f"{totals}")
    print(f"replication: phase 14 in {time.perf_counter() - t_phase:.3f} "
          f"s; launches {totals}")
    return totals


# -- phase 15: the decision sidecar ------------------------------------------
SIDECAR_THREADS = 8          # (a)'s client threads, one SidecarClient each
SIDECAR_DEPTH = 64           # (a)'s pipelined TRY_ACQUIRE frames a burst
SIDECAR_ROUNDS = 4           # (a)'s rounds (the clock steps between them)
SIDECAR_BURSTS = 8           # bursts a thread sends a round
SIDECAR_TRACE_EVERY = 16     # a v4 connection traces one frame in this many
BATCH_KEY_WIDTH = 13         # (b)'s fixed key width in bytes
BATCH_FRAMES = 12            # (b)'s frames a thread a path
LEASE_SIDECAR_KEYS = 64      # (c)'s leased keys
LEASE_SIDECAR_DECISIONS = 4096
EDGE_PROC_DECISIONS = 2048   # decisions through the edge process
HTTP_SPENT = 7               # (d)'s GET /api/data requests before the peek


def batch_rows(max_frame: int, key_width: int) -> int:
    """Rows of the largest v5 BATCH frame with a permits column and keys
    of ``key_width`` bytes that ``max_frame`` admits: the body is 17 header
    bytes, u32 klen, offsets[rows + 1], a flags byte and u32 permits."""
    return (max_frame - 17 - 4 - 4 - 1) // (key_width + 4 + 4)


def in_threads(worker, n: int, *args) -> float:
    """``worker(t, *args)`` on ``n`` threads at once; the wall seconds
    until all have ended."""
    import threading

    threads = [threading.Thread(target=worker, args=(t, *args))
               for t in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return time.perf_counter() - t0


def sidecar_frames(card, ctx, clock, totals):
    """(a): 8 threads, each its own ``SidecarClient`` (v2 and v4 by turns;
    v4 sends a trace id on one frame in 16), pipelined TRY_ACQUIRE bursts
    64 deep on the burst bucket, keys disjoint per thread (Zipf(1.1) over
    1M), permits in [1, 100]; every answer (allowed and remaining) against
    the oracle.  Returns the traced ids."""
    import threading

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import TokenBucketOracle
    from ratelimiter_tpu_torch.service import sidecar as sc

    lid = ctx.limiters["burst"]._lid
    port = ctx.sidecar.port
    versions = [2 if t % 2 == 0 else 4 for t in range(SIDECAR_THREADS)]
    clients = [sc.SidecarClient("127.0.0.1", port, timeout=60.0,
                                protocol=v) for v in versions]
    check([c.server_version for c in clients] == versions,
          f"sidecar: negotiated {[c.server_version for c in clients]}")
    oracles = [TokenBucketOracle(RateLimitConfig(**TRIO["burst"][1]))
               for _ in clients]
    rngs = [np.random.default_rng(SEED + 1500 + t) for t in range(len(clients))]
    rtts, traced, errors = [], [], []
    lock = threading.Lock()

    def worker(t, now, bursts):
        cli, rng = clients[t], rngs[t]
        try:
            for _ in range(bursts):
                ids = zipf_stream(rng, KEY_SPACE, SIDECAR_DEPTH)
                keys = [f"t{t}:{int(i)}" for i in ids]
                perms = rng.integers(1, 101, SIDECAR_DEPTH)
                tids = [0] * SIDECAR_DEPTH
                if cli.server_version >= 4:
                    for j in range(0, SIDECAR_DEPTH, SIDECAR_TRACE_EVERY):
                        tids[j] = int(rng.integers(1, 1 << 62))
                payload = b"".join(
                    cli._frame(sc.OP_TRY_ACQUIRE, lid, int(p), k,
                               trace_id=tid)
                    for k, p, tid in zip(keys, perms, tids))
                t0 = time.perf_counter()
                cli._send(payload)
                got = cli._read_responses(SIDECAR_DEPTH)
                dt = time.perf_counter() - t0
                for (status, allowed, rem), k, p in zip(got, keys, perms):
                    want = oracles[t].try_acquire(k, int(p), now)
                    if (status != sc.ST_OK or allowed != want.allowed
                            or rem != want.remaining_hint):
                        raise RuntimeError(
                            f"{k} permits {p}: status {status} allowed "
                            f"{allowed} remaining {rem}, oracle {want}")
                with lock:
                    rtts.append(dt)
                    traced.extend(x for x in tids if x)
        except Exception as exc:  # noqa: BLE001 — raised below
            errors.append(f"thread {t}: {exc!r}")

    def round_(bursts):
        clock["t"] += 1_300
        in_threads(worker, len(clients), clock["t"], bursts)
        check(not errors, f"sidecar (a): {errors[:3]}")

    raw = ctx.storage._inner._inner
    lat = raw.registry.timer("ratelimiter.storage.latency")
    index = raw.registry.timer("ratelimiter.latency.assembly.index")
    # Each frame's slot assignment first collects the batcher's queued
    # slots (the pin set): time those calls and their sizes apart.
    batcher = raw._batcher
    pins = {"calls": 0, "slots": 0, "s": 0.0}
    pins_lock = threading.Lock()
    pending_slots = batcher.pending_slots

    def timed_pending(algo):
        t1 = time.perf_counter()
        out = pending_slots(algo)
        dt = time.perf_counter() - t1
        with pins_lock:
            pins["calls"] += 1
            pins["slots"] += len(out)
            pins["s"] += dt
        return out

    def index_total():
        snap = index.snapshot()
        return snap["count"], snap["count"] * snap["mean_us"]

    n0 = lat.snapshot()["count"]
    i0 = index_total()
    batcher.pending_slots = timed_pending
    t0 = time.perf_counter()
    try:
        _, counts = counted(totals, lambda: [round_(SIDECAR_BURSTS)
                                             for _ in range(SIDECAR_ROUNDS)])
    finally:
        del batcher.pending_slots
    wall = time.perf_counter() - t0
    steps = lat.snapshot()["count"] - n0
    i1 = index_total()
    frames = len(clients) * SIDECAR_ROUNDS * SIDECAR_BURSTS * SIDECAR_DEPTH
    check_launches(counts["solver"] == counts["tb_writeback"] == steps
                   and counts["block_scatter"] == 0,
                   f"sidecar (a): {steps} micro steps, launches {counts}")
    ms = sorted(x * 1e3 for x in rtts)
    print(f"sidecar (a) ({card}): {len(clients)} connections (v2, v4 by "
          f"turns) x {SIDECAR_ROUNDS} rounds x {SIDECAR_BURSTS} bursts of "
          f"{SIDECAR_DEPTH} TRY_ACQUIRE frames = {frames} frames in "
          f"{wall:.4f} s = {frames / wall:.1f} frames/s, every answer "
          f"equal to the oracle; burst round trip p50 "
          f"{ms[len(ms) // 2]:.4f} ms, p99 {ms[int(len(ms) * 0.99)]:.4f} ms; "
          f"{steps} micro steps = {steps / frames:.5f} flushes per frame; "
          f"launches {counts}")
    print(f"sidecar (a) host ({card}): slot assignment (the storage's "
          f"index stage, pin set included) {(i1[1] - i0[1]) / 1e6:.4f} s "
          f"summed over {i1[0] - i0[0]} frames, "
          f"{(i1[1] - i0[1]) / max(i1[0] - i0[0], 1):.1f} us a frame; of "
          f"it the pin set, {pins['calls']} batcher.pending_slots calls of "
          f"{pins['slots'] / max(pins['calls'], 1):.1f} queued slots on "
          f"average, {pins['s']:.4f} s; the window {wall:.4f} s on "
          f"{len(clients)} handler threads")
    profiled_pass("sidecar (a) round", card, lambda: round_(1))
    for c in clients:
        c.close()
    return traced


def sidecar_batches(card, ctx, props, clock, totals):
    """(b): v5 BATCH frames of as many rows as the shipped frame cap
    admits, half on the burst bucket and half on the api window, from 8
    threads with disjoint keys: on the app's storage (8 partitions: the
    election sends them through ``acquire_async_many``), then the same
    frames on a second card storage with ``host_parallel=0``
    (``acquire_async_block``).  Both against the oracle and each other."""
    import threading

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    app_st = ctx.storage._inner._inner
    one = GpuBatchedStorage(num_slots=app_st.engine.num_slots,
                            host_parallel=0, clock_ms=lambda: clock["t"],
                            max_batch=props.get_int("batcher.max_batch",
                                                    8192))
    server = sc.SidecarServer.from_props(one, props, host="127.0.0.1")
    server.start()
    index_s = [0.0]
    index_lock = threading.Lock()

    def timed_assign(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with index_lock:
                    index_s[0] += time.perf_counter() - t0
        return run

    # Each route's slot assignment, timed: the many route hashes the
    # decoded keys (assign_batch_strs), the block route assigns off the
    # frame's key column (assign_batch_bytes).
    routes = {"many": (app_st, "assign_batch_strs"),
              "block": (one, "assign_batch_bytes")}
    for st, name in routes.values():
        for algo in ("sw", "tb"):
            idx = st._index[algo]
            setattr(idx, name, timed_assign(getattr(idx, name)))
    try:
        specs = {"tb": ("burst", TokenBucketOracle),
                 "sw": ("api", SlidingWindowOracle)}
        sides = {
            "many": (ctx.sidecar.port,
                     {a: ctx.limiters[n]._lid for a, (n, _) in specs.items()}),
            "block": (server.port, {
                a: server.register(a, RateLimitConfig(**TRIO[n][1]))
                for a, (n, _) in specs.items()})}
        cap = ctx.sidecar.max_frame_bytes
        rows = batch_rows(cap, BATCH_KEY_WIDTH)
        probe = sc.SidecarClient("127.0.0.1", ctx.sidecar.port, timeout=60.0)
        for n, fits in ((rows, True), (rows + 1, False)):
            body = len(probe._batch_frame(1, ["k" * BATCH_KEY_WIDTH] * n,
                                          [1] * n)) - 4
            check((body <= cap) == fits,
                  f"sidecar (b): {n} rows make a {body}-byte frame")
        probe.close()
        clock["t"] += 1_300
        now = clock["t"]
        plans = []
        for t in range(SIDECAR_THREADS):
            rng = np.random.default_rng(SEED + 1600 + t)
            plan = []
            for f in range(BATCH_FRAMES):
                ids = zipf_stream(rng, KEY_SPACE, rows)
                keys = [f"b{t}{int(i):011d}" for i in ids]
                check(all(len(k) == BATCH_KEY_WIDTH for k in keys),
                      "sidecar (b): key width")
                plan.append(("tb" if f % 2 == 0 else "sw", keys,
                             rng.integers(1, 101, rows).tolist()))
            plans.append(plan)
        got, walls = {}, {}
        for side, (port, lids) in sides.items():
            res = [None] * SIDECAR_THREADS
            errors = []

            def worker(t):
                try:
                    cli = sc.SidecarClient("127.0.0.1", port, timeout=60.0)
                    check(cli.server_version >= 5, "sidecar (b): v5")
                    res[t] = [cli.acquire_block(lids[algo], keys, perms,
                                                max_rows=rows)
                              for algo, keys, perms in plans[t]]
                    cli.close()
                except Exception as exc:  # noqa: BLE001 — raised below
                    errors.append(f"{side} thread {t}: {exc!r}")

            index_s[0] = 0.0
            walls[side], counts = counted(
                totals, lambda: in_threads(worker, SIDECAR_THREADS))
            check(not errors, f"sidecar (b): {errors[:3]}")
            got[side] = res
            n = SIDECAR_THREADS * BATCH_FRAMES * rows
            print(f"sidecar (b) {side} ({card}): {SIDECAR_THREADS} threads "
                  f"x {BATCH_FRAMES} BATCH frames of {rows} rows ("
                  f"{BATCH_KEY_WIDTH}-byte keys, permits column; "
                  f"{ctx.sidecar.max_frame_bytes}-byte cap) = {n} decisions "
                  f"in {walls[side]:.4f} s = {n / walls[side]:.1f} "
                  f"decisions/s; host_parallel "
                  f"{routes[side][0]._host_parallel}; {routes[side][1]} "
                  f"{index_s[0] * 1e3:.3f} ms in all (threads summed), "
                  f"{index_s[0] * 1e9 / n:.1f} ns a row; launches {counts}")
            check(index_s[0] > 0,
                  f"sidecar (b): the {side} route never called "
                  f"{routes[side][1]}")
        check(got["many"] == got["block"],
              "sidecar (b): the many and block routes decided apart")
        n_checked = 0
        for t, plan in enumerate(plans):
            oracles = {a: cls(RateLimitConfig(**TRIO[n][1]))
                       for a, (n, cls) in specs.items()}
            for (algo, keys, perms), bits in zip(plan, got["block"][t]):
                for k, p, b in zip(keys, perms, bits):
                    want = oracles[algo].try_acquire(k, p, now)
                    check(b == want.allowed, f"sidecar (b): {k} {p}")
                    n_checked += 1
        print(f"sidecar (b) ({card}): {n_checked} decisions of each route "
              f"equal to the oracle and to each other")
    finally:
        for algo in ("sw", "tb"):
            del app_st._index[algo].assign_batch_strs
        server.stop()
        one.close()


def sidecar_leases(card, ctx, clock, totals):
    """(c): ``LeaseClient``s over v6 ``SidecarClient``s (LEASE / RENEW /
    RELEASE frames) from 8 threads on 64 keys (8 each), RESET frames, then
    ``python -m ratelimiter_tpu_torch.edge.edgeproc`` in front of the
    sidecar with lease clients on its front door (BULK_RENEW upstream).
    Each key's permits on the card after every release must equal the
    capacity less its decisions; over-admission 0."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.leases import LeaseClient
    from ratelimiter_tpu_torch.service import sidecar as sc

    cap = 1_000_000
    lid = ctx.sidecar.register("tb", RateLimitConfig(
        max_permits=cap, window_ms=60_000, refill_rate=100_000.0))
    mgr = ctx.leases
    clock["t"] += 1_300
    per = LEASE_SIDECAR_DECISIONS // SIDECAR_THREADS
    # One lease a key: each connection leases keys of its own.
    keys_per = LEASE_SIDECAR_KEYS // SIDECAR_THREADS
    allowed = [0] * SIDECAR_THREADS
    wire_ops = [0] * SIDECAR_THREADS
    errors = []

    def worker(t):
        try:
            wire = sc.SidecarClient("127.0.0.1", ctx.sidecar.port,
                                    timeout=60.0)
            cli = LeaseClient(wire, lid, budget=64, direct_fallback=False)
            rng = np.random.default_rng(SEED + 1700 + t)
            for k in rng.integers(0, keys_per, per):
                allowed[t] += bool(cli.try_acquire(f"lease{t}:{int(k)}"))
            cli.release_all()
            wire_ops[t] = cli.wire_ops
            wire.close()
        except Exception as exc:  # noqa: BLE001 — raised below
            errors.append(f"thread {t}: {exc!r}")

    st0 = mgr.status()
    wall, counts = counted(totals,
                           lambda: in_threads(worker, SIDECAR_THREADS))
    check(not errors, f"sidecar (c): {errors[:3]}")
    st1 = mgr.status()
    check(sum(allowed) == LEASE_SIDECAR_DECISIONS,
          f"sidecar (c): {sum(allowed)} allowed")
    check(st1["over_admission"] == 0 and st1["outstanding"] == 0,
          f"sidecar (c): lease status {st1}")
    cli = sc.SidecarClient("127.0.0.1", ctx.sidecar.port, timeout=60.0)
    used = {}
    for t in range(SIDECAR_THREADS):
        rng = np.random.default_rng(SEED + 1700 + t)
        for k in rng.integers(0, keys_per, per):
            key = f"lease{t}:{int(k)}"
            used[key] = used.get(key, 0) + 1
    for key, n in used.items():
        got = cli.available(lid, key)
        check(got == cap - n, f"sidecar (c): {key} {got} != {cap - n}")

    def resets():
        for key in list(used)[:8]:
            cli.reset(lid, key)
        return [cli.available(lid, key) for key in list(used)[:8]]

    after, rc = counted(totals, resets)
    check(after == [cap] * 8, f"sidecar (c): resets left {after}")
    check_launches(counts["block_scatter"] > 0 and rc["block_scatter"] >= 8,
                   f"sidecar (c): row scatter launches {counts} / {rc}")
    print(f"sidecar (c) ({card}): {LEASE_SIDECAR_DECISIONS} leased "
          f"decisions from {SIDECAR_THREADS} v6 connections in {wall:.4f} s, "
          f"{sum(wire_ops)} lease frames = "
          f"{sum(wire_ops) / LEASE_SIDECAR_DECISIONS:.5f} frames per "
          f"decision; granted {st1['granted'] - st0['granted']}, renewed "
          f"{st1['renewed'] - st0['renewed']}, over-admission 0; every "
          f"key's permits on the card equal the oracle's after release; 8 "
          f"RESET frames; launches {counts} + resets {rc}")
    edge_process(card, ctx, lid, cap, cli, totals)
    cli.close()


def edge_process(card, ctx, lid, cap, core_cli, totals):
    """(c) continued: the standalone edge process as a subprocess of this
    script, pointed at the phase's sidecar."""
    import subprocess as sp

    from ratelimiter_tpu_torch.leases import LeaseClient
    from ratelimiter_tpu_torch.service import sidecar as sc

    mgr = ctx.leases
    st0 = mgr.status()
    t0 = time.perf_counter()
    proc = sp.Popen(
        [sys.executable, "-m", "ratelimiter_tpu_torch.edge.edgeproc",
         "--upstream-port", str(ctx.sidecar.port), "--lids", str(lid)],
        stdin=sp.PIPE, stdout=sp.PIPE, cwd=os.path.dirname(
            os.path.abspath(__file__)))
    try:
        ready = json.loads(proc.stdout.readline())
        ready_s = time.perf_counter() - t0
        check(ready.get("ready") and ready.get("role") == "edge"
              and ready.get("version") == sc.PROTOCOL_VERSION,
              f"edge process ready line {ready}")
        wire = sc.SidecarClient("127.0.0.1", int(ready["port"]),
                                timeout=60.0)
        cli = LeaseClient(wire, lid, budget=64, direct_fallback=False,
                          telemetry=False)
        keys = [f"edge{i % 8}" for i in range(EDGE_PROC_DECISIONS)]

        def drive():
            t1 = time.perf_counter()
            n = sum(bool(cli.try_acquire(k)) for k in keys)
            cli.release_all()
            return n, time.perf_counter() - t1

        (n_ok, wall), counts = counted(totals, drive)
        wire.close()
        proc.stdin.close()
        rc = proc.wait(timeout=60)
        check(rc == 0, f"edge process exit code {rc}")
        check(n_ok == EDGE_PROC_DECISIONS, f"edge process: {n_ok} allowed")
        st1 = mgr.status()
        check(st1["over_admission"] == 0 and st1["outstanding"] == 0,
              f"edge process: core lease status {st1}")
        for i in range(8):
            got = core_cli.available(lid, f"edge{i}")
            want = cap - EDGE_PROC_DECISIONS // 8
            check(got == want, f"edge process: edge{i} {got} != {want}")
        upstream = ((st1["granted"] - st0["granted"])
                    + (st1["renewed"] - st0["renewed"]))
        print(f"sidecar (c) edge process ({card}): ready line in "
              f"{ready_s:.3f} s ({ready}); {EDGE_PROC_DECISIONS} decisions "
              f"on 8 keys through its front door in {wall:.4f} s, "
              f"{cli.wire_ops} front-door lease frames "
              f"({cli.wire_ops / EDGE_PROC_DECISIONS:.5f} per decision), "
              f"{upstream} upstream grants and renewals at the core "
              f"({upstream / EDGE_PROC_DECISIONS:.5f} per decision); exit "
              f"0 on stdin EOF; over-admission 0, every key's permits on "
              f"the card equal the oracle's; launches {counts}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def sidecar_http(card, ctx, clock):
    """(d): ``GET /api/data`` and a sidecar AVAILABLE frame read one
    counter per key."""
    from ratelimiter_tpu_torch.service import sidecar as sc

    srv, thread, port = serve(ctx)
    try:
        clock["t"] += 1_300
        api = ctx.limiters["api"]._lid
        statuses = [http_call(port, "GET", "/api/data",
                              headers={"X-User-ID": "front-doors"})[0]
                    for _ in range(HTTP_SPENT)]
        cli = sc.SidecarClient("127.0.0.1", ctx.sidecar.port, timeout=60.0)
        seen = cli.available(api, "front-doors")
        cli.close()
        check(statuses == [200] * HTTP_SPENT and seen == 100 - HTTP_SPENT,
              f"sidecar (d): HTTP {statuses}, AVAILABLE {seen}")
        health = http_call(port, "GET", "/actuator/health")[1]
        check(set(health.get("sidecar", {})) == {
            "connections", "in_flight", "malformed_total",
            "idle_closed_total", "pipeline_shed_total", "refused_total"},
            f"sidecar (d): health {health}")
        print(f"sidecar (d) ({card}): {HTTP_SPENT} GET /api/data then "
              f"AVAILABLE on the api lid = {seen}; /actuator/health "
              f"sidecar {health['sidecar']}")
    finally:
        srv.shutdown()
        thread.join(timeout=30)
        srv.server_close()


def sidecar_hostile(card, ctx):
    """(e): ``ingress_drill`` on the card, and a client killed
    mid-pipeline on the app's sidecar through the fault proxy: the app's
    batcher queue, waiter set and the server's in-flight count return to
    baseline (bounded polls)."""
    from ratelimiter_tpu_torch.service import sidecar as sc
    from ratelimiter_tpu_torch.storage.chaos import (
        FaultInjectingProxy,
        ingress_drill,
    )

    t0 = time.perf_counter()
    report = ingress_drill(device=torch.device("cuda"))
    drill_s = time.perf_counter() - t0
    check(report["mismatches"] == 0 and report["shed"] >= 1
          and report["malformed_answered"] == 9,
          f"sidecar (e): ingress drill {report}")
    raw = ctx.storage._inner._inner
    batcher = raw._batcher
    proxy = FaultInjectingProxy(ctx.sidecar.port, seed=SEED).start()
    try:
        proxy.set_fault("kill", after=300)
        kil = sc.SidecarClient("127.0.0.1", proxy.port, timeout=10.0,
                               protocol=1)
        try:
            kil.acquire_batch(ctx.limiters["burst"]._lid,
                              [f"kill{i}" for i in range(128)])
        except (ConnectionError, OSError):
            pass
        finally:
            kil.close()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with batcher._cv:
                waiters = len(batcher._waiters)
            if (waiters == 0 and batcher.queue_depth() == 0
                    and ctx.sidecar.inflight() == 0):
                break
            time.sleep(0.02)
        with batcher._cv:
            waiters = len(batcher._waiters)
        check(waiters == 0 and batcher.queue_depth() == 0
              and ctx.sidecar.inflight() == 0,
              f"sidecar (e): after the kill {waiters} waiters, depth "
              f"{batcher.queue_depth()}, in flight {ctx.sidecar.inflight()}")
    finally:
        proxy.stop()
    print(f"sidecar (e) ({card}): ingress_drill on the card in "
          f"{drill_s:.3f} s: {report}; a client killed mid-pipeline through "
          f"the proxy ({proxy.faults_injected} faults), the batcher's queue "
          f"and waiters and the server's in-flight frames back to 0; "
          f"abandoned futures {ctx.sidecar.futures_abandoned}, withdrawn "
          f"{batcher.abandoned_total}")


def phase_sidecar(card: str) -> dict:
    """Phase 15, the decision sidecar: ``build_app`` of
    ``application.properties`` with the sidecar and the lease tier on, on
    a manual clock; (a) pipelined frames, (b) BATCH frames on both
    routes, (c) lease frames and the edge process, (d) the two front
    doors, (e) hostile ingress, (f) the kernels' launches.  Returns the
    kernel launch counts of (a)-(e)."""
    import functools

    from ratelimiter_tpu_torch.service import wiring
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    clock = {"t": 1_761_600_000_000}
    real = wiring.GpuBatchedStorage
    wiring.GpuBatchedStorage = functools.partial(
        GpuBatchedStorage, clock_ms=lambda: clock["t"])
    try:
        props = service_props(**{
            "server.port": "0", "ratelimiter.sidecar.enabled": "true",
            "ratelimiter.sidecar.port": "0",
            "ratelimiter.lease.enabled": "true"})
        ctx, boot = counted(totals, lambda: wiring.build_app(props))
    finally:
        wiring.GpuBatchedStorage = real
    try:
        raw = ctx.storage._inner._inner
        check(ctx.sidecar is not None and ctx.sidecar.storage is raw
              and raw.device.type == "cuda"
              and ctx.sidecar._leases is ctx.leases,
              "build_app: the sidecar is not over the card's storage")
        host_index_line("sidecar", raw)
        print(f"sidecar ({card}): build_app with ratelimiter.sidecar.* "
              f"(port {ctx.sidecar.port}, max_frame_bytes "
              f"{ctx.sidecar.max_frame_bytes}, max_pipeline "
              f"{ctx.sidecar.max_pipeline}, max_key_bytes "
              f"{ctx.sidecar.max_key_bytes}) and ratelimiter.lease.* on, "
              f"batcher.max_batch {raw._batcher.max_batch}; warmup "
              f"launches {boot}")
        before = dict(totals)
        traced = sidecar_frames(card, ctx, clock, totals)
        sidecar_batches(card, ctx, props, clock, totals)
        ab = {k: totals[k] - before[k] for k in totals}
        check_launches(ab["solver"] > 0 and ab["tb_writeback"] > 0
                       and ab["sw_writeback"] > 0,
                       f"sidecar: (a)-(b) launches {ab}")
        lin = raw.lineage
        # The ring keeps the newest traces (ratelimiter.obs.
        # lineage_capacity): read the last ones sent.
        hops = [lin.hops(t) for t in traced[-32:]]
        check(traced and all(h[:1] == ["sidecar"] and "resolve" in h
                             for h in hops),
              f"sidecar (a): trace lineage {hops[:3]}")
        before = dict(totals)
        sidecar_leases(card, ctx, clock, totals)
        c = {k: totals[k] - before[k] for k in totals}
        check_launches(c["block_scatter"] > 0,
                       f"sidecar: (c) launches {c}")
        sidecar_http(card, ctx, clock)
        sidecar_hostile(card, ctx)
        print(f"sidecar: {len(traced)} v4 trace ids, each with its "
              f"sidecar -> batcher -> shard -> resolve hops in the lineage "
              f"ring ({hops[0]})")
    finally:
        ctx.close()
    totals = {k: totals[k] - boot[k] for k in totals}
    print(f"sidecar: phase 15 in {time.perf_counter() - t_phase:.3f} s; "
          f"launches over (a)-(e) {totals}")
    return totals


CROSS_KEYS = 1 << 18        # (b)'s preloaded keys a limiter
CROSS_AGAIN = 1 << 14       # of them asked again (the oracle denies some)
CROSS_CONNS = 4             # (b)'s sidecar connections, one thread each
CROSS_KEY_WIDTH = 8         # "x" and 7 digits
CROSS_MAX = 4               # the bucket's max_permits (the window's is 3)
CROSS_SAMPLE = 4096         # preloaded keys asked of the promoted sidecar
CROSS_FRESH = 1024          # fresh keys asked of it
CROSS_BOOT_S = 180.0        # a node's ready-line deadline
CROSS_SETTLE_S = 60.0       # a state transition's deadline
CROSS_NOW = 1_753_000_000_000  # the oracle's stamp (order-only policies)
CROSS_DRILL_SLACK_S = 0.75  # the drill's self-fence slack past one TTL


class StampedRecorder:
    """Flight-recorder double for an orchestrator: every event with the
    monotonic time it was recorded."""

    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((time.monotonic(), kind, fields))

    def first(self, kind: str, after: float, **match):
        for t, k, f in self.events:
            if k == kind and t >= after and all(
                    f.get(a) == b for a, b in match.items()):
                return t
        return None


def order_only_limiters():
    """(b)'s token bucket (a refill rate whose fixed-point form is 0) and
    sliding window (a window that never rolls): decisions depend on
    arrival order alone, so the nodes' wall clocks cannot move them away
    from this script's oracle."""
    from ratelimiter_tpu_torch import RateLimitConfig

    window = 1 << 30
    cfg_tb = RateLimitConfig(max_permits=CROSS_MAX, window_ms=window,
                             refill_rate=1e-9)
    # The window counts requests, not permits (the reference's INCR): a
    # cap one under the bucket's makes its second visits deny too.
    cfg_sw = RateLimitConfig(max_permits=CROSS_MAX - 1, window_ms=window,
                             enable_local_cache=False)
    check(cfg_tb.refill_rate_fp == 0, "cross-host: the bucket refills")
    spec = json.dumps([
        {"algo": "tb", "max_permits": CROSS_MAX, "window_ms": window,
         "refill_rate": 1e-9},
        {"algo": "sw", "max_permits": CROSS_MAX - 1, "window_ms": window}])
    return cfg_tb, cfg_sw, spec


def cross_drill(card: str, totals: dict) -> float:
    """(a): the port's drill at the reference's defaults on the card."""
    from ratelimiter_tpu_torch.storage.chaos import cross_host_failover_drill

    t0 = time.perf_counter()
    r = cross_host_failover_drill(device="cuda")
    wall = time.perf_counter() - t0
    a, b, st = r["scenario_a"], r["scenario_b"], r["status"]
    check(r["mismatches"] == 0 and r["decisions"] > 0,
          f"cross-host (a): {r['mismatches']} mismatches")
    check(a["witness_vetoes"] >= 1 and not a["lease"]["self_fenced"],
          f"cross-host (a): scenario A {a}")
    check(st["promotions"] == 1 and st["fence_epoch"] == 1
          and b["new_epoch"] > b["old_epoch"],
          f"cross-host (a): promotions {st['promotions']}, epochs {b}")
    check(b["self_fence_after_s"] <= b["lease_ttl_s"] + CROSS_DRILL_SLACK_S,
          f"cross-host (a): self-fence after {b['self_fence_after_s']} s, "
          f"lease TTL {b['lease_ttl_s']} s")
    check(b["promotion_after_s"] >= b["self_fence_after_s"],
          f"cross-host (a): promoted before the self-fence {b}")
    launches = r.get("launches")
    check(launches is not None, "cross-host (a): a node did not exit 0")
    check_launches(launches["solver"] > 0 and launches["tb_writeback"] > 0
                   and launches["sw_writeback"] > 0
                   and launches["block_scatter"] > 0,
                   f"cross-host (a): node launches {launches}")
    for k, v in launches.items():
        totals[k] += v
    print(f"cross-host (a) drill ({card}) in {wall:.3f} s: ready lines "
          f"standby {r['ready_s']['standby']:.3f} s, primary "
          f"{r['ready_s']['primary']:.3f} s; {r['decisions']} decisions, 0 "
          f"mismatches; scenario A held {a['held_s']} s, witness vetoes "
          f"{a['witness_vetoes']}, lease {a['lease']}; scenario B "
          f"self-fence after {b['self_fence_after_s']} s (TTL "
          f"{b['lease_ttl_s']} s + {CROSS_DRILL_SLACK_S} s slack), "
          f"promotion after {b['promotion_after_s']} s, "
          f"{b['refused_after_fence']} later decisions refused (fence "
          f"rejected {b['fence_rejected']}), zombie allows "
          f"{r['zombie_allows']}, burns after the cut "
          f"{b['burns_after_cut']} of {b['outstanding_at_cut']}, epochs "
          f"{b['old_epoch']} -> {b['new_epoch']}; node launches {launches}")
    return wall


def boot_cross_pair(num_slots: int, spec: str, nodes: list) -> None:
    """(b)'s standby, then its primary (pointed at the standby's
    replication listener and control port), appended to ``nodes`` as
    each becomes ready."""
    from ratelimiter_tpu_torch.replication.hostproc import NodeProcess

    standby = NodeProcess(["--role", "standby", "--num-slots",
                           str(num_slots), "--lease"], device="cuda",
                          boot_timeout_s=CROSS_BOOT_S)
    nodes.append(standby)
    nodes.append(NodeProcess([
        "--role", "primary", "--num-slots", str(num_slots), "--lease",
        "--limiters", spec,
        "--repl-target", f"127.0.0.1:{standby.info['repl_port']}",
        "--standby-control", f"127.0.0.1:{standby.info['control_port']}",
        "--repl-interval-ms", "100"], device="cuda",
        boot_timeout_s=CROSS_BOOT_S))


def cross_preload(rng, primary, lids, oracles):
    """(b)'s preload: CROSS_CONNS connections, each on its own keys, a
    first visit of every key then CROSS_AGAIN keys again, per limiter,
    in v5 BATCH frames; every answer against the oracle.  Returns
    (decisions, wall seconds, oracle denials per limiter)."""
    from ratelimiter_tpu_torch.service import sidecar as sc

    keys = [f"x{i:07d}" for i in range(CROSS_KEYS)]
    first = rng.integers(1, CROSS_MAX, CROSS_KEYS).tolist()
    again = rng.integers(1, CROSS_MAX, CROSS_AGAIN).tolist()
    rows = batch_rows(4096, CROSS_KEY_WIDTH)
    plans = []
    for c in range(CROSS_CONNS):
        idx = range(c, CROSS_KEYS, CROSS_CONNS)
        redo = range(c, CROSS_AGAIN, CROSS_CONNS)
        plans.append(([keys[i] for i in idx], [first[i] for i in idx],
                      [keys[i] for i in redo], [again[i] for i in redo]))
    got = [None] * CROSS_CONNS

    def worker(c):
        cli = sc.SidecarClient("127.0.0.1", primary.info["sidecar_port"],
                               timeout=120.0)
        try:
            ks, ps, ks2, ps2 = plans[c]
            got[c] = [(lid, cli.acquire_block(lid, ks, ps, max_rows=rows),
                       cli.acquire_block(lid, ks2, ps2, max_rows=rows))
                      for lid in lids]
        finally:
            cli.close()

    wall = in_threads(worker, CROSS_CONNS)
    decisions, denied = 0, {}
    for c, (ks, ps, ks2, ps2) in enumerate(plans):
        check(got[c] is not None, f"cross-host (b): connection {c} failed")
        for lid, a1, a2 in got[c]:
            for k, p, a in list(zip(ks, ps, a1)) + list(zip(ks2, ps2, a2)):
                want = oracles[lid].try_acquire(k, p, CROSS_NOW).allowed
                check(bool(a) == want,
                      f"cross-host (b): preload {lid} {k} {a} != {want}")
                denied[lid] = denied.get(lid, 0) + (not want)
                decisions += 1
    return decisions, wall, denied


def cross_full_width(rng, card: str, nodes: list, totals: dict,
                     spec_cfgs) -> None:
    """(b): preload, SHIP, SIGKILL of the primary, the orchestrated
    failover, the promoted sidecar against the oracle."""
    from ratelimiter_tpu_torch.replication.control import ControlClient
    from ratelimiter_tpu_torch.replication.orchestrator import (
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
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )
    from ratelimiter_tpu_torch.service import sidecar as sc

    cfg_tb, cfg_sw = spec_cfgs
    standby, primary = nodes
    pinfo, sinfo = parse_ready(primary.info), parse_ready(standby.info)
    lid_tb, lid_sw = pinfo["lids"]
    clients = []

    def ctl(port, timeout=0.5):
        c = ControlClient("127.0.0.1", port, timeout=timeout)
        clients.append(c)
        return c

    cfg = OrchestratorConfig(
        probe_interval_ms=100.0, suspect_threshold=3, hysteresis_ms=300.0,
        promote_retries=2, promote_backoff_ms=100.0, reseed=False,
        fence_lease_ttl_ms=1200.0, fence_wait_slack_ms=150.0)
    backend = RemoteBackend(ctl(pinfo["control_port"]))
    directory = RemoteShardDirectory({0: backend})
    rx = RemoteReceiver(ctl(sinfo["control_port"], timeout=2.0),
                        promote_timeout_s=CROSS_SETTLE_S)
    promote_s = []
    promote = rx.promote

    def timed_promote(force=False):
        t0 = time.perf_counter()
        try:
            return promote(force)
        finally:
            promote_s.append(time.perf_counter() - t0)

    rx.promote = timed_promote
    rec = StampedRecorder()
    orch = FailoverOrchestrator(
        directory, RemoteStandbySet([rx]), None, config=cfg,
        probe=lambda q: directory.serving(q) is not None
        and directory.serving(q).is_available(),
        witness=standby_witness({0: ctl(sinfo["control_port"])},
                                fresh_ms=500.0),
        witness_fresh_ms=500.0, repl_heartbeat_ms=100.0,
        lease_channels={0: FanoutLeaseChannel(
            backend, ctl(sinfo["control_port"]))},
        recorder=rec).start()
    try:
        direct = ctl(pinfo["control_port"], timeout=60.0)
        poll_until(lambda: direct.call_ok("probe")["lease"]["installed"],
                   "cross-host (b): the first serving-lease grant")
        oracles = {lid_tb: TokenBucketOracle(cfg_tb),
                   lid_sw: SlidingWindowOracle(cfg_sw)}
        t_boot = time.perf_counter()
        decisions, wall, denied = cross_preload(
            rng, primary, (lid_tb, lid_sw), oracles)
        t0 = time.perf_counter()
        shipped = direct.call_ok("ship")["frames"]
        ship_s = time.perf_counter() - t0
        poll_until(lambda: rx.consistent and rx.last_epoch >= 1,
                   "cross-host (b): the standby's consistency")
        check(orch.fence_epoch == 0 and orch.promotions == 0,
              f"cross-host (b): failover before the kill {orch.status()}")
        t_kill = time.monotonic()
        check(primary.kill() == -9, "cross-host (b): primary not SIGKILLed")
        # Reaped: its sockets are closed from here on.  Until then a
        # probe may still connect to the dying process's listener and
        # wait out its timeout.
        t_dead = time.monotonic()
        poll_until(lambda: orch.promotions >= 1
                   and directory.shard_health()[0] == "promoted",
                   "cross-host (b): the promotion")
        t_seen = time.monotonic()
        cli = sc.SidecarClient("127.0.0.1", rx.serve_port, timeout=60.0)
        clients.append(cli)
        first_ok = cli.try_acquire(lid_tb, "first", 1)
        t_first = time.monotonic()
        check(first_ok == oracles[lid_tb].try_acquire(
            "first", 1, CROSS_NOW).allowed,
            "cross-host (b): the promoted sidecar's first answer")
        marks = {to: rec.first("orchestrator.transition", t_kill, to=to)
                 for to in ("SUSPECT", "FENCING", "PROMOTING")}
        marks["promoted"] = rec.first("orchestrator.promoted", t_kill)
        check(all(v is not None for v in marks.values()),
              f"cross-host (b): transitions {marks}")
        ms = {k: (v - t_kill) * 1000.0 for k, v in marks.items()}
        dead_ms = (t_dead - t_kill) * 1000.0
        budget = cfg.detection_budget_ms
        # The budget counts on-schedule probes from the death; the loop
        # sleeps a whole interval after each tick, so one interval covers
        # the ticks' own time.
        check(ms["FENCING"] - dead_ms <= budget + cfg.probe_interval_ms,
              f"cross-host (b): reaped -> FENCING "
              f"{ms['FENCING'] - dead_ms:.1f} ms, budget {budget} ms + "
              f"one {cfg.probe_interval_ms} ms probe interval")
        check(ms["PROMOTING"] >= ms["FENCING"], f"cross-host (b): {ms}")
        st = orch.status()
        check(st["promotions"] == 1 and st["fence_epoch"] == 1,
              f"cross-host (b): status {st}")
        sample = [f"x{i:07d}" for i in rng.choice(
            CROSS_KEYS, CROSS_SAMPLE, replace=False)]
        sample += [f"y{i:07d}" for i in range(CROSS_FRESH)]
        for lid in (lid_tb, lid_sw):
            got = cli.acquire_block(lid, sample, [1] * len(sample),
                                    max_rows=batch_rows(4096,
                                                        CROSS_KEY_WIDTH))
            want = [oracles[lid].try_acquire(k, 1, CROSS_NOW).allowed
                    for k in sample]
            bad = sum(bool(a) != w for a, w in zip(got, want))
            check(bad == 0, f"cross-host (b): {bad} promoted answers of "
                  f"lid {lid} differ from the oracle")
        print(f"cross-host (b) ({card}): ready lines standby "
              f"{standby.ready_s:.3f} s, primary {primary.ready_s:.3f} s "
              f"(booted beside (a)); {CROSS_KEYS} keys a limiter and "
              f"{CROSS_AGAIN} of them again ({decisions} decisions, oracle "
              f"denials {denied}; BATCH frames of "
              f"{batch_rows(4096, CROSS_KEY_WIDTH)} rows from {CROSS_CONNS} "
              f"connections) in {wall:.3f} s = {decisions / wall:.1f} "
              f"decisions/s, every answer equal to the oracle; SHIP "
              f"{shipped} frames in {ship_s:.3f} s")
        print(f"cross-host (b) crash failover ({card}): SIGKILL of the "
              f"primary -> reaped {dead_ms:.1f} ms, "
              f"-> SUSPECT {ms['SUSPECT']:.1f} ms, -> FENCING "
              f"{ms['FENCING']:.1f} ms, -> PROMOTING {ms['PROMOTING']:.1f} "
              f"ms, -> promoted {ms['promoted']:.1f} ms (detection budget "
              f"{budget} ms, lease TTL {cfg.fence_lease_ttl_ms} ms + "
              f"{cfg.fence_wait_slack_ms} ms slack); the promotion RPC "
              f"{promote_s[-1] * 1000.0:.1f} ms; seen here "
              f"{(t_seen - t_kill) * 1000.0:.1f} ms; the promoted "
              f"sidecar's first answer {(t_first - t_kill) * 1000.0:.1f} "
              f"ms after the kill; {CROSS_SAMPLE} sampled preloaded keys "
              f"and {CROSS_FRESH} fresh ones a limiter equal to the oracle "
              f"(preload {time.perf_counter() - t_boot:.3f} s to here)")
    finally:
        orch.close()
        for c in clients:
            c.close()
    rc = standby.stop(timeout_s=CROSS_SETTLE_S)
    check(rc == 0, f"cross-host (b): standby exit code {rc}")
    got = standby.launches()
    check(got is not None, "cross-host (b): no launch line from the standby")
    check_launches(got["block_scatter"] > 0 and got["solver"] > 0,
                   f"cross-host (b): standby launches {got}")
    for k, v in got.items():
        totals[k] += v
    print(f"cross-host (b): the standby's launches {got} (the primary's "
          f"died with its SIGKILL)")


def poll_until(pred, what: str, timeout_s: float = CROSS_SETTLE_S) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    check(False, f"timed out waiting for {what}")


def phase_cross_host(rng, card: str) -> dict:
    """Phase 16, the cross-host topology: (a) the port's drill, with (b)'s
    two nodes booting beside it; (b) the full-width crash failover.
    Returns the node processes' kernel launches."""
    import concurrent.futures as cf

    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t_phase = time.perf_counter()
    cfg_tb, cfg_sw, spec = order_only_limiters()
    num_slots = service_props().get_int("storage.num_slots")
    nodes: list = []
    try:
        with cf.ThreadPoolExecutor(1) as pool:
            boot = pool.submit(boot_cross_pair, num_slots, spec, nodes)
            wall_a = cross_drill(card, totals)
            boot.result()
        t_b = time.perf_counter()
        cross_full_width(rng, card, nodes, totals, (cfg_tb, cfg_sw))
        wall_b = time.perf_counter() - t_b
    finally:
        for node in nodes:
            node.close()
    print(f"cross-host: phase 16 in {time.perf_counter() - t_phase:.3f} s "
          f"((a) {wall_a:.3f} s, (b) {wall_b:.3f} s); the node processes' "
          f"launches {totals}")
    return totals


# -- phase 17: the sharded engine --------------------------------------------
SHARDS = 4
SHARD_SLOTS = 1 << 20        # (a)'s slots in all: application.properties'
SHARD_SINGLE = 1200          # (a)'s single decisions
SHARD_BURSTS = 6             # (a)'s acquire_many bursts of BURST keys
SHARD_STEP_REPS = 20         # (a)'s staged 8192-lane steps timed a storage
SHARD_PASS = 1 << 22         # (b)'s headline passes (bench.py runs 2^24)
SHARD_CHECK = 1 << 19        # (b)'s headline decisions against the oracle
SHARD_UNIFORM = 1 << 20      # (b)'s uniform unit-permit stream (words mode)
SHARD_PERMITS = 1 << 21      # (b)'s permit-mix calls
SHARD_TENANTS = 64           # (b)'s lid array's tenants
SHARD_STRS = 1 << 20         # (b)'s string stream


def shard_devices():
    """Phase 17's ``SHARDS`` devices: the visible cards in turn, so every
    shard is on ``cuda:0`` when it is the only card."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", q % n) for q in range(SHARDS)]


def sharded_storage(num_slots: int, clock, register=True,
                    table_capacity: int = 64):
    """A ``GpuBatchedStorage`` over a ``SHARDS``-shard engine of
    ``num_slots`` slots in all on ``clock``; the trio's policies (lids
    1-3) registered unless ``register`` is False."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    devs = shard_devices()
    st = GpuBatchedStorage(
        engine=ShardedDeviceEngine(
            num_slots // SHARDS,
            LimiterTable(capacity=table_capacity, device=devs[0]),
            devices=devs),
        clock_ms=lambda: clock["t"])
    check(st._host_parallel == 0, "a sharded storage elected partitions")
    if register:
        for lid, (algo, cfg) in enumerate(TRIO.values(), start=1):
            check(st.register_limiter(algo, RateLimitConfig(**cfg)) == lid,
                  "limiter ids")
    return st


class ShardSteps:
    """While entered, counts the micro steps each shard of ``eng`` runs
    (the engine runs ``engine.engine._STEPS``' step on each shard's
    state; the wrapper tells the shards apart by their state tensors)."""

    def __init__(self, eng):
        from ratelimiter_tpu_torch.engine import engine as flat_engine

        self.eng, self.table = eng, flat_engine._STEPS
        self.orig = dict(self.table)
        self.per_shard = [0] * eng.n_shards

    def __enter__(self):
        def wrap(algo, fn):
            def run(packed, *args):
                for q, part in enumerate(self.eng._parts[algo]):
                    if part.data_ptr() == packed.data_ptr():
                        self.per_shard[q] += 1
                return fn(packed, *args)
            return run
        for algo, fn in self.orig.items():
            self.table[algo] = wrap(algo, fn)
        return self

    def __exit__(self, *exc):
        self.table.update(self.orig)


def shard_step_breakdown(storages, rng, card: str) -> None:
    """A staged 8192-lane token-bucket micro step of the burst limiter on
    each storage: host enqueue, device span, drain wait (medians of
    ``SHARD_STEP_REPS``), top-level torch ops a step, and the idle share
    of the card over the timed steps (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch.engine.engine import MICRO_STAGE_ROWS

    n = BURST
    for label, st in storages:
        eng = st.engine

        def staged():
            buf = np.empty((MICRO_STAGE_ROWS, n), dtype=np.int64)
            buf[0] = zipf_keys(rng, n)
            buf[1] = 3
            buf[2] = rng.integers(1, 101, n)
            buf[3, 0] = 1_760_700_000_000
            return buf

        host, span, drain = [], [], []
        for _ in range(SHARD_STEP_REPS):
            buf = staged()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            handle = eng.micro_staged_dispatch("tb", buf, n)
            end.record()
            t1 = time.perf_counter()
            eng.micro_staged_drain("tb", handle, n)
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            drain.append((t2 - t1) * 1e3)
            span.append(start.elapsed_time(end))
        buf = staged()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.micro_staged_drain("tb", eng.micro_staged_dispatch(
                "tb", buf, n), n)
        ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                  and not (e.cpu_parent is not None
                           and e.cpu_parent.name.startswith("aten::")))
        bufs = [staged() for _ in range(SHARD_STEP_REPS)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for buf in bufs:
                eng.micro_staged_drain("tb", eng.micro_staged_dispatch(
                    "tb", buf, n), n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(e.self_device_time_total for e in prof.key_averages())
        idle = (f"device work {busy_us / 1e3 / SHARD_STEP_REPS:.4f} ms a "
                f"step, idle share {1 - busy_us / 1e6 / wall:.6f}"
                if busy_us > 0 else "device time not measured (the "
                "profiler recorded none)")
        print(f"sharded micro step ({card}) {label}: tb {n} requests, host "
              f"enqueue {statistics.median(host):.4f} ms, device span "
              f"{statistics.median(span):.4f} ms, drain wait "
              f"{statistics.median(drain):.4f} ms (medians of "
              f"{SHARD_STEP_REPS}); {ops} top-level torch ops a step; "
              f"{idle}")


def sharded_micro(rng, card: str, totals: dict) -> None:
    """(a) The micro route: the trio's traffic on a ``SHARDS``-shard
    storage and on a flat one of the same slots, every decision equal to
    the other's and to the oracle; admin resets; each shard's steps."""
    clock = {"t": 1_760_700_000_000}
    sharded = sharded_storage(SHARD_SLOTS, clock)
    flat = dur_storage(SHARD_SLOTS, clock)
    try:
        eng = sharded.engine
        check(all(d.type == "cuda" for d in eng.devices),
              "a shard is not on the card")
        print(f"sharded micro ({card}): {eng.n_shards} shards of "
              f"{eng.slots_per_shard} slots on "
              f"{[str(d) for d in eng.devices]}; flat storage "
              f"host_parallel {flat._host_parallel}")
        calls = micro_plan(rng, SHARD_BURSTS, SHARD_SINGLE)
        before = dict(totals)
        t0 = time.perf_counter()
        with ShardSteps(eng) as steps:
            n = drive_micro([sharded, flat], calls, clock, trio_oracles(),
                            totals)
        wall = time.perf_counter() - t0
        micro = {k: totals[k] - before[k] for k in totals}

        def resets():
            for lid, (algo, _) in enumerate(TRIO.values(), start=1):
                for key in (f"user{k}" for k in range(3)):
                    sharded.reset_key(algo, lid, key)
        _, reset_counts = counted(totals, resets)
        for lid, (algo, _) in enumerate(TRIO.values(), start=1):
            for key in (f"user{k}" for k in range(3)):
                flat.reset_key(algo, lid, key)
        print(f"sharded micro ({card}): {n} decisions equal to the oracle "
              f"and to the flat storage's in {wall:.3f} s (both storages); "
              f"micro steps a shard {steps.per_shard}; the sharded "
              f"storage's launches {micro}, its 9 admin resets' "
              f"{reset_counts}")
        check_launches(min(steps.per_shard) > 0,
                       f"a shard ran no micro step: {steps.per_shard}")
        check_launches(micro["solver"] == sum(steps.per_shard)
                       == micro["tb_writeback"] + micro["sw_writeback"],
                       f"one solver and one write-back a shard's step: "
                       f"{micro}, steps {steps.per_shard}")
        check_launches(reset_counts["block_scatter"] > 0,
                       "the admin resets launched no row scatter")
        clock["t"] += 1_000
        n_after = drive_micro([sharded, flat], micro_plan(rng, 0, 60),
                              clock, trio_oracles(), totals)
        print(f"sharded micro ({card}): {n_after} decisions after the "
              "resets equal to the oracle")
        shard_step_breakdown([("4 shards", sharded), ("flat", flat)], rng,
                             card)
    finally:
        sharded.close()
        flat.close()


def sharded_streams(rng, card: str, headline: np.ndarray,
                    totals: dict) -> None:
    """(b) The stream routes at the headline deployment (2_000_128 slots,
    ``SHARDS`` shards): the relay's per-shard lanes on the headline's
    Zipf keys (digest) and on uniform keys (words mode), the flat step on
    every shard under scenario 5's permit mix, and a string stream; each
    call equal to a flat storage's, the headline's first checked call
    also to the oracle; timed headline passes with each shard's mode and
    lane drain time, and one under the profiler."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics import TokenBucketOracle

    clock = {"t": 1_760_800_000_000}
    sharded = sharded_storage(STREAM_SLOTS, clock, register=False,
                              table_capacity=128)
    flat = dur_storage(STREAM_SLOTS, clock, table_capacity=128)
    try:
        lid = sharded.register_limiter("tb", RateLimitConfig(**HEADLINE_TB))
        sw = sharded.register_limiter("sw", RateLimitConfig(**HEADLINE_SW))
        tenants = [sharded.register_limiter("tb", RateLimitConfig(**BURST_TB))
                   for _ in range(SHARD_TENANTS)]
        # The flat storage holds the trio at lids 1-3 first.
        lids = {}
        for name, cfgs in (("lid", [HEADLINE_TB]), ("sw", [HEADLINE_SW]),
                           ("tenants", [BURST_TB] * SHARD_TENANTS)):
            lids[name] = [flat.register_limiter(
                "sw" if name == "sw" else "tb", RateLimitConfig(**c))
                for c in cfgs]
        eng = sharded.engine
        print(f"sharded streams ({card}): {eng.n_shards} shards of "
              f"{eng.slots_per_shard} slots, rank_bits {eng.rank_bits}")

        def pair(label, calls):
            """Each (sharded call, flat call): decisions equal."""
            outs = []
            for s_call, f_call in calls:
                got = counted(totals, s_call)[0]
                want = f_call()
                bad = int((got != want).sum())
                check(bad == 0, f"sharded {label}: {bad} of {len(got)} "
                      "decisions differ from the flat storage's")
                outs.append(got)
            return outs

        # The headline's first call against the oracle too.
        ids = headline[:SHARD_CHECK]
        got, = pair("headline", [(
            lambda: sharded.acquire_stream_ids("tb", lid, ids),
            lambda: flat.acquire_stream_ids("tb", lids["lid"][0], ids))])
        oracle = TokenBucketOracle(RateLimitConfig(**HEADLINE_TB))
        want = np.fromiter((oracle.try_acquire(k, 1, clock["t"]).allowed
                            for k in ids.tolist()), dtype=bool,
                           count=len(ids))
        check(int((got != want).sum()) == 0,
              "sharded headline: decisions differ from the oracle")
        modes = {m for rec in sharded.last_stream_chunks
                 for m in rec["modes"] if m}
        check("digest" in modes, f"sharded headline modes {modes}")
        clock["t"] += 1_000
        uniform = rng.integers(0, STREAM_KEYS, SHARD_UNIFORM)
        pair("uniform sw", [(
            lambda: sharded.acquire_stream_ids("sw", sw, uniform),
            lambda: flat.acquire_stream_ids("sw", lids["sw"][0], uniform))])
        modes = {m for rec in sharded.last_stream_chunks
                 for m in rec["modes"] if m}
        check("words" in modes, f"sharded uniform modes {modes}")
        # Scenario 5's mix: uniform keys with permits (weighted on one
        # device), Zipf keys with permits (its flat fallback), and a
        # tenant lid array in 2^22-request super-batches (its scan); the
        # sharded storage runs the flat step on every shard for each.
        clock["t"] += 1_000
        perm = rng.integers(1, 101, SHARD_PERMITS)
        ukeys = rng.integers(0, STREAM_KEYS, SHARD_PERMITS)
        zkeys = headline[-SHARD_PERMITS:]
        tlid = np.asarray(tenants)[rng.integers(0, SHARD_TENANTS,
                                                SHARD_PERMITS)]
        flat_tlid = tlid - tenants[0] + lids["tenants"][0]
        kw = dict(batch=PERMIT_BATCH, subbatches=PERMIT_SUBBATCHES)
        pair("permit mix", [
            (lambda: sharded.acquire_stream_ids("tb", lid, ukeys, perm),
             lambda: flat.acquire_stream_ids("tb", lids["lid"][0], ukeys,
                                             perm)),
            (lambda: sharded.acquire_stream_ids("tb", lid, zkeys, perm),
             lambda: flat.acquire_stream_ids("tb", lids["lid"][0], zkeys,
                                             perm)),
            (lambda: sharded.acquire_stream_ids("tb", tlid, zkeys, perm,
                                                **kw),
             lambda: flat.acquire_stream_ids("tb", flat_tlid, zkeys, perm,
                                             **kw))])
        check({r["mode"] for r in sharded.last_stream_chunks} == {"flat"},
              "sharded permit mix: a chunk off the flat step")
        print(f"sharded permit mix ({card}): flat storage's last modes "
              f"{sorted({r['mode'] for r in flat.last_stream_chunks})}")
        clock["t"] += 1_000
        strs = [f"k{i}" for i in headline[:SHARD_STRS].tolist()]
        pair("strings", [(
            lambda: sharded.acquire_stream_strs("tb", lid, strs),
            lambda: flat.acquire_stream_strs("tb", lids["lid"][0], strs))])

        # Timed headline passes on the sharded storage alone.
        passes = [headline[SHARD_PASS * p:SHARD_PASS * (p + 1)]
                  for p in range(3)]
        rates = []
        for p, ids in enumerate(passes):
            clock["t"] += 1_000
            t0 = time.perf_counter()
            allowed, counts = counted(
                totals, lambda: sharded.acquire_stream_ids("tb", lid, ids))
            wall = time.perf_counter() - t0
            rates.append(SHARD_PASS / wall)
            print(f"sharded headline pass {p} ({card}): {SHARD_PASS} "
                  f"requests in {wall:.4f} s = {rates[-1]:.1f} decisions/s, "
                  f"{int(allowed.sum())} allowed; launches {counts}")
            for i, rec in enumerate(sharded.last_stream_chunks):
                print(f"  chunk {i}: requests {rec['requests']} uniques "
                      f"{rec['uniques']} route {rec['route_s'] * 1e3:.3f} ms"
                      f" slowest assign {rec['assign_s'] * 1e3:.3f} ms; per "
                      f"shard: requests {rec['shard_n']} modes "
                      f"{rec['modes']} lane drain ms "
                      f"{[round(x * 1e3, 3) for x in rec['shard_drain_s']]}")
        print(f"sharded headline ({card}): median "
              f"{statistics.median(rates):.1f} decisions/s over 3 passes of "
              f"{SHARD_PASS}")
        flat_rates = []
        for ids in passes:
            clock["t"] += 1_000
            t0 = time.perf_counter()
            flat.acquire_stream_ids("tb", lids["lid"][0], ids)
            torch.cuda.synchronize()
            flat_rates.append(SHARD_PASS / (time.perf_counter() - t0))
        print(f"flat headline, the same passes ({card}, host_parallel "
              f"{flat._host_parallel}): "
              + ", ".join(f"{r:.1f}" for r in flat_rates)
              + " decisions/s")
        clock["t"] += 1_000
        profiled_pass("sharded headline", card,
                      lambda: sharded.acquire_stream_ids("tb", lid,
                                                         passes[0]))
    finally:
        sharded.close()
        flat.close()


def sharded_app(card: str) -> None:
    """(c) ``build_app`` of ``application.properties`` as shipped
    (``parallel.shard=auto``): one visible card serves one engine; more
    than one shard the slot array over all of them, and ``GET /api/data``
    answers."""
    from ratelimiter_tpu_torch.service.props import AppProperties
    from ratelimiter_tpu_torch.service.wiring import build_app

    props = AppProperties.load("application.properties")
    check((props.get("parallel.shard") or "auto") == "auto",
          "application.properties no longer ships parallel.shard=auto")
    values = dict(props._values)
    values["server.port"] = "0"
    ctx = build_app(AppProperties(values))
    raw = ctx.storage
    while getattr(raw, "_inner", None) is not None:
        raw = raw._inner
    n = torch.cuda.device_count()
    sharded = hasattr(raw.engine, "n_shards")
    check(sharded == (n > 1), f"build_app on {n} visible card(s) built "
          f"a {'sharded' if sharded else 'flat'} engine")
    srv, thread, port = serve(ctx)
    try:
        status, body, _ = http_call(port, "GET", "/api/data",
                                    headers={"X-User-ID": "shard-check"})
        check(status == 200, f"GET /api/data answered {status}: {body}")
    finally:
        stop(srv, thread)
    print(f"sharded app ({card}): {n} visible card(s), build_app with "
          f"parallel.shard=auto built a {'sharded' if sharded else 'flat'} "
          f"engine ({raw.engine.num_slots} slots"
          + (f", {raw.engine.n_shards} shards" if sharded else "")
          + f"); GET /api/data {status}")


def phase_sharded(rng, card: str, headline: np.ndarray) -> dict:
    """Phase 17: the sharded engine.  Returns the kernel launch counts of
    its sharded storages' calls."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t0 = time.perf_counter()
    sharded_micro(rng, card, totals)
    sharded_streams(rng, card, headline, totals)
    sharded_app(card)
    check_launches(all(v > 0 for v in totals.values()),
                   f"phase 17 left a kernel unlaunched: {totals}")
    print(f"phase 17 ({card}): {time.perf_counter() - t0:.1f} s; launches "
          f"{totals}")
    return totals



# -- phase 18: sharded replication, the router and the orchestrator --------
SF_DEVICE = "cuda"          # the drills' standbys (and shards, on one card)
SF_SLOTS = 1 << 20          # (a)'s full width: application.properties'
SF_KEYS = 1 << 18           # (a)'s full-width key population
SF_STREAM = 1 << 18         # (a)'s Zipf requests a token-bucket wave
SF_BATCH = 4096             # (a)'s string keys a sliding-window batch
SF_APP_USERS = 64           # (d)'s users through the app
SF_DRILL_S = 60.0           # (a) at the defaults, (b), (c): wall bound
SF_FULL_S = 180.0           # (a) at full width: wall bound
SF_FIRST_ANSWER_MS = 5000.0  # (a): the kill to the first answer after it
SF_RESTORED_MS = 5000.0     # (b): the kill to MONITORING again, a cycle
SF_FLAP_MS = 5000.0         # (c): one flap cycle


def shard_drill_report(label: str, card: str, r: dict) -> None:
    """Print a shard failover drill's counts and its per-shard cuts."""
    print(f"shard failover drill {label} ({card}): {r['decisions']} "
          f"decisions, 0 mismatches, {r['frames']} frames, victim shard "
          f"{r['victim_shard']}, loss wave {r['loss_wave_decisions']} "
          f"({r['loss_wave_admitted']} admitted), window "
          f"{r['window_decisions']} decisions and {r['window_denied']} "
          f"denied; journal {r['journal_kind']}; standbys byte-equal after "
          f"{r['standby_checks']} cuts; bootstrap (every shard's full frame "
          f"cut, shipped, applied) {r['bootstrap_ms']:.3f} ms; promotion "
          f"{r['promote_ms']:.3f} ms; kill to the first answer after it "
          f"{r['kill_to_first_answer_ms']:.3f} ms; wall {r['wall_s']:.3f} s")
    for i, cycle in enumerate(r["cuts"]):
        parts = []
        for c in cycle:
            if "cut_ms" not in c:
                parts.append(f"s{c['shard']} none")
                continue
            share = c["index_ms"] / c["cut_ms"] if c["cut_ms"] else 0.0
            parts.append(
                f"s{c['shard']} {'full' if c['full'] else 'delta'} "
                f"{c['rows']} rows {c['cut_ms']:.3f} ms (rows "
                f"{c['rows_ms']:.3f}, index {c['index_ms']:.3f}: "
                f"{share:.3f})")
        print(f"  cut cycle {i}: " + "; ".join(parts))


def shard_drills(card: str, totals: dict) -> None:
    """(a) ``shard_failover_drill`` at the reference's defaults and at the
    shipped width; (b) ``orchestrated_failover_drill``; (c)
    ``orchestrator_flap_drill``: the shards on ``shard_devices()``, the
    standbys on the card, every decision against the oracle, every
    standby byte-equal to its shard after each cut, wall times bounded."""
    from ratelimiter_tpu_torch.storage import chaos

    devs = shard_devices()
    for label, kw, bound_s in (
            ("at the reference's defaults", {}, SF_DRILL_S),
            (f"at {SF_SLOTS} slots, {SF_KEYS} keys",
             dict(slots_per_shard=SF_SLOTS // SHARDS, n_keys=SF_KEYS,
                  kill_after_wave=2, post_waves=1, stream_n=SF_STREAM,
                  batch=SF_BATCH), SF_FULL_S)):
        r, counts = counted(totals, lambda: chaos.shard_failover_drill(
            device=SF_DEVICE, devices=devs, **kw))
        check(r["mismatches"] == 0 and r["decisions"] > 0,
              f"shard drill {label}: {r['mismatches']} mismatches")
        check(r["standby_checks"] == len(r["cuts"]) > 0,
              f"shard drill {label}: standby checks {r['standby_checks']}")
        check(all(c.get("full") for c in r["cuts"][0]),
              f"shard drill {label}: the first cut was not full")
        check(r["wall_s"] <= bound_s, f"shard drill {label}: "
              f"{r['wall_s']:.1f} s past {bound_s} s")
        check(r["kill_to_first_answer_ms"] <= SF_FIRST_ANSWER_MS,
              f"shard drill {label}: first answer "
              f"{r['kill_to_first_answer_ms']:.1f} ms after the kill")
        shard_drill_report(label, card, r)
        print(f"  launches {counts}")
        check_launches(counts["block_scatter"] > 0 and counts["solver"] > 0
                       and counts["relay_step"] > 0,
                       f"shard drill {label}: launches {counts}")
    r, counts = counted(totals, lambda: chaos.orchestrated_failover_drill(
        device=SF_DEVICE, devices=devs, cycles=2))
    check(r["mismatches"] == 0 and r["promotions"] == r["reseeds"] == 2
          and r["false_alarms"] == 0,
          f"orchestrated drill: {r['mismatches']} mismatches, promotions "
          f"{r['promotions']}, re-seeds {r['reseeds']}")
    check(r["wall_s"] <= SF_DRILL_S,
          f"orchestrated drill: {r['wall_s']:.1f} s past {SF_DRILL_S} s")
    slow = [c["kill_to_restored_ms"] for c in r["cycles"]
            if c["kill_to_restored_ms"] > SF_RESTORED_MS]
    check(not slow, f"orchestrated drill: kill to MONITORING {slow} ms")
    print(f"orchestrated failover drill ({card}): {r['decisions']} "
          f"decisions, 0 mismatches, {r['frames']} frames, promotions "
          f"{r['promotions']}, re-seeds {r['reseeds']}, fence rejected "
          f"{r['fence_rejected']}; cycles "
          + "; ".join(f"victim {c['victim']} detection {c['detection_ms']} "
                      f"ms simulated, kill to MONITORING "
                      f"{c['kill_to_restored_ms']:.3f} ms wall"
                      for c in r["cycles"])
          + f"; wall {r['wall_s']:.3f} s; launches {counts}")
    r, counts = counted(totals, lambda: chaos.orchestrator_flap_drill(
        device=SF_DEVICE, devices=devs[:2]))
    check(r["mismatches"] == 0 and r["promotions"] == 0
          and r["false_alarms"] == 3,
          f"flap drill: {r['mismatches']} mismatches, promotions "
          f"{r['promotions']}, false alarms {r['false_alarms']}")
    check(r["wall_s"] <= SF_DRILL_S and max(r["flap_ms"]) <= SF_FLAP_MS,
          f"flap drill: {r['wall_s']:.1f} s, flaps {r['flap_ms']} ms")
    print(f"orchestrator flap drill ({card}): {r['decisions']} decisions, "
          f"0 mismatches, false alarms {r['false_alarms']}, promotions 0, "
          f"fence rejected {r['fence_rejected']}; flap cycles "
          f"{[round(x, 3) for x in r['flap_ms']]} ms; wall "
          f"{r['wall_s']:.3f} s; launches {counts}")


def negative_tb_permits(card: str) -> None:
    """ROADMAP C11: a negative token-bucket permit is refused with
    ``ValueError`` on the card's storage (flat and sharded, on every tb
    permit surface) as on a ``device="cpu"`` one, with no state touched;
    permit 0 decides alike on both."""
    clock = {"t": 1_762_100_000_000}
    stores = {"card": dur_storage(1 << 16, clock),
              "cpu": dur_storage(1 << 16, clock, device="cpu"),
              "card, 4 shards": sharded_storage(1 << 16, clock)}
    tb = 3  # the trio's burst bucket
    keys = np.arange(64, dtype=np.int64)
    perms = np.ones(64, dtype=np.int64)
    perms[17] = -3
    strs = [f"n{k}" for k in keys.tolist()]
    calls = {
        "acquire_stream_ids": lambda st: st.acquire_stream_ids(
            "tb", tb, keys, perms),
        "acquire_stream_ids (lid array)": lambda st: st.acquire_stream_ids(
            "tb", np.full(64, tb), keys, perms),
        "acquire_stream_strs": lambda st: st.acquire_stream_strs(
            "tb", tb, strs, perms),
        "acquire_many_ids": lambda st: st.acquire_many_ids(
            "tb", tb, keys, perms),
        "acquire_many": lambda st: st.acquire_many(
            "tb", [tb] * 64, strs, perms.tolist()),
        "acquire_async_many": lambda st: st.acquire_async_many(
            "tb", tb, strs, perms),
        "acquire": lambda st: st.acquire("tb", tb, "n1", -1),
    }
    try:
        zero = np.zeros(64, dtype=np.int64)
        for st in stores.values():
            st.acquire_stream_ids("tb", tb, keys, np.full(64, 2))
        got = {name: st.acquire_stream_ids("tb", tb, keys, zero)
               for name, st in stores.items()}
        check(all(np.array_equal(g, got["cpu"]) for g in got.values()),
              "permit 0: the card's decisions differ from the CPU's")
        for name, st in stores.items():
            before = {a: st.engine.packed_host(a)
                      if hasattr(st.engine, "packed_host")
                      else getattr(st.engine, f"{a}_packed").cpu().numpy()
                      for a in ("sw", "tb")}
            for surface, call in calls.items():
                try:
                    call(st)
                except ValueError as exc:
                    check("negative token-bucket" in str(exc),
                          f"C11 {name} {surface}: {exc}")
                else:
                    raise RuntimeError(f"chip smoke check failed: C11 "
                                       f"{name} {surface} took a negative "
                                       "token-bucket permit")
            st.flush()
            for a in ("sw", "tb"):
                after = (st.engine.packed_host(a)
                         if hasattr(st.engine, "packed_host")
                         else getattr(st.engine, f"{a}_packed").cpu().numpy())
                check(np.array_equal(before[a], after), f"C11 {name}: a "
                      f"refused call changed the {a} rows")
        print(f"negative token-bucket permits ({card}): {len(calls)} "
              f"surfaces each raised ValueError on the card's flat and "
              f"sharded storages as on the CPU's, rows unchanged; permit 0 "
              f"decided alike on all three")
    finally:
        for st in stores.values():
            st.close()


def orchestrated_app(card: str, totals: dict) -> None:
    """(d) ``build_app`` with ``ratelimiter.orchestrator.enabled=true`` over
    ``service/wiring.py:sharded_engine`` on ``shard_devices()``: the
    actuator answers; a shard whose standby never bootstrapped fails
    closed (FAILED, health DOWN) and ``POST
    /actuator/orchestrator/unfence`` recovers it; after a cut a failed
    shard reads DEGRADED (the breaker lists it), the orchestrator
    promotes its standby, and users' requests are answered throughout."""
    from ratelimiter_tpu_torch.service import wiring
    from ratelimiter_tpu_torch.service.props import AppProperties
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    real = wiring.build_storage

    def sharded_build(props, meter_registry=None, device=None):
        # service_props turns sharding off on a host of several cards
        # (phases 11-15 check one card's engine); this app shards.
        values = dict(props._values, **{"parallel.shard": "auto"})
        eng = wiring.sharded_engine(AppProperties(values), shard_devices())
        check(eng is not None, "sharded_engine built no sharded engine")
        return GpuBatchedStorage(engine=eng, meter_registry=meter_registry)

    wiring.build_storage = sharded_build
    try:
        ctx = wiring.build_app(service_props(**{
            "server.port": "0",
            "ratelimiter.orchestrator.enabled": "true",
            "ratelimiter.orchestrator.probe_interval_ms": "600000",
            "ratelimiter.orchestrator.suspect_threshold": "1",
            "ratelimiter.orchestrator.hysteresis_ms": "0",
            "ratelimiter.orchestrator.promote_retries": "0",
            "replication.interval_ms": "600000"}))
    finally:
        wiring.build_storage = real
    srv, thread, port = serve(ctx)
    t0 = time.perf_counter()
    try:
        check(ctx.orchestrator is not None, "build_app built no orchestrator")
        handle = ctx.orchestrator
        orch, router = handle.orchestrator, handle.router
        check(ctx.breaker._inner is router,
              "the breaker does not wrap the router")
        check(all(st.engine.device.type == "cuda"
                  for st in handle.standby_set.storages),
              "a standby is not on the card")

        def users(tag):
            """A user's GET /api/data (the api window) and POST /api/batch
            of 2 (the burst bucket), each answered 200."""
            for i in range(SF_APP_USERS):
                for method, path, body in (("GET", "/api/data", None),
                                           ("POST", "/api/batch",
                                            {"size": 2})):
                    status, out, _ = http_call(
                        port, method, path, body,
                        headers={"X-User-ID": f"{tag}{i}"})
                    check(status == 200, f"{method} {path} {status}: {out}")

        def health():
            return http_call(port, "GET", "/actuator/health")[:2]

        status, body, _ = http_call(port, "GET", "/actuator/orchestrator")
        check(status == 200 and body["enabled"] is True
              and set(body["router"]) == {str(q) for q in range(SHARDS)},
              f"GET /actuator/orchestrator {status}: {body}")
        _, counts = counted(totals, lambda: users("orch"))
        # Shard 1 dies before any cut: no standby can serve it.
        router.fail_shard(1)
        orch.tick()
        orch.tick()
        check(orch.status()["shards"][1]["state"] == "FAILED",
              f"shard 1 is {orch.status()['shards'][1]['state']}")
        status, body = health()
        check(status == 503 and body["status"] == "DOWN"
              and body["orchestrator"]["failed_shards"] == [1],
              f"health with a FAILED shard: {status} {body}")
        status, body, _ = http_call(port, "POST",
                                    "/actuator/orchestrator/unfence",
                                    {"shard": 1})
        check(status == 200 and body["state"] == "MONITORING",
              f"unfence {status}: {body}")
        status, body = health()
        check(status == 200 and body["status"] == "UP",
              f"health after unfence: {status} {body}")
        # A cut bootstraps every standby; then shard 2 dies.
        _, c2 = counted(totals, lambda: (users("after"),
                                         handle.replicator.ship_now()))
        router.fail_shard(2)
        status, body = health()
        check(status == 200 and body["status"] == "DEGRADED"
              and body["breaker"]["degraded_shards"] == ["2"],
              f"health with shard 2 failed: {status} {body}")
        _, c3 = counted(totals, lambda: (orch.tick(), orch.tick(),
                                         orch.tick(), users("promoted")))
        check(orch.status()["shards"][2]["state"] == "MONITORING"
              and orch.promotions == 1
              and router.shard_health()[2] == "promoted",
              f"shard 2 after the ticks: {orch.status()['shards'][2]}")
        check(router.replacements[2].engine.device.type == "cuda",
              "the promoted standby is not on the card")
        status, body = health()
        check(status == 200 and body["status"] == "DEGRADED",
              f"health with shard 2 promoted: {status} {body}")
        print(f"orchestrated app ({card}): {SHARDS} shards on "
              f"{[str(d) for d in shard_devices()]}, standbys on the card; "
              f"/actuator/orchestrator answered; shard 1 FAILED (health "
              f"503 DOWN) and unfenced (UP); shard 2 failed (DEGRADED, the "
              f"breaker lists it), promoted by the orchestrator; "
              f"{3 * SF_APP_USERS} users' GET /api/data and POST "
              f"/api/batch answered 200 in "
              f"{time.perf_counter() - t0:.3f} s; launches {counts}, "
              f"{c2}, {c3}")
    finally:
        stop(srv, thread)


def phase_shard_failover(card: str) -> dict:
    """Phase 18: sharded replication, the shard failover router and the
    in-process orchestrator on the card, and C11's refusal.  Returns the
    kernel launch counts of its drills and app."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t0 = time.perf_counter()
    negative_tb_permits(card)
    shard_drills(card, totals)
    orchestrated_app(card, totals)
    check_launches(all(v > 0 for v in totals.values()),
                   f"phase 18 left a kernel unlaunched: {totals}")
    print(f"phase 18 ({card}): {time.perf_counter() - t0:.1f} s; launches "
          f"{totals}")
    return totals


# -- phase 19: adaptive control and leases under failover ------------------
CTL_LEASE_SLOTS = 1 << 20    # (a)'s full width: application.properties'
CTL_LEASE_KEYS = 1024        # (a)'s leased keys an algorithm at full width
CTL_LEASE_BURNS = 12 * 1024  # 12 burns a key: 4 of 16 permits left at the kill
CTL_LEASE_TTL_MS = 60_000.0  # a key's 12 burns span 11 s of the drill's clock
CTL_DRILL_S = 60.0           # (a) at the defaults, (b): wall bound
CTL_FULL_S = 180.0           # (a) at full width: wall bound
CTL_STREAM = 1 << 17         # (d)'s Zipf unit-permit requests a side of the cut
CTL_STREAM_KEYS = 1 << 16
CTL_BURSTS = 4               # (d)'s micro bursts of CTL_BURST lanes a side
CTL_BURST = 2048
CTL_STORM = 30               # (d)'s logins of one user (20 denied)
CTL_HOT = 16                 # (d)'s storm keys, outside the Zipf keys
CTL_HOT_REQUESTS = 1 << 18   # (d)'s storm requests over them
CTL_TTL_MS = 500.0           # (e)'s controller lease
CTL_SEATS = 3


def lease_drills(card: str, totals: dict) -> None:
    """(a) ``lease_failover_drill`` at the reference's defaults and at the
    shipped 2^20 slots (4 shards of 2^18) with ``CTL_LEASE_KEYS`` leased
    keys an algorithm; (b) ``aggregator_failover_drill`` at the defaults.
    The shards on ``shard_devices()``, the standbys on the card: every
    reserve and credit a lease step on the card, the over-admission equal
    to the burns on revoked leases, the reserve / credit log replayed
    bit-identically against the oracle, wall times bounded."""
    from ratelimiter_tpu_torch.storage import chaos

    devs = shard_devices()
    for label, kw, bound_s in (
            ("at the reference's defaults", {}, CTL_DRILL_S),
            (f"at {CTL_LEASE_SLOTS} slots, {CTL_LEASE_KEYS} keys",
             dict(slots_per_shard=CTL_LEASE_SLOTS // SHARDS,
                  n_keys=CTL_LEASE_KEYS, burns=CTL_LEASE_BURNS,
                  lease_ttl_ms=CTL_LEASE_TTL_MS),
             CTL_FULL_S)):
        r, counts = counted(totals, lambda: chaos.lease_failover_drill(
            device=SF_DEVICE, devices=devs, **kw))
        check(r["promotions"] == 1 and r["revoked"] > 0
              and r["frames_per_decision"] <= 0.1,
              f"lease drill {label}: {r['promotions']} promotions, "
              f"{r['revoked']} revoked, {r['frames_per_decision']} frames "
              f"a decision")
        check(r["wall_s"] <= bound_s,
              f"lease drill {label}: {r['wall_s']:.1f} s past {bound_s} s")
        check_launches(counts["block_scatter"] > 0,
                       f"lease drill {label}: launches {counts}")
        print(f"lease failover drill {label} ({card}): {r['decisions']} "
              f"decisions, {r['wire_ops_healthy']} frames while healthy "
              f"({r['frames_per_decision']:.5f} a decision), stranded "
              f"{r['stranded_budget']}, burned after the fence "
              f"{r['burned_after_fence']}, revoked {r['revoked']}, "
              f"over-admission {r['over_admission']} (the burns on revoked "
              f"leases), survivor renewals {r['survivor_renewals']}, victim "
              f"shard {r['victim']}, fence epoch {r['fence_epoch']}; "
              f"{r['replayed_ops']} reserve / credit ops replayed against "
              f"the oracle, {r['reconciled_keys']} keys reconciled; wall "
              f"{r['wall_s']:.3f} s; launches {counts}")
    r, counts = counted(totals, lambda: chaos.aggregator_failover_drill(
        device=SF_DEVICE, devices=devs))
    check(r["promotions"] == 1 and 0 < r["scoped_revocations"] < 12,
          f"aggregator drill: {r['promotions']} promotions, "
          f"{r['scoped_revocations']} scoped revocations")
    check(r["wall_s"] <= CTL_DRILL_S,
          f"aggregator drill: {r['wall_s']:.1f} s past {CTL_DRILL_S} s")
    check_launches(counts["block_scatter"] > 0,
                   f"aggregator drill: launches {counts}")
    print(f"aggregator failover drill ({card}): {r['decisions']} decisions, "
          f"{r['wire_frames_healthy']} upstream frames while healthy "
          f"({r['frames_per_decision']:.5f} a decision), burned after the "
          f"aggregator's death {r['burned_after_death']} of "
          f"{r['exposure']['sliced_out']} sliced out, scoped revocations "
          f"{r['scoped_revocations']}, over-admission {r['over_admission']}, "
          f"fence epoch {r['fence_epoch']}; {r['replayed_ops']} ops "
          f"replayed; wall {r['wall_s']:.3f} s; launches {counts}")


def overload_on_host(card: str) -> None:
    """(c) ``overload_drill`` at the reference's fast arguments on the
    card's host (a synthetic device; no kernel): the queue bound, typed
    sheds, the admitted p99 within the deadline plus a dispatch cycle
    (asserted inside the drill)."""
    from ratelimiter_tpu_torch.storage import chaos

    r = chaos.overload_drill(load_multipliers=(0.8, 2.0), bursts=25)
    under, two_x = r["runs"]
    check(under["goodput_frac"] > 0.9 and two_x["shed_frac"] > 0.2
          and two_x["max_depth_seen"] <= 256,
          f"overload drill: {r['runs']}")
    print(f"overload drill ({card}, host only): capacity "
          f"{r['capacity_rps']:.0f} requests/s; " + "; ".join(
              f"{run['multiplier']}x: offered {run['offered']}, admitted "
              f"{run['admitted']}, shed {run['shed']}, deadline "
              f"{run['deadline_expired']}, max depth {run['max_depth_seen']},"
              f" admitted p99 {run['p99_ms']:.3f} ms" for run in r["runs"]))


def policy_oracles(info: dict) -> dict:
    """An oracle a limiter id, built from ``policy_info`` rows."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.semantics.oracle import (
        SlidingWindowOracle,
        TokenBucketOracle,
    )

    out = {}
    for lid, row in info["lids"].items():
        cfg = RateLimitConfig(max_permits=row["max_permits"],
                              window_ms=row["window_ms"],
                              refill_rate=row["refill_rate"])
        out[int(lid)] = (SlidingWindowOracle(cfg) if row["algo"] == "sw"
                         else TokenBucketOracle(cfg))
    return out


def free_tcp_port() -> int:
    """A free loopback TCP port (bound, read, released)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def control_app(rng, card: str, totals: dict) -> None:
    """(d) ``build_app`` of ``application.properties`` with
    ``ratelimiter.control.enabled``, ``ratelimiter.control.fleet.enabled``
    and a free ``ratelimiter.control.port`` on a manual clock (the
    controller's and the election's cadence threads parked; both ticked
    here): the fleet plane elects over the app's own control port; a
    unit-permit Zipf stream through ``acquire_stream_ids`` and micro
    bursts of the auth and burst limiters, then one user's storm of
    logins; a controller tick cuts the auth limiter at generation 1,
    broadcast over the control wire; the same traffic after the cut; every
    decision on both sides equal to the oracle rebuilt from ``policy_info``
    rows (the previous side's state carried); the pin over HTTP; ``GET
    /actuator/controller`` and the health blocks."""
    import functools

    from ratelimiter_tpu_torch.service import wiring
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_762_200_000_000}
    real = wiring.GpuBatchedStorage
    wiring.GpuBatchedStorage = functools.partial(
        GpuBatchedStorage, clock_ms=lambda: clock["t"])
    try:
        ctx = wiring.build_app(service_props(**{
            "server.port": "0",
            "ratelimiter.control.enabled": "true",
            "ratelimiter.control.interval_ms": "600000",
            "ratelimiter.control.fleet.enabled": "true",
            "ratelimiter.control.fleet.node": "ctrl-app",
            "ratelimiter.control.fleet.interval_ms": "600000",
            "ratelimiter.control.port": str(free_tcp_port())}))
    finally:
        wiring.GpuBatchedStorage = real
    srv, thread, port = serve(ctx)
    try:
        raw = ctx.storage._inner._inner
        fc, ctl = ctx.fleet_control, ctx.controller
        check(raw.device.type == "cuda", "control app: the storage is not "
              "on the card")
        check(fc is not None and ctl is not None and ctl.storage is fc.plane,
              "build_app: the controller is not over the fleet plane")
        t0 = time.perf_counter()
        fc.election.tick()
        elect_ms = (time.perf_counter() - t0) * 1000.0
        plane = fc.plane
        check(plane.is_leader and plane.epoch == 1
              and set(plane._configs) == {1, 2, 3},
              f"the plane did not elect over the app's control port: "
              f"{plane.fleet_status()}")
        info = raw.policy_info()
        oracles = policy_oracles(info)
        auth, burst = 2, 3
        keys = zipf_stream(rng, CTL_STREAM_KEYS, 2 * CTL_STREAM)

        def side(tag, stream):
            """The stream and the micro bursts at this clock, against the
            oracles; returns (decisions, denied)."""
            now = clock["t"]
            n = denied = 0
            got = np.asarray(ctx.storage.acquire_stream_ids(
                "sw", auth, stream))
            want = np.fromiter(
                (oracles[auth].try_acquire(int(k), 1, now).allowed
                 for k in stream.tolist()), dtype=bool, count=len(stream))
            check(np.array_equal(got, want),
                  f"control app {tag}: {int((got != want).sum())} stream "
                  f"decisions differ from the oracle")
            n += len(stream)
            denied += int((~got).sum())
            for b in range(CTL_BURSTS):
                for lid, algo, permits in ((auth, "sw", 1), (burst, "tb", 2)):
                    ks = [f"{tag}-{lid}-{i % 512}" for i in range(
                        b * CTL_BURST, (b + 1) * CTL_BURST)]
                    out = ctx.storage.acquire_many(
                        algo, [lid] * CTL_BURST, ks, [permits] * CTL_BURST)
                    want = [oracles[lid].try_acquire(k, permits, now).allowed
                            for k in ks]
                    check(out["allowed"].tolist() == want,
                          f"control app {tag}: lid {lid} burst {b} differs "
                          f"from the oracle")
                    n += CTL_BURST
                    denied += CTL_BURST - int(out["allowed"].sum())
            return n, denied

        before, c1 = counted(totals, lambda: side("before", keys[:CTL_STREAM]))
        # The storm: a stream on a few hot keys, then one user's logins.
        hot = CTL_STREAM_KEYS + rng.integers(0, CTL_HOT, CTL_HOT_REQUESTS)
        got = np.asarray(ctx.storage.acquire_stream_ids("sw", auth, hot))
        want = [oracles[auth].try_acquire(int(k), 1, clock["t"]).allowed
                for k in hot.tolist()]
        check(got.tolist() == want, "control app: the storm's decisions "
              "differ from the oracle")
        for _ in range(CTL_STORM):
            status, _, _ = http_call(port, "POST", "/api/login",
                                     {"username": "storm"})
            check(status in (200, 429), f"login {status}")
            oracles[auth].try_acquire("storm", 1, clock["t"])
        t0 = time.perf_counter()
        ctl.tick()
        tick_ms = (time.perf_counter() - t0) * 1000.0
        info = raw.policy_info()
        row = info["lids"][auth]
        check(info["generation"] == 1 and row["generation"] == 1
              and row["max_permits"] < 10
              and info["lids"][burst]["generation"] == 0
              and plane.last_broadcast_generation == 1
              and plane.node_generations == {plane.members_snapshot()[0][0]:
                                             1},
              f"no cut at generation 1: {info}, {plane.fleet_status()}")
        for lid, oracle in policy_oracles(info).items():
            oracles[lid].reconfigure(oracle.config)
        clock["t"] += 1500
        after, c2 = counted(totals, lambda: side("after", keys[CTL_STREAM:]))
        status, out, _ = http_call(port, "POST",
                                   f"/actuator/policies/{auth}/pin")
        check(status == 200 and out == {"lid": auth, "pinned": True},
              f"pin {status}: {out}")
        status, body, _ = http_call(port, "GET", "/actuator/controller")
        check(status == 200 and body["is_leader"] and body["epoch"] == 1
              and body["last_broadcast_generation"] == 1
              and body["lagging_nodes"] == []
              and all(v["generation"] == 1 for v in body["nodes"].values()),
              f"GET /actuator/controller {status}: {body}")
        status, health, _ = http_call(port, "GET", "/actuator/health")
        check(status == 200 and health["status"] == "UP"
              and health["control"]["generation"] == 1
              and health["control"]["pinned"] == [auth]
              and health["controller"]["is_leader"]
              and health["controller"]["lagging_nodes"] == [],
              f"health {status}: {health}")
        st = ctl.status()["lids"][str(auth)]
        print(f"control app ({card}): build_app with ratelimiter.control.* "
              f"and fleet control over its own control port; election "
              f"{elect_ms:.3f} ms (epoch 1, lids {sorted(plane._configs)}); "
              f"before the cut {before[0]} decisions ({before[1]} denied), "
              f"a storm of {CTL_HOT_REQUESTS} requests on {CTL_HOT} keys "
              f"({int(got.sum())} admitted) and {CTL_STORM} logins of one "
              f"user; the tick (signals over the "
              f"control wire, AIMD, one broadcast) {tick_ms:.3f} ms cut auth "
              f"to {row['max_permits']} permits (fraction {st['fraction']}) "
              f"at generation 1; after it {after[0]} decisions ({after[1]} "
              f"denied); every decision equal to the oracle rebuilt from "
              f"policy_info rows; pinned over HTTP; /actuator/controller and "
              f"the health control / controller blocks answered; launches "
              f"{c1}, {c2}")
    finally:
        stop(srv, thread)


def policy_bytes(st) -> bytes:
    """The storage's policy rows on the card, as bytes."""
    arrays = st.table.device_arrays
    return b"".join(t.cpu().numpy().tobytes() for t in arrays)


def controller_failover(card: str) -> None:
    """(e) ``CTL_SEATS`` port storages on the card, each serving the
    control RPC (``controller_handlers`` behind a ``ControlServer``), and
    two candidate planes, ``ctrl-a`` and ``ctrl-b``, over ``RemoteBackend``
    clients: ``ctrl-a`` claims the cell at epoch 1 and its cut lands on
    every seat at one generation; once ``ctrl-a`` stops renewing, its seat
    grants expire after ``CTL_TTL_MS`` and ``ctrl-b`` claims epoch 2 and
    converges every seat; ``ctrl-a``'s stale-epoch writes are refused and
    move no byte of any seat's policy rows on the card."""
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.control import FleetControlPlane, NotLeader
    from ratelimiter_tpu_torch.replication.control import (
        ControlClient,
        ControlServer,
        controller_handlers,
    )
    from ratelimiter_tpu_torch.replication.remote import RemoteBackend

    clock = {"t": 1_762_300_000_000}
    storages, servers, planes = [], [], []
    try:
        for _ in range(CTL_SEATS):
            st = dur_storage(1 << 16, clock)
            check(st.device.type == "cuda", "a seat is not on the card")
            storages.append(st)
            servers.append(ControlServer(controller_handlers(st),
                                         port=0).start())

        def plane(node):
            p = FleetControlPlane(node, {
                f"seat{i}": RemoteBackend(ControlClient(
                    "127.0.0.1", srv.port, timeout=5.0))
                for i, srv in enumerate(servers)}, ttl_ms=CTL_TTL_MS)
            planes.append(p)
            return p

        a, b = plane("ctrl-a"), plane("ctrl-b")
        t0 = time.perf_counter()
        check(a.elect() and a.epoch == 1, "ctrl-a did not elect")
        claim_ms = (time.perf_counter() - t0) * 1000.0
        t0 = time.perf_counter()
        gen = a.set_policy(3, RateLimitConfig(max_permits=20,
                                              window_ms=60_000,
                                              refill_rate=4.0))
        broadcast_ms = (time.perf_counter() - t0) * 1000.0
        infos = [st.policy_info() for st in storages]
        check(gen == 1 and {i["generation"] for i in infos} == {1}
              and all(i["lids"] == infos[0]["lids"] for i in infos)
              and infos[0]["lids"][3]["max_permits"] == 20,
              f"ctrl-a's cut did not land on every seat: {infos}")
        t0 = time.perf_counter()
        check(a.renew(), "ctrl-a's renewal")
        renewed = time.perf_counter()
        renew_ms = (renewed - t0) * 1000.0
        # ctrl-a stops renewing.  ctrl-b claims once a majority of seats
        # report the grant expired.
        seats = [m for _, m in b.members_snapshot()]
        while sum(bool(m.policy_info()["controller"]["expired"])
                  for m in seats) < CTL_SEATS // 2 + 1:
            check(time.perf_counter() - renewed < 30.0,
                  "ctrl-a's seat grants never expired")
            time.sleep(0.01)
        check(b.elect() and b.epoch == 2, "ctrl-b did not elect")
        failover_ms = (time.perf_counter() - renewed) * 1000.0
        check(failover_ms >= CTL_TTL_MS,
              f"ctrl-b seated {failover_ms:.1f} ms after the last renewal")
        check(b.converged() and set(b.node_generations.values()) == {1},
              f"ctrl-b did not converge the seats: {b.node_generations}")
        # ctrl-a's own clock passes its TTL too (its claim round ended
        # after the seats granted it): it demotes itself.
        while a.self_check():
            check(time.perf_counter() - renewed < 30.0,
                  "ctrl-a never demoted itself")
            time.sleep(0.001)
        before = [policy_bytes(st) for st in storages]
        row = {"3": {"algo": "tb", "max_permits": 5, "window_ms": 60_000,
                     "refill_rate": 1.0, "gen": 9}}
        for _, m in a.members_snapshot():
            resp = m.set_policy_rows(row, 1, "ctrl-a")
            check(resp["stale_epoch"] and not resp["applied"],
                  f"a stale-epoch write was not refused: {resp}")
        try:
            a.set_policy(3, RateLimitConfig(max_permits=5, window_ms=60_000,
                                            refill_rate=1.0))
        except NotLeader:
            pass
        else:
            raise RuntimeError("chip smoke check failed: ctrl-a actuated "
                               "after its lease expired")
        check([policy_bytes(st) for st in storages] == before,
              "a stale-epoch write moved a policy row on the card")
        status = b.fleet_status()
        check(status["stale_rejected"] == CTL_SEATS
              and b.set_policy(3, RateLimitConfig(
                  max_permits=30, window_ms=60_000, refill_rate=6.0)) == 2
              and {st.policy_info()["generation"] for st in storages}
              == {2}, f"ctrl-b's status {status}")
        print(f"controller failover ({card}): {CTL_SEATS} seats on the card "
              f"over loopback control ports; ctrl-a's claim (epoch 1) "
              f"{claim_ms:.3f} ms, its cut's broadcast round trip "
              f"{broadcast_ms:.3f} ms (every seat at generation 1, rows "
              f"equal), a renewal {renew_ms:.3f} ms; ctrl-a stopped "
              f"renewing and ctrl-b was seated at epoch 2 and converged "
              f"every seat {failover_ms:.3f} ms after its last renewal (TTL "
              f"{CTL_TTL_MS:.0f} ms); ctrl-a's {CTL_SEATS} stale-epoch writes "
              f"refused (stale_rejected {status['stale_rejected']}), the "
              f"policy rows on the card byte-equal; ctrl-b's next cut at "
              f"generation 2 on every seat")
    finally:
        for p in planes:
            p.close()
        for srv in servers:
            srv.stop()
        for st in storages:
            st.close()


def phase_adaptive_control(rng, card: str) -> dict:
    """Phase 19: adaptive control and leases under failover.  Returns the
    kernel launch counts of its drills and app."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t0 = time.perf_counter()
    lease_drills(card, totals)
    overload_on_host(card)
    control_app(rng, card, totals)
    controller_failover(card)
    check_launches(all(v > 0 for v in totals.values()),
                   f"phase 19 left a kernel unlaunched: {totals}")
    print(f"phase 19 ({card}): {time.perf_counter() - t0:.1f} s; launches "
          f"{totals}")
    return totals


# -- phase 20: the fleet tier and the chaos conductor ------------------------
FLEET_SLOTS = 1 << 20        # application.properties' storage.num_slots
FLEET_KEYS = 1 << 16         # (a)'s Zipf key population (the cut)
FLEET_PIPELINE = 2048        # (a)'s requests a wave
FLEET_WAVES = 2              # (a)'s waves a ladder step (the cut)
FLEET_BOOT_S = 180.0         # a node's ready-line deadline
FLEET_DETECT_S = 10.0        # (b)'s detection budget (the drill's default)
CHAOS_PLAN = dict(steps=14, fault_rate=0.5)   # the faulted plan, seed 0
CHAOS_WIDE = {"slots_per_shard": 1 << 18, "shards_per_cell": 4,
              "n_direct_keys": 4096}          # (c)'s cell: 2^20 slots
CHAOS_DIR = os.path.join("build", "chaos")


def node_launches(label: str, per_node: dict, totals: dict) -> list:
    """Add the nodes' launch counts (their clean exits' lines) into
    ``totals``; returns the names of the nodes that left none."""
    lost = sorted(name for name, c in per_node.items() if c is None)
    for counts in per_node.values():
        for k, v in (counts or {}).items():
            totals[k] += v
    print(f"{label}: node launches "
          + "; ".join(f"{name} {counts}" for name, counts in
                      sorted(per_node.items())))
    return lost


def fleet_rolling(card: str, totals: dict) -> float:
    """(a): the rolling upgrade on card nodes at full width."""
    from ratelimiter_tpu_torch.storage.chaos import rolling_upgrade_drill

    ttl_ms, deadline_s = 1200.0, 90.0  # the drill's defaults
    t0 = time.perf_counter()
    r = rolling_upgrade_drill(
        num_slots=FLEET_SLOTS // 2, n_keys=FLEET_KEYS,
        pipeline=FLEET_PIPELINE, waves=FLEET_WAVES,
        lease_ttl_ms=ttl_ms, reseed_deadline_s=deadline_s,
        boot_timeout_s=FLEET_BOOT_S, device="cuda")
    wall = time.perf_counter() - t0
    check(r["mismatches"] == 0 and r["decisions"] > 0,
          f"fleet (a): {r['mismatches']} mismatches of {r['decisions']}")
    check(r["promotions"] == 4 and r["respawns"] == 4
          and r["reseeds"] == 4 and r["upgrade_steps"] == 2,
          f"fleet (a): promotions {r['promotions']}, respawns "
          f"{r['respawns']}, reseeds {r['reseeds']}, steps "
          f"{r['upgrade_steps']}")
    check(r["kill_promote_s"] >= ttl_ms / 1000.0 * 0.5,
          f"fleet (a): promoted {r['kill_promote_s']} s after the kill, "
          f"inside half the {ttl_ms} ms lease")
    check(all(s <= deadline_s for s in r["reseed_elapsed_s"]),
          f"fleet (a): re-seed jobs {r['reseed_elapsed_s']}")
    nodes = r["fleet"]["nodes"]
    live = {n: v for n, v in nodes.items()
            if v["state"] in ("READY", "SERVING", "DRAINING")}
    auto = r["fleet"]["autopilot"][0]
    check(live and all(v["version"] == "v2" for v in live.values())
          and set(auto["serving"]) == set(auto["standby"]) == {"0", "1"}
          and auto["failed"] == 0,
          f"fleet (a): end state {live}, autopilot {auto}")
    lost = node_launches("fleet (a)", r["launches"], totals)
    check(lost == ["S2"], f"fleet (a): nodes without launch counts {lost}")
    print(f"fleet (a) rolling upgrade ({card}) in {wall:.3f} s: "
          f"{FLEET_SLOTS // 2} slots a shard, {FLEET_KEYS} Zipf keys, "
          f"{FLEET_PIPELINE} requests a wave; {r['decisions']} decisions, "
          f"0 mismatches; node boots {r['boot_s']}; drain promote-away "
          f"{r['drain_P']['promote_s']} s; kill to promotion "
          f"{r['kill_promote_s']} s (lease {ttl_ms / 1000.0} s); re-seed "
          f"jobs {r['reseed_elapsed_s']} s; orchestrator fence epoch "
          f"{r['orchestrator']['fence_epoch']}")
    return wall


def fleet_partition(card: str, totals: dict) -> float:
    """(b): the partitioned controller on two card nodes of 2^20 slots."""
    from ratelimiter_tpu_torch.storage.chaos import (
        partitioned_controller_drill,
    )

    t0 = time.perf_counter()
    r = partitioned_controller_drill(
        num_slots=FLEET_SLOTS, detection_budget_s=FLEET_DETECT_S,
        boot_timeout_s=FLEET_BOOT_S, device="cuda")
    wall = time.perf_counter() - t0
    check(r["mismatches"] == 0 and r["decisions"] > 0,
          f"fleet (b): {r['mismatches']} mismatches of {r['decisions']}")
    check(r["epochs"]["ctrl-b"] == r["epochs"]["ctrl-a"] + 1
          and r["demote_reason"] == "lease_expired"
          and r["stale_refused"] == 2 and r["elections"] == 2
          and r["goodput_ratio"] >= 0.8,
          f"fleet (b): claims {r['epochs']}, {r['demote_reason']}, "
          f"{r['stale_refused']} refused, {r['elections']} elections, "
          f"goodput {r['goodput_ratio']}")
    check(r["detect_s"] <= FLEET_DETECT_S,
          f"fleet (b): detected in {r['detect_s']} s")
    lost = node_launches("fleet (b)", r["launches"], totals)
    check(not lost, f"fleet (b): nodes without launch counts {lost}")
    print(f"fleet (b) partitioned controller ({card}) in {wall:.3f} s: "
          f"{FLEET_SLOTS} slots a node; {r['decisions']} decisions, 0 "
          f"mismatches; node boots {r['boot_s']}; partition to demotion "
          f"{r['demote_s']} s, to the successor's seat {r['detect_s']} s "
          f"(budget {FLEET_DETECT_S} s), to one generation "
          f"{r['converge_s']} s; epochs {r['epochs']}, generations "
          f"{r['cut_generation']} -> {r['final_generation']}, stale writes "
          f"refused {r['stale_refused']}, goodput ratio "
          f"{r['goodput_ratio']}")
    return wall


def stream_modes():
    """Count the stream chunks' modes of every ``acquire_stream_ids`` call
    while installed; returns (the counter, the uninstall)."""
    import collections

    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    modes = collections.Counter()
    orig = GpuBatchedStorage.acquire_stream_ids

    def counted_call(self, *args, **kw):
        out = orig(self, *args, **kw)
        for chunk in self.last_stream_chunks:
            modes[chunk.get("mode")] += 1
        return out

    GpuBatchedStorage.acquire_stream_ids = counted_call

    def uninstall():
        GpuBatchedStorage.acquire_stream_ids = orig

    return modes, uninstall


def conductor(card: str, totals: dict) -> float:
    """(c): the conductor's plans on the card against the CPU."""
    import shutil

    from ratelimiter_tpu_torch.chaos import (
        FaultAction,
        FaultPlan,
        dump_artifact,
        load_artifact,
        minimize,
        replay,
        run_plan,
    )

    t0 = time.perf_counter()
    plan = FaultPlan.generate(0, **CHAOS_PLAN)
    modes, uninstall = stream_modes()
    reset_launch_counts()
    try:
        t1 = time.perf_counter()
        on_card = run_plan(plan, device="cuda")
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        wide = FaultPlan.generate(0, topology=CHAOS_WIDE, **CHAOS_PLAN)
        wide_r = run_plan(wide, device="cuda")
        wide_s = time.perf_counter() - t1
        bad_base = FaultPlan.generate(5, steps=10, fault_rate=0.4)
        bad = bad_base.with_actions(
            list(bad_base.actions)
            + [FaultAction(5, "epoch_rollback", {"cell": 1})])
        t1 = time.perf_counter()
        mini = minimize(bad, max_runs=16, device="cuda")
        mini_s = time.perf_counter() - t1
        os.makedirs(CHAOS_DIR, exist_ok=True)
        path = os.path.join(CHAOS_DIR, "epoch_rollback.json")
        dump_artifact(path, mini["plan"], mini["violation"],
                      minimized=True, original_actions=len(bad.actions))
        art = load_artifact(path)
        replayed = replay(art, device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        uninstall()
        shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    for k, v in counts.items():
        totals[k] += v
    t1 = time.perf_counter()
    on_cpu = run_plan(plan, device="cpu")
    cpu_s = time.perf_counter() - t1
    cpu_mini = minimize(bad, max_runs=16, device="cpu")
    cpu_replay = replay(art, device="cpu")
    differ = sorted(k for k in set(on_card) | set(on_cpu)
                    if on_card.get(k) != on_cpu.get(k))
    check(not differ, f"chaos (c): card and CPU reports differ at {differ}")
    check(on_card["violation"] is None and on_card["steps_completed"] == 14,
          f"chaos (c): {on_card['violation']}, "
          f"{on_card['steps_completed']} steps")
    check(wide_r["violation"] is None and wide_r["steps_completed"] == 14,
          f"chaos (c) wide: {wide_r['violation']}")
    kept = [a.op for a in mini["plan"].actions]
    check(mini["reproduced"] and kept == ["epoch_rollback"]
          and mini["violation"]["invariant"] == "epoch-monotonicity",
          f"chaos (c): minimized to {kept}, {mini['violation']}")
    check(mini["violation"] == cpu_mini["violation"]
          == replayed["violation"] == cpu_replay["violation"]
          and replayed["reproduced"] and cpu_replay["reproduced"],
          f"chaos (c): violations card {mini['violation']}, cpu "
          f"{cpu_mini['violation']}, replayed {replayed['violation']} / "
          f"{cpu_replay['violation']}")
    relay_chunks = modes.get("relay", 0) + modes.get("resident", 0)
    check_launches((counts["relay_step"] > 0) == (relay_chunks > 0),
                   f"chaos (c): {counts['relay_step']} relay launches for "
                   f"chunk modes {dict(modes)}")
    wall = time.perf_counter() - t0
    print(f"chaos (c) conductor ({card}): DEFAULT_TOPOLOGY plan "
          f"({len(plan.actions)} actions) {card_s:.3f} s on the card, "
          f"{cpu_s:.3f} s on the CPU, reports equal key for key; "
          f"{on_card['decisions']} decisions, {on_card['invariant_checks']} "
          f"invariant checks, promotions {on_card['promotions']}, zombies "
          f"fenced {on_card['zombies_fenced']}")
    print(f"chaos (c) wide ({card}): {CHAOS_WIDE}, "
          f"{len(wide.actions)} actions: {wide_r['decisions']} decisions, "
          f"{wide_r['invariant_checks']} invariant checks, promotions "
          f"{wide_r['promotions']}, zombies fenced "
          f"{wide_r['zombies_fenced']}, no violation; "
          f"{wide_s / wide.steps * 1000.0:.1f} ms a step ({wide_s:.3f} s)")
    print(f"chaos (c) planted epoch_rollback ({card}): minimized in "
          f"{mini['runs']} runs ({mini_s:.3f} s) from "
          f"{mini['reduced_from']} actions to {kept}; violation "
          f"{mini['violation']} on the card, the CPU and both replays")
    print(f"chaos (c) launches {counts}; stream chunk modes {dict(modes)} "
          f"(the relay step runs for the relay / resident chunks, a "
          f"shard's digest a launch)")
    return wall


def phase_fleet_chaos(card: str) -> dict:
    """Phase 20: the fleet tier and the chaos conductor.  Returns the
    kernel launches: the card nodes' from their clean exits, (c)'s from
    this process."""
    totals = dict.fromkeys(KERNEL_COUNTERS, 0)
    t0 = time.perf_counter()
    wall_a = fleet_rolling(card, totals)
    wall_b = fleet_partition(card, totals)
    wall_c = conductor(card, totals)
    check_launches(all(totals[k] > 0 for k in (
        "solver", "tb_writeback", "sw_writeback", "block_scatter")),
        f"phase 20 left a kernel unlaunched: {totals}")
    print(f"phase 20 ({card}): {time.perf_counter() - t0:.1f} s ((a) "
          f"{wall_a:.1f} s, (b) {wall_b:.1f} s, (c) {wall_c:.1f} s); "
          f"launches {totals}")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from ratelimiter_tpu_torch.engine import native_index
    from ratelimiter_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        index_build = pool.submit(native_index.build)
        build.build()
        index_lib = index_build.result()
    for name in build.KERNELS:
        build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(build.KERNELS)}; C slot index {index_lib.name})")

    rng = np.random.default_rng(SEED)
    headline = zipf_stream(rng, STREAM_KEYS, STREAM_PASS)
    clock_hz = sm_clock_hz()
    floor_ms, _ = cuda_ms(lambda: torch.cuda._sleep(0), reps=100)
    print(f"SM clock (max) {clock_hz / 1e6:.0f} MHz; solver walk step "
          f"{WALK_STEP_CYCLES} cycles; launch floor (device time of an "
          f"empty kernel, torch.cuda._sleep(0)) {floor_ms:.5f} ms")
    kernels = phase_kernels(rng, dev, floor_ms, clock_hz)
    phase_flat_kernels(rng, dev, headline, floor_ms, clock_hz, kernels)
    phase_relay_mode_scatter(rng, dev, floor_ms, kernels)
    kernels["relay_step"] = phase_relay_kernel(dev, headline)
    storage, launches = phase_main_path(rng, card)
    phase_step_breakdown(storage, rng, card)
    storage.close()
    launches["relay_step"] = phase_stream(rng, card, headline)
    # Each path's launches were counted from 0 around its own run; the
    # line reports their sum.
    for k, v in phase_permit_stream(rng, card, headline).items():
        launches[k] += v
    for phase in (phase_relay_modes, phase_strings, phase_partition_churn,
                  phase_compose, phase_service, phase_leases):
        args = (rng, card, headline) if phase is phase_strings else (
            rng, card)
        for k, v in phase(*args).items():
            launches[k] += v
    for k, v in phase_durability(rng, card, headline, kernels,
                                 floor_ms).items():
        launches[k] += v
    for k, v in phase_replication(rng, card, headline, kernels,
                                  floor_ms).items():
        launches[k] += v
    for k, v in phase_sidecar(card).items():
        launches[k] += v
    for k, v in phase_cross_host(rng, card).items():
        launches[k] += v
    for k, v in phase_sharded(rng, card, headline).items():
        launches[k] += v
    for k, v in phase_shard_failover(card).items():
        launches[k] += v
    for k, v in phase_adaptive_control(rng, card).items():
        launches[k] += v
    for k, v in phase_fleet_chaos(card).items():
        launches[k] += v

    meta = {
        "solver": ("ratelimiter_tpu_torch/ops/cuda/solver.cu",
                   "ratelimiter_tpu/ops/pallas/solver.py:141"),
        "tb_writeback": ("ratelimiter_tpu_torch/ops/cuda/block_scatter.cu",
                         "ratelimiter_tpu/ops/pallas/block_scatter.py:113"),
        "sw_writeback": ("ratelimiter_tpu_torch/ops/cuda/block_scatter.cu",
                         "ratelimiter_tpu/ops/pallas/block_scatter.py:113"),
        "block_scatter": ("ratelimiter_tpu_torch/ops/cuda/block_scatter.cu",
                          "ratelimiter_tpu/ops/pallas/block_scatter.py:113"),
        "relay_step": ("ratelimiter_tpu_torch/ops/cuda/relay_step.cu",
                       "ratelimiter_tpu/ops/pallas/relay_step.py:440"),
    }
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": kernels[name]["err"],
        "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
        "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"],
        "library_ms": kernels[name]["library_ms"],
    } for name, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
