#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`corrosion_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its wall (`wall_s`, or
`phase_wall_s` beside a `wall_s` of the phase's own); any failure exits
non-zero before the result line is printed:

1. the card's `nvidia-smi` name and power limit, then the build of every
   CUDA source of the port (one nvcc per source, all started together),
   then what the card's host has (`host`): whether `aiohttp` and
   `cryptography` import, whether `ctypes.util.find_library("nghttp2")`
   finds a library, `sqlite3.sqlite_version`, and the UDP-GSO probe's
   answer (`net/quic.py`'s endpoint over loopback, 256 KiB on one bi
   stream: whether GSO stayed on, its batches, segments and diversions),
   and the seconds loopback TCP takes for 12,000 bytes in 300 writes of
   40 B and in 3 writes of 4,000 B;
1a. `analysis`: the port's corro-analyze (`corrosion_tpu_torch.analysis`,
   every rule) over this checkout must be clean against
   `ANALYSIS_BASELINE_TORCH.json`; then kernel-purity is held against
   the card: two dense pick ticks at the slice's state (n=10,000, the
   inbox kernel launched once each), the dense stats pass, two pview
   pick ticks (the kernel launched once each) and the pview stats pass
   at n=4,096, K=256, and one `crdt_merge` batch of 4,096 rows that
   captures its CUDA graph and one that replays it, each under
   `torch.cuda.set_sync_debug_mode("warn")`.
   Each reported sync is mapped to the innermost line of the port on its
   Python stack; it fails if a sync lies inside a device root's closure
   at a statement the static rule does not report (baselined and
   suppressed sites count), or if an idiom the rule lets pass
   (`x[mask] = 0`, `masked_fill`, int indexing, `repeat_interleave(3)`,
   `as_tensor` of a device tensor) reports a sync. Prints the findings
   per rule, the syncs each idiom reports, the syncs per tick (or call)
   of each root, the host wrappers' syncs and every site;
2. the inbox kernel against its plain PyTorch version on the card, at the
   dense tick's shapes (n=10,000, G=20,000, m=5, slots=8, several seeds),
   at the other shapes of `inbox_bench.SHAPES` (n=10^5, n=10^6 and the
   partial-view tick's n=262,144, G=524,288, m=12, slots=16), on five
   degenerate cases and on four more (2,000,000 packets to 4
   destinations; n not a multiple of the kernel's range per cluster; G=0;
   m=1): outputs must be exactly equal;
3. `entry()` on the card for one tick, bit-equal to the same call on the
   CPU;
4. the dense tick on the card against the same tick on the CPU (n=256,
   10 ticks; pick+cuda, pick+cuda with Lifeguard, loss and a partition,
   and shift): every state field must be bit-equal;
5. the same for the partial-view tick (n=256, K=64, 10 ticks; fused +
   shift, fused + pick + cuda, r5 + pick + cuda with Lifeguard, loss 0.1
   and a partition, r5 + batched feeds);
6. the dense slice: `ClusterSim(10_000, seed=0, seed_mode="fingers",
   gossip_mode="pick", inbox_impl="cuda")` at the bench's widths boots to
   99.9% coverage through `run_until_stable_device`; it must end at the
   JAX package's stable tick (70) with FP 0, and the inbox kernel must be
   launched exactly once per tick run; then the same with
   `gossip_mode="shift"`: stable tick 55;
7. the partial-view slice at full width: `PViewClusterSim(262_144,
   seed=0, gossip_mode="pick", inbox_impl="cuda", **bench.pview_params())`
   (K=2048, fingers seeds, 8 feeds of 128 entries, tie epoch 512)
   `.run_until_converged_device(0.99, 8, 2000, 10)` must return the JAX
   package's converged tick with its six stats (`PVIEW_REF`, rtol 1e-6),
   FP 0 and its 14 event totals exactly, with the inbox kernel launched
   exactly once per tick; then the same in shift mode. Each run's
   published registry delta (`kernel_event_totals()["pview"]`) must equal
   its device event lane, and `FLIGHT` must hold its frames up to the
   last tick. Each prints its wall (which holds one stats pass per 10
   ticks), the wall per tick of 10 more ticks with no stats pass, and the
   median of three stats passes;
8. the CRDT merge engine's decision program (`ops/crdt_merge.py::
   _merge_kernel`) on the card as `merge_table_array` runs it there
   (`run_packed`: the packed inputs, the shape's CUDA graph replayed)
   against the same function op by op on the CPU, all ten outputs
   exactly equal: seeded inputs of 64, 4,096 and 2^20
   rows (`crdt_bench.scale_inputs`), and batches marshaled from changes:
   two digest ties that must come out ambiguous (`"y"*20` against
   `"y"*30`, 2^53 against 2^53 + 1), one change, sentinels only, one pk
   holding every change, and even-cl changes with a non-sentinel cid;
9. the CRDT decision slice: `crdt_bench.run_rung` at 512, 4,096, 16,384
   and 65,536 changes on the card. Every batch's decision (event counts,
   decline, digest of the win mask, final_cl and both winner tables)
   must equal `CRDT_REF` (the JAX package's engine) and the port's own
   run on the CPU; the registry delta of `kernel="crdt_merge"` must equal
   the batches' event lanes, `FLIGHT` must gain one frame per batch, and
   each batch must read back once (`read_decisions.readbacks`; and
   `torch.profiler` must see one device-to-host copy and one
   host-to-device copy of the packed inputs in a profiled batch, after
   the timed ones). Prints per size the decisions per
   second, each batch's split (marshal, host-to-device, device,
   readback, rebuild) and the peak device memory, then the decision
   program's device ms alone on 2^20 rows (its graph replayed);
10. `store_parity`: the store workload of `store_checks.parity_cases`
   (120-180 random changes per case, rich values, split batches, even
   causal lengths with a non-sentinel cid, two value ties the decision
   program declines) through the port's `CrdtStore`, with `array` on
   the card and on the CPU and with `python`: every case's final dump
   and impactful changes must hash to `STORE_PARITY_REF` (the JAX
   package's store), and the card's `crdt_merge` lane must decide and
   decline the batches the CPU's does;
11. `store_flood`: `crdt_bench.run_ab`, the store A/B of
   `scripts/bench_crdt_merge.py` at its schedule (512 to 65,536 changes
   per batch over 2,048 hot rows, a warm batch and three batches per
   size) through `CrdtStore.apply_changes` on `:memory:`, for the
   `python`, `native` and `array` engines: every engine's final state
   must hash to `STORE_FLOOD_REF`, and the array engine's lane (batches
   decided and declined, event totals) must equal the JAX package's
   array engine over the same run. The native batch library must load.
   Prints per size each engine's changes per second end to end and
   decisions per second alone, and the array engine's phase split;
12. `store_ingest`: `ingest_bench.run`, the remote rungs of
   `scripts/bench_ingest.py` (20,000 changes each, uniform over 400 pks
   and conflicting from 3 sites, batches of 500, a file-backed store),
   under each engine: every final state must hash to `INGEST_REF`;
   prints rows per second;
13. `store_replicas`: three port stores (sites 1, 2, 3) on the card with
   `array` each run 1,000 seeded local write transactions, export their
   versions through the changeset codec and apply the other two's in
   orders of their own (`store_checks.replica_run`): the three must reach
   one converged state, and each replica must equal `REPLICA_REF`;
14. the kernel-peer bridge's wire (`bridge_wire`): a `KernelPeerBridge`
   over `ClusterSim(192, seed=3)` on the card and another on the CPU,
   each on its own `MemNetwork`, get `bridge_scale.wire_replies`'s
   scripted datagrams (PING, ANNOUNCE, PING_REQ for a live, a crashed
   and a non-virtual target, INDIRECT_PING, INDIRECT_ACK, a datagram to
   a crashed member, undecodable bytes; three rounds: as booted, after
   `step(5)` + `refresh()`, after a crash and a restart). The replies
   must be equal, byte for byte, and hash to `BRIDGE_REF` (the JAX
   package's bridge on the same script); under `torch.profiler` the
   host's timeline must show no aten op and no CUDA call while the
   card's bridge serves a round, and one or two device-to-host copies
   issued by one `refresh()`;
15. `bridge_silent`: the port's SWIM prober (`agent/membership.py`)
   against a bridge over `ClusterSim(192, seed=3)` on the card must
   absorb 193 members, then down exactly the silently crashed members
   7, 63 and 150 by its own probe and suspicion; prints absorb and
   detect seconds;
16. `bridge_scale`: `bridge_scale.rung(10_000, 50, "gossip")`, the
   reference script's largest rung cut from 100,000 to 10,000 members
   (the rung is host-bound and ticks no kernel; the module's CLI keeps
   100,000): a dense `ClusterSim(10_000)` on the card, one prober that
   must absorb all 10,000 members, and 50 crashes it must down exactly
   (FP 0, cluster size 9,951). Prints absorb and detect seconds, the
   median ms of five `refresh()` calls, the peak device memory and the
   `nvidia-smi` line;
17. `dense_ref`: the dense tick at n=32,768 against `DENSE_REF`, the
   JAX package's run on the CPU: `dense_100k.run` (the program of
   `scripts/dense_100k.py`: 16 feeds, chunk 25, shift) and `bench.py`'s
   configuration (pick with the inbox kernel, check every 5, device
   loop) must each reach the reference's stable tick, its three stats
   bit for bit in float32 and its 14 event totals, and the kernel must
   be launched once per tick of the pick run (G = 65,536 packets of
   m = 5, slots 8), whose last launch's inputs it keeps for the kernels
   line;
18. `dense_100k_pick`, the north star on the bench's path:
   `bench.measure` at n=100,000 (`bench_params`: 4 feeds of 6,250; pick
   with the inbox kernel, fingers, target 0.999, check every 5) must
   converge with FP 0 and coverage >= 0.999, with one kernel launch per
   timed tick (G = 200,000 packets of m = 5, slots 8). Prints the stable
   tick, wall s, ms per tick, the peak device memory and the launches,
   and keeps the inputs of the run's last launch for the kernels line;
19. `dense_100k_shift`: `dense_100k.run` at n=100,000, chunk 25 (the
   reference script's program) must converge with FP 0; prints ticks,
   init s, first-dispatch s, convergence wall s, ms per tick and the
   peak device memory;
20. `ladder`: `scale_ladder.py`'s rungs 1, 2 and 3 (n=128 with 5 %
   churn; n=1,000, fanout 3, suspicion 3/6/9 with one crash; n=10,000
   with 1 % churn) on the card: every tick count, detection, crash
   count, false positive and coverage must equal `LADDER_REF`, the JAX
   package's rungs through the same code on the CPU. Wall times are
   printed;
21. runs in this process while the child phases of 24.-31., started
   just before it, run beside it, and 22.-23. run in this process beside
   the late children of 32.-35. and 38.: the agents leave the card
   mostly idle for minutes, these three are checked exactly and no bar
   reads their times (their ms per tick are the card's shared with the
   children);
21. `pview_churn_ref`: `pview_converge.run` (the program of
   `scripts/pview_converge.py`) at n=8,192, K=512, in shift and in pick
   with the inbox kernel: each run's boot tick, its six stats and 14
   event totals, the detection tick of its 81 crashes, the stats and
   totals there and its flight timeline must equal `PVIEW_CHURN_REF`
   (the JAX package's program on the CPU), with one kernel launch per
   pick tick; the pick run's last launch's inputs are kept for the
   kernels line;
22. `pview_smoke`: `bench_smoke.run()` (n=2,048, K=256, boot through the
   device loop, 1 % churn) must equal `SMOKE_REF`;
23. `pview_flight`: `chaos_soak.kernel_flight_phase(7)` and
   `flaky_node_phase((3, 11))`, each publishing into a recorder of its
   own while the global one holds every earlier pview frame, must equal
   `FLIGHT_REF`; `churn_sweep.run_config` at n=2,048, K=256 for
   "baseline" and "lifeguard" must equal `SWEEP_REF`;
24.-31. the agent phases, `store_ingest_threads` and
   `pview_churn_100k`, side by side, each in a child process of this
   script (`--child-phase NAME`): each agent phase is host-bound under
   an interpreter lock of its own, and the card serves their decision
   programs, one CUDA graph replay per batch, in turn; the churn rung
   keeps the card busy beside them. Printed once all have ended, each
   line with its process's wall (`process_wall_s`) and the wall from
   their start to there (`side_by_side_wall_s`, 21. included).
   `store_ingest_threads` (`ingest_bench.apply_concurrently`, printed
   first): the remote rungs of `store_ingest` under `array` into three
   stores each at once, every store fed in order by a thread of its
   own, so six threads replay the decision program's graphs together: every store must end at its
   rung's `INGEST_REF` and have decided batches on the card. Prints the
   wall and the graph cache (`crdt_merge.replay_stats`);
24. `agent_cluster`: six port agents (`agent_checks.cluster_run` at
   `CHIP_CLUSTER`, the shape of the JAX package's stress test on a
   random bootstrap topology, `random.Random(4242)`, `MemNetwork(seed=
   23)`), their stores on the card with `array`: each writes 50
   transactions of 20 rows into its own id range, then all six write the
   same 100 ids with values of their own. Every agent's disjoint rows
   must equal `AGENT_REF` (the JAX package's agents doing the same on the
   CPU), the shared ids must be equal across the six, every writer's
   versions booked by every peer with one `held_total`, the cluster size
   6 everywhere, and the decision program must have decided batches.
   Prints the wall to convergence, the process's graph cache (shapes,
   captures, their seconds and reserved bytes, evictions) and its peak
   reserved device memory;
25. `agent_sync_100k`: `sync_bench.run_rung(100_000, False, "delta",
   17)`, the quiet delta rung of `scripts/bench_sync.py`: a cold node catches up the
   origin's 100,000 rows (50 versions) by delta sync, under `array` and,
   in a process of its own, under `python`. Each run must meet the
   script's bar (rows, `held_total` and clock rows equal the origin's)
   and equal `SYNC_REF` (100,000 rows, 200,000 clock rows, the rows'
   digest), and under `array` the stores must have decided batches on
   the card. Prints per engine the wall to convergence, the changes
   received by sync and per second, the cold node's rows per second,
   the changes that reached it by broadcast and by sync, the array lane,
   the graph cache and the peak reserved device memory;
26. `agent_sync_100k_fire`: the same rung under `array` with the
   script's concurrent writer (10 rows every 50 ms) until the cold node
   is within five of its transactions: after the writer stops, the exact
   bar must close. Prints the fire rows written;
27. `agent_local_writes`: `ingest_bench.run_local`, the six local-write
   rungs of `scripts/bench_ingest.py` (1, 4 and 16 writers over 576
   transactions of 10 rows, and their `-durable` forms) through one port
   agent's `make_broadcastable_changes`: each rung's rows must equal
   `INGEST_LOCAL_REF`. Prints rows per second, commit p50 and p99;
28. `agent_sync_100k_snapshot`: `sync_bench.run_rung(100_000, False,
   "snapshot", 18)`, the script's quiet snapshot rung under `array`: the
   cold node fetches the origin's compressed snapshot, swaps it in under
   SQLite's locks (`agent/catchup.py`, `store/snapshot.py`,
   `store/restore.py`) and tops up by delta sync from its watermark. It
   must meet the script's bar, equal `SYNC_REF`, install once, be served
   once, and keep the cold node's site id. Prints the wall to
   convergence, the snapshot's raw bytes and install seconds, the
   changes received by delta, the array lane (in all and after the
   install; it may be 0 when the snapshot covers every version), the
   graph cache, and `snapshot_vs_delta_speedup`: the `array` delta
   rung's wall in this run over this one's;
29. `agent_sync_100k_snapshot_fire`: the same rung under the script's
   writer (seed 20): one install, the exact bar after the writer stops,
   and decided batches on the card after the install (the top-up of
   the fire rows);
30. `agent_chaos`: `sync_bench.chaos_phase(29)`, the script's chaos
   loop under `array` (three agents, 10,000 rows, then 4,000 written on
   the majority side while the third is partitioned away, gentle SWIM,
   `circuit_reset_secs` 3): the first agent's observatory must open a
   divergence episode during the partition; after the heal all three
   must converge to `CHAOS_REF`'s 14,000 rows with one `held_total`, the
   detector must close the episode with one view group and nothing
   silent, and the partitioned node must have decided its catch-up
   batches on the card. Prints `detect_s`, `catchup_s`, the episodes
   beside the JAX run's, and the array lane;
31. `pview_churn_100k`: `pview_converge.run(100_000, 2048)`, the
   script's default rung at full width, must converge on the four-term
   bar and detect all 1,000 crashes with FP 0 within its caps; prints
   the ticks beside the banked `A-convergence-100000`'s (a TPU run of
   older code: ticks only), the detected share at every churn check,
   the wall of both phases, ms per tick, the stats pass's ms and the
   peak device memory;
32. `agent_net`, in a child process of its own started after 24.-31.,
   beside 22.-23. and 39.-40., whose host is idle (beside 24.-31. its
   agents starved), as are 33.-35. and 38.: `agent_checks.scenario_net` at `CHIP_NET`
   over plaintext QUIC and then over TCP, stores on the card with
   `array`: agents A and B boot on loopback sockets with the SLO canary
   on and delta sync only;
   B attaches the live query `SELECT id, text FROM tests WHERE id % 4 =
   0` and the `tests` update handle; A writes 10,000 seeded rows in 50
   transactions of 200 (cut from 20,000 in 100 for the phase's time);
   once B holds them, C boots with the same watches and catches up by
   delta sync over the transport's bi streams. Per transport, the rows
   of A, B and C and the live query's rows on B and C must equal
   `NET_REF` (the JAX package's run of it on the CPU), the live query's
   rows must equal a SELECT on each agent's store, its events must be
   exactly 2,500 inserts on B and on C (the update handle's 10,000
   inserts), B's and C's stores must have decided
   batches on the card, and each agent's canary must have seen its own
   row. Prints B's wall from boot to converged and C's catch-up wall per
   transport, the events, the decided batches and what each canary saw;
33. `agent_api`: `agent_checks.scenario_api` at `CHIP_NET` over
   plaintext QUIC, stores on the card with `array`: agents A, B and C
   each serve the public API (`ApiServer` on `127.0.0.1:0`), and every
   client is the port's `CorrosionApiClient` over h2. B's client opens a
   `/v1/subscriptions` stream on the live query above and a
   `/v1/updates/tests` stream; A's client writes the 10,000 rows in 50
   `/v1/transactions` calls; once B's streams hold them, C boots with
   the same two streams open and catches up by delta sync. On B and on
   C the stream's rows and `/v1/queries` must equal `API_REF` (the JAX
   package's run on the CPU), the same query from an HTTP/1.1 client on
   the same port must give the same rows, both streams must carry one insert event
   per row, both stores must have decided batches on the card,
   `/v1/status` must read `chaos.active` false and the plane-off
   endpoints (`/v1/traces`, `/v1/alerts`, `/v1/remediation`,
   `/v1/profile`) must give the JAX package's bodies. Then B's API stops
   with both streams live: `stop()` must return within 10 s and both
   streams end with a typed error (or cleanly) within 20 s of the stop.
   Prints the walls (first row on B, all rows on B, C's catch-up), the
   event rate per stream and the HPACK codec of the clients' live h2
   connections;
34. `pubsub_bench`: `pubsub_bench.main` over the `--all` grid (rows
   {5k, 20k, 80k} × 1 subscription, 5k × {1, 16, 128} shared, 5k × 16
   distinct), each on one port agent: every rung must deliver `n_rows`
   events to each stream. Prints each rung's event rate, write rate and
   wall. Its writes are local commits, which run no merge engine: the
   host's serving plane on the card's machine; `pubsub_scale`, a child
   of its own: `streams_rung` at 1,000 × 10 shared, 1,000 distinct and
   10,000 × 10 shared streams, every stream receiving its events and the
   over-limit probe refused with the typed 503;
35. `agent_planes`: `planes_checks.scenario_planes` at `CHIP_NET` over
   plaintext QUIC, stores on the card with `array`, every runtime plane
   on as a default `Config` has them (trace store, TSDB, alerts with
   remediation, profiler; only their clocks shortened) and OTLP export
   into an in-process sink: agents A, B and C serve the API, A's h2
   client writes the 10,000 rows. Then C is cut off from A and B with
   remediation armed, A writes 200 more rows, and the cut holds until
   `view-divergence` fires, B's `/v1/alerts?scope=cluster` shows it on A
   and `targeted-sync` has acted on A and B; after the heal C must hold
   every row, its catch-up batches decided on the card. Then A's disk
   fails every statement (`StoreFaults`, the census naming the drill)
   with remediation observe-only, until `store-faults` fires everywhere,
   `drain-refuse-bulk` is recorded as `would_act` on every node and a
   trace is kept for an error. The rows, the episode rules fired per
   node with their severities, the actuators' outcomes, the divergence
   episode each node opened during the cut and one incident per episode
   must equal `PLANES_REF` (the JAX
   package's run on the CPU); bounded: a kept trace for the sick disk's
   errors in `/v1/traces`, every node's hotspot block in
   `/v1/profile?scope=cluster`, a speedscope document, the profiler's
   overhead under `profile.max_overhead_pct`, every span the exporter
   counts as sent received by the sink, and every rule input the
   registry holds sampled by the TSDB. Prints the walls, the profiler's
   top self-time frames and overhead, the TSDB's sample cost, the array
   batches per node and the inbox kernel's launches (0: no SWIM tick);
36.-37. run in child processes of their own, started before 8. and
   collected after 16., beside the CRDT, store and bridge phases, which
   keep only this process busy (beside the late group the matrix's
   sick disk raised its alert too late: the TSDB sampler starved);
   their lines print after 16.
36. `agent_cli`: `cli_checks.scenario_cli` at `CHIP_CLI`: a
   `ProcessCluster` (`A -> C`, `B -> C`) of three `python -m
   corrosion_tpu_torch agent` processes on the card with `array`, driven
   only by the port's CLI as subprocesses: 10,000 rows by 5 `exec` calls
   of 40 INSERTs, `query` on A, B and C, `cluster members` and
   `membership-states`, `sync generate`, `subs list`, `locks`, a
   `template` render, `backup` on A and `restore` into a fresh path;
   then A stops, `snapshot dump` of its database, 100 more rows on B, and
   a fourth node D by `snapshot install` and `agent --from-snapshot`
   that catches up by sync. The row digests, member counts, template
   bytes, first query lines and the snapshot reports must equal
   `CLI_REF` (the JAX package's CLI on the CPU), and every agent process
   must hold a context on the card (`cli_checks.device_holders`: a
   `/dev/nvidia<N>` file open and `/dev/nvidia-uvm` mapped, calibrated
   first on a probe process that has only counted the cards and then
   made a context) and must not have loaded the inbox kernel's library
   (so it made no launch: the agent processes' count, 0, is that). Then
   `scale_ladder.rung0` (three in-process agents over `DevCluster`,
   default SWIM) with FP 0 and no inbox launch in this process. Prints
   the walls, the card holders, the probe and rung 0's record;
37. `traffic_sim`: `traffic_sim.run_matrix(tiny=False)`, the full
   matrix (4 nodes, 8 scenarios of 6 s, observe-only), stores on the
   card with `array`: every scenario passes `_assert_bars` (zero op
   timeouts, availability floors, recovery under the cap, zero
   divergence at close, the typed alerts and their profiles), the ids
   are `TRAFFIC_SCENARIOS`, churn-storm and zombie-node decided batches
   on the card, and the inbox kernel made no launch. Prints per scenario
   the availability, timeouts, events, recovery s and array lane;
38. `pview_churn_25k` (a late child): `pview_converge.run(25_000, 512)`
   in shift (250
   crashed) must equal `PVIEW_CHURN_25K_REF` at every check (the six
   stats) and at each end (ticks, event totals, timeline), the JAX
   package's program on the CPU: the churn path's witness between 8,192
   and the 100,000 rung, which has no reference;
39. `pview_boot_1m`: `pview_converge.run(1_048_576, 2048,
   skip_churn=True)` to tick 100 must equal `PVIEW_1M_REF` (the JAX
   package's program there: six stats at ticks 50, 75 and 100; the 14
   event totals at tick 100 from the port's run on the H100 that
   equalled the JAX totals at tick 200) with FP 0 and full tables;
   prints init s, wall, ms per tick and the peak device memory beside
   the 8.6 GB table (the run to the bar, which does not converge within
   2,000 ticks, is the CLI's);
40. `pview_profile`: `pview_profile.run` at 16,384 x 512 with three
   calls per row: every phase row (the Hopper kernel's `inbox[cuda]`
   among them) and the memory ladder's row in both tick modes must come
   back with finite times and peaks;
41. `torch.profiler` must see exactly one device kernel, and no memset,
   in one `build_inbox` call (after the slice phases, so that no
   profiling precedes their clocks; in a fresh process, with the times
   per shape: `fresh_kernel_measurements`); then the kernels line: per
   kernel its launches on the main paths (and per path), its median time
   over 100 launches at the dense slice's shapes, the plain version's, and the
   bound; for the inbox kernel also per shape of `inbox_bench.SHAPES`,
   and at the inputs of the last launches of `dense_ref` pick,
   `dense_100k_pick` and `pview_churn_ref` pick (each checked equal to
   the plain version first), its
   ms, device ms, plain ms, bound and host us per call, the floor of
   CUDA-event timing, the kernel's cluster size (its `kCluster`) and its
   device kernels per call. Every bound is computed from this run's
   inputs.

Before the kernels line, a `walls` line: the script's wall to there and
the kernels phase's, beside the 1,200 s limit. The last line is
`{"ok": true, "device": {"platform": "gpu", ...}}`.

`python3 chip_smoke.py --window-ab` runs only the build and the phases
that share their window with 36.-37. (`WINDOW_PHASES`), first alone and
then beside those two children, each line tagged `window`: the host
load's effect on their host-clock readings, within one call.
"""

from __future__ import annotations

import ast
import asyncio
import contextlib
import importlib
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

from corrosion_tpu_torch import bench
from corrosion_tpu_torch import bridge_scale as bs
from corrosion_tpu_torch import (
    bench_smoke,
    chaos_soak,
    churn_sweep,
    crdt_bench,
    dense_100k,
    pview_profile,
    scale_ladder,
)
from corrosion_tpu_torch import agent_checks
from corrosion_tpu_torch import inbox_bench as ib
from corrosion_tpu_torch import ingest_bench, native, store_checks, sync_bench
from corrosion_tpu_torch import cli_checks, planes_checks, pubsub_bench
from corrosion_tpu_torch import traffic_sim
from corrosion_tpu_torch import pview_converge as pc
from corrosion_tpu_torch import random as jr
from corrosion_tpu_torch.bench import PVIEW_N, bench_params, pview_params
from corrosion_tpu_torch.convert import crdt_inputs_to_torch
from corrosion_tpu_torch.entry import entry
from corrosion_tpu_torch.models.bridge import KernelPeerBridge
from corrosion_tpu_torch.models.cluster import ClusterSim, PViewClusterSim
from corrosion_tpu_torch.net.mem import MemNetwork
from corrosion_tpu_torch.ops import (
    _build,
    crdt_merge,
    inbox_cuda,
    swim,
    swim_pview,
)
from corrosion_tpu_torch.runtime.metrics import (
    CRDT_MERGE_EVENTS,
    KERNEL_EVENTS,
    kernel_event_totals,
)
from corrosion_tpu_torch.runtime.records import FLIGHT
from corrosion_tpu_torch.types.base import Timestamp
from corrosion_tpu_torch.types.change import SENTINEL, Change
from corrosion_tpu_torch.types.pack import pack_columns

SLICE_N = 10_000
SLICE_EXPECT = {"pick": 70, "shift": 55}  # JAX package, same config + seed

PVIEW_ARGS = dict(pview_params(), seed=0, inbox_impl="cuda")
PVIEW_K = PVIEW_ARGS["slots"]
PVIEW_STATS = ("pv_coverage", "mean_in_degree", "min_in_degree",
               "occupancy", "false_positive", "detected")
# The JAX package's PViewClusterSim(PVIEW_N, **PVIEW_ARGS,
# gossip_mode=mode) with its "gsort" inbox, run on the CPU through
# run_until_converged_device(0.99, 8, 2000, 10)'s key chain one chunk at
# a time: the converged tick, the six PVIEW_STATS there, and its event
# lane there (KERNEL_EVENTS order, totals since init).
PVIEW_REF = {
    "pick": (70, (0.9930076599121094, 2047.0, 499.0, 1.0, 0.0, 1.0),
             (156358022, 0, 93086961, 63271061, 33286589, 63185415,
              18350080, 0, 0, 0, 4587520, 0, 0, 0)),
    "shift": (380, (0.990509033203125, 2047.0, 80.0, 1.0, 0.0, 1.0),
              (1256559354, 0, 1175882126, 80677228, 90494823, 771930676,
               99614720, 0, 0, 0, 24903680, 0, 0, 0)),
}

# The JAX package's merge_table_array on the CPU over crdt_bench's
# schedule (the reference script's own batches), chained as
# crdt_bench.run_rung chains them: per size, per batch, its event lane
# (CRDT_MERGE_EVENTS order), whether it was declined, and the sha256 of
# its win mask, final_cl, cell_winner and clock_winner
# (crdt_bench.outputs_digest). `python -m tests.test_torch_crdt` prints it.
CRDT_REF = {
    512: [
        ((492, 471, 20, 0), False, "a01c3219a8f21ec0c7c25f3509ca4067"
         "fd00f94430132daa9d47cddc62d12ca2"),
        ((446, 382, 66, 0), False, "4386c5f0c197e6388cf47114fdd9a174"
         "032a1e2d2b14553ca56c42dcb7bb5a2e"),
        ((426, 334, 86, 0), False, "9b34c9ca8a1f8781285c44b547f59541"
         "bb7d12e2ababd3bd0423bb1ef10758f7"),
    ],
    4096: [
        ((2996, 2201, 1100, 0), False, "45e6566108f6a422597a03b30de0d3ae"
         "6b8e37e7e27b86d1c29fe45994a4847e"),
        ((1629, 764, 2467, 0), False, "c3579be398117ebd6263946c54988157"
         "8d1b4dca8a5db91c28d460a6f1802fe5"),
        ((1035, 452, 3061, 0), False, "887f27bf982bdc53ce1f34731111085e"
         "4e7826133edeeed42438d5bb7391b41b"),
    ],
    16384: [
        ((6337, 3722, 10047, 0), False, "1bb81df75f0e79efa8829693359bc2d2"
         "c25f51e86cf7197aca611c043bfb7311"),
        ((1783, 704, 14601, 0), False, "bca71de36b51b8436e89bff54af68051"
         "c1906d083fb00aa37ddbe755da3fe031"),
        ((995, 423, 15389, 0), False, "d2482d127f0983efd253f419b6025c6a"
         "31f113897d9c13f50ae94bb0c1c4499a"),
    ],
    65536: [
        ((9865, 5144, 55671, 0), False, "de6c82ebae192fac4e8cded7ceb2d94f"
         "860ea4598dc102db807633debae149a5"),
        ((1186, 752, 64350, 0), False, "9a45d270e47fa7ce38380e6f5e0be32a"
         "56624fa632065ea0b5b8ea761ce3a063"),
        ((424, 366, 65112, 0), False, "26ea4f962757e249b03dffa127190c77"
         "98e7cabcea31fb6f1eddf7b066dccb17"),
    ],
}

# The JAX package's CrdtStore on the CPU, python engine, over the same
# inputs (`python -m tests.test_torch_store`): per case of
# `store_checks.parity_cases`, sha256 of the final dump and the impactful
# changes in order.
STORE_PARITY_REF = {
    'randomized_0': 'c64b15fb83cd984305d7e5c5339bf5befbcb9524a99d8ef04c662401e4de5e25',
    'randomized_1': '4a94e067187ebc5d16182008a37da91a600b390eb4bc838de71590e31d9a6bd9',
    'randomized_2': '61c5e6ee6cab01fe82162735c8c4d1a83d62e383257ba6bea2ec37c4d25b7c1b',
    'randomized_3': '494421e1e28014f09500121226195a3de178122e056256f9001d4e18710b90ab',
    'rich_0': '09d6d012c27c5397cd6abb0903c7b83e9a5f283325e5f7a585e6431ec1864b40',
    'rich_1': '38fe879ef891cb4948fdbd724669a42a5491dabbce8688e1dbf8bed91296de0f',
    'rich_2': '694f5356f660f7df26c73d1508145b2a9f24625af900f469bb33d0d07633643d',
    'rich_3': 'be7e559c144edde4cf5c0a1ad88e308e92d2c2cf450b41c13547b26f47495737',
    'split_13': 'c248da8431d05df115849e5f84a019db528a9570c9756cc75d73848ae567ba41',
    'rich_split_11': 'ac112e5d410a8d9c0348a33d5ff7719b45381220a6af73581b4c2a81098bdbc3',
    'even_cl_0': 'ab40b846412c9c0224804b2d9a78e2723de38149b5d971f3e1d680cf3743cab9',
    'even_cl_1': 'e599c9da2447bc8c0b3159429631eba9e0888fe286e320586529d19dcfdab49f',
    'even_cl_2': 'bb93294ccddbd7147be25b17ceb8ffb530710b36e2060814c938b0623742eff4',
    'even_cl_3': '38c09908b826ce45c33652c41badf08e0ec7c29f0eea7d96c1455763506f58cc',
    'tie_0': 'f9789ca943c3729097114de9b3ba7ed8c6ab34f6c081cabe3bdef208fa0e787c',
    'tie_1': 'cff544a57b86bb60ea67ad380f8f872caa2428bee132f7067dcb19e81a5539e3',
}

# The same store after `ingest_bench`'s two remote rungs (20,000 changes
# in batches of 500 into a file): sha256 of `crdt_bench.dump_state`.
INGEST_REF = {
    'ingest-remote': '5b84ff88b1e535d6b1fe87adc9691fa91a44ebeaf417a75370779a580d1382a7',
    'ingest-conflict': '8d2c0b2e1c04e06d7c5b118684637b08662507c07b30c8c194dedb6e9ff2ab42',
}

# The JAX package's CrdtStore on the CPU through `crdt_bench.bench_engine`
# over the reference script's schedule (`python -m tests.test_torch_store`):
# per size, sha256 of the final state (python engine; its array engine ends
# at the same), and what its array engine's `crdt_merge` lane saw over the
# three timed batches: batches decided and declined, event totals.
STORE_FLOOD_REF = {
    512: {
        "digest": "e457f29441b6c1c68d7e01cc3a6221d9"
                  "181591f40a4ab8c6f0e68729a1f78a53",
        "decided": 3, "declined": 0,
        "events": {"decide_won": 1254.0, "decide_transition": 989.0,
                   "decide_stale": 282.0, "decide_ambiguous": 0.0},
    },
    4096: {
        "digest": "c2c6ef840472768a48267004c1fb1b4b"
                  "cfa9431ce2be0c77e63e8e82c4521a44",
        "decided": 3, "declined": 0,
        "events": {"decide_won": 4335.0, "decide_transition": 2131.0,
                   "decide_stale": 7953.0, "decide_ambiguous": 0.0},
    },
    16384: {
        "digest": "d8e0752b08e7a9cd3de61ba9edb9b0f0"
                  "bec9034df7b1502701d5f7a49f3226ad",
        "decided": 3, "declined": 0,
        "events": {"decide_won": 7400.0, "decide_transition": 3439.0,
                   "decide_stale": 41752.0, "decide_ambiguous": 0.0},
    },
    65536: {
        "digest": "8d5c3ea06accb9e0c932a909ce157517"
                  "86d0ef2723dbb41af3fc7cbafee6c28c",
        "decided": 3, "declined": 0,
        "events": {"decide_won": 9710.0, "decide_transition": 4801.0,
                   "decide_stale": 186898.0, "decide_ambiguous": 0.0},
    },
}

# The JAX package's three stores through `store_checks.replica_run`
# (`python -m tests.test_torch_store_writes`): each replica's dump
# (clocks without ts), its converged part, and what each exported.
REPLICA_REF = {
    "replicas": {
        1: 'c2e2d42d7bcd4651d66bd8f8932194b7f687daa3edccd18acab9a85141f5047a',
        2: 'fb111636e589b13d49eecfda64b1c2b8c3f3a41a3a606829a3bead721761e8e0',
        3: '2bae773d43669ddd721f87f2566aef390df0124f303ff44402a0816e7c047907',
    },
    "converged": {
        1: 'd3c540b3497ac8d2d43195f0a78a714fa13a41f085a0a1a8606d39b75e646872',
        2: 'd3c540b3497ac8d2d43195f0a78a714fa13a41f085a0a1a8606d39b75e646872',
        3: 'd3c540b3497ac8d2d43195f0a78a714fa13a41f085a0a1a8606d39b75e646872',
    },
    "versions": {1: 816, 2: 804, 3: 806},
    "bytes": {1: 293147, 2: 284231, 3: 279917},
}

# The JAX package's agents on the CPU with the python engine (`python -m
# tests.test_torch_agent --ref`). AGENT_REF: `agent_checks.cluster_run`
# at `CHIP_CLUSTER` (6 agents, random.Random(4242), MemNetwork(seed=23)):
# the digest of the disjoint ranges' rows (every agent's), the versions of
# each writer, the rows and `held_total` of every agent. SYNC_REF:
# `sync_bench.run_rung(100_000, False, "delta", 17)`, the cold node's
# rows, clock rows, `held_total` and a digest of its rows; the JAX
# package's snapshot rung (`"snapshot"`, seed 18) ends there too
# (`python -m tests.test_torch_catchup --ref` checks it).
# INGEST_LOCAL_REF: per local-write rung of `ingest_bench.run_local`, the
# digest of the rows.
AGENT_REF = {
    "disjoint_digest": "3e9a80019a4f5c085d2cd2784e61a15015673b8326664653ab14aa3b0f687c9e",
    "versions_per_writer": 55,
    "rows_total": 6100,
    "held_total": 330,
}
SYNC_REF = {
    "rows_final": 100000,
    "clock_rows_final": 200000,
    "held_total": 50,
    "rows_digest": "929338f3ef5f4acbfa46b8002820cb66f4c2bdeb3f9adb57bc8a99a60b7a1f50",
}
# The JAX package's `sync_bench.chaos_phase(29)` on the CPU (`python -m
# tests.test_torch_catchup --ref`): the 14,000 rows' digest and
# `held_total`, equal on all three agents, and its divergence episodes
# (timing-dependent: printed beside the port's, not compared).
CHAOS_REF = {
    "rows": 14000,
    "rows_digest": "524f5526456d0d144759e0f748fa3f7494bd59dcfcc8ee0beb4af58c7273070c",
    "held_total": 7,
    "episodes": 4,
}
INGEST_LOCAL_REF = {
    "ingest-local-w1": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
    "ingest-local-w4": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
    "ingest-local-w16": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
    "ingest-local-w1-durable": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
    "ingest-local-w4-durable": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
    "ingest-local-w16-durable": "1bfab2a06bbf975ea1e23369c6fd494ee6b790f8730fe2d79eaa517cfee9bb50",
}

# The JAX package's `agent_checks.scenario_net` at `CHIP_NET` on the CPU
# over each transport (`python -m tests.test_torch_pubsub --ref`): the
# rows' digest, the live query's rows (digest, count) and events, and the
# `tests` update handle's events (`agent_checks.net_outcome`).
NET_REF = {
    "quic": {
        "rows_digest": "9f523b004019782e4ea4ab7ba838a073622a88094bcb08d56078ead0c9109f73",
        "sub_digest": "9edaf295afff3e00c22ac32a1859a0ad4116e78bbdaa799f3a643e9d6192b7ba",
        "sub_rows": 2500, "events": {"insert": 2500},
        "updates": {"insert": 10000},
    },
    "tcp": {
        "rows_digest": "9f523b004019782e4ea4ab7ba838a073622a88094bcb08d56078ead0c9109f73",
        "sub_digest": "9edaf295afff3e00c22ac32a1859a0ad4116e78bbdaa799f3a643e9d6192b7ba",
        "sub_rows": 2500, "events": {"insert": 2500},
        "updates": {"insert": 10000},
    },
}

# The JAX package's `agent_checks.scenario_api` at `CHIP_NET` over QUIC on
# the CPU (`python -m tests.test_torch_api --ref`): the rows' digest, the
# subscription stream's rows (digest, count) and events, `/v1/queries`'
# rows, the updates stream's events, `/v1/status`'s chaos census and the
# plane-off endpoints' bodies, `actor_id` masked (`agent_checks.api_outcome`).
API_REF = {
    "rows_digest": "9f523b004019782e4ea4ab7ba838a073622a88094bcb08d56078ead0c9109f73",
    "sub_digest": "9edaf295afff3e00c22ac32a1859a0ad4116e78bbdaa799f3a643e9d6192b7ba",
    "sub_rows": 2500,
    "query_digest": "9edaf295afff3e00c22ac32a1859a0ad4116e78bbdaa799f3a643e9d6192b7ba",
    "events": {"insert": 2500}, "updates": {"insert": 10000},
    "chaos": {"active": False, "scenario": None, "since": None,
              "injections": {}},
    "planes_off": {
        "/v1/traces": [200, {"actor_id": "<actor>",
                             "census": {"enabled": False}, "traces": []}],
        "/v1/alerts": [200, {"enabled": False, "rules": [], "active": []}],
        "/v1/remediation": [200, {"enabled": False, "actuators": [],
                                  "history": []}],
        "/v1/profile": [200, {"enabled": False}],
    },
}

# The JAX package's `planes_checks.scenario_planes` at `CHIP_NET` over
# plaintext QUIC on the CPU (`python -m tests.test_torch_planes --ref`):
# the rows' digest, the episode rules each node fired with their
# severities, the actuator each drove and whether it reached its outcome
# (acted while armed, would_act observe-only; C's partition outcome is
# left out), whether each node opened a divergence episode between the
# cut and the heal, and whether each episode dumped one incident
# (`planes_checks.planes_outcome`).
PLANES_REF = {
    "rows_digest": "9d790d15cef54f80a0b9e334c7b1912fc329da9291171d486ed0e9516460d1f3",
    "rows": 10200,
    "fired": {n: {"view-divergence": "page", "store-faults": "page"}
              for n in "abc"},
    "actions": {
        "a": {"view-divergence": [["targeted-sync"], True],
              "store-faults": [["drain-refuse-bulk"], True]},
        "b": {"view-divergence": [["targeted-sync"], True],
              "store-faults": [["drain-refuse-bulk"], True]},
        "c": {"store-faults": [["drain-refuse-bulk"], True]},
    },
    "episode_opened": {"a": True, "b": True, "c": True},
    "incident_per_episode": True,
}

# The JAX package's CLI on the CPU at `cli_checks.CHIP_CLI` (`python -m
# tests.test_torch_cli`): `cli_checks.cli_outcome` of `scenario_cli` run
# with `python -m corrosion_tpu` agents and commands.
CLI_REF = {
    "rows": 10000,
    "extra": 100,
    "statements": 200,
    "exec_calls": 5,
    "rows_affected": 10000,
    "digests": {n: "4b8e01331603fd8c" for n in "ABC"},
    "lines": {"A": 10000, "B": 10000, "C": 10000},
    "first_lines": ["1|r1", "2|r2", "3|r3"],
    "columns_head": ["id|text", "1|r1", "2|r2"],
    "members": {"A": 2, "B": 2, "C": 2},
    "membership_states": 3,
    "sync_generate_keys": ["actor_id", "heads", "need", "partial_need"],
    "subs": 0,
    "locks_answered": True,
    "template_sha": "f73b11c1ccbb2a19",
    "template_lines": 103,
    "restored_digest": "4b8e01331603fd8c",
    "snapshot_dump": "5 watermark versions, schema sha 04e655171bc9",
    "snapshot_install": ("5 watermark versions"
                         " (delta sync tops up from there)"),
    "final_digests": {n: "4f7d8cf4e70d9c0b" for n in "BCD"},
    "final_lines": {"B": 10100, "C": 10100, "D": 10100},
    "d_self_id": "00000000-0000-4000-8000-00000000000d",
}

# sha256 of the JAX package's bridge replies to `bridge_scale.wire_replies`
# over its ClusterSim(n, seed=3) (`python -m tests.test_torch_bridge`)
BRIDGE_REF = {
    64: "3e9d1c497d0ab4e7685ee8f4a259f784ad103091d9167f3cd33ae7e7afcb7a02",
    192: "371730e647162f9d833cee313e1214df45c4211ed5167c772fda50ecd4092577",
}

# The JAX package on the CPU at n=32,768 (`python -m
# tests.test_torch_dense_scale`): per configuration, the stable tick, the
# three stats (coverage, detected, false_positive) as float32 and the
# event lane (KERNEL_EVENTS order) there. "shift": `dense_100k`'s program
# through `_tick_n_impl` (chunk 25); "pick": `bench.py`'s configuration
# through `ClusterSim.run_until_stable_device` with the "gsort" inbox.
DENSE_REF_N = 32_768
DENSE_REF = {
    "shift": (100, (1.0, 0.0, 0.0),
              (25099364, 0, 23445992, 1653372, 9771600, 52282923, 3276800,
               0, 0, 0, 409600, 0, 0, 0)),
    "pick": (95, (0.9992537498474121, 0.0, 0.0),
             (25604728, 0, 18923985, 6680743, 10200323, 12415754, 3112960,
              0, 0, 0, 389120, 0, 0, 0)),
}
DENSE_100K_N = 100_000

# `scale_ladder.checked` of the JAX package's rungs 1, 2 and 3 (n=10,000)
# through the same rung code on the CPU (`python -m tests.test_torch_ladder`)
LADDER_REF = {
    "1": {"convergence_ticks": 11, "detect_all_ticks": 21,
          "churn_crashed": 6, "false_positive_healthy": 0.0,
          "false_positive_after_churn": 0.0},
    "2/3": {"convergence_ticks": 61, "detect_one_ticks": 15,
            "false_positive": 0.0},
    "2/6": {"convergence_ticks": 61, "detect_one_ticks": 18,
            "false_positive": 0.0},
    "2/9": {"convergence_ticks": 61, "detect_one_ticks": 21,
            "false_positive": 0.0},
    "3": {"convergence_ticks": 61, "detect_all_ticks": 37,
          "churn_crashed": 100, "false_positive_healthy": 0.0,
          "false_positive_after_churn": 0.0, "coverage": 1.0},
}

# `pview_converge.checked` of the JAX package's program (the body of
# `scripts/pview_converge.py` on one device: fingers seeds, PRNGKey(1)
# split once per 25-tick `tick_n_donated`, stats every 25 ticks) with its
# "gsort" inbox on the CPU, at the A-convergence-8192 configuration
# (`python -m tests.test_torch_pview_churn`): the boot tick, its six
# PVIEW_STATS (float32) and 14 event totals, the ticks to detect the 81
# crashes, the stats and totals there, and the flight timeline's row
# count and sha256 (`pview_converge.timeline_digest`)
PVIEW_CHURN_N = (8192, 512)
PVIEW_CHURN_REF = {
    "shift": (50, (0.9990234375, 511.0, 152.0, 1.0, 0.0, 1.0),
              (7930414, 0, 6166726, 1763688, 1507275, 2889832, 409600, 0,
               0, 0, 102400, 0, 0, 0),
              425, (1.0, 505.9712829589844, 464.0, 1.0, 0.0, 1.0),
              (43089541, 0, 41308991, 1780550, 1603908, 30429771, 3823201,
               4597, 4145, 0, 964197, 0, 0, 0),
              0, "4f53cda18c2baa0c0354bb5f9a3ecbe5"
                 "ed12ab4d8e11ba873c2f11161202b945"),
    "pick": (50, (0.9949951171875, 511.0, 160.0, 1.0, 0.0, 1.0),
             (5118080, 0, 3112374, 2005706, 768562, 2189831, 409600, 0, 0,
              0, 102400, 0, 0, 0),
             400, (1.0, 505.9712829589844, 464.0, 1.0, 0.0, 1.0),
             (37890033, 0, 32629314, 5260719, 800444, 28116623, 3622402,
              3476, 2910, 0, 913500, 0, 0, 0),
             4, "8e3375d95c4bed09424558c7ccf35a99"
                "c42502667fe49542fb0d6c22df4e7b80"),
}
# `bench_smoke.checked` of the JAX package's `scripts/bench_smoke.py`
# workload at its defaults (n=2,048, K=256) on the CPU
SMOKE_REF = (50, (0.9990234375, 255.0, 106.0, 1.0, 0.0, 1.0), 225,
             (1.0, 252.43836975097656, 231.0, 1.0, 0.0, 1.0),
             (6871586, 0, 6347406, 524180, 407748, 2194324, 554200, 528,
              423, 0, 139673, 0, 0, 0))
# `chaos_soak.checked` of the JAX package's `kernel_flight_phase(7)` and
# `flaky_node_phase((3, 11))` runs on the CPU, each sim publishing into a
# clean recorder
FLIGHT_REF = {
    "kernel_flight": (7, 40, 18, "a1b4f6c29bba381b830bc99384e14d25"
                                 "2ecba259e1b9aa157c7273d220bd2988"),
    "flaky": [
        (3, (119, 115, 119, 116, 0, 0, 15, 280,
             "373d3de666154ed541eeb7b12ddfed07"
             "17879f3f16411bdac41f22e0682e38a5"),
         (5, 3, 5, 5, 8, 2, 15, 280,
          "562b742001f844fb8ea8b5fa730c05c5"
          "f15e2fb9d32ca7a0dc0e68eb02693a9a")),
        (11, (119, 114, 119, 116, 0, 0, 15, 280,
              "234fb763b8803fefb39141871ef11d7b"
              "736aed7e1f5be2ee9d198307076df4fd"),
         (5, 2, 5, 5, 6, 2, 15, 280,
          "e8e0370578bd90e24532b689a8cef9d0"
          "6fe23181e429ef9c12b25b8a59f5d614")),
    ],
}
# `churn_sweep.checked` of the JAX package's `run_config` on the CPU
SWEEP_N = (2048, 256)
SWEEP_REF = {
    "baseline": ("baseline", 20, 130,
                 (0.9970703125, 255.0, 103.0, 1.0, 0.0, 1.0),
                 (1.0, 252.43836975097656, 231.0, 1.0, 0.0, 1.0),
                 (3874915, 0, 3521639, 353276, 277362, 2370503, 302000, 463,
                  346, 0, 76153, 0, 0, 0)),
    "lifeguard": ("lifeguard", 20, 120,
                  (0.9970703125, 255.0, 103.0, 1.0, 0.0, 1.0),
                  (1.0, 252.43836975097656, 231.0, 1.0, 0.0, 1.0),
                  (3675868, 0, 3324083, 351785, 277466, 2207963, 281920,
                   458, 297, 0, 71080, 167, 0, 0)),
}
PVIEW_100K = (100_000, 2048)
# PVIEW_SCALE.json's A-convergence-100000: a TPU run of older code, its
# tick mode not recorded; compared for ticks only
PVIEW_100K_BANKED = {"ticks": 195, "detect_all_ticks": 1430}
PVIEW_25K = (25_000, 512)
# the JAX package's `pview_converge` program at n=25,000, K=512, shift,
# on the CPU (`python -m tests.test_torch_pview_churn --ref-25k`): each
# check's tick and six stats (float32, shortest repr), and
# `pview_converge.checked` of the run. PVIEW_SCALE.json's
# A-convergence-25000 (CPU, older code): boot 250, detection 1,125,
# compared for ticks only
PVIEW_25K_BANKED = {"ticks": 250, "detect_all_ticks": 1125}
PVIEW_CHURN_25K_REF = {
    "history": (
        (50, 0.95364, 511.0, 102.0, 1.0, 0.0, 1.0),
        (75, 0.95892, 511.0, 121.0, 1.0, 0.0, 1.0),
        (100, 0.96512, 511.0, 115.0, 1.0, 0.0, 1.0),
        (125, 0.96956, 511.0, 108.0, 1.0, 0.0, 1.0),
        (150, 0.9734, 511.0, 114.0, 1.0, 0.0, 1.0),
        (175, 0.9778, 511.0, 116.0, 1.0, 0.0, 1.0),
        (200, 0.98108, 511.0, 116.0, 1.0, 0.0, 1.0),
        (225, 0.98524, 511.0, 118.0, 1.0, 0.0, 1.0),
        (250, 0.98736, 511.0, 125.0, 1.0, 0.0, 1.0),
        (275, 0.9898, 511.0, 128.0, 1.0, 0.0, 1.0),
        (300, 0.9916, 511.0, 132.0, 1.0, 0.0, 1.0),
        (325, 0.9937374, 505.94464, 141.0, 1.0, 0.0, 0.0),
        (350, 0.9949495, 505.94434, 144.0, 1.0, 0.0, 0.004),
        (375, 0.9957576, 505.944, 145.0, 1.0, 0.0, 0.016),
        (400, 0.99664646, 505.9471, 149.0, 1.0, 0.0, 0.016),
        (425, 0.9971313, 505.94788, 155.0, 1.0, 0.0, 0.016),
        (450, 0.997697, 505.94702, 157.0, 1.0, 0.0, 0.016),
        (475, 0.9979394, 505.94946, 158.0, 1.0, 0.0, 0.016),
        (500, 0.9981818, 505.9525, 161.0, 1.0, 0.0, 0.016),
        (525, 0.9976162, 505.617, 134.0, 1.0, 0.0, 0.016),
        (550, 0.99519193, 505.59094, 124.0, 1.0, 0.0, 0.016),
        (575, 0.9904646, 505.64694, 135.0, 1.0, 0.0, 0.016),
        (600, 0.9876364, 505.70993, 121.0, 1.0, 0.0, 0.016),
        (625, 0.98642427, 505.75342, 122.0, 1.0, 0.0, 0.02),
        (650, 0.98610103, 505.79538, 121.0, 1.0, 0.0, 0.02),
        (675, 0.98735356, 505.83292, 119.0, 1.0, 0.0, 0.028),
        (700, 0.98941416, 505.85587, 114.0, 1.0, 0.0, 0.028),
        (725, 0.99151516, 505.87338, 112.0, 1.0, 0.0, 0.04),
        (750, 0.99288887, 505.9002, 113.0, 1.0, 0.0, 0.076),
        (775, 0.9941818, 505.91504, 111.0, 1.0, 0.0, 0.1),
        (800, 0.99571717, 505.92828, 112.0, 1.0, 0.0, 0.12),
        (825, 0.99640405, 505.93427, 113.0, 1.0, 0.0, 0.148),
        (850, 0.9971717, 505.93918, 116.0, 1.0, 0.0, 0.176),
        (875, 0.99737376, 505.94177, 117.0, 1.0, 0.0, 0.228),
        (900, 0.9976162, 505.94492, 119.0, 1.0, 0.0, 0.276),
        (925, 0.9978586, 505.9505, 121.0, 1.0, 0.0, 0.332),
        (950, 0.998101, 505.95334, 130.0, 1.0, 0.0, 0.384),
        (975, 0.99842423, 505.95648, 130.0, 1.0, 0.0, 0.424),
        (1000, 0.99870706, 505.95844, 130.0, 1.0, 0.0, 0.476),
        (1025, 0.99866664, 505.97418, 130.0, 1.0, 0.0, 0.548),
        (1050, 0.993697, 505.92416, 103.0, 1.0, 0.0, 0.772),
        (1075, 0.9897778, 505.95264, 106.0, 1.0, 0.0, 0.832),
        (1100, 0.98561615, 505.9778, 90.0, 1.0, 0.0, 0.852),
        (1125, 0.984, 505.9955, 97.0, 1.0, 0.0, 0.864),
        (1150, 0.98468685, 505.99728, 99.0, 1.0, 0.0, 0.888),
        (1175, 0.98727274, 505.99634, 110.0, 1.0, 0.0, 0.904),
        (1200, 0.9883232, 506.00198, 125.0, 1.0, 0.0, 0.92),
        (1225, 0.99030304, 506.00134, 139.0, 1.0, 0.0, 0.936),
        (1250, 0.99220204, 505.9971, 147.0, 1.0, 0.0, 0.944),
        (1275, 0.9939394, 505.9968, 146.0, 1.0, 0.0, 0.952),
        (1300, 0.9951111, 505.99924, 143.0, 1.0, 0.0, 0.96),
        (1325, 0.9960404, 505.99915, 147.0, 1.0, 0.0, 0.964),
        (1350, 0.99680805, 506.00208, 147.0, 1.0, 0.0, 0.972),
        (1375, 0.99737376, 506.00372, 151.0, 1.0, 0.0, 0.976),
        (1400, 0.9978586, 506.00476, 157.0, 1.0, 0.0, 0.98),
        (1425, 0.9983838, 506.00797, 161.0, 1.0, 0.0, 0.984),
        (1450, 0.99874747, 506.007, 163.0, 1.0, 0.0, 0.984),
        (1475, 0.9990303, 506.0067, 169.0, 1.0, 0.0, 0.988),
        (1500, 0.9991515, 506.0072, 184.0, 1.0, 0.0, 0.988),
        (1525, 0.99923235, 506.00607, 187.0, 1.0, 0.0, 0.988),
        (1550, 0.99559593, 505.99066, 143.0, 1.0, 0.0, 1.0),
    ),
    "checked": (300, (0.991599977016449, 511.0, 132.0, 1.0, 0.0, 1.0),
                (93473884, 0, 86917537, 6556347, 5576681, 58855211, 7500000,
                 0, 0, 0, 1875000, 0, 0, 0),
                1250,
                (0.9955959320068359, 505.99066162109375, 143.0, 1.0, 0.0, 1.0),
                (436014582, 0, 419113983, 16900599, 10984596, 306075288,
                 38128754, 34389, 32234, 0, 9609381, 0, 0, 0),
                2, "1c6974c51c0d62cf5155cee2ba67e4c0"
                   "b3ed81e5a9e7d48f7ecbf5829400226f"),
}
PVIEW_1M = (1_048_576, 2048)
PVIEW_1M_BANKED = {"ticks": 50, "pv_coverage": 0.990914}  # CPU, older code
# the JAX package's 10^6 bootstrap on the CPU to tick 200 (`python -m
# tests.test_torch_pview_churn --ref-1m 200`, 3,259 s there): each
# check's tick and six stats (float32, shortest repr), and the 14 event
# totals at the last. Its run to the bar does not end within 45 minutes
# there; inside these checks min in-degree already falls (182 to 113)
# and pv_coverage's rise slows (0.0277 per 25 ticks to 0.0020). The
# script runs to tick 100: it checks the stats to there, and the event
# totals at tick 100 against `events_100`, the port's own on the H100
# (`python -m corrosion_tpu_torch.pview_converge 1048576 2048
# --skip-churn --max-ticks 100`), taken beside a run to tick 200 on the
# same card that equalled `events` and every check here (the JAX run to
# tick 100 needs ~42 GB of host memory, as the one to 200 did)
PVIEW_1M_TICKS = 100  # the script's depth
PVIEW_1M_REF = {
    "history": (
        (50, 0.8597574, 2047.0, 182.0, 1.0, 0.0, 1.0),
        (75, 0.8874893, 2047.0, 169.0, 1.0, 0.0, 1.0),
        (100, 0.90175056, 2047.0, 158.0, 1.0, 0.0, 1.0),
        (125, 0.90953827, 2047.0, 152.0, 1.0, 0.0, 1.0),
        (150, 0.9143543, 2047.0, 138.0, 1.0, 0.0, 1.0),
        (175, 0.917429, 2047.0, 125.0, 1.0, 0.0, 1.0),
        (200, 0.91946507, 2047.0, 113.0, 1.0, 0.0, 1.0),
    ),
    "events": (3108930198, 0, 2769435024, 339495174, 370701347,
               1582095122, 209715200, 0, 0, 0, 52428800, 0, 0, 0),
    "events_100": (1882463402, 0, 1549170212, 333293190, 353450311,
                   743234322, 104857600, 0, 0, 0, 26214400, 0, 0, 0),
}
BRIDGE_SCALE_N = 10_000  # bridge_scale.py's CLI keeps 100,000

# (n, g, m, slots, p_ok, dst_spread): tests/test_inbox_impls.py's cases
DEGENERATE_CASES = [
    (64, 128, 10, 16, 0.8, 64),
    (64, 128, 10, 4, 0.8, 8),
    (16, 400, 3, 2, 0.5, 16),
    (32, 64, 10, 16, 0.0, 32),
    (32, 64, 10, 16, 1.0, 1),
]
# (name, n, g, m, slots, p_ok, dst_spread or 0 for n)
EDGE_CASES = [
    ("skew", 10_000, 2_000_000, 5, 8, 0.8, 4),
    ("ragged_n", 10_007, 20_014, 5, 8, 0.8, 0),  # prime n
    ("G=0", 10_000, 0, 5, 8, 0.8, 0),
    ("m=1", 10_000, 20_000, 1, 8, 0.8, 0),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def slice_inbox_case(seed, dev):
    """Inputs at the pick-mode tick's inbox shapes: G = n * fanout
    packets of m = piggyback + antientropy messages."""
    p = bench_params(SLICE_N)
    g, m = SLICE_N * 2, p["piggyback"] + p["antientropy"]
    return (SLICE_N, p["incoming_slots"],
            ib.inputs(seed, SLICE_N, g, m, dev))


def phase_build() -> dict:
    smi = ib.nvidia_smi()
    print(smi, flush=True)
    t0 = time.monotonic()
    logs = _build.build()
    for name in _build.sources():
        _build.load(name)
    return {"phase": "build", "ok": True, "nvidia_smi": smi,
            "sources": _build.sources(), "build_s": time.monotonic() - t0,
            "ptxas": {k: [ln for ln in v.splitlines() if "ptxas info" in ln]
                      for k, v in logs.items()}}


def _imports(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


async def _gso_probe() -> dict:
    """256 KiB on one bi stream between two loopback QUIC endpoints: did
    the sending endpoint keep UDP GSO on, and how many batches, segments
    and diversions did its flushes make."""
    from corrosion_tpu_torch.net.quic import QuicEndpoint, QuicTransport
    from corrosion_tpu_torch.runtime.metrics import METRICS

    blob = bytes(range(256)) * 1024
    got = []

    async def on_bi(stream):
        while (frame := await stream.recv()) is not None:
            got.append(frame)
        await stream.send(b"ok")
        await stream.finish()

    async def nope(*_args):
        pass

    names = ("batches", "segments", "diverted")
    before = [METRICS.counter(f"corro.quic.gso.{n}").value for n in names]
    server = await QuicEndpoint.bind("127.0.0.1", 0)
    server.serve(nope, nope, on_bi)
    client = await QuicEndpoint.bind("127.0.0.1", 0)
    transport = QuicTransport(client)
    try:
        bi = await transport.open_bi(server.addr)
        await bi.send(blob)
        await bi.finish()
        ack = await asyncio.wait_for(bi.recv(), 60)
    finally:
        await transport.close()
        await client.close()
        await server.close()
    return {"gso_on": client._gso_ok,
            "transfer_ok": ack == b"ok" and b"".join(got) == blob,
            **{n: METRICS.counter(f"corro.quic.gso.{n}").value - b
               for n, b in zip(names, before)}}


async def _loopback_writes(n: int, size: int) -> float:
    """Seconds for `n` writes of `size` bytes (each write drained) from an
    asyncio server to a client reading on loopback TCP."""
    async def serve(_r, w):
        for _ in range(n):
            w.write(b"x" * size)
            await w.drain()
        w.close()

    srv = await asyncio.start_server(serve, "127.0.0.1", 0)
    t0 = time.monotonic()
    r, w = await asyncio.open_connection(
        "127.0.0.1", srv.sockets[0].getsockname()[1])
    got = 0
    while chunk := await asyncio.wait_for(r.read(65536), 30.0):
        got += len(chunk)
    wall = time.monotonic() - t0
    w.close()
    srv.close()
    if got != n * size:
        raise AssertionError(f"loopback: {got} of {n * size} bytes")
    return wall


def phase_host() -> dict:
    """What the card's host has for the API slice and the QUIC stack, and
    what its loopback TCP charges for the same 12,000 bytes in small and
    in large writes (the API writes each stream event as one write)."""
    import ctypes.util
    import sqlite3

    return {"phase": "host", "ok": True, "aiohttp": _imports("aiohttp"),
            "cryptography": _imports("cryptography"),
            "libnghttp2": ctypes.util.find_library("nghttp2"),
            "sqlite_version": sqlite3.sqlite_version,
            "udp_gso": asyncio.run(_gso_probe()),
            # 12,000 B each way: one machine of the card's kind charged
            # 48 ms per small write (3,000 of them took 144.86 s)
            "loopback_s": {
                "300x40B": asyncio.run(_loopback_writes(300, 40)),
                "3x4000B": asyncio.run(_loopback_writes(3, 4000))}}


REPO_ROOT = Path(__file__).resolve().parent
PORT_DIR = REPO_ROOT / "corrosion_tpu_torch"
ANALYSIS_PVIEW_N = 4096  # the pview slice's warm-up sim's n and K
ANALYSIS_CRDT_ROWS = 4096


class SyncRecorder:
    """Every synchronizing CUDA operation the card reports under
    `torch.cuda.set_sync_debug_mode("warn")`, each with the Python stack
    at the moment its warning is shown: the warning's own location is
    the innermost Python frame, which for an op torch wraps in Python
    (`torch.unique`, a graph capture's `synchronize`) is torch's file,
    so the caller's line is read off the stack instead."""

    # the warning of one sync (torch's `warn_or_error_on_sync`); the mode
    # itself warns once per process that it "does not yet detect all
    # synchronizing operations" (`torch.cuda.synchronize` is one)
    MESSAGE = "called a synchronizing CUDA operation"

    def __init__(self, label: str):
        self.label = label
        self.events = []

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if self.MESSAGE not in str(message):
            return self._prev(message, category, filename, lineno, file, line)
        self.events.append({
            "warned_at": (filename, lineno),
            "stack": traceback.extract_stack()[:-2],
        })

    def __enter__(self):
        torch.cuda.synchronize()
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        self._prev = warnings.showwarning
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)
        torch.cuda.synchronize()
        return False


def _rel(filename: str):
    """The repo path of a file of the port, None for any other file."""
    try:
        path = Path(filename).resolve()
        path.relative_to(PORT_DIR)
    except ValueError:
        return None
    return path.relative_to(REPO_ROOT).as_posix()


def _statement(ctx, rel: str, line: int) -> tuple:
    """(path, first line) of the innermost statement holding `line`: a
    card-reported frame line and a static finding's line meet there,
    whichever line of a multi-line statement each names."""
    best = None
    for node in ast.walk(ctx.file(rel).tree):
        if (isinstance(node, ast.stmt)
                and node.lineno <= line <= node.end_lineno
                and (best is None or node.lineno >= best.lineno)):
            best = node
    return (rel, best.lineno if best is not None else line)


def _device_roots(ctx):
    """{(path, root): [(first, last) line of each function of its
    closure]} from the analyzer's own kernel-purity closure."""
    from corrosion_tpu_torch.analysis.purity import (SCOPE,
                                                     KernelPurityChecker)

    out = {}
    for sf in ctx.walk(*SCOPE):
        fns = {n.name: n for n in sf.tree.body
               if isinstance(n, ast.FunctionDef)}
        for root, reach in KernelPurityChecker.closure(sf.tree).items():
            out[(sf.path, root)] = [(fns[f].lineno, fns[f].end_lineno)
                                    for f in reach]
    return out


def _sync_sites(rec: SyncRecorder, roots: dict) -> list:
    """Per reported sync: the innermost frame of the port (its site) and
    the device roots whose frames are on its stack."""
    out = []
    for ev in rec.events:
        frames = [(_rel(f.filename), f.lineno, f.name) for f in ev["stack"]]
        port = [f for f in frames if f[0] is not None]
        if not port:
            raise AssertionError(f"{rec.label}: a sync with no frame of the "
                                 f"port on its stack: {ev['warned_at']}")
        on_stack = {(p, name) for p, _ln, name in port} & set(roots)
        out.append({"site": port[-1][:2], "roots": sorted(on_stack),
                    "warned_at": ev["warned_at"]})
    return out


def sync_idioms(dev) -> dict:
    """{idiom: syncs the card reports for it}: what kernel-purity flags
    (`flagged`) and what it lets pass (`exempt`). An exempt idiom that
    reports a sync is a hole in the rule."""
    x = torch.arange(1000, device=dev)
    m = x % 3 == 0
    flagged = {
        "torch.tensor(list)": lambda: torch.tensor([1, 2], device=dev),
        "torch.as_tensor(int)": lambda: torch.as_tensor(3, device=dev),
        "x[mask]": lambda: x[m],
        "x[mask] = tensor": lambda: x.clone().__setitem__(m, x[:334]),
        "torch.where(cond)": lambda: torch.where(m),
        "nonzero": lambda: m.nonzero(),
        "repeat_interleave(tensor)": lambda: x[:10].repeat_interleave(
            x[:10] % 3),
        "bool()": lambda: bool(m.any()),
        ".item()": lambda: x.sum().item(),
        "torch.unique": lambda: torch.unique(x % 7),
        "masked_select": lambda: x.masked_select(m),
        "int()": lambda: int(x[3]),
        ".cpu()": lambda: x.cpu(),
        "torch.cuda.synchronize()": torch.cuda.synchronize,
    }
    exempt = {
        "x[mask] = 0": lambda: x.clone().__setitem__(m, 0),
        "masked_fill": lambda: x.masked_fill(m, 0),
        "x[int tensor]": lambda: x[x[:10]],
        "repeat_interleave(3)": lambda: x[:10].repeat_interleave(3),
        "torch.as_tensor(device tensor)": lambda: torch.as_tensor(
            x, device=dev),
    }
    out = {}
    for kind, cases in (("flagged", flagged), ("exempt", exempt)):
        out[kind] = {}
        for name, fn in cases.items():
            with SyncRecorder(name) as rec:
                fn()
            out[kind][name] = len(rec.events)
    holes = [name for name, n in out["exempt"].items() if n]
    if holes:
        raise AssertionError(f"idioms kernel-purity lets pass report syncs "
                             f"on the card: {holes}")
    return out


def phase_analysis(dev) -> dict:
    """The port's analyzer over this checkout (clean against its
    baseline), the syncs the card reports per idiom (`sync_idioms`),
    then kernel-purity held against the card: one dense pick
    tick at the slice's state and a second one, the dense stats pass, two
    pview ticks and its stats pass at n=4,096, K=256, and one crdt_merge
    batch that captures its CUDA graph and one that replays it, each
    under `set_sync_debug_mode("warn")`. Every sync the card reports at
    a line inside a device root's closure must be a site the static rule
    reports (raw: baselined and suppressed sites count)."""
    from corrosion_tpu_torch.analysis import (AnalysisContext, all_checkers,
                                              run_analysis)
    from corrosion_tpu_torch.analysis.purity import KernelPurityChecker

    t0 = time.monotonic()
    ctx = AnalysisContext(str(REPO_ROOT))
    result = run_analysis(ctx)
    lint_s = time.monotonic() - t0
    if not result.ok:
        raise AssertionError(
            "corro_lint on the port is not clean: "
            + "; ".join(f.render() for f in result.new)
            + "; stale: " + ", ".join(result.stale_keys))
    by_rule = {}
    for kind, found in (("baselined", [f for f, _ in result.baselined]),
                        ("suppressed", result.suppressed)):
        for f in found:
            by_rule.setdefault(f.rule, {"baselined": 0, "suppressed": 0})
            by_rule[f.rule][kind] += 1
    static = {_statement(ctx, f.path, f.line)
              for f in KernelPurityChecker().run(ctx)}
    roots = _device_roots(ctx)
    idioms = sync_idioms(dev)

    runs = []  # (label, the device root it calls, recorder)

    def record(label, root, fn):
        with SyncRecorder(label) as rec:
            out = fn()
        runs.append((label, root, rec))
        return out

    dense = ("corrosion_tpu_torch/ops/swim.py", "tick_impl")
    p = dict(bench_params(SLICE_N), gossip_mode="pick", inbox_impl="cuda")
    sim = ClusterSim(SLICE_N, seed=0, seed_mode="fingers", device=dev, **p)
    key = jr.PRNGKey(0)
    launches0 = inbox_cuda.build_inbox.launches
    state = record("dense_tick_first", dense, lambda: swim.tick_impl(
        sim.state, jr.fold_in(key, 0), sim.params))
    state = record("dense_tick", dense, lambda: swim.tick_impl(
        state, jr.fold_in(key, 1), sim.params))
    record("dense_stats", (dense[0], "_stats_sums"),
           lambda: swim._stats_sums(state.view, state.alive))
    dense_launches = inbox_cuda.build_inbox.launches - launches0
    if dense_launches != 2:
        raise AssertionError(f"analysis: 2 dense pick ticks launched the "
                             f"inbox kernel {dense_launches} times")
    del sim, state
    launches0 = inbox_cuda.build_inbox.launches
    pview = ("corrosion_tpu_torch/ops/swim_pview.py", "tick_impl")
    kw = dict(PVIEW_ARGS, slots=256, gossip_mode="pick")
    pv = PViewClusterSim(ANALYSIS_PVIEW_N, device=dev, **kw)
    pstate = record("pview_tick_first", pview, lambda: swim_pview.tick_impl(
        pv.state, jr.fold_in(key, 0), pv.params))
    pstate = record("pview_tick", pview, lambda: swim_pview.tick_impl(
        pstate, jr.fold_in(key, 1), pv.params))
    record("pview_stats", (pview[0], "_stats_impl"),
           lambda: swim_pview._stats_impl(pv.params, pstate.slot_packed,
                                          pstate.alive, pstate.t))
    del pv, pstate
    pview_launches = inbox_cuda.build_inbox.launches - launches0
    if pview_launches != 2:
        raise AssertionError(f"analysis: 2 pview pick ticks launched the "
                             f"inbox kernel {pview_launches} times")
    program = ("corrosion_tpu_torch/ops/crdt_merge.py", "_program")
    arrays = crdt_bench.scale_inputs(ANALYSIS_CRDT_ROWS, 0)
    packed = crdt_merge.pack_inputs(arrays)
    captures0 = crdt_merge.replay_stats()["captures"]
    for label in ("crdt_capture", "crdt_replay"):
        record(label, program, lambda: crdt_merge.run_packed(
            packed, arrays["num_groups"], arrays["num_cells"], dev))
    if crdt_merge.replay_stats()["captures"] != captures0 + 1:
        raise AssertionError("analysis: the crdt batch did not take the "
                             "captured path")
    missing = {r for _l, r, _rec in runs} - set(roots)
    if missing:
        raise AssertionError(f"analysis: {sorted(missing)} are not device "
                             f"roots of kernel-purity")

    # per run: the syncs with its root's frame on the stack (one tick or
    # one call each) and those with no root's frame (its host wrapper)
    per_root, outside = {}, {}
    sites, unreported = {}, []
    for label, root, rec in runs:
        evs = _sync_sites(rec, roots)
        per_root.setdefault("::".join(root), {})[label] = sum(
            root in ev["roots"] for ev in evs)
        outside[label] = sum(not ev["roots"] for ev in evs)
        for ev in evs:
            path, line = ev["site"]
            inside = [r for r in roots if r[0] == path and any(
                lo <= line <= hi for lo, hi in roots[r])]
            row = sites.setdefault(f"{path}:{line}", {
                "count": 0, "runs": set(), "in_closure_of": set(),
                "static": _statement(ctx, path, line) in static,
                "warned_at": "%s:%d" % ev["warned_at"]})
            row["count"] += 1
            row["runs"].add(label)
            row["in_closure_of"].update("::".join(r) for r in inside)
            if inside and not row["static"]:
                unreported.append(f"{path}:{line} ({label})")
    if unreported:
        raise AssertionError(
            "kernel-purity misses syncs the card reports inside a device "
            "root's closure: " + ", ".join(sorted(set(unreported))))
    return {
        "phase": "analysis", "ok": True,
        "lint": {"rules": len(all_checkers()), "new": len(result.new),
                 "stale": len(result.stale_keys),
                 "baselined": len(result.baselined),
                 "suppressed": len(result.suppressed),
                 "by_rule": by_rule, "lint_s": lint_s},
        "kernel_purity_static_sites": len(static),
        "idioms": idioms,
        "syncs_per_tick": per_root,
        "host_wrapper_syncs": outside,
        "sync_sites": {k: {**v, "runs": sorted(v["runs"]),
                           "in_closure_of": sorted(v["in_closure_of"])}
                       for k, v in sorted(sites.items())},
        "inbox_kernel_launches": dense_launches + pview_launches,
    }


def phase_inbox_kernel(dev) -> dict:
    cases = [slice_inbox_case(seed, dev) for seed in range(4)]
    for i, (n, g, m, slots, p_ok, spread) in enumerate(DEGENERATE_CASES):
        cases.append((n, slots, ib.inputs(99 + i, n, g, m, dev, p_ok, spread,
                                          2**20)))
    for i, (_, n, g, m, slots) in enumerate(ib.SHAPES[1:]):
        cases.append((n, slots, ib.inputs(120 + i, n, g, m, dev)))
    for i, (_, n, g, m, slots, p_ok, spread) in enumerate(EDGE_CASES):
        cases.append((n, slots, ib.inputs(130 + i, n, g, m, dev, p_ok,
                                          spread)))
    max_err = 0
    for n, slots, args in cases:
        got = inbox_cuda.build_inbox(n, slots, *args)
        ref = inbox_cuda.build_inbox_plain(n, slots, *args)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            max_err = max(max_err, int((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"inbox kernel differs from the plain "
                                     f"version at n={n}, slots={slots}")
        del got, ref
    return {"phase": "inbox_kernel", "ok": True, "cases": len(cases),
            "max_abs_err": max_err}


def kernels_per_call(n, slots, args) -> int:
    """The device operations `torch.profiler` sees in one `build_inbox`
    call: it must be exactly one kernel and no memset or copy."""
    inbox_cuda.build_inbox(n, slots, *args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        inbox_cuda.build_inbox(n, slots, *args)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in on_device]
    if len(on_device) != 1 or any(
            w in names[0].lower() for w in ("memset", "memcpy")):
        raise AssertionError(f"one build_inbox call ran {names} on the "
                             f"device, not exactly one kernel")
    return len(on_device)


def kernel_measurements(real_cases: str = "") -> dict:
    """The profiled and timed part of the kernels line: the device
    operations in one `build_inbox` call, the times per shape of
    `inbox_bench.SHAPES` and, where `real_cases` names a file saved by
    `fresh_kernel_measurements`, at each of its launches' inputs (each
    checked equal to the plain version first); and the floor of
    CUDA-event timing."""
    dev = torch.device("cuda:0")
    kernels = kernels_per_call(*slice_inbox_case(0, dev))
    shapes = ib.time_shapes(inbox_cuda.build_inbox,
                            inbox_cuda.build_inbox_plain, dev)
    for case in torch.load(real_cases) if real_cases else []:
        shapes.append(ib.time_case(
            inbox_cuda.build_inbox, inbox_cuda.build_inbox_plain,
            case["name"], case["n"], case["slots"],
            [a.to(dev) for a in case["args"]]))
    return {"kernels": kernels, "shapes": shapes,
            "event_floor_ms": ib.event_floor_ms()}


def fresh_kernel_measurements(real_cases) -> dict:
    """`kernel_measurements` in a fresh process. With torch 2.11 and CUDA
    12.8 on the H100 machines this runs on, the profiler keeps a kernel's
    device record only in sessions that start soon after a process's
    first one: later, the record falls outside the session's window
    (Kineto counts it out-of-range), and this run profiles again minutes
    after the CRDT slice's profiled batch. `real_cases` (each a path's
    name, n, slots and four inputs) go to it through a temporary file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "real_cases.pt")
        torch.save([{"name": name, "n": n, "slots": slots,
                     "args": [a.cpu() for a in args]}
                    for name, n, slots, args in real_cases], path)
        code = ("import json, sys, chip_smoke as c; "
                "print(json.dumps(c.kernel_measurements(sys.argv[1])))")
        out = subprocess.run([sys.executable, "-c", code, path],
                             cwd=Path(__file__).resolve().parent,
                             capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"kernel_measurements in a fresh process: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_tick_parity(dev) -> dict:
    n = 256
    base = bench_params(n)

    def partition(state):
        state = swim.set_partition(state, (np.arange(n) % 2).astype(np.int32))
        state = swim.set_degraded(state, [3, 17, 101], loss=0.3, lag=2)
        return swim.set_alive(state, 7, False)

    configs = [
        ("pick+cuda", dict(gossip_mode="pick", inbox_impl="cuda"), None),
        ("pick+cuda+lifeguard+loss+partition",
         dict(gossip_mode="pick", inbox_impl="cuda", lhm_max=4, loss=0.1),
         partition),
        ("shift", dict(gossip_mode="shift"), None),
    ]
    for name, kw, setup in configs:
        params = swim.SwimParams(n=n, **base, **kw)
        key = jr.PRNGKey(11)
        states = [swim.init_state(params, key, 3, "fingers", d)
                  for d in ("cpu", dev)]
        if setup:
            states = [setup(s) for s in states]
        for t in range(10):
            k = jr.fold_in(key, t)
            states = [swim.tick_impl(s, k, params) for s in states]
        cpu, gpu = states
        for field in swim.SwimState._fields:
            if not torch.equal(getattr(cpu, field), getattr(gpu, field).cpu()):
                raise AssertionError(f"{name}: field {field} differs between "
                                     f"the card and the CPU after 10 ticks")
    return {"phase": "tick_parity", "ok": True, "n": n, "ticks": 10,
            "configs": [c[0] for c in configs]}


def _states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in a._fields)


def phase_entry(dev) -> dict:
    """One tick of `entry()` on the card, bit-equal to the CPU's."""
    outs = []
    for d in (dev, "cpu"):
        fn, (state, key) = entry(device=d)
        outs.append(fn(state, key))
    if not _states_equal(*outs):
        raise AssertionError("entry(): the card's tick differs from the CPU's")
    return {"phase": "entry", "ok": True, "n": 1024, "ticks": 1}


def phase_pview_tick_parity(dev) -> dict:
    n, k = 256, 64
    base = dict(feeds_per_tick=4, feed_entries=16, tie_epoch=4)

    def faults(state):
        state = swim_pview.set_partition(
            state, (np.arange(n) % 2).astype(np.int32))
        state = swim_pview.set_degraded(state, [3, 17, 101], loss=0.3, lag=2)
        return swim_pview.set_alive_many(state, [7], False)

    configs = [
        ("fused+shift", dict(), None),
        ("fused+pick+cuda", dict(gossip_mode="pick", inbox_impl="cuda"),
         None),
        ("r5+pick+cuda+lifeguard+loss+partition",
         dict(tick_mode="r5", gossip_mode="pick", inbox_impl="cuda",
              lhm_max=4, loss=0.1), faults),
        ("r5+batched", dict(tick_mode="r5", feed_mode="batched"), None),
    ]
    for name, kw, setup in configs:
        params = swim_pview.PViewParams(n=n, slots=k, **base, **kw)
        key = jr.PRNGKey(11)
        states = [swim_pview.init_state(params, key, 3, "fingers", d)
                  for d in ("cpu", dev)]
        if setup:
            states = [setup(s) for s in states]
        for t in range(10):
            sub = jr.fold_in(key, t)
            states = [swim_pview.tick_impl(s, sub, params) for s in states]
        for field in swim_pview.PViewState._fields:
            if not torch.equal(getattr(states[0], field),
                               getattr(states[1], field).cpu()):
                raise AssertionError(f"pview {name}: field {field} differs "
                                     f"between the card and the CPU")
    return {"phase": "pview_tick_parity", "ok": True, "n": n, "slots": k,
            "ticks": 10, "configs": [c[0] for c in configs]}


def phase_pview_slice(dev, gossip_mode: str) -> dict:
    kw = dict(PVIEW_ARGS, gossip_mode=gossip_mode)
    warm = PViewClusterSim(4096, device=dev, **dict(kw, slots=256))
    warm.step(2)  # first launches of every op outside the clock
    warm.stats()
    del warm
    t0 = time.monotonic()
    sim = PViewClusterSim(PVIEW_N, device=dev, **kw)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    before = kernel_event_totals().get("pview", {})
    inbox_cuda.build_inbox.launches = 0
    t0 = time.monotonic()
    tick = sim.run_until_converged_device(0.99, 8, 2000, 10)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, ran = inbox_cuda.build_inbox.launches, sim.ticks
    peak = torch.cuda.max_memory_allocated()
    # telemetry: the run's published delta against its device lane
    after = kernel_event_totals()["pview"]
    lane = sim.state.events.cpu().numpy().astype(np.uint32)
    published = [after.get(e, 0.0) - before.get(e, 0.0)
                 for e in KERNEL_EVENTS]
    last_frame = FLIGHT.window(1, kernel="pview")[-1]["tick"]
    stats = sim.stats()
    vals = [stats[k] for k in PVIEW_STATS]
    # the run's wall holds one stats pass per 10 ticks; time both apart,
    # after every check has read the converged state
    st, p = sim.state, sim.params
    stats_s = []
    for _ in range(3):
        t1 = time.monotonic()
        swim_pview._stats_impl(p, st.slot_packed, st.alive, st.t).cpu()
        stats_s.append(time.monotonic() - t1)
    t1 = time.monotonic()
    sim.step(10)  # synchronizes at its end
    tick_ms = 1e3 * (time.monotonic() - t1) / 10
    out = {
        "phase": f"pview_slice_{gossip_mode}", "n": PVIEW_N,
        "slots": PVIEW_K, "gossip_mode": gossip_mode,
        "converged_tick": tick, "stats": dict(zip(PVIEW_STATS, vals)),
        "init_s": init_s, "wall_s": wall,
        "wall_ms_per_tick": 1e3 * wall / max(1, ran),
        "tick_ms": tick_ms, "stats_pass_ms": 1e3 * sorted(stats_s)[1],
        "inbox_kernel_launches": launches, "peak_mem_bytes": peak,
        "events": dict(zip(KERNEL_EVENTS, lane.tolist())),
        "last_flight_tick": last_frame,
    }
    want_launches = ran if gossip_mode == "pick" else 0
    ref_tick, ref_vals, ref_events = PVIEW_REF[gossip_mode]
    if (tick != ref_tick or stats["false_positive"] != 0.0
            or not np.allclose(vals, ref_vals, rtol=1e-6, atol=0)
            or lane.tolist() != list(ref_events)
            or launches != want_launches):
        raise AssertionError(f"pview slice off its reference: {out}, "
                             f"expected {PVIEW_REF[gossip_mode]} and "
                             f"{want_launches} kernel launches")
    if published != [float(v) for v in lane] or last_frame != ran - 1:
        raise AssertionError(f"pview telemetry: published {published}, "
                             f"lane {lane.tolist()}, last flight frame "
                             f"{last_frame} of {ran} ticks")
    out["ok"] = True
    return out


def _dense_boot(dev, n: int, gossip_mode: str, inbox_impl: str):
    """`bench.py`'s configuration at n, booted to 99.9 % coverage through
    `run_until_stable_device` (check every 5) after a warm-up sim: (its
    record, the sim)."""
    params = dict(bench_params(n), gossip_mode=gossip_mode,
                  inbox_impl=inbox_impl)
    warm = ClusterSim(n, seed=1, seed_mode="fingers", device=dev, **params)
    warm.warm_device_loop(0.999, 5000, 5)
    warm.step(5)  # first launches of every op outside the clock
    warm.stats()
    del warm
    sim = ClusterSim(n, seed=0, seed_mode="fingers", device=dev, **params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inbox_cuda.build_inbox.launches = 0
    t0 = time.monotonic()
    tick = sim.run_until_stable_device(0.999, 5000, 5)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = inbox_cuda.build_inbox.launches
    stats = sim.stats()
    out = {
        "n": n, "gossip_mode": gossip_mode, "inbox_impl": inbox_impl,
        "stable_tick": tick, "coverage": stats["coverage"],
        "false_positive": stats["false_positive"], "wall_s": wall,
        "ms_per_tick": 1e3 * wall / max(1, sim.ticks),
        "inbox_kernel_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    return out, stats, sim


def phase_slice(dev, gossip_mode: str, inbox_impl: str) -> dict:
    rec, stats, sim = _dense_boot(dev, SLICE_N, gossip_mode, inbox_impl)
    out = {"phase": f"slice_{gossip_mode}", **rec}
    tick, launches = rec["stable_tick"], rec["inbox_kernel_launches"]
    expect = SLICE_EXPECT[gossip_mode]
    want_launches = sim.ticks if inbox_impl == "cuda" and \
        gossip_mode == "pick" else 0
    if (tick != expect or stats["false_positive"] != 0.0
            or not np.float32(stats["coverage"]) >= np.float32(0.999)
            or launches != want_launches):
        raise AssertionError(f"slice run off its reference: {out}, expected "
                             f"stable tick {expect} and {want_launches} "
                             f"kernel launches")
    out["ok"] = True
    return out


def crdt_parity_cases() -> list:
    """(name, decision-program inputs, must be ambiguous) for the card
    against the CPU."""
    cases = [(f"rows_{r}", crdt_bench.scale_inputs(r, i), None)
             for i, r in enumerate((64, 4096, 2**20))]
    site, sent = bytes([1]) * 16, SENTINEL

    def ch(row, cid, val, cl, cv, dbv):
        return Change("kv", pack_columns([row]), cid, val, cv, dbv, 0, site,
                      cl, Timestamp.from_unix(dbv))

    rng = np.random.default_rng(5)
    batches = [
        ("tie_long_text", [ch(1, "a", "y" * 20, 1, 2, 1),
                           ch(1, "a", "y" * 30, 1, 2, 2)], True),
        ("tie_2^53", [ch(1, "b", 2**53, 1, 1, 1),
                      ch(1, "b", 2**53 + 1, 1, 1, 2)], True),
        ("one_change", [ch(1, "a", "x", 1, 1, 1)], False),
        ("sentinels_only", [ch(int(rng.integers(1, 20)), sent, None,
                               int(rng.integers(1, 6)), 1, j + 1)
                            for j in range(300)], False),
        ("one_pk", [ch(7, *(
            (sent, None, int(rng.integers(1, 6)), 1) if rng.random() < 0.1
            else (str(rng.choice(["a", "b", "c"])), int(rng.integers(0, 9)),
                  int(rng.choice([1, 1, 3, 5])), int(rng.integers(1, 5)))),
            j + 1) for j in range(500)], None),
        # tests/test_crdt_array.py's even-cl changes with a non-sentinel cid
        ("even_cl_cid_0", [ch(1, "a", "ghost", 2, 3, 1)], False),
        ("even_cl_cid_1", [ch(1, "a", "ghost", 2, 3, 1),
                           ch(1, "b", 7, 3, 1, 2)], False),
        ("even_cl_cid_2", [ch(1, "a", "x", 1, 1, 1),
                           ch(1, "b", "ghost", 2, 9, 2),
                           ch(1, "a", "y", 3, 1, 3)], False),
        ("even_cl_cid_3", [ch(1, sent, None, 2, 1, 1),
                           ch(1, "a", "ghost", 2, 5, 2)], False),
    ]
    for name, batch, ambiguous in batches:
        st = {c.pk: crdt_bench.fresh_state() for c in batch}
        cases.append((name, crdt_merge.marshal(batch, st).arrays, ambiguous))
    return cases


def phase_crdt_parity(dev) -> dict:
    """Each case through the program as `merge_table_array` runs it on the
    card (`crdt_merge.run_packed`: packed inputs, the shape's CUDA graph
    replayed) against `_merge_kernel` op by op on the CPU: every output
    equal."""
    names = []
    for name, arrays, ambiguous in crdt_parity_cases():
        got = crdt_merge.run_packed(
            crdt_merge.pack_inputs(arrays), arrays["num_groups"],
            arrays["num_cells"], dev)[0]
        want = crdt_merge.read_decisions(crdt_merge._merge_kernel(
            **crdt_inputs_to_torch(arrays, "cpu")))
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"crdt decision program: output {i} "
                                     f"differs between the card and the "
                                     f"CPU on {name}")
        if ambiguous is not None and bool(want[8]) != ambiguous:
            raise AssertionError(f"crdt case {name}: ambiguous is "
                                 f"{bool(want[8])}, not {ambiguous}")
        names.append(f"{name}:{len(arrays['grp'])}")
    return {"phase": "crdt_parity", "ok": True, "cases": names}


def _decision(rec) -> tuple:
    return tuple(rec["events"]), rec["declined"], rec["digest"]


def phase_crdt_slice(dev) -> dict:
    sizes = []
    for size, warm, batches in crdt_bench.schedule():
        before = kernel_event_totals().get("crdt_merge", {})
        frames = FLIGHT.window(1, kernel="crdt_merge")
        tick0 = frames[-1]["tick"] if frames else -1
        reads0 = crdt_merge.read_decisions.readbacks
        run = crdt_bench.run_rung(size, dev, (warm, batches))
        reads = crdt_merge.read_decisions.readbacks - reads0
        after = kernel_event_totals()["crdt_merge"]
        tick1 = FLIGHT.window(1, kernel="crdt_merge")[-1]["tick"]
        recs = [run["warm"]] + run["batches"]
        lane = np.sum([[0, 0, 0, r["events"][3]] if r["declined"]
                       else r["events"] for r in recs], axis=0)
        published = [after.get(e, 0.0) - before.get(e, 0.0)
                     for e in CRDT_MERGE_EVENTS]
        cpu = crdt_bench.run_rung(size, "cpu", (warm, batches))
        got = [_decision(r) for r in recs]
        if (got[1:] != CRDT_REF[size]
                or got != [_decision(r) for r in [cpu["warm"]]
                           + cpu["batches"]]):
            raise AssertionError(f"crdt rung {size}: the card decided "
                                 f"{got[1:]}, the reference "
                                 f"{CRDT_REF[size]}, the CPU "
                                 f"{[_decision(r) for r in cpu['batches']]}")
        if (published != [float(v) for v in lane] or tick1 - tick0 != len(recs)
                or reads != len(recs)):
            raise AssertionError(f"crdt rung {size} telemetry: published "
                                 f"{published}, lanes {lane.tolist()}, "
                                 f"{tick1 - tick0} frames and {reads} "
                                 f"readbacks for {len(recs)} batches")
        split = ("wall_ms", "marshal_ms", "h2d_ms", "device_ms",
                 "readback_ms", "rebuild_ms", "rows")
        out = {"phase": "crdt_rung", "size": size,
               "decisions_per_s": run["decisions_per_s"],
               "batches": [{k: r[k] for k in split} for r in run["batches"]],
               "peak_mem_bytes": run["peak_mem_bytes"], "ok": True}
        emit(out)
        sizes.append(size)
    prof = crdt_bench.profile_batch(dev, sizes[0])
    if prof["dtoh_copies"] != 1 or prof["htod_copies"] != 1:
        raise AssertionError(f"a profiled crdt batch made "
                             f"{prof['htod_copies']} host-to-device and "
                             f"{prof['dtoh_copies']} device-to-host copies, "
                             f"not one of the packed inputs and one "
                             f"readback")
    return {"phase": "crdt_slice", "ok": True, "sizes": sizes,
            "profiled_batch": {k: prof[k] for k in (
                "size", "device_ops", "htod_copies", "dtoh_copies")},
            "scale_rows": crdt_bench.SCALE_ROWS,
            "scale_device_ms": crdt_bench.scale_point_ms(dev)}


def _lane_counts(lane: dict) -> tuple:
    return lane["decided"], lane["declined"]


def phase_store_parity(dev) -> dict:
    """The parity workload through the port's store: `array` on the card
    and on the CPU, and `python`; every case's digest must equal
    `STORE_PARITY_REF`, and the card's array engine must decide and
    decline the batches its CPU run does (the two value ties decline)."""
    got, lanes = {}, {}
    for engine, where in (("array", dev), ("array", "cpu"),
                          ("python", dev)):
        with crdt_bench.engine_env(engine):
            mark = crdt_bench.lane_mark()
            digests = store_checks.parity_digests(store_checks.port_api(where))
            lanes[f"{engine}@{where}"] = crdt_bench.lane_since(mark)
        bad = sorted(k for k, v in STORE_PARITY_REF.items()
                     if digests.get(k) != v)
        if bad or set(digests) != set(STORE_PARITY_REF):
            raise AssertionError(f"store parity, {engine} on {where}: cases "
                                 f"{bad} differ from STORE_PARITY_REF")
        got[f"{engine}@{where}"] = len(digests)
    card, cpu = lanes[f"array@{dev}"], lanes["array@cpu"]
    if card != cpu or card["declined"] != 2 or card["decided"] == 0:
        raise AssertionError(f"store parity lanes: card {card}, CPU {cpu}")
    return {"phase": "store_parity", "ok": True, "cases": got,
            "array_batches": {"decided": card["decided"],
                              "declined": card["declined"]},
            "native": native.status()}


def phase_store_flood(dev) -> dict:
    """`crdt_bench.run_ab` at the script's schedule: per size, all three
    engines' final states equal `STORE_FLOOD_REF`, and the array engine's
    lane (batches decided and declined on the card, event totals) equals
    the JAX package's array engine over the same store run."""
    libs = native.status()
    if not libs["merge_batch"]:
        raise AssertionError("the native merge engine did not load: the "
                             "native column would be the Python engine")
    ab = crdt_bench.run_ab(device=dev)
    for rung in ab["rungs"]:
        size = rung["batch_size"]
        ref = STORE_FLOOD_REF[size]
        e2e = {r["engine"]: r for r in rung["end_to_end"]}
        bad = [e for e, r in e2e.items() if r["digest"] != ref["digest"]]
        lane = e2e["array"]["lane"]
        want = {k: ref[k] for k in ("decided", "declined", "events")}
        if bad or lane != want or lane["decided"] == 0:
            raise AssertionError(f"store flood {size}: engines {bad} off the "
                                 f"reference's state; array lane {lane}, "
                                 f"reference {want}")
        dec = {r["engine"]: r for r in rung["decision_only"]}
        emit({"phase": "store_flood_rung", "size": size,
              "changes_per_s": {e: r["changes_per_s"] for e, r in e2e.items()},
              "wall_s": {e: r["wall_s"] for e, r in e2e.items()},
              "decisions_per_s": {e: r["decisions_per_s"]
                                  for e, r in dec.items()},
              "array_split_ms": dec["array"].get("split_ms"),
              "array_batches": _lane_counts(lane), "ok": True})
    return {"phase": "store_flood", "ok": True, "native": libs,
            "sizes": [r["batch_size"] for r in ab["rungs"]],
            "card": [ab["device_kind"], ab["power_limit_w"]]}


def phase_store_ingest(dev) -> dict:
    """`ingest_bench.run`: both remote rungs under each engine end at
    `INGEST_REF`."""
    mark = crdt_bench.lane_mark()
    run = ingest_bench.run(device=dev)
    lane = crdt_bench.lane_since(mark)
    bad = [(r["rung"], r["engine"]) for r in run["rungs"]
           if r["digest"] != INGEST_REF[r["rung"]]]
    if bad or lane["decided"] == 0:
        raise AssertionError(f"ingest rungs {bad} off INGEST_REF; array "
                             f"lane {lane}")
    return {"phase": "store_ingest", "ok": True,
            "rows_per_s": {f"{r['rung']}/{r['engine']}": r["rows_per_s"]
                           for r in run["rungs"]},
            "array_batches": _lane_counts(lane)}


def phase_store_ingest_threads(dev) -> dict:
    """`ingest_bench.apply_concurrently`: both remote rungs under `array`
    into three stores each at once, one thread per store, six threads
    replaying the decision program's graphs together: every store ends at
    its rung's `INGEST_REF` and decided batches on the card."""
    t0 = time.monotonic()
    recs = ingest_bench.apply_concurrently(dev, stores=3)
    wall = time.monotonic() - t0
    bad = [r for r in recs if r["digest"] != INGEST_REF[r["rung"]]
           or r["lane"]["decided"] == 0]
    if bad or len(recs) != 2 * 3:
        raise AssertionError(f"threaded ingest: stores {bad} off INGEST_REF "
                             f"or deciding nothing")
    return {"phase": "store_ingest_threads", "ok": True,
            "stores": len(recs), "wall_s": wall,
            "array_batches": [sum(r["lane"][k] for r in recs)
                              for k in ("decided", "declined")],
            "replays": crdt_merge.replay_stats()}


def phase_store_replicas(dev) -> dict:
    """Three port stores on the card with `array` write, exchange their
    versions through the changeset codec and converge: every replica's
    dump equals `REPLICA_REF` (the JAX package's stores doing the same),
    and the converged part is one state."""
    with crdt_bench.engine_env("array"):
        mark = crdt_bench.lane_mark()
        t0 = time.monotonic()
        got = store_checks.replica_digests(store_checks.port_api(dev))
        wall = time.monotonic() - t0
        lane = crdt_bench.lane_since(mark)
    if (got != REPLICA_REF or len(set(got["converged"].values())) != 1
            or lane["decided"] == 0):
        raise AssertionError(f"replicas {got} differ from REPLICA_REF "
                             f"{REPLICA_REF}; array lane {lane}")
    return {"phase": "store_replicas", "ok": True, "wall_s": wall,
            "txs_per_replica": store_checks.REPLICA_TXS,
            "versions": got["versions"], "bytes": got["bytes"],
            "array_batches": _lane_counts(lane)}


def phase_agent_cluster(dev) -> dict:
    """Six port agents (stores on the card, `array`) on a random bootstrap
    topology write their own ranges and then the same shared ids: every
    agent's disjoint rows equal `AGENT_REF`, the shared ids are equal
    across the six, every writer's versions are booked everywhere with
    one `held_total`, the cluster holds six with no down-marking, and the
    decision program decided batches."""
    with crdt_bench.engine_env("array"), \
            tempfile.TemporaryDirectory(prefix="agent_cluster") as tmp:
        rec = asyncio.run(agent_checks.cluster_run(
            agent_checks.port_api(dev), tmp, **agent_checks.CHIP_CLUSTER,
            timeout=600.0))
    bad = agent_checks.cluster_checks(rec)
    got = {"disjoint_digest": rec["disjoint_digest"][0],
           "versions_per_writer": rec["versions_per_writer"],
           "rows_total": rec["rows_total"],
           "held_total": rec["held_total"][0]}
    if bad or got != AGENT_REF:
        raise AssertionError(f"agent cluster: {bad}; {got} against "
                             f"AGENT_REF {AGENT_REF}")
    return {"phase": "agent_cluster", "ok": True, "agents": rec["agents"],
            "rows_total": rec["rows_total"],
            "wall_to_converged_s": rec["wall_s"],
            "shared_winners": rec["shared_writers"],
            "array_batches": _lane_counts(rec["array_lane"]),
            **_replay_line(dev)}


def _replay_line(dev) -> dict:
    """This process's decision-program graphs (`crdt_merge.replay_stats`)
    and the peak device memory it reserved."""
    return {"replays": crdt_merge.replay_stats(),
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev)}


def _sync_rung(dev, engine: str, fire: bool, mode: str = "delta") -> dict:
    """`sync_bench.run_rung(100_000)` in `mode` at the script's seed."""
    with crdt_bench.engine_env(engine):
        rec = sync_bench.run_rung(
            100_000, fire, mode, sync_bench.seed_of(100_000, fire, mode),
            device=dev, cap_s=600.0)
        return asyncio.run(rec)


def _sync_line(dev, rec: dict) -> dict:
    return {k: rec[k] for k in ("engine", "wall_to_converged_s",
                                "load_wall_s", "delta_changes_received",
                                "changes_per_s", "rows_per_s",
                                "changes_in_by_source", "resume_waves")} | {
        "array_batches": _lane_counts(rec["array_lane"]),
        **_replay_line(dev)}


def _agent_sync_100k(dev, engine: str) -> dict:
    """`sync_bench.run_rung(100_000)` under `engine`: a cold node catches
    up the origin's 100,000 rows by delta sync; it meets the script's bar
    and ends at `SYNC_REF`, and under `array` every remote batch was
    decided on the card."""
    rec = _sync_rung(dev, engine, False)
    got = {k: rec[k] for k in SYNC_REF}
    lane = rec["array_lane"]
    if (got != SYNC_REF or rec["held_total"] != rec["origin_held_total"]
            or (lane["decided"] == 0) != (engine != "array")):
        raise AssertionError(f"agent sync 100k, {engine}: {got} against "
                             f"SYNC_REF {SYNC_REF}; held "
                             f"{rec['origin_held_total']}; lane {lane}")
    return {"phase": f"agent_sync_100k_{engine}", "ok": True,
            "rows": 100_000, **_sync_line(dev, rec)}


def phase_agent_sync_100k_array(dev) -> dict:
    return _agent_sync_100k(dev, "array")


def phase_agent_sync_100k_python(dev) -> dict:
    return _agent_sync_100k(dev, "python")


def phase_agent_sync_100k_fire(dev) -> dict:
    """The same rung under `array` with the concurrent writer: after it
    stops, the exact bar closes (rows, `held_total`, clock rows)."""
    rec = _sync_rung(dev, "array", True)
    rows = 100_000 + rec["fire_rows_written"]
    lane = rec["array_lane"]
    if (rec["rows_final"] != rows or rec["clock_rows_final"] != 2 * rows
            or rec["held_total"] != rec["origin_held_total"]
            or lane["decided"] == 0):
        raise AssertionError(f"agent sync 100k fire: {rec}")
    return {"phase": "agent_sync_100k_fire", "ok": True, "rows": rows,
            "fire_rows_written": rec["fire_rows_written"],
            **_sync_line(dev, rec)}


def phase_agent_local_writes(dev) -> dict:
    """The six local-write rungs of `bench_ingest.py` through one port
    agent's public write path (a local commit runs no merge engine):
    each rung's rows equal `INGEST_LOCAL_REF`."""
    with crdt_bench.engine_env("array"):
        recs = ingest_bench.run_local(device=dev)
    bad = [r["rung"] for r in recs
           if r["digest"] != INGEST_LOCAL_REF[r["rung"]]]
    if bad or len(recs) != len(INGEST_LOCAL_REF):
        raise AssertionError(f"local-write rungs {bad} off INGEST_LOCAL_REF")
    return {"phase": "agent_local_writes", "ok": True,
            "rungs": {r["rung"]: {k: r[k] for k in (
                "rows", "rows_per_s", "commit_p50_ms", "commit_p99_ms")}
                for r in recs}}


def _snapshot_line(dev, rec: dict) -> dict:
    return _sync_line(dev, rec) | {
        k: rec[k] for k in ("seed", "snapshot_installed", "snapshot_served",
                            "snapshot_raw_bytes", "snapshot_install_s")} | {
        "array_batches_after_install":
            _lane_counts(rec["array_lane_after_install"])}


def phase_agent_sync_100k_snapshot(dev) -> dict:
    """The script's quiet snapshot rung (seed 18) under `array`: the cold
    node installs the origin's snapshot once and tops up by delta sync;
    it meets the script's bar and ends at `SYNC_REF`, the origin served
    once, and the cold node kept its own site id. Its decision program
    may decide no batch: the snapshot can cover every version."""
    rec = _sync_rung(dev, "array", False, "snapshot")
    got = {k: rec[k] for k in SYNC_REF}
    if (got != SYNC_REF or rec["held_total"] != rec["origin_held_total"]
            or rec["snapshot_installed"] != 1
            or rec["snapshot_served"] != 1
            or not rec["site_id_is_actor_id"]):
        raise AssertionError(f"agent sync 100k snapshot: {got} against "
                             f"SYNC_REF {SYNC_REF}; {rec}")
    return {"phase": "agent_sync_100k_snapshot", "ok": True,
            "rows": 100_000, **_snapshot_line(dev, rec)}


def phase_agent_sync_100k_snapshot_fire(dev) -> dict:
    """The snapshot rung under the script's writer (seed 20): one
    install, the exact bar after the writer stops, and the top-up's fire
    batches decided on the card after the install."""
    rec = _sync_rung(dev, "array", True, "snapshot")
    rows = 100_000 + rec["fire_rows_written"]
    after = rec["array_lane_after_install"]
    if (rec["rows_final"] != rows or rec["clock_rows_final"] != 2 * rows
            or rec["held_total"] != rec["origin_held_total"]
            or rec["snapshot_installed"] != 1
            or not rec["site_id_is_actor_id"]
            or after is None or after["decided"] == 0):
        raise AssertionError(f"agent sync 100k snapshot fire: {rec}")
    return {"phase": "agent_sync_100k_snapshot_fire", "ok": True,
            "rows": rows, "fire_rows_written": rec["fire_rows_written"],
            **_snapshot_line(dev, rec)}


def phase_agent_chaos(dev) -> dict:
    """The script's `chaos_phase` (seed 29) under `array`: the partition
    opens a divergence episode on the first agent, all three agents
    converge to the 14,000 rows of `CHAOS_REF` with one `held_total`,
    the episode closes (one view group, nothing silent), and the
    partitioned node's catch-up batches were decided on the card."""
    with crdt_bench.engine_env("array"):
        rec = asyncio.run(sync_bench.chaos_phase(29, device=dev))
    after = rec["array_lane_after_heal"]
    if (rec["rows"] != CHAOS_REF["rows"]
            or rec["rows_digest"] != [CHAOS_REF["rows_digest"]] * 3
            or rec["held_total"] != [CHAOS_REF["held_total"]] * 3
            or rec["episodes"] < 1 or rec["final_groups"] != 1
            or rec["final_silent"] != 0 or rec["final_divergent"]
            or after["decided"] == 0):
        raise AssertionError(f"agent chaos: {rec} against CHAOS_REF "
                             f"{CHAOS_REF}")
    return {"phase": "agent_chaos", "ok": True, "rows": rec["rows"],
            "partition_writes": rec["partition_writes"],
            "detect_s": rec["detect_s"], "catchup_s": rec["catchup_s"],
            "episodes": rec["episodes"],
            "jax_episodes": CHAOS_REF["episodes"],
            "array_batches": _lane_counts(rec["array_lane"]),
            "array_batches_after_heal": _lane_counts(after),
            **_replay_line(dev)}


def phase_agent_net(dev) -> dict:
    """`scenario_net` at `CHIP_NET` over plaintext QUIC and over TCP,
    stores on the card with `array`: per transport the rows and the live
    query's rows equal `NET_REF`, one insert event per live-query row on
    B and on C, decided batches on both, and every canary saw its own
    row."""
    runs = []
    for transport in ("quic", "tcp"):
        with crdt_bench.engine_env("array"), tempfile.TemporaryDirectory(
                prefix=f"agent_net_{transport}") as tmp:
            rec = asyncio.run(agent_checks.scenario_net(
                agent_checks.port_api(dev), tmp, transport,
                **agent_checks.CHIP_NET, timeout=600.0))
        bad = agent_checks.net_checks(rec, NET_REF[transport])
        if bad:
            raise AssertionError(f"agent net over {transport}: {bad}")
        runs.append({
            "transport": transport, **rec["walls"],
            "events": {k: rec[k]["events"] for k in "bc"},
            "updates": {k: rec[k]["updates"] for k in "bc"},
            "array_batches": {k: _lane_counts(rec["array_lane"][k])
                              for k in "abc"},
            "canary_seen": rec["canary_seen"]})
    return {"phase": "agent_net", "ok": True,
            "rows": agent_checks.CHIP_NET["rows"],
            "txs": agent_checks.CHIP_NET["txs"], "runs": runs,
            **_replay_line(dev)}


def phase_agent_api(dev) -> dict:
    """`scenario_api` at `CHIP_NET` over plaintext QUIC, stores on the
    card with `array`, every client the port's h2 `CorrosionApiClient`:
    on B and on C the subscription stream's rows, `/v1/queries` (equal
    over HTTP/1.1 on the same port), both streams' events, `/v1/status`'s chaos census and the plane-off
    endpoints equal `API_REF`, both stores decided batches on the card,
    and B's API, stopped with both streams live, returns within 10 s
    while the streams end typed within 20 s."""
    inbox_cuda.build_inbox.launches = 0
    with crdt_bench.engine_env("array"), tempfile.TemporaryDirectory(
            prefix="agent_api") as tmp:
        rec = asyncio.run(agent_checks.scenario_api(
            agent_checks.port_api(dev), tmp, "quic",
            **agent_checks.CHIP_NET, timeout=600.0))
    # the API path runs no SWIM tick: the inbox kernel's count stays 0
    launches = inbox_cuda.build_inbox.launches
    bad = agent_checks.api_checks(rec, API_REF)
    if bad:
        raise AssertionError(f"agent api: {bad}")
    return {"phase": "agent_api", "ok": True, "transport": "quic",
            "rows": agent_checks.CHIP_NET["rows"],
            "txs": agent_checks.CHIP_NET["txs"],
            # the codec of the clients' live h2 connections in the run
            "hpack_codec": {k: rec[k]["hpack_codec"] for k in "bc"},
            **rec["walls"],
            "event_rate_per_s": {k: rec[k]["rate_per_s"] for k in "bc"},
            "events": {k: rec[k]["events"] for k in "bc"},
            "updates": {k: rec[k]["updates"] for k in "bc"},
            "array_batches": {k: _lane_counts(rec["array_lane"][k])
                              for k in "abc"},
            "restart": rec["restart"], "inbox_build_launches": launches,
            **_replay_line(dev)}


def phase_agent_planes(dev) -> dict:
    """`scenario_planes` at `CHIP_NET` over plaintext QUIC, stores on the
    card with `array`, every runtime plane on: the partition's and the
    sick disk's outcomes equal `PLANES_REF`, and the bounds of
    `planes_checks` hold (a kept trace for the disk's errors, hotspots
    from every node, the profiler under its overhead budget, every
    exported span at the sink, the rules' inputs in the TSDB, C's
    catch-up decided on the card)."""
    inbox_cuda.build_inbox.launches = 0
    with crdt_bench.engine_env("array"), tempfile.TemporaryDirectory(
            prefix="agent_planes") as tmp:
        rec = asyncio.run(planes_checks.scenario_planes(
            agent_checks.port_api(dev), tmp, "quic",
            **agent_checks.CHIP_NET, timeout=600.0))
    # the planes run no SWIM tick: the inbox kernel's count stays 0
    launches = inbox_cuda.build_inbox.launches
    bad = planes_checks.planes_checks(rec, PLANES_REF)
    if bad:
        raise AssertionError(f"agent planes: {bad}")
    sample = rec["tsdb"]["sample_seconds"]
    prof = rec["profile"]
    return {"phase": "agent_planes", "ok": True, "transport": "quic",
            "rows": rec["rows"], "txs": agent_checks.CHIP_NET["txs"],
            **rec["walls"],
            "profile": {"top_self": prof["top_self"][:8],
                        "overhead_pct": prof["overhead_pct"],
                        "max_overhead_pct": prof["max_overhead_pct"],
                        "shed": prof["shed"], "hz": prof["hz"],
                        "samples": prof["samples"],
                        "busy_secs_total": prof["busy_secs_total"]},
            "tsdb": {**rec["tsdb"]["census"], "samples_timed":
                     sample["count"], "sample_ms_mean":
                     1e3 * sample["sum"] / max(1.0, sample["count"]),
                     "never_published": rec["tsdb"]["never_published"]},
            "fired": rec["fired"], "remediation": rec["remediation"],
            "episodes": rec["episodes"], "incidents": rec["incidents"],
            "traces": rec["traces"], "otlp": rec["otlp"],
            "sick_disk_refused_writes": rec["sick_disk_refused_writes"],
            "array_batches": {k: _lane_counts(rec["array_lane"][k])
                              for k in "abc"},
            "c_catch_up_batches": _lane_counts(rec["c_catch_up_lane"]),
            "inbox_build_launches": launches, **_replay_line(dev)}


# `pubsub_bench.SCALE_RUNGS` this phase runs: 1,000 × 10 shared, 1,000
# distinct and 10,000 × 10 shared (the 100,000-stream rung is the CLI's)
PUBSUB_SCALE_RUNGS = pubsub_bench.SCALE_RUNGS[:3]


def phase_pubsub_bench(dev) -> dict:
    """`pubsub_bench`'s `--all` grid, each rung on one port agent whose
    store opens on the card: every rung must deliver `n_rows` events to
    each of its streams. Local commits run no merge engine: this is the
    host's serving plane on the card's machine."""
    rungs = []
    for n_rows, batch, n_subs, distinct in pubsub_bench.ALL_RUNGS:
        rec = asyncio.run(pubsub_bench.main(n_rows, batch, n_subs,
                                            distinct=distinct, device=dev))
        if rec["events_delivered"] != n_rows * n_subs:
            raise AssertionError(f"pubsub rung {rec['rung']}: "
                                 f"{rec['events_delivered']} events")
        rungs.append({k: rec[k] for k in (
            "rung", "events_delivered", "event_rate_per_s",
            "write_rate_per_s", "write_wall_s", "total_wall_s")})
    return {"phase": "pubsub_bench", "ok": True, "rungs": rungs}


def phase_pubsub_scale(dev) -> dict:
    """Three SUBS_SCALE rungs of `pubsub_bench` (`PUBSUB_SCALE_RUNGS`),
    each on one port agent whose store opens on the card: every stream
    must receive its events and the ladder's over-limit probe must be
    answered with the typed 503."""
    rungs = []
    for n_streams, n_queries, n_rows, distinct in PUBSUB_SCALE_RUNGS:
        rec = asyncio.run(pubsub_bench.streams_rung(
            n_streams, n_queries, n_rows, distinct=distinct, device=dev))
        if (rec["events_delivered"] != rec["events_expected"]
                or not rec["admission"]["over_limit_probe_rejected"]):
            raise AssertionError(f"subs rung {rec['rung']}: {rec}")
        rungs.append({
            **{k: rec[k] for k in (
                "rung", "events_delivered", "event_rate_per_s",
                "write_wall_s", "setup_wall_s", "total_wall_s",
                "deliver_p99_s", "matchers")},
            "write_rate_per_s": n_rows / rec["write_wall_s"]})
    return {"phase": "pubsub_scale", "ok": True, "rungs": rungs}


# a process that counts the cards (`cuInit`), then makes a context;
# it waits for a line on stdin after each step
CARD_PROBE = """import sys, torch
torch.cuda.device_count()
print("counted", flush=True)
sys.stdin.readline()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
print("context", flush=True)
sys.stdin.readline()
"""


def card_probe() -> dict:
    """`cli_checks.device_holders` calibrated on this host: a process
    that has only counted the cards must read as holding no context, and
    the same process once it made one must read as holding it."""
    proc = subprocess.Popen([sys.executable, "-c", CARD_PROBE],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    seen = {}
    try:
        for step in ("counted", "context"):
            line = proc.stdout.readline().strip()
            if line != step:
                raise AssertionError(f"card probe: {line!r} at {step}")
            seen[step] = cli_checks.device_holders({"p": proc.pid})["p"]
            proc.stdin.write("\n")
            proc.stdin.flush()
        proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if seen["counted"]["context"] or not seen["context"]["context"]:
        raise AssertionError(f"card probe: the holder check does not tell "
                             f"a context from cuInit here: {seen}")
    return {step: {k: h[k] for k in ("device_files", "mapped")}
            for step, h in seen.items()}


def phase_agent_cli(dev) -> dict:
    """`cli_checks.scenario_cli` at `CHIP_CLI`: three `python -m
    corrosion_tpu_torch agent` processes on the card (no `--device`:
    their default), stores deciding with `array`, driven only through the
    port's CLI (10,000 rows by `exec`, `query`, the admin commands,
    `template`, `backup` and `restore`, then `snapshot dump`, `snapshot
    install` and `agent --from-snapshot` for a fourth node): the outcome
    must equal `CLI_REF`, and every agent process must hold a context on
    the card and must not have loaded the inbox kernel's library
    (`device_holders`, calibrated by `card_probe`; read from each
    process's `/proc`, A before it stops, B, C and D after D caught up),
    so each made 0 inbox launches. Then `scale_ladder.rung0` (three
    in-process agents over `DevCluster`, default SWIM) in this process:
    full membership, every broadcast landed, FP 0 and no inbox launch
    (`build_inbox.launches`, set to 0 just before)."""
    probe = card_probe()
    with crdt_bench.engine_env("array"), tempfile.TemporaryDirectory(
            prefix="agent_cli") as tmp:
        rec = cli_checks.scenario_cli(cli_checks.port_api(), tmp,
                                      **cli_checks.CHIP_CLI, timeout=600.0)
    bad = cli_checks.cli_checks(rec, CLI_REF)
    holders = rec["device_holders"]
    off_card = [n for n, h in holders.items() if not h["context"]]
    if off_card:
        bad.append(f"agents without a context on the card: {off_card}")
    loaded = {n: h["libs_loaded"] for n, h in holders.items()
              if h["libs_loaded"]}
    if loaded:
        bad.append(f"agents loaded kernel libraries (launches unread): "
                   f"{loaded}")
    if bad:
        raise AssertionError(f"agent cli: {bad}")
    t0 = time.monotonic()
    inbox_cuda.build_inbox.launches = 0
    with crdt_bench.engine_env("array"):
        (rung0,) = scale_ladder.rung0(dev)
    rung0_launches = inbox_cuda.build_inbox.launches
    if rung0["false_positive"] != 0.0 or rung0_launches:
        raise AssertionError(f"ladder rung 0: {rung0}, "
                             f"{rung0_launches} inbox launches")
    by_process = {n: 0 for n in holders}
    return {"phase": "agent_cli", "ok": True,
            "rows": rec["rows"], "statements": rec["statements"],
            "exec_calls": rec["exec_calls"], **rec["walls"],
            "card_probe": probe, "device_holders": holders,
            "rung0": {**rung0, "wall_s": time.monotonic() - t0},
            "inbox_build_launches_by_process": {
                **by_process, "rung0": rung0_launches},
            "inbox_build_launches": sum(by_process.values())
            + rung0_launches}


# `TRAFFIC_SIM.json`'s scenario ids, the full matrix's (the JAX package's
# banked run; `tests/test_torch_traffic.py` holds them equal)
TRAFFIC_SCENARIOS = ("baseline", "geo-latency", "asym-partition",
                     "flap-storm", "churn-storm", "zombie-node", "slow-disk",
                     "sick-disk")


def phase_traffic_sim(dev) -> dict:
    """`traffic_sim.run_matrix(tiny=False)`, the full matrix the script
    banks (4 nodes, 8 scenarios of 6 s, observe-only), the stores on the
    card with `array`: every scenario passes `_assert_bars(rec,
    tiny=False)` inside the run (zero op timeouts, the availability
    floors, recovery under the cap, zero divergence at close), the ids
    are `TRAFFIC_SCENARIOS`, the churn-storm and zombie-node scenarios
    decided batches on the card (each scenario's array-lane delta per
    node, read around `run_scenario`), and the inbox kernel made no
    launch."""
    inbox_cuda.build_inbox.launches = 0
    lanes: dict = {}
    orig = traffic_sim.TrafficSim.run_scenario

    async def run_scenario(self, sid, injections):
        before = {n: (node.agent.store, dict(node.agent.store.array_lane))
                  for n, node in self.nodes.items() if node.agent}
        rec = await orig(self, sid, injections)
        lanes[sid] = {}
        for n, node in self.nodes.items():
            if node.agent is None:
                continue
            store = node.agent.store
            old, base = before.get(n, (None, {}))
            if old is not store:  # restarted: a new store's whole lane
                base = {}
            lanes[sid][n] = [store.array_lane[k] - base.get(k, 0)
                             for k in ("decided", "declined")]
        return rec

    traffic_sim.TrafficSim.run_scenario = run_scenario
    try:
        with crdt_bench.engine_env("array"):
            rec = asyncio.run(traffic_sim.run_matrix(False, device=dev))
    finally:
        traffic_sim.TrafficSim.run_scenario = orig
    ids = tuple(r["scenario"] for r in rec["scenarios"])
    if ids != TRAFFIC_SCENARIOS:
        raise AssertionError(f"traffic sim scenarios: {ids}")
    for sid in ("churn-storm", "zombie-node"):
        if not any(d for d, _ in lanes[sid].values()):
            raise AssertionError(f"traffic sim {sid}: nothing decided on "
                                 f"the card: {lanes[sid]}")
    launches = inbox_cuda.build_inbox.launches
    if launches:
        raise AssertionError(f"traffic sim: {launches} inbox launches")
    return {"phase": "traffic_sim", "ok": True, "nodes": rec["nodes"],
            "duration_per_scenario_secs": rec["duration_per_scenario_secs"],
            "wall_s": rec["wall_secs"],
            "scenarios": [{
                "scenario": r["scenario"],
                "availability": {st: r["stages"][st]["availability"]
                                 for st in ("write", "query")},
                "timeouts": sum(v["timeouts"]
                                for v in r["stages"].values()),
                "events": r["events_delivered"],
                "recovery_s": r["recovery"]["secs"],
                "array_lane": lanes[r["scenario"]],
                **({"alert": {k: r["alerts"][k] for k in (
                    "expected", "raised", "resolved")}}
                   if "alerts" in r else {}),
            } for r in rec["scenarios"]],
            "inbox_build_launches": launches, **_replay_line(dev)}


# The agent phases and the threaded store check, each in a process of
# its own, side by side: each is host-bound under its own interpreter
# lock (an agent's loops and apply threads), and the card serves their
# few-ms decision programs in turn. The cluster is the longest, so the
# others add no wall; the 100,000-member churn rung, bound by the card,
# runs beside them in that wall rather than after it. The two engines'
# runs of `agent_sync_100k` are two of them, printed as one line.
CHILD_PHASES = ("agent_cluster", "agent_sync_100k_array",
                "agent_sync_100k_python", "agent_sync_100k_fire",
                "agent_local_writes", "store_ingest_threads",
                "agent_sync_100k_snapshot", "agent_sync_100k_snapshot_fire",
                "agent_chaos", "pview_churn_100k")
# `agent_net`'s agents gossip over loopback sockets through a QUIC stack
# written in Python: beside the ten processes above on the host's eight
# cores they starved (on an H100 host a late joiner's catch-up and a
# connect timed out), so it runs in a process of its own beside the
# card-bound pview phases that follow them, whose host is idle.
# `agent_api`, `pubsub_bench`, `pubsub_scale` and `agent_planes`
# (host-bound serving planes) join it there, and `pview_churn_25k`,
# whose 200 s in this process set the group's wall, while this process
# runs the shorter pview phases.
LATE_CHILD_PHASES = ("agent_net", "agent_api", "pubsub_bench",
                     "pubsub_scale", "agent_planes", "pview_churn_25k")
# The operator surface and the chaos matrix, host-bound as the late
# children are, run beside the CRDT, store and bridge phases, where this
# process alone keeps the host busy (beside the late group the matrix's
# sick disk raised no alert in time: its TSDB sampler starved).
EARLY_CHILD_PHASES = ("agent_cli", "traffic_sim")
CHILD_PHASE_TIMEOUT_S = 900


@contextlib.contextmanager
def phase_children(names=CHILD_PHASES):
    """Every entry of `names` in a child process of this script at
    once, started on entry; yields a function that waits for them and
    returns their lines by name, each with the wall of its process. A
    child that fails fails the run with its output; one still running on
    exit is killed."""
    procs = []
    with tempfile.TemporaryDirectory(prefix="agent_phases") as tmp:
        try:
            for name in names:
                out = open(Path(tmp) / f"{name}.out", "w+")
                err = open(Path(tmp) / f"{name}.err", "w+")
                procs.append((name, out, err, time.monotonic(),
                              subprocess.Popen(
                                  [sys.executable, str(Path(__file__).resolve()),
                                   "--child-phase", name],
                                  stdout=out, stderr=err, text=True)))
            ends = {}
            watch = threading.Thread(target=_watch_children,
                                     args=(procs, ends), daemon=True)
            watch.start()
            yield lambda: _collect_children(procs, ends, watch)
        finally:
            for _name, out, err, _t0, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
                err.close()


def _watch_children(procs, ends: dict) -> None:
    """Record when each child ends (the parent may be busy then), until
    all have, one failed, or `CHILD_PHASE_TIMEOUT_S` has passed."""
    deadline = procs[0][3] + CHILD_PHASE_TIMEOUT_S
    failed = False
    while (len(ends) < len(procs) and not failed
           and time.monotonic() < deadline):
        for name, _out, _err, _t0, p in procs:
            if name not in ends and p.poll() is not None:
                ends[name] = time.monotonic()
                failed |= p.returncode != 0
        time.sleep(0.2)


def _collect_children(procs, ends: dict, watch) -> dict:
    watch.join()
    lines = {}
    # a failed child first, then one cut by the timeout
    for name, out, err, t0, p in sorted(
            procs, key=lambda x: x[4].poll() in (0, None)):
        rc = p.poll()
        out.seek(0)
        err.seek(0)
        text = out.read().strip()
        if rc != 0 or not text:
            tail = "\n".join(err.read().splitlines()[-30:])
            raise AssertionError(f"child phase {name}: rc {rc}\n"
                                 f"{text}\n{tail}")
        line = json.loads(text.splitlines()[-1])
        line["process_wall_s"] = ends[name] - t0
        lines[name] = line
    return lines


def _agent_lines(lines: dict) -> list:
    """`CHILD_PHASES`' lines in print order, the two engines' runs of
    `agent_sync_100k` as one line."""
    sync = [lines.pop(f"agent_sync_100k_{e}") for e in ("array", "python")]
    for line in sync:
        del line["phase"], line["ok"], line["rows"]
    lines["agent_sync_100k"] = {"phase": "agent_sync_100k", "ok": True,
                                "rows": 100_000, "engines": sync}
    # the script's in-band A/B: the delta rung's wall over the snapshot
    # rung's, both under `array` in this run
    snap = lines["agent_sync_100k_snapshot"]
    snap["snapshot_vs_delta_speedup"] = (
        sync[0]["wall_to_converged_s"] / snap["wall_to_converged_s"])
    return [lines[name] for name in (
        "store_ingest_threads", "agent_cluster", "agent_sync_100k",
        "agent_sync_100k_fire", "agent_sync_100k_snapshot",
        "agent_sync_100k_snapshot_fire", "agent_chaos",
        "agent_local_writes", "pview_churn_100k")]


def phase_bridge_wire(dev) -> dict:
    """The scripted datagram exchange against a bridge over ClusterSim(192)
    on the card and on the CPU: equal replies, equal to `BRIDGE_REF`. The
    card's run and one more `refresh()` go under one profiler session,
    read on the host's timeline (see `fresh_kernel_measurements` on
    the device records): no aten op and no CUDA call while a round is served,
    and one or two device-to-host copies issued by the `refresh()`."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    net = MemNetwork(seed=0)
    cpu = asyncio.run(bs.wire_replies(
        KernelPeerBridge(net, ClusterSim(192, seed=3, device="cpu")), net))
    net = MemNetwork(seed=0)
    card = KernelPeerBridge(net, ClusterSim(192, seed=3, device=dev))
    if card.sim.state.view.device.type != "cuda":
        raise AssertionError(f"the bridge's sim is on "
                             f"{card.sim.state.view.device}, not the card")
    with torch.profiler.profile(activities=acts) as prof:
        got = asyncio.run(bs.wire_replies(
            card, net, lambda: torch.profiler.record_function("wire.serve")))
        with torch.profiler.record_function("wire.refresh"):
            card.refresh()
    digest = bs.wire_digest(got)
    if got != cpu or digest != BRIDGE_REF[192]:
        raise AssertionError(f"bridge replies: {len(got)} on the card, "
                             f"{len(cpu)} on the CPU, sha256 {digest}, "
                             f"not {BRIDGE_REF[192]}")
    host = [e for e in prof.events() if e.device_type
            == torch.autograd.DeviceType.CPU]

    def inside(rng) -> list:
        return [e.name for e in host if e is not rng
                and rng.time_range.start <= e.time_range.start
                and e.time_range.end <= rng.time_range.end]

    served = [[n for n in inside(r) if n.startswith(("aten::", "cu"))]
              for r in host if r.name == "wire.serve"]
    copies = [n for r in host if r.name == "wire.refresh"
              for n in inside(r) if n.startswith("cudaMemcpy")]
    if len(served) != 3 or any(served):
        raise AssertionError(f"serving the script ran device work: "
                             f"{served}")
    if not 0 < len(copies) <= 2:
        raise AssertionError(f"one refresh() issued {copies}, not one or "
                             f"two device-to-host copies")
    return {"phase": "bridge_wire", "ok": True, "n": 192,
            "replies": len(got), "sha256": digest,
            "device_calls_while_serving": [len(x) for x in served],
            "refresh_copies": copies}


def phase_bridge_silent(dev) -> dict:
    """n=192: the port's prober must absorb 193 members and down exactly
    the three silent crashes by its own probe and suspicion."""
    rec = asyncio.run(bs.silent_pipeline(dev))
    if not rec["device"].startswith("cuda") or rec["cluster_size"] != 190:
        raise AssertionError(f"bridge_silent: {rec}")
    return {"phase": "bridge_silent", "ok": True, **rec}


def phase_bridge_scale(dev) -> dict:
    """`bridge_scale.py`'s largest rung cut to `BRIDGE_SCALE_N` members
    on the card, 50 crashes, gossip mode."""
    rec = asyncio.run(bs.rung(BRIDGE_SCALE_N, 50, "gossip", dev))
    torch.cuda.empty_cache()  # the rung's view is gone
    if not (rec["absorbed"] and rec["detected"]
            and rec["false_positives"] == 0 and rec["n_crash"] == 50
            and rec["cluster_size"] == BRIDGE_SCALE_N - 49
            and rec["device"].startswith("cuda")):
        raise AssertionError(f"bridge_scale: {rec}")
    return {"phase": "bridge_scale", "ok": True, **rec,
            "nvidia_smi": ib.nvidia_smi()}


def _dense_ref_check(name: str, tick, stats: dict, events) -> dict:
    """The run against `DENSE_REF[name]`: the stable tick, the three
    stats bit for bit in float32, the 14 event totals."""
    ref_tick, ref_stats, ref_events = DENSE_REF[name]
    got = [np.float32(stats[k]) for k in ("coverage", "detected",
                                          "false_positive")]
    if (tick != ref_tick or got != [np.float32(v) for v in ref_stats]
            or tuple(events) != ref_events):
        raise AssertionError(f"dense_ref {name}: tick {tick}, stats {got}, "
                             f"events {list(events)}; the reference: "
                             f"{DENSE_REF[name]}")
    return {"stable_tick": tick, "stats": [float(v) for v in got],
            "events": dict(zip(KERNEL_EVENTS, events))}


@contextlib.contextmanager
def last_inbox_dispatch():
    """Within the block, `dispatch_inbox` (as the dense and the pview
    tick each call it) keeps a reference to its inputs (no copy): the
    dict yielded holds the last call's as "args"."""
    last = {}
    dispatch = swim.dispatch_inbox

    def keep_last(*args):
        last["args"] = args
        return dispatch(*args)

    swim.dispatch_inbox = swim_pview.dispatch_inbox = keep_last
    try:
        yield last
    finally:
        swim.dispatch_inbox = swim_pview.dispatch_inbox = dispatch


def _real_case(name: str, last: dict, want: tuple) -> tuple:
    """(name, n, slots, inputs) of a path's last inbox launch, which must
    be at that path's (n, G, m, slots): on the dense paths G = 2n groups
    of m = 5 into 8 slots, on the pview pick path G = 2n of m = 12 into
    16."""
    _, n, slots, *args = last["args"]
    shape = (n, args[0].shape[0], args[1].shape[1], slots)
    if shape != want:
        raise AssertionError(f"{name}: inbox launched at (n, G, m, slots) "
                             f"= {shape}, not {want}")
    return name, n, slots, args


def phase_dense_ref(dev) -> tuple:
    """n=32,768 (the largest size at which the dense stats sum exactly):
    the `dense_100k` program and `bench.py`'s configuration against the
    JAX package's ticks, stats and event lanes. Returns the phase's line
    and the inputs of the pick run's last kernel launch."""
    shift = dense_100k.run(DENSE_REF_N, 25, device=dev, log=lambda s: None)
    checked = {"shift": _dense_ref_check(
        "shift", shift["convergence_ticks"] if shift["converged"] else None,
        shift, shift["events"])}
    with last_inbox_dispatch() as last:
        rec, stats, sim = _dense_boot(dev, DENSE_REF_N, "pick", "cuda")
    events = sim.state.events.cpu().numpy().astype(np.uint32).tolist()
    checked["pick"] = _dense_ref_check("pick", rec["stable_tick"], stats,
                                       events)
    if rec["inbox_kernel_launches"] != sim.ticks:
        raise AssertionError(f"dense_ref pick: {rec['inbox_kernel_launches']}"
                             f" kernel launches in {sim.ticks} ticks")
    case = _real_case("dense_ref_pick", last,
                      (DENSE_REF_N, 2 * DENSE_REF_N, 5, 8))
    return {"phase": "dense_ref", "ok": True, "n": DENSE_REF_N,
            "shift": {**checked["shift"], **{k: shift[k] for k in (
                "init_s", "compile_s", "convergence_wall_s", "ms_per_tick",
                "peak_mem_bytes")}},
            "pick": {**checked["pick"], **{k: rec[k] for k in (
                "wall_s", "ms_per_tick", "inbox_kernel_launches",
                "peak_mem_bytes")}}}, case


def phase_dense_100k_pick(dev) -> tuple:
    """`bench.measure` at the north star: 100,000 members, pick with the
    inbox kernel. Returns the phase's line and the inputs of the run's
    last kernel launch."""
    params = dict(bench_params(DENSE_100K_N), gossip_mode="pick",
                  inbox_impl="cuda")
    inbox_cuda.build_inbox.launches = 0
    with last_inbox_dispatch() as last:
        rec = bench.measure(DENSE_100K_N, 0.999, params, "fingers",
                            check_every=5, device=dev)
    counted = inbox_cuda.build_inbox.launches
    det = rec["detail"]
    tick = det["stable_tick"]
    case = _real_case("dense_100k_pick", last,
                      (DENSE_100K_N, 2 * DENSE_100K_N, 5, 8))
    _, n, slots, args = case
    out = {"phase": "dense_100k_pick", "n": DENSE_100K_N,
           "stable_tick": tick, "wall_s": rec["value"],
           "ms_per_tick": 1e3 * rec["value"] / max(1, tick or 0),
           "coverage": det["coverage"],
           "false_positive": det["false_positive"],
           "feeds_per_tick": det["feeds_per_tick"],
           "feed_entries": det["feed_entries"],
           "inbox_kernel_launches": det["inbox_kernel_launches"],
           "launches_with_warm_up": counted,
           "peak_mem_bytes": det["peak_mem_bytes"],
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "inbox_shape": {"n": n, "G": args[0].shape[0],
                           "m": args[1].shape[1], "slots": slots},
           "against": {"north_star_s": 60.0,
                       "BENCH_CPU_100k_stable_tick": 130},
           "nvidia_smi": ib.nvidia_smi()}
    if (tick is None or det["false_positive"] != 0.0
            or not np.float32(det["coverage"]) >= np.float32(0.999)
            or det["inbox_kernel_launches"] != tick
            or counted <= det["inbox_kernel_launches"]):
        raise AssertionError(f"dense_100k_pick: {out}")
    out["ok"] = True
    return out, case


def phase_dense_100k_shift(dev) -> dict:
    """The reference script's program at n=100,000, chunk 25."""
    rec = dense_100k.run(DENSE_100K_N, 25, device=dev, log=lambda s: None)
    out = {"phase": "dense_100k_shift", **{k: rec[k] for k in (
        "n", "chunk", "feeds_per_tick", "feed_entries", "convergence_ticks",
        "init_s", "compile_s", "convergence_wall_s", "ms_per_tick",
        "coverage", "false_positive", "converged", "history",
        "peak_mem_bytes", "device_kind", "power_limit_w")}}
    if not rec["converged"] or rec["false_positive"] != 0.0:
        raise AssertionError(f"dense_100k_shift: {out}")
    out["ok"] = True
    return out


def phase_ladder(dev) -> dict:
    """`scale_ladder.py`'s kernel rungs on the card against `LADDER_REF`."""
    recs = (scale_ladder.rung1(dev) + scale_ladder.rung2(dev)
            + scale_ladder.rung3(dev))
    got = dict(scale_ladder.checked(r) for r in recs)
    if got != LADDER_REF or any(r["platform"] != "gpu" for r in recs):
        raise AssertionError(f"ladder: {got}, the reference: {LADDER_REF}")
    return {"phase": "ladder", "ok": True, "rungs": got,
            "wall_s": {k: r["convergence_wall_s"] for k, r in zip(got, recs)},
            "per_tick_s_rung3": recs[-1]["per_tick_s"]}


def _quiet(line: str) -> None:
    pass


def _stats_close(got: tuple, want: tuple) -> bool:
    return len(got) == len(want) and np.allclose(got, want, rtol=1e-6,
                                                 atol=0)


def _churn_ref_check(name: str, rec: dict, want: tuple) -> dict:
    """The run against `want` (`pview_converge.checked` of the JAX
    program): ticks, event totals and the timeline exactly, the stats at
    rtol 1e-6 (float32 sums)."""
    got = pc.checked(rec)
    exact = (0, 2, 3, 5, 6, 7)
    if (any(got[i] != want[i] for i in exact)
            or not _stats_close(got[1], want[1])
            or not _stats_close(got[4], want[4])):
        raise AssertionError(f"{name}: {got}; the reference: {want}")
    return {"boot_tick": got[0], "detect_all_ticks": got[3],
            "timeline_rows": got[6]}


def _history_check(name: str, rec: dict, want: tuple) -> None:
    """Every check of the run against the JAX program's: the same ticks,
    the six stats at rtol 1e-6."""
    got = rec["history"]
    if (len(got) != len(want) or any(
            g[0] != w[0] or not _stats_close(tuple(g[1:]), w[1:])
            for g, w in zip(got, want))):
        raise AssertionError(f"{name}: history {got}; the reference: "
                             f"{want}")


def phase_pview_churn_ref(dev) -> tuple:
    """`pview_converge.run` at n=8,192, K=512 in shift and in pick+cuda
    against the JAX package's program. Returns the phase's line and the
    inputs of the pick run's last kernel launch."""
    out, case = {"phase": "pview_churn_ref", "n": PVIEW_CHURN_N[0],
                 "slots": PVIEW_CHURN_N[1]}, None
    for mode in ("shift", "pick"):
        inbox_cuda.build_inbox.launches = 0
        with last_inbox_dispatch() as last:
            rec = pc.run(*PVIEW_CHURN_N, gossip_mode=mode, device=dev,
                         log=_quiet)
        launches = inbox_cuda.build_inbox.launches
        ran = rec["ticks"] + (rec["churn"]["detect_all_ticks"] or 0)
        want = ran if mode == "pick" else 0
        if launches != want or rec["inbox_kernel_launches"] != want:
            raise AssertionError(f"pview_churn_ref {mode}: {launches} "
                                 f"kernel launches in {ran} ticks")
        out[mode] = {**_churn_ref_check(f"pview_churn_ref {mode}", rec,
                                        PVIEW_CHURN_REF[mode]),
                     "killed": rec["churn"]["killed"],
                     "inbox_kernel_launches": launches, "ticks_run": ran,
                     **{k: rec[k] for k in (
                         "compile_s", "boot_wall_s", "churn_wall_s",
                         "ms_per_tick", "churn_ms_per_tick",
                         "peak_mem_bytes")}}
        if mode == "pick":
            n = PVIEW_CHURN_N[0]
            case = _real_case("pview_churn_ref_pick", last,
                              (n, 2 * n, 12, 16))
    out["ok"] = True
    return out, case


def phase_pview_smoke(dev) -> dict:
    """`bench_smoke.run()` at its defaults against `SMOKE_REF`."""
    rec = bench_smoke.run(device=dev)
    got = bench_smoke.checked(rec)
    if (any(got[i] != SMOKE_REF[i] for i in (0, 2, 4))
            or not _stats_close(got[1], SMOKE_REF[1])
            or not _stats_close(got[3], SMOKE_REF[3])):
        raise AssertionError(f"pview_smoke: {got}; the reference: "
                             f"{SMOKE_REF}")
    det = rec["detail"]
    return {"phase": "pview_smoke", "ok": True, **{k: det[k] for k in (
        "n", "slots", "stable_tick", "churn_killed",
        "churn_detect_all_ticks", "init_s", "warm_s", "boot_wall_s",
        "churn_wall_s", "device_kind", "power_limit_w")}}


def phase_pview_flight(dev) -> dict:
    """The chaos soak's kernel phases, each in a recorder of its own while
    the global `FLIGHT` holds every earlier pview run's frames, against
    `FLIGHT_REF`; then two `churn_sweep` configurations against
    `SWEEP_REF`."""
    t0 = time.monotonic()
    foreign = len(FLIGHT.window(4096, kernel="pview"))
    kf = chaos_soak.kernel_flight_phase(7, dev)
    fl = chaos_soak.flaky_node_phase((3, 11), dev)
    got = chaos_soak.checked(kf, fl)
    if got != FLIGHT_REF:
        raise AssertionError(f"pview_flight: {got}; the reference: "
                             f"{FLIGHT_REF}")
    flight_s = time.monotonic() - t0
    sweep = {}
    for label in ("baseline", "lifeguard"):
        t0 = time.monotonic()
        rec = churn_sweep.run_config(label, *SWEEP_N, device=dev,
                                     **dict(churn_sweep.CONFIGS)[label])
        g, w = churn_sweep.checked(rec), SWEEP_REF[label]
        if (g[:3] != w[:3] or g[5] != w[5] or not _stats_close(g[3], w[3])
                or not _stats_close(g[4], w[4])):
            raise AssertionError(f"churn_sweep {label}: {g}; the "
                                 f"reference: {w}")
        sweep[label] = {"boot_ticks": g[1], "detect_all_ticks": g[2],
                        "wall_s": time.monotonic() - t0}
    return {"phase": "pview_flight", "ok": True,
            "global_pview_frames_before": foreign,
            "kernel_flight": got["kernel_flight"][:3],
            "flaky_detect_ticks": {r["seed"]: [r[m]["detect_ticks"] for m in (
                "vanilla", "lifeguard")] for r in fl["runs"]},
            "flight_s": flight_s, "sweep": sweep}


def _scale_line(rec: dict) -> dict:
    return {k: rec[k] for k in (
        "n", "slots", "ticks", "converged", "init_s", "compile_s",
        "boot_wall_s", "ms_per_tick", "stats_pass_ms", "peak_mem_bytes",
        "device_kind", "power_limit_w")}


def phase_pview_churn_25k(dev) -> dict:
    """`pview_converge.run` at n=25,000, K=512, shift (the banked
    `A-convergence-25000` configuration; 250 crashed), every check equal
    to `PVIEW_CHURN_25K_REF`: the churn path's witness between the 8,192
    reference and the 100,000 rung, which has none."""
    rec = pc.run(*PVIEW_25K, device=dev, log=_quiet)
    ref = PVIEW_CHURN_25K_REF
    out = {"phase": "pview_churn_25k",
           **_churn_ref_check("pview_churn_25k", rec, ref["checked"]),
           "killed": rec["churn"]["killed"], "checks": len(rec["history"]),
           **{k: rec[k] for k in ("n", "slots", "boot_wall_s",
                                  "churn_wall_s", "ms_per_tick",
                                  "churn_ms_per_tick", "peak_mem_bytes")},
           "banked_ticks_only": PVIEW_25K_BANKED}
    _history_check("pview_churn_25k", rec, ref["history"])
    out["ok"] = True
    return out


def phase_pview_churn_100k(dev) -> dict:
    """The script's default rung, n=100,000, K=2,048, shift: converged on
    the four-term bar, then all 1,000 crashes detected with FP 0 (within
    the 2,000-tick cap; the detected share at every check is printed, so
    that a drift shows before the cap)."""
    torch.cuda.empty_cache()
    rec = pc.run(*PVIEW_100K, device=dev, log=_quiet)
    churn = rec["churn"]
    out = {"phase": "pview_churn_100k", **_scale_line(rec),
           "killed": churn["killed"],
           "detect_all_ticks": churn["detect_all_ticks"],
           "detected_by_check": [(row[0], row[6]) for row in rec["history"]
                                 if row[0] > rec["ticks"]],
           "churn_wall_s": rec["churn_wall_s"],
           "churn_ms_per_tick": rec["churn_ms_per_tick"],
           "stats": rec["stats"], "churn_stats": churn["stats"],
           "timeline_rows": len(churn["timeline"]),
           "banked_ticks_only": PVIEW_100K_BANKED,
           "nvidia_smi": ib.nvidia_smi()}
    if (not pc.ok(rec) or churn["killed"] != 1000
            or churn["stats"]["detected"] != 1.0
            or churn["stats"]["false_positive"] != 0.0):
        raise AssertionError(f"pview_churn_100k: {out}")
    out["ok"] = True
    return out


def phase_pview_boot_1m(dev) -> dict:
    """The 10^6-member bootstrap, K=2,048, to tick `PVIEW_1M_TICKS`:
    every check (ticks 50, 75, 100) equal to `PVIEW_1M_REF`, the JAX
    package's program there, and the 14 event totals at tick 100 equal
    to its `events_100`, with FP 0 and full tables. The bar itself is
    not met there, nor within the script's 2,000 ticks (PERF.md §6)."""
    torch.cuda.empty_cache()
    rec = pc.run(*PVIEW_1M, max_ticks=PVIEW_1M_TICKS, skip_churn=True,
                 device=dev, log=_quiet)
    out = {"phase": "pview_boot_1m", **_scale_line(rec),
           "stats": rec["stats"], "table_bytes": PVIEW_1M[0] * PVIEW_1M[1] * 4,
           "history": rec["history"], "banked_ticks_only": PVIEW_1M_BANKED,
           "nvidia_smi": ib.nvidia_smi()}
    _history_check("pview_boot_1m", rec, tuple(
        w for w in PVIEW_1M_REF["history"] if w[0] <= PVIEW_1M_TICKS))
    raw = rec["raw"]["boot_stats"]
    if (rec["ticks"] != PVIEW_1M_TICKS
            or tuple(rec["raw"]["boot_events"]) != PVIEW_1M_REF["events_100"]
            or raw["false_positive"] != 0.0 or raw["occupancy"] != 1.0):
        raise AssertionError(f"pview_boot_1m: {out}; the reference: "
                             f"{PVIEW_1M_REF}")
    torch.cuda.empty_cache()
    out["ok"] = True
    return out


def phase_pview_profile(dev) -> dict:
    """`pview_profile.run` at a reduced shape: every phase row, the
    kernel's among them, and the memory ladder's rows, on the card."""
    n, k = 16_384, 512
    rec = pview_profile.run(n, k, 8, shapes=[(n, k)], iters=3, device=dev,
                            log=_quiet)
    rows = {r["phase"]: r["ms"] for r in rec["rows"]}
    if (len(rows) != 14 or f"inbox[cuda] G={2 * n}" not in rows
            or not all(np.isfinite(v) and v > 0 for v in rows.values())
            or [r["tick_mode"] for r in rec["ladder"]] != ["fused", "r5"]
            or not all(r["tick_peak_gb"] > r["live_gb"] > r["table_gb"]
                       for r in rec["ladder"])):
        raise AssertionError(f"pview_profile: {rec['text']}")
    return {"phase": "pview_profile", "ok": True, "n": n, "slots": k,
            "rows_ms": rows, "ladder": rec["ladder"]}


def phase_kernels(launches: dict, max_err: dict, real_cases) -> dict:
    """`launches` maps each kernel to {main path: launches}; `real_cases`
    are (path, n, slots, inputs) of launches on the main paths whose
    shapes `inbox_bench.SHAPES` does not hold."""
    measured = fresh_kernel_measurements(real_cases)
    shapes = measured["shapes"]
    at_slice = shapes[0]
    return {"kernels": [{
        "name": "inbox_build",
        "route": "cuda",
        "source": "corrosion_tpu_torch/csrc/inbox.cu",
        "replaces": "corrosion_tpu/ops/inbox_pallas.py:140",
        "launches": sum(launches["inbox_build"].values()),
        "launches_by_path": launches["inbox_build"],
        "max_abs_err": max_err["inbox_build"],
        "ms": at_slice["ms"],
        "plain_ms": at_slice["plain_ms"],
        "bound_ms": at_slice["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": shapes,
        "host_us": at_slice["host_us"],
        "event_floor_ms": measured["event_floor_ms"],
        "cluster_size": int(re.search(
            r"constexpr int kCluster = (\d+);",
            (_build.CSRC / "inbox.cu").read_text())[1]),
        "device_kernels_per_call": measured["kernels"],
    }]}


def timed(fn, *args):
    """Run one phase; its line gains the wall of the whole call as
    `wall_s`, or as `phase_wall_s` where it has a `wall_s` of its own."""
    t0 = time.monotonic()
    out = fn(*args)
    wall = time.monotonic() - t0
    line = out[0] if isinstance(out, tuple) else out
    line["phase_wall_s" if "wall_s" in line else "wall_s"] = wall
    return out


# the phases of this process that run beside `EARLY_CHILD_PHASES`
WINDOW_PHASES = ("crdt_parity", "crdt_slice", "store_parity", "store_flood",
                 "store_ingest", "store_replicas", "bridge_wire",
                 "bridge_silent", "bridge_scale")


def early_window(dev, **tag) -> dict:
    """`WINDOW_PHASES` in this process beside the early children; every
    line gains `tag`; returns the children's lines."""
    t0 = time.monotonic()
    with phase_children(EARLY_CHILD_PHASES) as early_children:
        for name in WINDOW_PHASES:
            emit({**timed(globals()[f"phase_{name}"], dev), **tag})
        early = early_children()
    for name in EARLY_CHILD_PHASES:
        early[name]["side_by_side_wall_s"] = time.monotonic() - t0
        emit({**early[name], **tag})
    return early


def window_ab(dev) -> None:
    """`--window-ab`: `WINDOW_PHASES` alone (in a child process: their
    checks count the copies of a process's first batches), then beside
    the early children in this process, each line tagged `window`
    (`alone`, `beside_early_children`): what the children's host load
    does to those phases' host-clock readings."""
    emit(timed(phase_build))
    alone = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--window-alone"],
        stdout=subprocess.PIPE, text=True)
    print(alone.stdout, end="", flush=True)
    if alone.returncode:
        raise AssertionError(f"--window-alone: exit {alone.returncode}")
    early_window(dev, window="beside_early_children")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    if sys.argv[1:2] == ["--child-phase"]:
        if sys.argv[2] not in (CHILD_PHASES + LATE_CHILD_PHASES
                               + EARLY_CHILD_PHASES):
            raise SystemExit(f"unknown child phase {sys.argv[2]!r}")
        emit(timed(globals()[f"phase_{sys.argv[2]}"], dev))
        return 0
    if sys.argv[1:2] == ["--window-ab"]:
        window_ab(dev)
        return 0
    if sys.argv[1:2] == ["--window-alone"]:
        for name in WINDOW_PHASES:
            emit({**timed(globals()[f"phase_{name}"], dev),
                  "window": "alone"})
        return 0
    t_start = time.monotonic()
    emit(timed(phase_build))
    emit(timed(phase_host))
    analysis = timed(phase_analysis, dev)
    emit(analysis)
    inbox = timed(phase_inbox_kernel, dev)
    emit(inbox)
    emit(timed(phase_entry, dev))
    emit(timed(phase_tick_parity, dev))
    emit(timed(phase_pview_tick_parity, dev))
    pick = timed(phase_slice, dev, "pick", "cuda")
    emit(pick)
    emit(timed(phase_slice, dev, "shift", "gsort"))
    pview_pick = timed(phase_pview_slice, dev, "pick")
    emit(pview_pick)
    emit(timed(phase_pview_slice, dev, "shift"))
    early = early_window(dev)
    dense_ref, ref_case = timed(phase_dense_ref, dev)
    emit(dense_ref)
    dense_100k_pick, case_100k = timed(phase_dense_100k_pick, dev)
    emit(dense_100k_pick)
    emit(timed(phase_dense_100k_shift, dev))
    emit(timed(phase_ladder, dev))
    # the children's host-bound agents leave the card mostly idle for
    # minutes: a pview phase, whose checks are exact and whose times no
    # bar reads, runs here meanwhile (not the dense phases: the north
    # star's wall is read alone)
    t0 = time.monotonic()
    with phase_children() as children:
        churn_ref, case_churn = timed(phase_pview_churn_ref, dev)
        emit(churn_ref)
        lines = _agent_lines(children())
    side_by_side = time.monotonic() - t0
    for line in lines:
        # a child's own wall is its process's (`process_wall_s`)
        line["side_by_side_wall_s"] = side_by_side
        emit(line)
    t0 = time.monotonic()
    with phase_children(LATE_CHILD_PHASES) as late:
        emit(timed(phase_pview_smoke, dev))
        emit(timed(phase_pview_flight, dev))
        emit(timed(phase_pview_boot_1m, dev))
        emit(timed(phase_pview_profile, dev))
        lines = late()
    for name in LATE_CHILD_PHASES:
        lines[name]["side_by_side_wall_s"] = time.monotonic() - t0
        emit(lines[name])
    paths = {"analysis": analysis["inbox_kernel_launches"],
             "agent_api": lines["agent_api"]["inbox_build_launches"],
             "agent_planes": lines["agent_planes"]["inbox_build_launches"],
             "agent_cli": early["agent_cli"]["inbox_build_launches"],
             "traffic_sim": early["traffic_sim"]["inbox_build_launches"],
             "dense_pick": pick["inbox_kernel_launches"],
             "pview_pick": pview_pick["inbox_kernel_launches"],
             "dense_ref_pick": dense_ref["pick"]["inbox_kernel_launches"],
             "dense_100k_pick": dense_100k_pick["inbox_kernel_launches"],
             "pview_churn_ref_pick":
                 churn_ref["pick"]["inbox_kernel_launches"]}
    kernels = timed(phase_kernels, {"inbox_build": paths},
                    {"inbox_build": inbox["max_abs_err"]},
                    [ref_case, case_100k, case_churn])
    print(json.dumps({"phase": "walls", "ok": True,
                      "script_wall_s": time.monotonic() - t_start,
                      "kernels_phase_wall_s": kernels.pop("wall_s"),
                      "limit_s": 1200}), flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
