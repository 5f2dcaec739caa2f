"""Well-known series of the port, declared in one place so that the emitting
module and a scraper cannot drift apart (the port's cut of
nice_tpu/obs/series.py: the series the port emits and every series that
obs/telemetry.snapshot reads, with the reference's names, help text, label
names and buckets, so that dashboards keyed on them read a port client
unchanged). Importing this module pre-seeds the label combinations the port
emits, so a scrape of a fresh process shows each series at 0.

nice_mesh_devices is set by parallel/mesh.make_mesh (1 until a field runs
on a mesh of slices), and a downshift counts in
nice_mesh_reshard_events_total and nice_mesh_reshard_seconds. The port has
no downgrade chain, so nice_engine_backend_downgrades_total stays 0.
nice_pallas_dispatch_seconds keeps its name: its kernel label is the
cuda_engine.LAUNCHES key of the launched CUDA kernel.
"""

from __future__ import annotations

from . import metrics

# Series the port reads but only the reference's server emits: its SLO specs
# (obs/slo.py) are over the server's request and spot-check series.
SERVER_SERIES = (
    "nice_api_request_seconds",
    "nice_api_requests_total",
    "nice_server_spot_checks_total",
)

ENGINE_BATCH_KERNEL_SECONDS = metrics.histogram(
    "nice_engine_batch_kernel_seconds",
    "Device kernel wall time per collected batch, by pipeline path.",
    labelnames=("path",),
)

ENGINE_HOST_FALLBACK = metrics.counter(
    "nice_engine_host_fallback_total",
    "Work routed to the host engine instead of the device, by reason.",
    labelnames=("reason",),
)

ENGINE_AUDITS = metrics.counter(
    "nice_engine_audit_total",
    "Device-vs-host audit re-checks performed on strided batches.",
)

ENGINE_DESCRIPTORS = metrics.counter(
    "nice_engine_stride_descriptors_total",
    "Stride descriptors dispatched to the device.",
)

ENGINE_NUMBERS = metrics.counter(
    "nice_engine_numbers_total",
    "Candidate numbers whose range processing completed, by mode.",
    labelnames=("mode",),
)

ENGINE_READBACK_BYTES = metrics.counter(
    "nice_engine_readback_bytes_total",
    "Device->host result bytes actually transferred, by payload kind "
    "(nm/count scalars, compacted survivor lists, folded stats, dense "
    "fallbacks, strided count tiles).",
    labelnames=("kind",),
)

ENGINE_STATS_TRANSFERS = metrics.counter(
    "nice_engine_stats_transfers_total",
    "Device->host transfers of the detailed stats accumulator, by mode. "
    "With device-resident accumulation this is ~1 per field, not 1 per batch.",
    labelnames=("mode",),
)

ENGINE_SURVIVOR_OVERFLOW = metrics.counter(
    "nice_engine_survivor_overflow_total",
    "Compacted survivor readbacks that overflowed the on-device cap and "
    "fell back to a dense per-lane transfer.",
)

ENGINE_FILTER_PRUNED = metrics.counter(
    "nice_engine_filter_pruned_total",
    "Candidates pruned on-device by the fused residue/stride filter before "
    "any limb math ran, by mode and base.",
    labelnames=("mode", "base"),
)

ENGINE_DISPATCHES = metrics.counter(
    "nice_engine_dispatches_total",
    "Device dispatches issued by the dense engine loops, by mode. With the "
    "megaloop one dispatch covers a whole segment (batch_size * segment "
    "lanes per device), so this collapses by the segment factor vs the "
    "per-batch feed.",
    labelnames=("mode",),
)

PALLAS_DISPATCH_SECONDS = metrics.histogram(
    "nice_pallas_dispatch_seconds",
    "Wall time of one pallas kernel dispatch call (async enqueue under jit;"
    " synchronous execution in interpreter mode).",
    labelnames=("kernel",),
)

MESH_DEVICES = metrics.gauge(
    "nice_mesh_devices",
    "Devices in the most recently constructed mesh.",
)

MESH_FEED_IDLE = metrics.histogram(
    "nice_mesh_feed_idle_seconds",
    "Host-side inter-dispatch gap in the device feed: time between one "
    "sharded dispatch returning and the next being issued. The double-"
    "buffered feed (NICE_TPU_FEED_DEPTH > 0) moves per-batch host "
    "arithmetic off this path, so the gap is the direct measure of feed "
    "overlap.",
    labelnames=("mode",),
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0),
)

MESH_RESHARDS = metrics.counter(
    "nice_mesh_reshard_events_total",
    "Elastic mesh downshifts: mid-field rebuilds over surviving devices "
    "after a device loss, by detection reason (device_lost = the dispatch "
    "raised MeshDeviceLost; probe = a post-failure device probe found the "
    "loss).",
    labelnames=("reason",),
)

MESH_RESHARD_SECONDS = metrics.histogram(
    "nice_mesh_reshard_seconds",
    "Wall time of one elastic downshift: partial-accumulator flush, mesh "
    "rebuild over survivors, re-slice of the remaining cursor range.",
    buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
)

MESH_SLICE_CURSOR = metrics.gauge(
    "nice_mesh_slice_cursor",
    "Per-slice scan cursor of the in-flight field (float: precision-lossy "
    "above 2^53, observability only — the checkpoint manifest carries the "
    "exact cursors).",
    labelnames=("slice",),
)

AUTOTUNE_EVENTS = metrics.counter(
    "nice_autotune_events_total",
    "Autotuner winners-table traffic: hit (a tuned winner was applied), miss"
    " (no entry; built-in default used), invalidated (entry dropped because"
    " its plan signature no longer matches this runtime), env_override (an"
    " NICE_TPU_* env var took precedence), sweep (a timing sweep ran), store"
    " (a winner was persisted).",
    labelnames=("event",),
)

CLIENT_REQUEST_SECONDS = metrics.histogram(
    "nice_client_request_seconds",
    "API round-trip latency per attempt, by endpoint.",
    labelnames=("endpoint",),
)

CLIENT_RETRIES = metrics.counter(
    "nice_client_retries_total",
    "Failed API attempts that triggered a backoff retry, by endpoint.",
    labelnames=("endpoint",),
)

CLIENT_FAILOVERS = metrics.counter(
    "nice_client_failovers_total",
    "Multi-server rotations: an endpoint attempt failed (conn_error/5xx/"
    "fence) and the client moved to the next configured server.",
    labelnames=("endpoint",),
)

CLIENT_FIELDS = metrics.counter(
    "nice_client_fields_total",
    "Fields fully processed by this client, by mode.",
    labelnames=("mode",),
)

CLIENT_NUMBERS = metrics.counter(
    "nice_client_numbers_total",
    "Candidate numbers processed by this client.",
)

CLIENT_FIELD_SECONDS = metrics.histogram(
    "nice_client_field_seconds",
    "Wall time to process one claimed field, by mode.",
    labelnames=("mode",),
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
             600.0, 1800.0),
)

CKPT_WRITES = metrics.counter(
    "nice_engine_checkpoint_writes_total",
    "Field-scan snapshots written (atomic manifest+payload files).",
)

CKPT_BYTES = metrics.counter(
    "nice_engine_checkpoint_bytes_total",
    "Bytes of snapshot data written to the checkpoint directory.",
)

CKPT_RESTORES = metrics.counter(
    "nice_engine_checkpoint_restores_total",
    "Field scans resumed from a validated snapshot instead of restarting.",
)

CKPT_BATCHES_SKIPPED = metrics.counter(
    "nice_engine_checkpoint_batches_skipped_total",
    "Dispatch batches skipped (not recomputed) thanks to a resumed cursor.",
)

CKPT_RENEWALS = metrics.counter(
    "nice_engine_checkpoint_renewals_total",
    "Successful /renew_claim heartbeats sent while scanning.",
)

CKPT_REJECTED = metrics.counter(
    "nice_engine_checkpoint_rejected_total",
    "Snapshots rejected on restore, by reason (corrupt CRC/truncation, "
    "plan-signature mismatch, state-contract version drift, unknown format "
    "version).",
    labelnames=("reason",),
)

FAULTS_INJECTED = metrics.counter(
    "nice_faults_injected_total",
    "Chaos faults actually fired, by injection site and action "
    "(NICE_TPU_FAULTS; zero in production unless someone armed the spec).",
    labelnames=("site", "action"),
)

ENGINE_BACKEND_DOWNGRADES = metrics.counter(
    "nice_engine_backend_downgrades_total",
    "Mid-field backend fallbacks after a dispatch failure "
    "(pallas -> jnp -> scalar chain).",
    labelnames=("from_backend", "to_backend"),
)

SPOOL_JOURNALED = metrics.counter(
    "nice_client_spool_journaled_total",
    "Finished submissions journaled to the on-disk spool after retry "
    "exhaustion instead of being dropped.",
)

SPOOL_REPLAYS = metrics.counter(
    "nice_client_spool_replays_total",
    "Spooled submissions replayed, by outcome (accepted / duplicate / "
    "rejected 4xx / failed-will-retry).",
    labelnames=("outcome",),
)

SPOOL_QUARANTINE_PRUNED = metrics.counter(
    "nice_spool_quarantine_pruned_bytes_total",
    "Bytes of quarantined (.rejected) spool entries deleted by the "
    "size/age retention sweep (NICE_TPU_SPOOL_QUARANTINE_MAX_BYTES / "
    "_MAX_AGE_SECS).",
)

STEPPROF_PHASE_SECONDS = metrics.histogram(
    "nice_stepprof_phase_seconds",
    "Per-field phase-attributed wall time from the device-step profiler "
    "(NICE_TPU_STEPPROF=1): compile / h2d_feed / device_compute / fold / "
    "readback / host_other, by mode, base and backend.",
    labelnames=("mode", "base", "backend", "phase"),
    buckets=(0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0),
)

SLO_STATE = metrics.gauge(
    "nice_slo_state",
    "Burn-rate alert state per SLO (0 = ok, 1 = warn, 2 = page).",
    labelnames=("slo",),
)
SLO_TRANSITIONS = metrics.counter(
    "nice_slo_transitions_total",
    "SLO alert state transitions, by SLO and entered state.",
    labelnames=("slo", "state"),
)

METRICS_BOUND_PORT = metrics.gauge(
    "nice_metrics_bound_port",
    "TCP port the local /metrics endpoint actually bound (matters when "
    "NICE_TPU_METRICS_PORT=0 asks for an ephemeral port; 0 = not serving).",
)

DAEMON_HEARTBEAT = metrics.gauge(
    "nice_daemon_heartbeat_timestamp_seconds",
    "Unix time of the daemon supervisor loop's last tick.",
)

DAEMON_RESTARTS = metrics.counter(
    "nice_daemon_client_restarts_total",
    "Client processes (re)started by the daemon.",
)

DAEMON_CPU = metrics.gauge(
    "nice_daemon_cpu_usage_ratio",
    "Most recent whole-machine CPU usage sample (0..1).",
)

DAEMON_RESTART_BACKOFF = metrics.gauge(
    "nice_daemon_restart_backoff_secs",
    "Crash-loop protection: the restart delay imposed after the client's "
    "latest short-lived nonzero exit (0 = no backoff; resets after a "
    "healthy run).",
)

MEM_RSS_BYTES = metrics.gauge(
    "nice_mem_rss_bytes",
    "Host resident set of this process at the last memwatch sample "
    "(utils/resources backend ladder: /proc -> psutil -> rusage peak).",
)

MEM_RSS_PEAK_BYTES = metrics.gauge(
    "nice_mem_rss_peak_bytes",
    "Process-lifetime peak resident set (getrusage ru_maxrss).",
)

MEM_DEVICE_BYTES = metrics.gauge(
    "nice_mem_device_bytes",
    "Accelerator bytes in use per device (device.memory_stats; absent "
    "stats report live-array bytes on that device instead).",
    labelnames=("device",),
)

MEM_DEVICE_PEAK_BYTES = metrics.gauge(
    "nice_mem_device_peak_bytes",
    "Accelerator peak bytes in use per device since process start "
    "(device.memory_stats peak_bytes_in_use where the backend exposes it).",
    labelnames=("device",),
)

MEM_DEVICE_LIMIT_BYTES = metrics.gauge(
    "nice_mem_device_limit_bytes",
    "Accelerator memory capacity per device (device.memory_stats "
    "bytes_limit; the exhaustion forecaster's HBM ceiling).",
    labelnames=("device",),
)

MEM_LIVE_ARRAYS = metrics.gauge(
    "nice_mem_live_arrays",
    "jax.live_arrays() population at the last memwatch sample.",
)

MEM_LIVE_ARRAY_BYTES = metrics.gauge(
    "nice_mem_live_array_bytes",
    "Total nbytes of jax.live_arrays() at the last memwatch sample.",
)

MEM_SAMPLES = metrics.counter(
    "nice_mem_samples_total",
    "Memwatch samples taken (stays 0 with NICE_TPU_MEMWATCH_SECS=0 — the "
    "memwatch-off proof, like stepprof's fence count).",
)

DISK_USAGE_BYTES = metrics.gauge(
    "nice_disk_usage_bytes",
    "On-disk footprint of each watched path (spool, quarantined spool "
    "entries, checkpoint dir, trace sink, SQLite ledger incl. the "
    "repl_ops journal).",
    labelnames=("what",),
)

DISK_FREE_BYTES = metrics.gauge(
    "nice_disk_free_bytes",
    "Free bytes on the filesystem holding the watched paths (statvfs; the "
    "exhaustion forecaster's disk headroom unless "
    "NICE_TPU_MEMWATCH_DISK_CAPACITY overrides it).",
)

PYPROF_SAMPLES = metrics.counter(
    "nice_pyprof_samples_total",
    "Thread-stack samples taken by the statistical profiler, attributed "
    "to the owning threadspec root ('unattributed' = a thread no "
    "ThreadRoot names; stays 0 with NICE_TPU_PYPROF_HZ=0).",
    labelnames=("root",),
)

PYPROF_STACKS = metrics.gauge(
    "nice_pyprof_stacks",
    "Distinct folded stacks currently retained across all roots "
    "(bounded by NICE_TPU_PYPROF_MAX_STACKS).",
)

PYPROF_OVERFLOW = metrics.counter(
    "nice_pyprof_overflow_total",
    "Samples collapsed into a root's (other) bucket because the folded-"
    "stack table hit NICE_TPU_PYPROF_MAX_STACKS.",
)

# --- multi-tenant scheduler (sched/) ------------------------------------
# Tenant labels are operator-chosen names, so nothing here is pre-seeded:
# the series appear the moment the scheduler dispatches its first page.
SCHED_PAGES = metrics.counter(
    "nice_sched_pages_total",
    "Device pages dispatched by the multi-tenant scheduler, by tenant. One "
    "page = one batch-aligned megaloop-segment quantum of a field.",
    labelnames=("tenant",),
)
SCHED_PAGE_SECONDS = metrics.histogram(
    "nice_sched_page_seconds",
    "Wall time of one scheduled page (engine dispatch + fold), by tenant. "
    "The per-tenant SLO specs (obs/slo.tenant_specs) burn against this.",
    labelnames=("tenant",),
    buckets=(0.01, 0.05, 0.25, 1.0, 2.5, 5.0, 15.0, 60.0, 300.0),
)
SCHED_PREEMPTIONS = metrics.counter(
    "nice_sched_preemptions_total",
    "Tenant turns ended at a segment boundary before their work drained, "
    "by preempted tenant and reason (quantum = time-slice expiry; "
    "slo_boost = a burning tenant took the mesh).",
    labelnames=("tenant", "reason"),
)
SCHED_OCCUPANCY = metrics.gauge(
    "nice_sched_tenant_occupancy",
    "Share of scheduler device-busy time attributed to each tenant over "
    "the run so far (0..1; sums to ~1 across tenants once work flows).",
    labelnames=("tenant",),
)
SCHED_MESH_OCCUPANCY = metrics.gauge(
    "nice_sched_mesh_occupancy",
    "Fraction of scheduler wall-clock the mesh spent executing pages "
    "(0..1) — the interleaving win over sequential single-tenant runs.",
)
SCHED_SLO_BURN = metrics.gauge(
    "nice_sched_slo_burn",
    "Short-window SLO burn rate per tenant (1.0 = burning exactly at the "
    "objective; drives the scheduler's priority boost).",
    labelnames=("tenant",),
)
SCHED_STARVED = metrics.counter(
    "nice_sched_tenant_starved_total",
    "Anti-starvation interventions: rounds where a runnable tenant had "
    "been skipped past the starvation bound and was force-scheduled.",
    labelnames=("tenant",),
)
SCHED_FIELDS = metrics.counter(
    "nice_sched_fields_total",
    "Fields fully drained (all pages folded) by the scheduler, by tenant.",
    labelnames=("tenant",),
)

FLIGHT_EVENTS = metrics.counter(
    "nice_flight_events_total",
    "Structured events appended to the in-process flight-recorder ring, "
    "by kind.",
    labelnames=("kind",),
)

FLIGHT_DUMPS = metrics.counter(
    "nice_flight_dumps_total",
    "Flight-recorder ring dumps written to disk, by trigger reason.",
    labelnames=("reason",),
)

TRACE_SPAN_SECONDS = metrics.histogram(
    "nice_trace_span_seconds",
    "Wall-clock duration of named trace spans.",
    labelnames=("span",),
)

FLIGHT_KNOWN_KINDS = ("dispatch_error", "retry", "fault", "checkpoint",
                      "restore", "downgrade", "spool", "quarantine",
                      "submit", "claim", "crash", "telemetry",
                      "mesh_reshard", "device_loss", "spot_check_fail",
                      "trust_slash", "consensus_hold", "slo_transition",
                      "journal_write_failed", "anomaly_transition",
                      "bottleneck_shift", "sched_preemption", "tenant_starved",
                      "quarantine_pruned")

# The cuda_engine.LAUNCHES keys of the launches themselves (not
# detailed_megaloop_plan, which counts K1's again): the kernel label of
# nice_pallas_dispatch_seconds.
KERNELS = ("detailed_megaloop", "uniques", "strided_niceonly", "niceonly_dense",
           "detailed_megaloop_mma", "niceonly_dense_mma")

# Pre-seed the label combinations the port emits.
MESH_DEVICES.set(1)
for _path in ("detailed", "dense", "strided"):
    ENGINE_BATCH_KERNEL_SECONDS.labels(_path)
for _kind in ("nm", "count", "survivors", "survivors-dense", "stats",
              "strided-counts"):
    ENGINE_READBACK_BYTES.labels(_kind)
ENGINE_STATS_TRANSFERS.labels("detailed")
for _reason in ("sliver", "host-route", "limbs"):
    ENGINE_HOST_FALLBACK.labels(_reason)
for _mode in ("detailed", "niceonly"):
    ENGINE_NUMBERS.labels(_mode)
    ENGINE_DISPATCHES.labels(_mode)
    MESH_FEED_IDLE.labels(_mode)
    CLIENT_FIELDS.labels(_mode)
    CLIENT_FIELD_SECONDS.labels(_mode)
for _reason in ("device_lost", "probe"):
    MESH_RESHARDS.labels(_reason)
for _kernel in KERNELS:
    PALLAS_DISPATCH_SECONDS.labels(_kernel)
for _ev in ("hit", "miss", "invalidated", "env_override", "sweep", "store"):
    AUTOTUNE_EVENTS.labels(_ev)
for _endpoint in ("claim", "submit", "validate", "renew", "telemetry"):
    CLIENT_REQUEST_SECONDS.labels(_endpoint)
    CLIENT_RETRIES.labels(_endpoint)
    CLIENT_FAILOVERS.labels(_endpoint)
for _reason in ("corrupt", "signature", "state_version", "version"):
    CKPT_REJECTED.labels(_reason)
for _outcome in ("delivered", "rejected", "deferred"):
    SPOOL_REPLAYS.labels(_outcome)
for _from, _to in (("pallas", "jnp"), ("jnp", "scalar")):
    ENGINE_BACKEND_DOWNGRADES.labels(_from, _to)
for _what in ("spool", "quarantine", "ckpt", "trace"):
    DISK_USAGE_BYTES.labels(_what)
PYPROF_SAMPLES.labels("unattributed")
for _kind in FLIGHT_KNOWN_KINDS:
    FLIGHT_EVENTS.labels(_kind)
for _reason in ("crash", "sigusr2", "quarantine", "manual"):
    FLIGHT_DUMPS.labels(_reason)
del (_path, _kind, _reason, _mode, _kernel, _ev, _endpoint, _outcome, _from,
     _to, _what)
