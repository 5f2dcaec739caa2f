"""Idle-compute daemon (the port's copy of nice_tpu/daemon/main.py, which
hard-codes the JAX client): watches system CPU usage, spawns
`python -m nice_tpu_torch.client` once the machine has been idle long
enough, stops it with SIGINT on shutdown, and restarts it with a crash-loop
backoff whenever it exits. Every setting is a flag (the port reads no
environment variable). The daemon's nice_daemon_* series (heartbeat, CPU
sample, restarts, restart backoff) are served on --metrics-port, and it
arms the flight recorder and the memwatch and pyprof samplers as the
client does (its crash and SIGUSR2 dumps armed by daemon/__main__.py).

    python -m nice_tpu_torch.daemon [--checkpoint-dir DIR] [-- CLIENT ARGS]

The client's arguments default to --repeat; --checkpoint-dir is passed
through so a client the daemon restarts resumes its field.
"""

from __future__ import annotations

import argparse
import logging
import signal
import subprocess
import sys
import time
from typing import Optional

from nice_tpu_torch import obs
from nice_tpu_torch.obs import flight, logsink, memwatch, pyprof
from nice_tpu_torch.obs.series import (
    DAEMON_CPU,
    DAEMON_HEARTBEAT,
    DAEMON_RESTART_BACKOFF,
    DAEMON_RESTARTS,
)
from nice_tpu_torch.utils import resources

log = logging.getLogger("nice_tpu_torch.daemon")

read_cpu_times = resources.read_cpu_times


class CpuMonitor(resources.CpuMonitor):
    """resources.CpuMonitor with "proc" reads routed through THIS module's
    ``read_cpu_times`` global, so tests can stub the reader here."""

    def __init__(self, interval_secs: float = 5.0, backend: str | None = None):
        super().__init__(
            interval_secs, backend, reader=lambda: read_cpu_times()
        )


# Crash-loop protection (ProcessManager): a client that keeps dying within
# healthy_secs of spawn (broken config, dead server, bad install) would
# otherwise be respawned every sample interval forever.
RESTART_BACKOFF_BASE_SECS = 5.0
RESTART_BACKOFF_CAP_SECS = 600.0
HEALTHY_RUN_SECS = 60.0

CLIENT_MODULE = "nice_tpu_torch.client"


class ProcessManager:
    """Spawns/stops/restarts the client.

    Crash-loop protection: a nonzero exit within healthy_secs of spawn
    escalates an exponential restart backoff (base 5s, doubling, capped at
    10 min); a run that lasts healthy_secs — or any clean exit — resets
    it."""

    def __init__(self, client_args: list[str],
                 healthy_secs: float = HEALTHY_RUN_SECS):
        self.client_args = client_args
        self.proc: Optional[subprocess.Popen] = None
        self.healthy_secs = healthy_secs
        self.consecutive_crashes = 0
        self.starts = 0
        self._started_at: Optional[float] = None
        self._backoff_until = 0.0

    def command(self) -> list[str]:
        return [sys.executable, "-m", CLIENT_MODULE, *self.client_args]

    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def restart_delay(self) -> float:
        """Seconds until crash-loop backoff allows another start (0 = now)."""
        return max(0.0, self._backoff_until - time.monotonic())

    def start(self) -> None:
        if self.running():
            return
        cmd = self.command()
        log.info("starting client: %s", " ".join(cmd))
        self.proc = subprocess.Popen(cmd)
        self._started_at = time.monotonic()
        self.starts += 1
        DAEMON_RESTARTS.inc()

    def stop(self) -> None:
        if not self.running():
            return
        log.info("stopping client (pid %d)", self.proc.pid)
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def reap(self) -> bool:
        """True if the client exited since last check."""
        if self.proc is not None and self.proc.poll() is not None:
            code = self.proc.returncode
            ran = (
                time.monotonic() - self._started_at
                if self._started_at is not None else float("inf")
            )
            log.info("client exited with code %s", code)
            self.proc = None
            if code != 0 and ran < self.healthy_secs:
                self.consecutive_crashes += 1
                delay = min(
                    RESTART_BACKOFF_BASE_SECS
                    * 2 ** (self.consecutive_crashes - 1),
                    RESTART_BACKOFF_CAP_SECS,
                )
                self._backoff_until = time.monotonic() + delay
                DAEMON_RESTART_BACKOFF.set(delay)
                log.warning(
                    "client crashed %.1fs after spawn (crash %d in a row); "
                    "holding next spawn for %.0fs",
                    ran, self.consecutive_crashes, delay,
                )
            elif self.consecutive_crashes:
                self.consecutive_crashes = 0
                self._backoff_until = 0.0
                DAEMON_RESTART_BACKOFF.set(0)
                log.info("client ran healthily; restart backoff reset")
            return True
        return False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nice-tpu-torch-daemon")
    p.add_argument("--min-cpu", type=float, default=0.3,
                   help="spawn the client when usage stays below this "
                   "fraction")
    p.add_argument("--wait-time", type=float, default=30.0,
                   help="seconds of idleness required before spawning")
    p.add_argument("--sample-interval", type=float, default=5.0,
                   help="seconds per CPU sample")
    p.add_argument("--healthy-secs", type=float, default=HEALTHY_RUN_SECS,
                   help="a client that exits nonzero sooner than this after "
                   "its spawn counts as a crash (restart backoff)")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--log-file", default=None,
                   help="also append the JSON log lines to this file")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the daemon's /metrics on this localhost port "
                   "(0: a free port)")
    p.add_argument("--memwatch-secs", type=float,
                   default=memwatch.DEFAULT_INTERVAL_SECS,
                   help="seconds between RSS / disk samples; 0 disables")
    p.add_argument("--pyprof-hz", type=float, default=pyprof.DEFAULT_HZ,
                   help="samples a second of the statistical Python "
                   "profiler; 0 disables")
    p.add_argument("--flight-dir", default=None,
                   help="directory of flight-recorder dumps; default: the "
                   "system temp dir")
    p.add_argument("--flight-events", type=int,
                   default=flight.DEFAULT_CAPACITY,
                   help="events the flight recorder's ring keeps")
    p.add_argument("--checkpoint-dir", default=None,
                   help="passed through to the client: snapshot directory so "
                   "a client that is restarted resumes its field")
    p.add_argument("client_args", nargs="*", default=["--repeat"],
                   help="arguments passed through to the client")
    return p


def client_args_of(args) -> list[str]:
    """The client's arguments: the pass-through list (--repeat when empty)
    plus --checkpoint-dir when the daemon was given one."""
    client_args = list(args.client_args or ["--repeat"])
    if args.checkpoint_dir and "--checkpoint-dir" not in client_args:
        client_args += ["--checkpoint-dir", args.checkpoint_dir]
    return client_args


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logsink.install(args.log_level, args.log_file)
    # The local endpoint: the heartbeat gauge and restart counter make a
    # silently dead supervisor loop visible from outside.
    obs.maybe_serve_metrics(args.metrics_port)
    flight.configure(args.flight_dir, args.flight_events)
    memwatch.maybe_start_sampler(args.memwatch_secs)
    pyprof.configure(args.pyprof_hz)
    pyprof.maybe_start()
    monitor = CpuMonitor(args.sample_interval)
    log.info("cpu sampler backend: %s", monitor.backend)
    manager = ProcessManager(client_args_of(args), args.healthy_secs)
    idle_since: Optional[float] = None
    try:
        while True:
            usage = monitor.sample()
            DAEMON_HEARTBEAT.set(time.time())
            DAEMON_CPU.set(usage)
            manager.reap()
            if manager.running():
                # While our client runs the CPU is busy by design.
                continue
            if usage < args.min_cpu:
                if idle_since is None:
                    idle_since = time.monotonic()
                if time.monotonic() - idle_since >= args.wait_time:
                    # Crash-loop protection: idle_since stays set, so the
                    # spawn happens on the first tick after backoff expiry.
                    if manager.restart_delay() <= 0:
                        manager.start()
                        idle_since = None
            else:
                idle_since = None
                log.debug("cpu busy (%.0f%%), holding off", usage * 100)
    except KeyboardInterrupt:
        log.info("interrupted; stopping client")
        manager.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
