"""Process launcher: the torchrun role for a gang of ranks (counterpart
of ``bigdl_tpu.tools.launch``; reference: Engine.scala:93-137 derived
its topology from what spark-submit provided)::

    # one host, two ranks (two cards, or two ranks sharing one)
    python -m bigdl_tpu_torch.tools.launch --nproc 2 \\
        bigdl_tpu_torch/models/transformer/train.py --synthetic 20000 \\
        --sp ulysses --spSize 2
    # one host of four, each running one rank
    python -m bigdl_tpu_torch.tools.launch --nproc 1 \\
        --coordinator host0:12345 --nnodes 4 --node-rank 2 train.py

Each worker gets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
``BIGDL_RESTART_ATTEMPT``, so ``utils.engine.init_distributed()`` (no
arguments) starts the process group, and the port's root on
``PYTHONPATH``, so a script inside the package runs as a file. Output is
streamed with a ``[rank]`` prefix; the exit is non-zero if any worker
fails.

Fault handling, as in the JAX launcher, each result a typed
:class:`GangResult` of :class:`ProcExit` reports:

- startup failures (``--start-retries``): a worker that dies inside the
  ``--startup-grace`` window with rendezvous-shaped output (a bind
  conflict, a store or process-group timeout) restarts the whole gang
  on a fresh port through the port's ``faults.retry.retry_call``
  (classified, backoff with jitter);
- runtime failures (``--max-restarts``): one dead worker poisons the
  gang's collectives, so the survivors are put down and the gang
  relaunched at the same world size, each worker's ``Optimizer``
  resuming from the newest format-2 checkpoint;
- ``--timeout`` (the port's): a wall limit for the whole run, after
  which every worker is killed and the run fails (kind ``timeout``), so
  a collective that one rank never reaches cannot hang the caller.

Not ported yet (item 12, the elastic layer): resuming at another world
size from format-3 checkpoints, ``--ship-telemetry`` and
``tools.chaos --hostkill``. ``--cpu-devices`` (the JAX package's
virtual CPU devices) has no counterpart: a rank is a process here.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import signal as _signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional

__all__ = ["GangResult", "GangStartupError", "ProcExit", "build_args",
           "kill_gang", "main", "run_gang"]

#: the directory that holds the ``bigdl_tpu_torch`` package
_ROOT = str(Path(__file__).resolve().parents[2])


class GangStartupError(RuntimeError):
    """The gang died during bring-up with rendezvous-shaped output.
    Classified transient (a ``RuntimeError``), so ``retry_call`` retries
    the start on a fresh port."""


_STARTUP_RE = re.compile(
    r"Address already in use|EADDRINUSE|DistStoreError|"
    r"Timed out .*(store|rendezvous|client)|Connection (refused|reset)|"
    r"Failed to connect|barrier timed out|TCPStore", re.IGNORECASE)


@dataclasses.dataclass
class ProcExit:
    """One worker's typed exit report: ``kind`` is ``"ok"`` (rc 0),
    ``"startup"`` (died in the grace window with rendezvous-shaped
    output), ``"killed"`` (by a signal), ``"timeout"`` (put down at the
    wall limit) or ``"runtime"`` (any other non-zero exit). ``lines``
    is everything the worker printed."""

    rank: int
    returncode: Optional[int]
    kind: str
    signal: Optional[str] = None
    attempt: int = 0
    output_tail: str = ""
    lines: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GangResult:
    """A whole ``run_gang``: the final gang's reports, the restarts at
    both layers, the coordinator of the last attempt and, on failure,
    the worker whose death brought the gang down."""

    reports: List[ProcExit]
    ok: bool
    restarts: int = 0
    start_retries: int = 0
    coordinator: str = ""
    culprit: Optional[ProcExit] = None

    def failed(self) -> List[ProcExit]:
        return [r for r in self.reports if r.kind != "ok"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _signame(rc) -> Optional[str]:
    if rc is None or rc >= 0:
        return None
    try:
        return _signal.Signals(-rc).name
    except ValueError:
        return f"signal {-rc}"


class _Worker:
    """One worker process and the thread streaming its output."""

    def __init__(self, rank: int, proc: subprocess.Popen, echo: bool):
        self.rank = rank
        self.proc = proc
        self.echo = echo
        self.lines: List[str] = []
        self.tail: collections.deque = collections.deque(maxlen=80)
        self.thread = threading.Thread(target=self._stream, daemon=True)
        self.thread.start()

    def _stream(self):
        for line in iter(self.proc.stdout.readline, ""):
            self.lines.append(line)
            self.tail.append(line)
            if self.echo:
                sys.stdout.write(f"[{self.rank}] {line}")
                sys.stdout.flush()

    def tail_text(self) -> str:
        return "".join(self.tail)[-4000:]


def _command(args) -> List[str]:
    if getattr(args, "module", False):
        return [sys.executable, "-m", args.script] + args.script_args
    return [sys.executable, args.script] + args.script_args


def _launch_gang(args, coord: str, attempt: int) -> List[_Worker]:
    host, port = coord.rsplit(":", 1)
    total = args.nproc * args.nnodes
    workers = []
    for local in range(args.nproc):
        rank = args.node_rank * args.nproc + local
        env = dict(os.environ)
        env.update(getattr(args, "extra_env", None) or {})
        env.update(MASTER_ADDR=host, MASTER_PORT=port,
                   WORLD_SIZE=str(total), RANK=str(rank),
                   LOCAL_RANK=str(local), LOCAL_WORLD_SIZE=str(args.nproc),
                   BIGDL_RESTART_ATTEMPT=str(attempt),
                   PYTHONUNBUFFERED="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        p = subprocess.Popen(_command(args), env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        workers.append(_Worker(rank, p, getattr(args, "echo", True)))
    return workers


def kill_gang(workers, sig: Optional[int] = None) -> None:
    """Put a gang down: SIGTERM, a bounded wait, then SIGKILL (or
    ``sig`` at once to every live worker)."""
    live = [w for w in workers if w.proc.poll() is None]
    for w in live:
        try:
            os.killpg(w.proc.pid, sig or _signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + 10
    for w in live:
        while w.proc.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if w.proc.poll() is None:
            try:
                os.killpg(w.proc.pid, _signal.SIGKILL)
            except OSError:
                pass
            w.proc.wait()


def _join_threads(workers) -> None:
    for w in workers:
        w.thread.join(timeout=5)


def _reports(workers, attempt: int, kind_for) -> List[ProcExit]:
    out = []
    for w in workers:
        rc = w.proc.poll()
        out.append(ProcExit(rank=w.rank, returncode=rc,
                            kind=kind_for(w, rc), signal=_signame(rc),
                            attempt=attempt, output_tail=w.tail_text(),
                            lines=list(w.lines)))
    return out


def _start_gang(args, attempt: int, counters: dict, monitor=None):
    """One bring-up: launch, then watch the grace window. A worker dying
    there with rendezvous-shaped output kills the gang and raises
    :class:`GangStartupError`; any other fast death is the runtime
    path's."""
    coord = args.coordinator or f"127.0.0.1:{_free_port()}"
    counters["coordinator"] = coord
    workers = _launch_gang(args, coord, attempt)
    counters["workers"] = workers
    deadline = time.time() + args.startup_grace
    while time.time() < deadline:
        if monitor is not None:
            monitor(workers)
        rcs = [w.proc.poll() for w in workers]
        bad = [(w, rc) for w, rc in zip(workers, rcs)
               if rc is not None and rc != 0]
        if bad:
            w, rc = bad[0]
            time.sleep(0.3)  # let the tail drain before classifying
            if _STARTUP_RE.search(w.tail_text() or ""):
                culprit = w.rank
                kill_gang(workers)
                _join_threads(workers)
                counters["start_retries"] += 1

                def startup_kind(wk, wrc):
                    if wrc == 0:
                        return "ok"
                    if wk.rank == culprit:
                        return "startup"
                    return "killed" if wrc is not None and wrc < 0 \
                        else "runtime"

                counters["last_reports"] = _reports(workers, attempt,
                                                    startup_kind)
                raise GangStartupError(
                    f"worker {w.rank} died rc={rc} during the "
                    f"{args.startup_grace:.0f}s startup grace with "
                    "rendezvous-shaped output; retrying the gang on a "
                    "fresh port")
            return coord, workers
        if all(rc == 0 for rc in rcs):
            break
        time.sleep(0.1)
    return coord, workers


def run_gang(args, monitor: Optional[Callable] = None) -> GangResult:
    """Run the gang to its end with both recovery layers and the wall
    limit; returns the typed :class:`GangResult` (it never raises on a
    worker's failure). ``monitor(workers)`` runs at every poll."""
    from bigdl_tpu_torch.faults.retry import retry_call

    counters = {"start_retries": 0, "coordinator": ""}
    attempt = 0
    wall = getattr(args, "timeout", None)
    t_end = None if not wall else time.time() + wall
    while True:
        try:
            coord, workers = retry_call(
                _start_gang, args, attempt, counters, monitor,
                attempts=args.start_retries + 1, base_delay_s=0.5,
                max_delay_s=10.0, describe="gang start")
        except GangStartupError:
            reports = counters.get("last_reports", [])
            return GangResult(
                reports=reports, ok=False, restarts=attempt,
                start_retries=counters["start_retries"],
                coordinator=counters["coordinator"],
                culprit=next((r for r in reports
                              if r.kind == "startup"), None))
        failed = None
        timed_out = False
        while failed is None and any(w.proc.poll() is None
                                     for w in workers):
            if monitor is not None:
                monitor(workers)
            if t_end is not None and time.time() > t_end:
                timed_out = True
                break
            for w in workers:
                rc = w.proc.poll()
                if rc is not None and rc != 0:
                    failed = (w.rank, rc)
                    break
            else:
                time.sleep(0.2)
        if timed_out:
            live = {w.rank for w in workers if w.proc.poll() is None}
            kill_gang(workers, _signal.SIGKILL)
            _join_threads(workers)
            reports = _reports(
                workers, attempt,
                lambda w, rc: "timeout" if w.rank in live
                else ("ok" if rc == 0 else "runtime"))
            print(f"[launcher] wall limit {wall}s reached: ranks "
                  f"{sorted(live)} killed", flush=True)
            return GangResult(reports=reports, ok=False, restarts=attempt,
                              start_retries=counters["start_retries"],
                              coordinator=coord,
                              culprit=next((r for r in reports
                                            if r.kind == "timeout"), None))
        if failed is None:
            rcs = [w.proc.wait() for w in workers]
            bad = [(w.rank, rc) for w, rc in zip(workers, rcs) if rc != 0]
            if not bad:
                _join_threads(workers)
                return GangResult(
                    reports=_reports(workers, attempt, lambda w, rc: "ok"),
                    ok=True, restarts=attempt,
                    start_retries=counters["start_retries"],
                    coordinator=coord)
            failed = bad[0]
        kill_gang(workers)
        _join_threads(workers)

        def kind_for(w, rc):
            if rc == 0:
                return "ok"
            if rc is not None and rc < 0:
                return "killed"
            return "runtime"

        reports = _reports(workers, attempt, kind_for)
        if attempt >= args.max_restarts:
            return GangResult(reports=reports, ok=False, restarts=attempt,
                              start_retries=counters["start_retries"],
                              coordinator=coord,
                              culprit=next((r for r in reports
                                            if r.rank == failed[0]), None))
        attempt += 1
        print(f"[launcher] worker {failed[0]} died rc={failed[1]}; "
              f"gang restart {attempt}/{args.max_restarts}", flush=True)


def _refuse(cpu_devices: int, ship_telemetry) -> None:
    if cpu_devices:
        raise NotImplementedError(
            "--cpu-devices: the JAX package's virtual CPU devices have no "
            "counterpart here, where a rank is a process: launch --nproc "
            "N ranks instead")
    if ship_telemetry:
        raise NotImplementedError(
            "--ship-telemetry: the snapshot shipper and flight recorder "
            "are not ported yet (ROADMAP queue 1, item 12)")


def build_args(script: str, script_args=(), *, nproc: int = 1,
               nnodes: int = 1, node_rank: int = 0,
               coordinator: Optional[str] = None, cpu_devices: int = 0,
               max_restarts: int = 0, startup_grace: float = 20.0,
               start_retries: int = 3, extra_env: Optional[dict] = None,
               ship_telemetry: Optional[str] = None,
               timeout: Optional[float] = None, module: bool = False,
               echo: bool = True) -> argparse.Namespace:
    """The programmatic form of the CLI arguments (``run_gang``'s
    input). ``extra_env`` overlays each worker's environment;
    ``timeout`` is the wall limit in seconds; ``module`` runs
    ``python -m script``; ``echo`` streams the workers' output (the
    reports keep it either way)."""
    _refuse(cpu_devices, ship_telemetry)
    return argparse.Namespace(
        nproc=nproc, nnodes=nnodes, node_rank=node_rank,
        coordinator=coordinator, cpu_devices=cpu_devices,
        max_restarts=max_restarts, startup_grace=startup_grace,
        start_retries=start_retries, script=script,
        script_args=list(script_args), extra_env=dict(extra_env or {}),
        ship_telemetry=ship_telemetry, timeout=timeout, module=module,
        echo=echo)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Launch a gang of training ranks")
    ap.add_argument("--nproc", type=int, default=1,
                    help="processes (ranks) to start on THIS host")
    ap.add_argument("--nnodes", type=int, default=1,
                    help="total hosts participating")
    ap.add_argument("--node-rank", type=int, default=0,
                    help="this host's rank in [0, nnodes)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's store (default: a free "
                         "local port, one host)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="the JAX launcher's virtual CPU devices: raises "
                         "here (a rank is a process)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="gang-restart the workers up to N times after a "
                         "runtime failure (they resume from their newest "
                         "checkpoint)")
    ap.add_argument("--startup-grace", type=float, default=20.0,
                    help="seconds after launch in which a death with "
                         "rendezvous-shaped output is a startup failure")
    ap.add_argument("--start-retries", type=int, default=3,
                    help="retry a failed gang START this many times on a "
                         "fresh port")
    ap.add_argument("--timeout", type=float, default=None,
                    help="wall limit in seconds: past it every worker is "
                         "killed and the launch fails")
    ap.add_argument("--ship-telemetry", dest="ship_telemetry",
                    default=None, metavar="DIR",
                    help="not ported yet (item 12)")
    ap.add_argument("-m", dest="module", action="store_true",
                    help="run the script argument as a module")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    _refuse(args.cpu_devices, args.ship_telemetry)
    args.extra_env, args.echo = {}, True

    result = run_gang(args)
    for r in result.reports:
        sig = f" ({r.signal})" if r.signal else ""
        print(f"[launcher] rank {r.rank}: rc={r.returncode}{sig} "
              f"kind={r.kind} attempt={r.attempt}", flush=True)
    if result.ok:
        return 0
    bad = result.culprit or result.failed()[0]
    budget = (f"start-retries={args.start_retries}"
              if bad.kind == "startup"
              else f"max-restarts={args.max_restarts}")
    raise SystemExit(
        f"worker {bad.rank} failed rc={bad.returncode} "
        f"kind={bad.kind} and {budget} exhausted")


if __name__ == "__main__":
    main()
