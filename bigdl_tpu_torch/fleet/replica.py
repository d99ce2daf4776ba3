"""One generation-serving replica: an engine and decode loop behind a
health breaker (counterpart of ``bigdl_tpu.fleet.replica``).

A **replica** is the fleet's unit of failure and of capacity: its own
:class:`~bigdl_tpu_torch.generation.service.GenerationService` (own
program cache, own KV cache, own decode loop), plus a
:class:`~bigdl_tpu_torch.serving.breaker.CircuitBreaker` fed by its
stream outcomes, so the router sheds a failing replica at once instead
of queueing into it. :class:`Replica` is hosted on threads of this
process; :class:`ProcessReplica` hosts the same serving loop in a
subprocess (``python -m bigdl_tpu_torch.fleet.replica --worker``) on
the device its spec names.

Lifecycle: ``serving`` → (``drain()``) → ``draining`` → (``shutdown``)
→ ``dead``. A draining replica finishes the streams it holds but takes
no new sessions; a dead one is evicted by the router and its in-flight
streams fail typed. The ``fleet/replica`` fault point at the submit
path is a scripted kill of the replica.

Not ported yet: ``ProcessReplica(telemetry_dir=)`` — the worker's
snapshot shipping and flight recorder (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from bigdl_tpu_torch import faults
from bigdl_tpu_torch.generation.service import (GenerationConfig,
                                                GenerationService)
from bigdl_tpu_torch.generation.stream import TokenStream
from bigdl_tpu_torch.serving.breaker import CircuitBreaker
from bigdl_tpu_torch.serving.errors import QueueFull, WorkerDied

__all__ = ["ProcessReplica", "Replica", "model_from_spec"]


def _killed(name: str, e: BaseException) -> WorkerDied:
    err = WorkerDied(f"replica {name!r} killed by injected fault: "
                     f"{type(e).__name__}: {e}")
    err.__cause__ = e
    return err


class Replica:
    """Thread-hosted replica (module docstring has the contract).

    ``name`` doubles as the served model name, so every replica's
    generation metrics land under their own ``model=<name>`` series in
    a shared registry. ``device`` is the service's (the card by
    default); ``model`` must live there."""

    def __init__(self, name: str, model: torch.nn.Module, *,
                 config: Optional[GenerationConfig] = None,
                 breaker_failures: int = 3,
                 breaker_cooldown_ms: float = 250.0, metrics=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.name = name
        self.state = "serving"
        self.breaker = CircuitBreaker(failures=breaker_failures,
                                      cooldown_ms=breaker_cooldown_ms)
        self._lock = threading.Lock()
        self._svc = GenerationService(config=config, device=device,
                                      metrics_registry=metrics)
        self._svc.load(name, model)

    @property
    def service(self) -> GenerationService:
        """The replica's own GenerationService (hot-swap a new model
        version through it; the router keeps routing throughout)."""
        return self._svc

    # -------------------------------------------------------- routing
    def accepting(self) -> bool:
        """Whether the router may place a NEW session here now: serving
        (not draining or dead) and the breaker admits."""
        return self.state == "serving" and self.breaker.allow()

    def load(self) -> int:
        """Live slots + queued requests: the router's least-loaded
        placement key."""
        with self._svc._lock:
            loop = self._svc._loops.get(self.name)
        if loop is None:
            return 0
        return loop.live_slots() + loop.queue_depth()

    def submit(self, prompt, **kw) -> TokenStream:
        """Submit one generation to this replica. The ``fleet/replica``
        fault point fires first: a fault there IS this replica's death
        — it fails its streams typed and raises ``WorkerDied``, and the
        router evicts it and places the request elsewhere."""
        try:
            faults.point("fleet/replica", replica=self.name)
        except BaseException as e:
            self.kill()
            raise _killed(self.name, e) from e
        try:
            return self._svc.generate(self.name, prompt, **kw)
        except QueueFull:
            raise
        except RuntimeError as e:
            if self.state == "dead":
                # a concurrent kill shut the service down under this
                # submit: keep the router's typed-error contract
                raise WorkerDied(f"replica {self.name!r} is dead") from e
            raise

    # ------------------------------------------------------ lifecycle
    def drain(self) -> None:
        """Stop taking new sessions; held streams run to completion."""
        with self._lock:
            if self.state == "serving":
                self.state = "draining"

    def resume(self) -> None:
        """Return a draining replica to service."""
        with self._lock:
            if self.state == "draining":
                self.state = "serving"

    def kill(self) -> None:
        """Replica death: in-flight and queued streams fail promptly and
        typed; the replica never serves again."""
        with self._lock:
            if self.state == "dead":
                return
            self.state = "dead"
        self._svc.shutdown(drain=False)

    def shutdown(self, drain: bool = True) -> None:
        """Clean stop: with ``drain`` finish held streams first."""
        with self._lock:
            already = self.state == "dead"
            self.state = "dead"
        if not already:
            self._svc.shutdown(drain=drain)

    def metrics(self) -> Dict[str, float]:
        """The replica's own generation metrics."""
        return self._svc.metrics(self.name)

    def __repr__(self) -> str:
        return f"Replica({self.name!r} {self.state} load={self.load()})"


def model_from_spec(spec: Dict, max_len: int,
                    device: Optional[Union[str, torch.device]] = None):
    """The seeded TransformerLM a model spec describes (``seed``,
    ``vocab_size``, ``hidden_size``, ``num_layers``, ``num_heads`` and
    optional ``max_len``), in evaluation mode on
    ``device``: initialised on the CPU from ``torch.Generator()
    .manual_seed(seed)``, so every process and device builds the same
    weights."""
    from bigdl_tpu_torch.models import TransformerLM

    return TransformerLM(
        vocab_size=int(spec["vocab_size"]),
        hidden_size=int(spec["hidden_size"]),
        num_layers=int(spec["num_layers"]),
        num_heads=int(spec["num_heads"]),
        max_len=int(spec.get("max_len", max_len)), device=device,
        generator=torch.Generator().manual_seed(int(spec.get("seed", 42)))
    ).eval()


# --------------------------------------------------------------------
# process-hosted replica: the same serving loop, one process a replica

class ProcessReplica:
    """A replica hosted in a subprocess, driven over a line-JSON pipe.

    The worker (``python -m bigdl_tpu_torch.fleet.replica --worker``)
    builds the seeded model ``model_spec`` describes
    (:func:`model_from_spec`) on ``device`` (the card by default) and
    serves through its own GenerationService; tokens stream back as
    ``{"id", "token"}`` lines, terminal lines are ``{"id", "done"}`` /
    ``{"id", "error"}``. The object duck-types :class:`Replica`, so the
    router treats both hosts alike. The worker's stderr is this
    process's."""

    def __init__(self, name: str, model_spec: Dict, *,
                 slots: int = 2, max_len: int = 32,
                 breaker_failures: int = 3,
                 breaker_cooldown_ms: float = 250.0,
                 startup_timeout_s: float = 120.0,
                 telemetry_dir: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if telemetry_dir is not None:
            raise NotImplementedError(
                "ProcessReplica(telemetry_dir=): the worker's snapshot "
                "shipping and flight recorder wait for the port's "
                "telemetry slice (ROADMAP queue 1, item 12)")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to host the "
                "replica's worker on the CPU")
        self.name = name
        self.state = "serving"
        self.telemetry_dir = None
        self.breaker = CircuitBreaker(failures=breaker_failures,
                                      cooldown_ms=breaker_cooldown_ms)
        self._lock = threading.Lock()
        self._seq = 0
        self._streams: Dict[int, TokenStream] = {}
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep \
            + env.get("PYTHONPATH", "")
        self._proc = subprocess.Popen(
            # -W: runpy warns that the package imported this module
            # before running it as __main__, which is harmless here
            [sys.executable, "-W", "ignore::RuntimeWarning:runpy", "-m",
             "bigdl_tpu_torch.fleet.replica",
             "--worker", "--model-spec", json.dumps(model_spec),
             "--slots", str(slots), "--max-len", str(max_len),
             "--device", str(dev)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        ready = self._read_ready(startup_timeout_s)
        if not ready.strip().startswith("{"):
            self._proc.kill()
            self._proc.wait()
            raise RuntimeError(
                f"process replica {name!r} failed to start: {ready!r}")
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"fleet-proc-{name}",
                                        daemon=True)
        self._reader.start()

    def _read_ready(self, timeout_s: float) -> str:
        """The worker's first line, or ``""`` past ``timeout_s``."""
        box = []
        t = threading.Thread(
            target=lambda: box.append(self._proc.stdout.readline()),
            daemon=True)
        t.start()
        t.join(timeout_s)
        return box[0] if box else ""

    def accepting(self) -> bool:
        """Router placement gate (see :meth:`Replica.accepting`)."""
        return self.state == "serving" and self.breaker.allow()

    def load(self) -> int:
        """In-flight requests held by the subprocess."""
        with self._lock:
            return len(self._streams)

    def submit(self, prompt, *, max_new_tokens=None, temperature=0.0,
               top_k=None, seed=0, timeout_ms=None) -> TokenStream:
        """Submit one generation over the pipe; the same fault-point
        kill as :meth:`Replica.submit`."""
        try:
            faults.point("fleet/replica", replica=self.name)
        except BaseException as e:
            self.kill()
            raise _killed(self.name, e) from e
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        stream = TokenStream(int(prompt.shape[0]), max_new_tokens or 16)
        with self._lock:
            if self.state != "serving" or self._proc.poll() is not None:
                raise WorkerDied(f"replica {self.name!r} is {self.state}")
            self._seq += 1
            rid = self._seq
            self._streams[rid] = stream
            req = {"id": rid, "prompt": prompt.tolist(),
                   "max_new": int(max_new_tokens or 16),
                   "temperature": float(temperature),
                   "top_k": top_k, "seed": int(seed)}
            try:
                self._proc.stdin.write(json.dumps(req) + "\n")
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError) as e:
                self._streams.pop(rid, None)
                raise WorkerDied(
                    f"replica {self.name!r} pipe closed") from e
        return stream

    def _read_loop(self) -> None:
        for line in self._proc.stdout:
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            with self._lock:
                stream = self._streams.get(msg.get("id"))
            if stream is None:
                continue
            if "token" in msg:
                stream._push(int(msg["token"]))
            elif "done" in msg:
                with self._lock:
                    self._streams.pop(msg["id"], None)
                stream._finish(msg["done"])
            elif "error" in msg:
                with self._lock:
                    self._streams.pop(msg["id"], None)
                stream._fail(WorkerDied(
                    f"replica {self.name!r}: {msg['error']}"))
        # pipe closed: the worker died — fail everything typed
        self._fail_all(WorkerDied(f"replica {self.name!r} process died"))

    def _fail_all(self, err: BaseException) -> None:
        with self._lock:
            doomed = list(self._streams.values())
            self._streams.clear()
            self.state = "dead"
        for s in doomed:
            s._fail(err)

    def drain(self) -> None:
        """Stop placing new sessions here (held streams finish)."""
        with self._lock:
            if self.state == "serving":
                self.state = "draining"

    def resume(self) -> None:
        """Return a draining replica to service."""
        with self._lock:
            if self.state == "draining":
                self.state = "serving"

    def kill(self) -> None:
        """SIGKILL the hosting process; streams fail typed through the
        reader's pipe-closed path."""
        with self._lock:
            if self.state == "dead":
                return
            self.state = "dead"
        self._proc.kill()

    def shutdown(self, drain: bool = True) -> None:
        """Stop the subprocess (``drain`` waits up to 30 s for held
        streams) and reap it."""
        if drain:
            end = time.monotonic() + 30.0
            while self.load() and time.monotonic() < end:
                time.sleep(0.01)
        with self._lock:
            self.state = "dead"
        try:
            self._proc.stdin.close()
        except OSError:
            pass
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._reader.join(10)

    def metrics(self) -> Dict[str, float]:
        """The parent's view (the full registry lives in the worker)."""
        return {"in_flight": self.load(), "state": self.state}

    def __repr__(self) -> str:
        return f"ProcessReplica({self.name!r} {self.state})"


# ----------------------------------------------------------- worker

def _worker(argv) -> int:
    """Subprocess entry: serve generations over stdin/stdout."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--model-spec", required=True)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = model_from_spec(json.loads(args.model_spec), args.max_len,
                            args.device)
    svc = GenerationService(config=GenerationConfig(
        slots=args.slots, max_len=args.max_len,
        length_buckets=(args.max_len,),
        prefill_rows=min(2, args.slots)), device=args.device)
    svc.load("lm", model)
    out_lock = threading.Lock()

    def emit(obj):
        with out_lock:
            print(json.dumps(obj), flush=True)

    emit({"ready": True})

    def pump(rid, stream):
        try:
            for tok in stream:
                emit({"id": rid, "token": int(tok)})
            emit({"id": rid, "done": stream.finish_reason or "done"})
        except Exception as e:  # noqa: BLE001 — reported to the parent
            emit({"id": rid, "error": f"{type(e).__name__}: {e}"})

    for line in sys.stdin:
        try:
            req = json.loads(line)
        except ValueError:
            continue
        try:
            stream = svc.generate(
                "lm", np.asarray(req["prompt"], np.int32),
                max_new_tokens=req.get("max_new"),
                temperature=req.get("temperature", 0.0),
                top_k=req.get("top_k"), seed=req.get("seed", 0))
        except Exception as e:  # noqa: BLE001 — reported to the parent
            emit({"id": req.get("id"), "error":
                  f"{type(e).__name__}: {e}"})
            continue
        threading.Thread(target=pump, args=(req["id"], stream),
                         daemon=True).start()
    svc.shutdown(drain=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker(sys.argv[1:]))
