"""TokenStream — the caller's handle on one in-flight generation
(counterpart of ``bigdl_tpu.generation.stream``).

Tokens arrive one at a time (the decode loop pushes each sampled token
the step it exists); the stream exposes them three ways — blocking
iteration, per-token futures, and a completion future — and fails
*typed*: a deadline miss is :class:`~bigdl_tpu_torch.serving.errors.
DeadlineExceeded`, a decode-loop death is :class:`~bigdl_tpu_torch.
serving.errors.WorkerDied`, the serving stack's error vocabulary. A
stream can never hang silently.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, Iterator, List, Optional

import numpy as np


class TokenStream:
    """Streaming result of :meth:`~bigdl_tpu_torch.generation.service.
    GenerationService.generate` (one request).

    Read side: ``first()`` blocks for the first token (the TTFT
    moment), ``__iter__`` yields tokens as they are generated,
    ``token_future(i)`` returns a Future of the i-th generated token
    (resolved with ``None`` when the stream finishes earlier), and
    ``result()`` / ``completion`` give the whole generated sequence.
    ``finish_reason`` is one of ``"eos" | "max_tokens" | "max_len"``
    after a clean finish. Write side (`_push`/`_finish`/`_fail`) is
    decode-loop-only."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 trace_id: Optional[str] = None):
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        #: per-request id assigned at submit (``<model>/gen-<n>``)
        self.trace_id = trace_id
        self.finish_reason: Optional[str] = None
        #: resolves to the np.int32 array of generated tokens, or to
        #: the stream's typed error
        self.completion: Future = Future()
        self._cond = threading.Condition()
        self._closed = False  # set under _cond; completion resolves after
        self._tokens: List[int] = []
        self._error: Optional[BaseException] = None
        self._token_futures: Dict[int, Future] = {}
        self._t_submit = time.monotonic()
        self._t_first: Optional[float] = None
        self._observer = None  # the fleet router's hook (see _attach)

    # ---------------------------------------------------------- read
    def tokens(self) -> List[int]:
        """Snapshot of the tokens generated so far."""
        with self._cond:
            return list(self._tokens)

    def done(self) -> bool:
        """True once the stream has finished or failed."""
        return self.completion.done()

    def first(self, timeout: Optional[float] = None) -> int:
        """Block until the first token (raises the stream's typed
        error if it fails before producing one)."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._tokens or self.finish_reason is not None
                or self._error is not None, timeout)
            if self._tokens:
                return self._tokens[0]
            if self._error is not None:
                raise self._error
            if self.finish_reason is not None:
                raise RuntimeError(f"stream finished with no tokens "
                                   f"({self.finish_reason})")
            raise TimeoutError("no first token within timeout")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The full generated token array (blocks; raises typed)."""
        return self.completion.result(timeout)

    def token_future(self, i: int) -> Future:
        """Future of generated token ``i`` (0-based): resolves to the
        token id as it is produced, to ``None`` when the stream
        finishes before producing it, or to the stream's typed
        error."""
        with self._cond:
            fut = self._token_futures.get(i)
            if fut is None:
                fut = Future()
                if i < len(self._tokens):
                    fut.set_result(self._tokens[i])
                elif self._error is not None:
                    fut.set_exception(self._error)
                elif self.finish_reason is not None:
                    fut.set_result(None)
                else:
                    self._token_futures[i] = fut
            return fut

    def __iter__(self) -> Iterator[int]:
        """Yield tokens as they arrive; raises the typed error on
        failure, stops cleanly at finish."""
        i = 0
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: len(self._tokens) > i
                    or self.finish_reason is not None
                    or self._error is not None)
                if len(self._tokens) > i:
                    tok = self._tokens[i]
                elif self._error is not None:
                    raise self._error
                else:
                    return
            yield tok
            i += 1

    @property
    def ttft_ms(self) -> Optional[float]:
        """Submit → first-token latency (None until the first
        token)."""
        if self._t_first is None:
            return None
        return (self._t_first - self._t_submit) * 1000.0

    # ---------------------------------------------- decode-loop side
    def _attach(self, observer) -> None:
        """Fleet-private: register ONE observer (``on_token(i, tok)`` /
        ``on_finish(reason)`` / ``on_fail(err)``, called from the
        decode thread outside the stream lock). Tokens already pushed
        are replayed first, and a stream that already resolved delivers
        its terminal callback at once, so the router can attach after
        submit without a race."""
        with self._cond:
            self._observer = observer
            replay = list(enumerate(self._tokens))
            closed, reason, err = self._closed, self.finish_reason, \
                self._error
        for i, tok in replay:
            observer.on_token(i, tok)
        if closed:
            if err is not None:
                observer.on_fail(err)
            else:
                observer.on_finish(reason)

    def _push(self, token: int) -> None:
        with self._cond:
            if self._t_first is None:
                self._t_first = time.monotonic()
            i = len(self._tokens)
            # bounded per request by max_new_tokens: the token list IS
            # the stream's product, released with the stream object
            self._tokens.append(int(token))
            fut = self._token_futures.pop(i, None)
            obs = self._observer
            self._cond.notify_all()
        if fut is not None:
            fut.set_result(int(token))
        if obs is not None:
            obs.on_token(i, int(token))

    def _finish(self, reason: str) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self.finish_reason = reason
            pending = list(self._token_futures.values())
            self._token_futures.clear()
            out = np.asarray(self._tokens, np.int32)
            obs = self._observer
            self._cond.notify_all()
        for fut in pending:
            fut.set_result(None)
        self.completion.set_result(out)
        if obs is not None:
            obs.on_finish(reason)

    def _fail(self, err: BaseException) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._error = err
            pending = list(self._token_futures.values())
            self._token_futures.clear()
            obs = self._observer
            self._cond.notify_all()
        for fut in pending:
            fut.set_exception(err)
        self.completion.set_exception(err)
        if obs is not None:
            obs.on_fail(err)
