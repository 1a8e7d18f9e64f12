"""A retrying CWSI client with exactly-once request semantics.

``CWSIClient`` (cwsi.py) assumes a perfect transport: one call, one
response. Over a real network the interesting failure is the ambiguous
one — the connection died and the client cannot know whether the server
acted before the loss. Blind retry would double-register a workflow or
double-submit a task; not retrying loses the call.

``ReliableCWSIClient`` resolves the ambiguity with the server's request
dedup window (see cwsi.py, "Exactly-once requests"): every mutating call
(POST/PUT) is stamped with a client-unique ``requestId``, so a retry of
a request the server already applied is acknowledged without
re-executing. Reads are not stamped — they are idempotent and a retried
GET simply re-reads.

Retry policy: up to ``max_attempts`` tries with exponential backoff
capped at ``max_delay`` plus multiplicative jitter (decorrelates client
herds after a shared outage). Retried errors are transport losses
(``TransportError``, ``OSError`` — which covers ``urllib.error.URLError``
and socket timeouts — and ``http.client.HTTPException``) and the two
back-pressure statuses the server uses to say "come back later": 429
(quota) and 503 (overload shedding, ``cwsi_http.py``). Everything else
(400/404/...) re-raises immediately — a malformed request does not get
better with repetition.
"""
from __future__ import annotations

import http.client
import itertools
import random
import time
from typing import Any, Callable, Dict, Optional

from .cwsi import CWSIClient, CWSIError, CWSIServer


class TransportError(RuntimeError):
    """The transport lost the exchange: the request may or may not have
    reached the server. Safe to retry only with request dedup."""


#: CWSI statuses that mean "back off and retry", not "request is wrong".
RETRYABLE_STATUSES = (429, 503)


class ReliableCWSIClient(CWSIClient):
    """Drop-in ``CWSIClient`` that survives a lossy transport.

    ``sleep`` is the backoff primitive — ``time.sleep`` by default, pass
    ``None`` to retry without waiting (simulations, tests). ``seed``
    fixes the jitter stream so retry timing is reproducible.
    """

    def __init__(self, server: Optional[CWSIServer] = None,
                 transport: Optional[Any] = None, *,
                 max_attempts: int = 5,
                 base_delay: float = 0.05,
                 max_delay: float = 2.0,
                 jitter: float = 0.5,
                 seed: int = 0,
                 sleep: Optional[Callable[[float], Any]] = time.sleep,
                 request_id_prefix: str = "req") -> None:
        super().__init__(server, transport)
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._seq = itertools.count()
        self._prefix = request_id_prefix
        self.retries = 0          # attempts beyond the first, any call
        self.duplicate_acks = 0   # retries the server had already applied
        self.gave_up = 0          # calls that exhausted every attempt

    def _backoff(self, attempt: int) -> float:
        delay = min(self.base_delay * (2 ** (attempt - 1)), self.max_delay)
        return delay * (1.0 + self.jitter * self._rng.random())

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if method in ("POST", "PUT"):
            # one id for ALL attempts of this call — that identity is
            # what makes the retry safe
            body = dict(body or {})
            body["requestId"] = f"{self._prefix}-{next(self._seq)}"
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            if attempt > 1:
                self.retries += 1
                if self._sleep is not None:
                    self._sleep(self._backoff(attempt - 1))
            try:
                result = super()._call(method, path, body)
            except CWSIError as e:
                if e.code not in RETRYABLE_STATUSES:
                    raise
                last = e
                continue
            except (TransportError, OSError,
                    http.client.HTTPException) as e:
                last = e
                continue
            if isinstance(result, dict) and result.get("duplicate") is True:
                # the lost attempt had landed; the server acked without
                # re-executing (post-recovery ack carries no payload)
                self.duplicate_acks += 1
            return result
        self.gave_up += 1
        raise TransportError(
            f"{method} {path} failed after {self.max_attempts} attempts"
        ) from last
