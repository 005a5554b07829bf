"""Minimal serve replica base: the router-facing surface an LLM replica
inherits.

Own copy of the part of ``ray_dynamic_batching_tpu/serve/replica.py`` that
``LLMReplica`` relies on — identity, admission bound, multiplex residency,
queue-length signal, draining. The opportunistic batch loop, failover and
quarantine wiring belong to the router/controller slice and are not
ported yet.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List

from ray_dynamic_batching_tpu_torch.engine.queue import RequestQueue
from ray_dynamic_batching_tpu_torch.engine.request import Request


@dataclass(frozen=True)
class ReplicaConfig:
    """What a replica needs of its deployment's config."""

    name: str
    max_ongoing_requests: int = 256


class Replica:
    """One deployment replica: an admission queue plus its bounds."""

    def __init__(self, replica_id: str, deployment: str,
                 max_ongoing_requests: int = 256) -> None:
        self.replica_id = replica_id
        self.deployment = deployment
        self.max_ongoing_requests = max_ongoing_requests
        self.queue = RequestQueue(deployment, max_len=max_ongoing_requests)
        self._lock = threading.Lock()
        # Multiplexed models resident on this replica, most recent last.
        self.loaded_models: List[str] = []
        self.max_multiplexed_models = 8
        self._stopped = False

    def queue_len(self) -> int:
        """Queued + in-flight, the routing signal."""
        return len(self.queue)

    def accepting(self) -> bool:
        return (not self._stopped
                and self.queue_len() < self.max_ongoing_requests)

    def assign(self, request: Request) -> bool:
        """Enqueue, declining when saturated; a declined request stays
        retryable."""
        if not self.accepting():
            return False
        ok = self.queue.add_request(request, reject_on_full=False)
        if ok and request.multiplexed_model_id:
            self.record_multiplexed_model(request.multiplexed_model_id)
        return ok

    def record_multiplexed_model(self, model_id: str) -> None:
        with self._lock:
            if model_id in self.loaded_models:
                self.loaded_models.remove(model_id)
            self.loaded_models.append(model_id)
            while len(self.loaded_models) > self.max_multiplexed_models:
                self.loaded_models.pop(0)

    def drain_queue(self) -> List[Request]:
        """Stop accepting and pop everything still queued."""
        self._stopped = True
        out: List[Request] = []
        while len(self.queue) > 0:
            out.extend(self.queue.get_batch(self.max_ongoing_requests,
                                            discard_stale=False))
        return out

    def stats(self) -> dict:
        s = self.queue.stats()
        s["ongoing"] = float(self.queue_len())
        return s
