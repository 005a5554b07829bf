"""Replica autoscaling policy — queue-length proportional control.

Own copy of ``ray_dynamic_batching_tpu/serve/autoscaling.py``, whole.

Re-creates Ray Serve's default policy
(``python/ray/serve/autoscaling_policy.py:12-85``
``replica_queue_length_autoscaling_policy``): desired replicas =
``ceil(current * smoothed(total_ongoing / target_ongoing))`` with separate
up/down smoothing factors, bounded by [min, max], and up/down-scale delay
windows implemented as consecutive-decision counters (ref
``_private/autoscaling_state.py`` delay accounting).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class AutoscalingConfig:
    """Knobs mirroring serve's AutoscalingConfig (serve/config.py)."""

    min_replicas: int = 1
    max_replicas: int = 8
    target_ongoing_requests: float = 4.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 0.5
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0


class AutoscalingPolicy:
    """Stateful wrapper adding delay windows around the pure policy."""

    def __init__(self, config: AutoscalingConfig, interval_s: float = 1.0):
        self.config = config
        self.interval_s = interval_s
        self._consecutive_up = 0
        self._consecutive_down = 0

    def desired_replicas(
        self, total_ongoing: float, current_replicas: int
    ) -> int:
        """Pure proportional decision (ref autoscaling_policy.py:42-85)."""
        cfg = self.config
        if current_replicas == 0:
            return cfg.min_replicas if total_ongoing == 0 else max(
                cfg.min_replicas, 1
            )
        error_ratio = total_ongoing / (
            cfg.target_ongoing_requests * current_replicas
        )
        if error_ratio >= 1:
            smoothed = 1 + (error_ratio - 1) * cfg.upscale_smoothing_factor
        else:
            smoothed = 1 - (1 - error_ratio) * cfg.downscale_smoothing_factor
        desired = math.ceil(current_replicas * smoothed)
        return max(cfg.min_replicas, min(cfg.max_replicas, desired))

    def step(
        self, total_ongoing: float, current_replicas: int
    ) -> Optional[int]:
        """Delay-gated decision; returns a new target or None (hold).

        Scale-ups apply after ``upscale_delay_s`` of consistent pressure,
        scale-downs after ``downscale_delay_s`` (ref delay semantics in
        autoscaling_state.py)."""
        desired = self.desired_replicas(total_ongoing, current_replicas)
        if desired > current_replicas:
            self._consecutive_up += 1
            self._consecutive_down = 0
            need = math.ceil(self.config.upscale_delay_s / self.interval_s)
            if self._consecutive_up > need:
                self._consecutive_up = 0
                return desired
        elif desired < current_replicas:
            self._consecutive_down += 1
            self._consecutive_up = 0
            need = math.ceil(self.config.downscale_delay_s / self.interval_s)
            if self._consecutive_down > need:
                self._consecutive_down = 0
                return desired
        else:
            self._consecutive_up = 0
            self._consecutive_down = 0
        return None
