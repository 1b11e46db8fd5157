# Copy of pasero_tpu/utils/metrics.py, verbatim.
"""Rolling-window metrics store and timers (pasero/utils.py:453-689)."""

from __future__ import annotations

import collections
import time
from typing import Optional


class RollingValue:
    """Sum/average over a sliding window of updates."""

    def __init__(self, window: Optional[int] = None):
        self.window = window
        self.values = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.values.append((float(value), n))
        self.total += float(value)
        self.count += n

    @property
    def window_sum(self) -> float:
        return sum(v for v, _ in self.values)

    @property
    def window_avg(self) -> float:
        n = sum(n for _, n in self.values)
        return self.window_sum / max(1, n)

    @property
    def avg(self) -> float:
        return self.total / max(1, self.count)

    def state_dict(self):
        return {"values": list(self.values), "total": self.total,
                "count": self.count, "window": self.window}

    def load_state_dict(self, state):
        self.window = state["window"]
        self.values = collections.deque(state["values"], maxlen=self.window)
        self.total = state["total"]
        self.count = state["count"]


class Timer:
    """Accumulating wall-clock timer with pause/resume."""

    def __init__(self):
        self.elapsed = 0.0
        self._start: Optional[float] = None

    def start(self):
        if self._start is None:
            self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def reset(self) -> float:
        self.stop()
        value, self.elapsed = self.elapsed, 0.0
        return value

    def state_dict(self):
        return {"elapsed": self.elapsed}

    def load_state_dict(self, state):
        self.elapsed = state["elapsed"]


class Metrics:
    """Named rolling metrics + timers with checkpointable state."""

    def __init__(self, window: Optional[int] = 100):
        self.window = window
        self.values: dict[str, RollingValue] = {}
        self.timers: dict[str, Timer] = {}

    def update(self, name: str, value, n: int = 1, window: Optional[int] = -1):
        if name not in self.values:
            self.values[name] = RollingValue(
                self.window if window == -1 else window)
        self.values[name].update(value, n)

    def timer(self, name: str) -> Timer:
        return self.timers.setdefault(name, Timer())

    def avg(self, name: str, default=0.0) -> float:
        v = self.values.get(name)
        return v.window_avg if v else default

    def sum(self, name: str, default=0.0) -> float:
        v = self.values.get(name)
        return v.window_sum if v else default

    def total(self, name: str, default=0.0) -> float:
        v = self.values.get(name)
        return v.total if v else default

    def state_dict(self) -> dict:
        return {"window": self.window,
                "values": {k: v.state_dict() for k, v in self.values.items()},
                "timers": {k: t.state_dict() for k, t in self.timers.items()}}

    def load_state_dict(self, state: dict):
        self.window = state.get("window", self.window)
        for k, v in state.get("values", {}).items():
            rv = RollingValue()
            rv.load_state_dict(v)
            self.values[k] = rv
        for k, t in state.get("timers", {}).items():
            timer = Timer()
            timer.load_state_dict(t)
            self.timers[k] = timer
