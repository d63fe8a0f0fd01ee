"""Straggler detection for multi-host steps (port of
``repro.dist.straggler``, plain Python).

Hosts report per-step wall time via :meth:`StragglerMonitor.record`;
:meth:`evaluate` compares each host's recent mean against the across-host
median.  A host whose ratio exceeds ``threshold`` earns a strike; ``patience``
consecutive strikes puts it on the exclude list (the supervisor's signal to
drop/replace the node).  Recovering for one evaluation clears the strikes.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics


@dataclasses.dataclass
class StragglerConfig:
    threshold: float = 1.5      # slow if mean step time > threshold * median
    patience: int = 3           # consecutive slow evaluations before exclude
    window: int = 32            # per-host samples kept


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self._times: dict[str, collections.deque] = {}
        self._strikes: dict[str, int] = {}

    def record(self, host: str, step_seconds: float) -> None:
        self._times.setdefault(
            host, collections.deque(maxlen=self.cfg.window)).append(
                float(step_seconds))

    def evaluate(self) -> dict:
        """Returns {"slow": {host: ratio}, "exclude": [host...], "median"}."""
        means = {h: statistics.fmean(t) for h, t in self._times.items() if t}
        if not means:
            return {"slow": {}, "exclude": [], "median": None}
        med = statistics.median(means.values())
        slow = {}
        for h, m in means.items():
            ratio = m / med if med > 0 else 1.0
            if ratio > self.cfg.threshold:
                slow[h] = ratio
                self._strikes[h] = self._strikes.get(h, 0) + 1
            else:
                self._strikes[h] = 0
        exclude = sorted(h for h, s in self._strikes.items()
                         if s >= self.cfg.patience)
        return {"slow": slow, "exclude": exclude, "median": med}
