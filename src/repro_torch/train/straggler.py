"""Straggler detection: per-host step-time EWMA and z-score.

The port's copy of ``repro/train/straggler.py`` (the port imports nothing
of the reference, not even its jax-free modules). Each host reports its
step time; a host whose time is a sustained z > threshold outlier fires
``on_straggler``. A flagged host un-flags (``on_recovered``) only after
``recover_sustained`` consecutive observations at z <= ``recover_z``,
so a single fast step never clears a flag and a host at the threshold
does not flap. The sketch session drives it (``StreamSession(
monitor=...)`` with ``sketch.faults`` delay events).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.1
    z_threshold: float = 3.0
    min_steps: int = 8           # warmup before detection
    sustained: int = 2           # consecutive outliers before firing
    # hysteresis: un-flag only after recover_sustained consecutive
    # observations with z <= recover_z (strictly below z_threshold, so
    # flag/unflag cannot flap on a host hovering at the threshold, yet
    # above ordinary noise, which routinely exceeds z = 1)
    recover_z: float = 2.0
    recover_sustained: int = 4


class StragglerMonitor:
    def __init__(
        self,
        cfg: StragglerConfig = StragglerConfig(),
        on_straggler: Optional[Callable[[int, float, float], None]] = None,
        on_recovered: Optional[Callable[[int, float], None]] = None,
    ):
        self.cfg = cfg
        self.on_straggler = on_straggler or (lambda host, t, z: None)
        self.on_recovered = on_recovered or (lambda host, t: None)
        self._mean: Dict[int, float] = {}
        self._var: Dict[int, float] = {}
        self._steps: Dict[int, int] = {}
        self._outlier_run: Dict[int, int] = {}
        self._recover_run: Dict[int, int] = {}
        self.flagged: List[int] = []

    def observe(self, host: int, step_time: float) -> Optional[float]:
        """Record one host's step time; returns its z-score (or None in
        warmup). Fires on_straggler on sustained outliers and
        on_recovered when a flagged host sustains healthy timings."""
        a = self.cfg.ewma_alpha
        n = self._steps.get(host, 0)
        if n == 0:
            self._mean[host] = step_time
            self._var[host] = 0.0
            self._steps[host] = 1
            return None
        mean = self._mean[host]
        var = self._var[host]
        z = None
        if n >= self.cfg.min_steps and var > 0:
            z = (step_time - mean) / (var ** 0.5)
            if z > self.cfg.z_threshold:
                run = self._outlier_run.get(host, 0) + 1
                self._outlier_run[host] = run
                self._recover_run[host] = 0
                if run >= self.cfg.sustained:
                    if host not in self.flagged:
                        self.flagged.append(host)
                    self.on_straggler(host, step_time, z)
            else:
                self._outlier_run[host] = 0
                if host in self.flagged and z <= self.cfg.recover_z:
                    rec = self._recover_run.get(host, 0) + 1
                    self._recover_run[host] = rec
                    if rec >= self.cfg.recover_sustained:
                        self.flagged.remove(host)
                        self._recover_run[host] = 0
                        self.on_recovered(host, step_time)
                else:
                    self._recover_run[host] = 0
        # EWMA update (skip updating stats with extreme outliers so a
        # straggler does not poison its own baseline)
        if z is None or z <= self.cfg.z_threshold:
            delta = step_time - mean
            self._mean[host] = mean + a * delta
            self._var[host] = (1 - a) * (var + a * delta * delta)
        self._steps[host] = n + 1
        return z
