"""The port's copy of the straggler monitor (``repro_torch/train/
straggler.py``) against the reference's, on the four straggler cases of
``tests/test_fault_tolerance.py``: the same observation sequences give
the same flags, the same hook calls and the same z-scores."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.train as ttrain
from repro.train import straggler as jst
from repro_torch.train import straggler as tst


def _pair(**cfg):
    """(reference monitor, port monitor), each logging its hook calls."""
    out = []
    for mod in (jst, tst):
        log = []
        mon = mod.StragglerMonitor(
            mod.StragglerConfig(**cfg),
            on_straggler=lambda h, t, z, log=log: log.append(("flag", h, t)),
            on_recovered=lambda h, t, log=log: log.append(("recover", h, t)))
        out.append((mon, log))
    return out


def _drive(pair, observations):
    zs = [[], []]
    for host, t in observations:
        for i, (mon, _) in enumerate(pair):
            zs[i].append(mon.observe(host, t))
    (jm, jlog), (tm, tlog) = pair
    assert zs[0] == zs[1]
    assert jlog == tlog
    assert jm.flagged == tm.flagged
    assert jm._recover_run == tm._recover_run
    assert jm._outlier_run == tm._outlier_run
    return tm, tlog


def test_straggler_detection_injected_delays():
    pair = _pair(min_steps=4, z_threshold=3.0, sustained=2)
    obs = []
    for i in range(30):
        obs.append((0, 1.0 + 0.01 * (i % 3)))
        obs.append((1, 1.0 + 0.01 * (i % 3) + (5.0 if i >= 20 else 0.0)))
    mon, log = _drive(pair, obs)
    assert 1 in mon.flagged and 0 not in mon.flagged
    assert log and log[0][:2] == ("flag", 1)


def test_straggler_hysteresis_unflags_after_transient_slowdown():
    pair = _pair(min_steps=4, z_threshold=3.0, sustained=2, recover_z=2.0,
                 recover_sustained=3)
    obs = [(0, 1.0 + 0.01 * (i % 3) + (5.0 if 20 <= i < 24 else 0.0))
           for i in range(40)]
    mon, log = _drive(pair, obs)
    assert ("flag", 0) in [e[:2] for e in log]
    assert 0 not in mon.flagged
    assert [e[1] for e in log if e[0] == "recover"] == [0]
    assert mon._recover_run.get(0, 0) == 0


def test_straggler_recovery_needs_sustained_health():
    pair = _pair(min_steps=4, z_threshold=3.0, sustained=1, recover_z=2.0,
                 recover_sustained=3)
    obs = [(1, 1.0 + 0.01 * (i % 3)) for i in range(16)]
    obs += [(1, 6.0 if i % 2 == 0 else 1.0) for i in range(10)]
    mon, _ = _drive(pair, obs)
    assert 1 in mon.flagged


def test_straggler_no_false_positive_on_noise():
    pair = _pair(min_steps=4)
    rng = np.random.default_rng(0)
    mon, log = _drive(pair, [(0, 1.0 + 0.05 * rng.random())
                             for _ in range(100)])
    assert not mon.flagged and not log


def test_train_package_exports_the_monitor_only():
    """(Named when the monitor was the package's only export.) The
    package exports the reference's names, the monitor among them."""
    import repro.train as jtrain

    assert ttrain.__all__ == jtrain.__all__
    assert ttrain.StragglerMonitor is tst.StragglerMonitor
    assert tst.StragglerConfig() == tst.StragglerConfig(
        **vars(jst.StragglerConfig()))
