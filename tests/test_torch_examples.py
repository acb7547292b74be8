"""The four examples of ``examples_torch/`` on the CPU.

Each runs in a process of its own with ``--device cpu`` and must exit 0
(its own asserts hold). ``quickstart.py`` must print the numbers that
``examples/quickstart.py`` prints on the CPU through the reference
package (pinned below; the sketches are bit for bit the reference's),
the same pins ``chip_smoke.examples_phase`` holds the card's run to.
Without a card, ``--device cuda`` (each example's default) raises.
"""
from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
NAMES = ("quickstart", "quantile_monitor", "serve_h2o", "train_lm")

# examples/quickstart.py's output through the reference on the CPU
REFERENCE_QUICKSTART = """\
true top-5: [0, 1, 2, 3, 4]
estimated : [(0, 2190), (1, 1127), (2, 701), (3, 552), (4, 403)]
errors [0, 0, 0, 0, 0] all <= eps*(I-D) = 250: True
jax sketch top-5: [(0, 2307), (1, 1178), (2, 743), (3, 576), (4, 426)]
sharded top-3 : [0, 1, 2]
merged top-3: [0, 1, 2]
median estimate: 179 | p99 estimate: 58559
done.
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [env.get("PYTHONPATH")])])
    return env


RUNS = {
    "quickstart": ("quickstart", "--device", "cpu"),
    "quantile_monitor 0": ("quantile_monitor", "--shards", "0", "--device",
                           "cpu"),
    "quantile_monitor 4": ("quantile_monitor", "--shards", "4", "--device",
                           "cpu"),
    "serve_h2o": ("serve_h2o", "--device", "cpu"),
    "train_lm": ("train_lm", "--steps", "2", "--batch", "2", "--seq", "32",
                 "--device", "cpu"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CPU run of the examples, started together; each test waits
    for its own."""
    ckpt = str(tmp_path_factory.mktemp("train_lm"))
    procs = {}
    for key, (name, *args) in RUNS.items():
        if name == "train_lm":
            args += ["--ckpt-dir", ckpt]
        procs[key] = subprocess.Popen(
            [sys.executable, str(EXAMPLES / f"{name}.py"), *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=ROOT)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _ok(runs, key):
    out, err = runs[key].communicate(timeout=300)
    assert runs[key].returncode == 0, out[-2000:] + err[-4000:]
    return out


def test_quickstart_prints_the_references_numbers(runs):
    cs = _chip_smoke()
    out = _ok(runs, "quickstart")
    want = cs.printed_numbers(REFERENCE_QUICKSTART.replace(
        "jax sketch", "torch sketch"))
    assert want == cs.QUICKSTART_PRINTS
    assert cs.printed_numbers(out) == want
    assert "errors [0, 0, 0, 0, 0] all <= eps*(I-D) = 250: True" in out


@pytest.mark.parametrize("shards", ["0", "4"])
def test_quantile_monitor(runs, shards):
    out = _ok(runs, f"quantile_monitor {shards}")
    assert "ok: windowed p95 tracked through drift and burst" in out
    assert ("consolidated (4 shards -> 1 bank)" in out) == (shards == "4")


def test_serve_h2o(runs):
    out = _ok(runs, "serve_h2o")
    assert "ok: long-context decode ran with bounded global-layer KV." in out


def test_train_lm(runs):
    out = _ok(runs, "train_lm")
    assert "in 2 steps" in out and out.rstrip().endswith("ok.")


def test_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is attached: the default device runs")
    procs = {name: subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py"), "--device", "cuda",
         *(("--ckpt-dir", os.devnull) if name == "train_lm" else ())],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for name in NAMES}
    for name, p in procs.items():
        _, err = p.communicate(timeout=120)
        assert p.returncode != 0, name
        assert "no CUDA device is available" in err, (name, err[-2000:])

