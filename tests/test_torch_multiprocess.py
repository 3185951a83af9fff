"""The port's sharded store over a grid that spans processes.

- ``python -m imatch_tpu_torch.scripts.dryrun_multiprocess --device cpu``:
  2 worker processes x 4 ``cpu`` shards joined by torch.distributed
  (gloo), the library call and the unchanged ``sharded`` VectorStore exact
  against float64 numpy in every process (the port of
  tests/test_multiprocess.py, with its 240 / 270 s limits).
- A launcher whose workers outlive ``--timeout`` stops them and exits
  non-zero, printing no OK line; so does one asked for no device on a
  machine without a card (the workers raise).
- A process-spanning grid by hand (no process group): each process
  prepares only its own shards; the search refuses to answer without the
  group, and ``ivf-sharded`` refuses such a grid with a ValueError naming
  it. The model axis cannot span processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imatch_tpu_torch.parallel.dist_ivf import prepare_sharded_ivf
from imatch_tpu_torch.parallel.dist_search import prepare_sharded_corpus, sharded_topk_prepared
from imatch_tpu_torch.parallel.mesh import Grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch.scripts.dryrun_multiprocess", "--device", "cpu", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=REPO,
    )


def test_multiprocess_sharded_engine_dryrun():
    out = _run("--timeout", "240", timeout=270)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "MULTIPROCESS DRYRUN OK" in out.stdout
    for proc in (0, 1):
        assert f"[proc {proc}] VectorStore sharded engine + mutation exact" in out.stdout


def test_launcher_fails_when_workers_time_out():
    out = _run("--timeout", "1", timeout=120)
    assert out.returncode != 0
    assert "MULTIPROCESS DRYRUN OK" not in out.stdout
    assert "timed out" in out.stdout


def test_launcher_without_device_fails_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("IMATCH_DEVICE", None)
    out = subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch.scripts.dryrun_multiprocess", "--timeout", "120"],
        capture_output=True,
        text=True,
        timeout=150,
        env=env,
        cwd=REPO,
    )
    assert out.returncode != 0 and "no CUDA device" in out.stdout
    assert "MULTIPROCESS DRYRUN OK" not in out.stdout


def _spanning():
    return Grid(["cpu"] * 4, owners=[0, 0, 1, 1], process=0)


def test_spanning_grid_prepares_only_its_own_shards():
    grid = _spanning()
    assert grid.spans_processes and [grid.is_local(s) for s in range(4)] == [True, True, False, False]
    rows = np.random.default_rng(0).standard_normal((4096, 16)).astype(np.float32)
    sc = prepare_sharded_corpus(rows, np.ones(4096, bool), mesh=grid, score_dtype=torch.float32)
    assert [s is not None for s in sc.shards] == [True, True, False, False]
    with pytest.raises(RuntimeError, match="no process group"):
        sharded_topk_prepared(torch.from_numpy(rows[:2]), sc, k=3)


def test_ivf_sharded_refuses_a_spanning_grid():
    rows = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="spans processes.*owners"):
        prepare_sharded_ivf(rows, np.ones(256, bool), mesh=_spanning())


def test_model_axis_cannot_span_processes():
    with pytest.raises(ValueError, match="model axis"):
        Grid(["cpu"] * 4, model=2, owners=[0, 0, 1, 1])
