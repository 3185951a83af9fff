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
  prepares only its own shards, ``sharded`` and ``ivf-sharded`` alike;
  the search and the IVF build's exchange refuse to go on without the
  group. A grid whose processes each hold a whole model row builds, its
  model axis with no cross-process group; the Moondream prefill under TP
  refuses a model row that spans processes. The paths over joined
  processes are tests/test_torch_grid_processes.py's.
- Leaving the group forgets the grids made under it: after ``shutdown``
  and a new ``initialize`` in the same process, a list of an old grid's
  devices makes a new grid.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from imatch_tpu_torch.index import ivf as _ivf
from imatch_tpu_torch.models.moondream.configs import TINY_MD
from imatch_tpu_torch.models.moondream.model import MoondreamModel
from imatch_tpu_torch.parallel.dist_ivf import prepare_sharded_ivf
from imatch_tpu_torch.parallel import distributed
from imatch_tpu_torch.parallel.dist_search import prepare_sharded_corpus, sharded_topk_prepared
from imatch_tpu_torch.parallel.mesh import Grid, make_mesh
from imatch_tpu_torch.parallel.sharding import shard_model

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


def test_ivf_sharded_refuses_a_spanning_grid(monkeypatch):
    """The spanning ``ivf-sharded`` build trains its own shards only (seeds
    0 and 1 of process 0's shards 0 and 1), then refuses to go on without
    the process group that would bring the other shards' host state: it
    never answers from the local shards alone."""
    trained, served = [], _ivf.train_centroids

    def counted(rows, valid, *, n_clusters, seed):
        trained.append(seed)
        return served(rows, valid, n_clusters=n_clusters, seed=seed)

    monkeypatch.setattr(_ivf, "train_centroids", counted)
    rows = np.random.default_rng(0).standard_normal((256, 16)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no process group"):
        prepare_sharded_ivf(rows, np.ones(256, bool), mesh=_spanning())
    assert trained == [0, 1]


def test_model_axis_cannot_span_processes():
    """Each process holding a whole model row: the grid builds, its model
    rows lie inside one process each (no group), and only its data axis
    spans processes (whose groups need a joined process)."""
    grid = Grid(["cpu"] * 4, model=2, owners=[0, 0, 1, 1])
    assert grid.shape == {"data": 2, "model": 2} and grid.local_block() == ([0], [0, 1])
    assert [grid.line_spans("model", d) for d in (0, 1)] == [False, False]
    assert grid.group("model", 0) is None and grid.group("model", 1) is None
    assert grid.line_spans("data", 0)
    with pytest.raises(RuntimeError, match="no process group"):
        grid.group("data", 0)


def test_moondream_tp_refuses_a_model_row_across_processes():
    with torch.device("meta"):
        model = MoondreamModel(TINY_MD)
    with pytest.raises(ValueError, match="Moondream prefill under TP runs in one process"):
        shard_model(model, Grid(["cpu"] * 2, model=2, owners=[0, 1]))


def _join_alone():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, timeout=60)


def test_rejoin_forgets_the_grids_of_the_group_left():
    """A grid made under a group is known by its devices until the group
    is left: then its groups are dropped and its devices, listed, make a
    new grid under the next group."""
    _join_alone()
    try:
        old = make_mesh(["cpu", "cpu"])
        assert make_mesh(list(old)) is old and len(distributed.GRIDS) == 1
        old.groups[("data", 0)] = "a group of the old process group"
        distributed.shutdown()
        assert distributed.GRIDS == {} and old.groups == {}
        _join_alone()
        new = make_mesh(list(old))
        assert new is not old and list(new) == list(old) and new.owners == (0, 0)
        assert make_mesh(list(new)) is new
    finally:
        distributed.shutdown()
