"""The port's training CLI (imatch_tpu_torch/scripts/train_clip.py) on the CPU.

- The port of tests/test_parallel.py::test_train_cli_synthetic with
  ``--device cpu``: ``done at step 3``, then ``--resume``: ``resumed from
  step 3`` and ``done at step 5``.
- Without a card and without a device choice the script raises and writes
  no checkpoint directory; ``--mp 2`` over one device raises (the model
  axis must divide the grid's devices) and writes nothing
  (tests/test_torch_parallel.py trains at ``--mp 2`` over four).
- Library mode: pairs read from a port store's records and their processed
  images through the loader, trained for one step; fewer than two usable
  records exit with status 2.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.parallel.checkpoint import latest_step
from imatch_tpu_torch.scripts import train_clip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DIM = 48  # the tiny CLIP config's embedding width


def _run(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch.scripts.train_clip", *args],
        capture_output=True,
        text=True,
        cwd=REPO,
        env={**(env or os.environ), "PYTHONPATH": REPO},
        timeout=300,
    )


def test_train_cli_synthetic(tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--config", "tiny", "--batch", "4", "--synthetic", "8", "--ckpt-dir", ck]
    r = _run(*common, "--steps", "3", "--ckpt-every", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done at step 3" in r.stderr + r.stdout
    assert sorted(os.listdir(ck)) == ["step_00000002.npz", "step_00000003.npz"]
    r2 = _run(*common, "--steps", "5", "--resume", env={**os.environ, "IMATCH_DEVICE": "cpu"})
    assert r2.returncode == 0, r2.stderr[-2000:]
    out = r2.stderr + r2.stdout
    assert "resumed from step 3" in out and "done at step 5" in out


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_no_card_and_no_device_raises_and_writes_nothing(no_cuda, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "IMATCH_DEVICE"}
    ck = tmp_path / "ck"
    r = _run("--config", "tiny", "--synthetic", "8", "--steps", "1", "--ckpt-dir", str(ck), env=env)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not ck.exists()


def test_mp_above_one_raises(tmp_path):
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        train_clip.main(
            ["--config", "tiny", "--mp", "2", "--synthetic", "8", "--device", "cpu",
             "--ckpt-dir", str(tmp_path / "ck")]
        )
    assert not (tmp_path / "ck").exists()


def _library(root, n):
    store = VectorStore(device="cpu", persist_dir=str(root / "index_data"))
    proc = root / "static" / "processed"
    proc.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(proc / f"r{i}.png")
    store.add(
        ids=[f"r{i}" for i in range(n)],
        embeddings=rng.standard_normal((n, TINY_DIM)).astype(np.float32),
        metadatas=[
            {"id": f"r{i}", "filename": f"r{i}.png", "description": f"a thing {i}"}
            for i in range(n)
        ],
    )
    store.save()


def test_library_mode(tmp_path, caplog):
    _library(tmp_path, 3)
    paths, texts = train_clip.load_library(str(tmp_path), device="cpu")
    assert len(paths) == 3 and texts == ["a thing 0", "a thing 1", "a thing 2"]
    args = ["--root", str(tmp_path), "--config", "tiny", "--batch", "4", "--steps", "1",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    with caplog.at_level(logging.INFO, logger="imatch.train"):
        run = train_clip.train(train_clip.parse_args(args))
    assert run.rc == 0 and run.state.step == 1 and np.isfinite(run.losses).all()
    assert "library: 3 image-text pairs" in caplog.text and "done at step 1" in caplog.text
    assert latest_step(str(tmp_path / "ck")) == 1

    empty = tmp_path / "empty"
    empty.mkdir()
    args[1] = str(empty)
    assert train_clip.main(args) == 2

