"""The PyTorch port stands alone: no JAX, no imatch_tpu, no silent CPU.

- In a subprocess whose import system refuses ``jax`` and ``imatch_tpu``
  (a ``sys.meta_path`` finder), every module of ``imatch_tpu_torch`` (each
  .py file under it) and ``chip_smoke.py`` import.
- Entry points asked for no device raise where CUDA is unavailable.
- ``chip_smoke.py`` fails, printing no result, without a card and in a
  directory that holds nothing else of the repo.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = textwrap.dedent(
    """
    import importlib, importlib.util, os, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "imatch_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path.insert(0, sys.argv[1])
    import imatch_tpu_torch

    # every .py file, namespace subpackages (models/clip) included, which
    # pkgutil.walk_packages does not enter
    root = os.path.dirname(imatch_tpu_torch.__file__)
    names = []
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), os.path.dirname(root))[:-3]
                names.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1] + "/chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))  # defines, runs nothing
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "imatch_tpu"))
    assert not loaded, loaded
    print(" ".join(sorted(m for m in sys.modules if m.split(".")[0] == "imatch_tpu_torch")))
    """
)


def test_every_module_imports_without_jax_or_imatch_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS, REPO],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(proc.stdout.split())
    assert len(names) >= 36
    # every module was imported (models/clip is reached through the
    # embedder), the kernels' wrappers and the script ports among them
    for name in (
        "index.patch",
        "ops.quant",
        "ops.kernels.quantize",
        "models.clip.quant",
        "ops.kernels.int4_topk",
        "ops.kernels.topk_t",
        "scripts.exp_int4_kernel",
        "scripts.exp_pallas_search",
    ):
        assert f"imatch_tpu_torch.{name}" in names, name


def test_blocker_really_blocks():
    code = _BLOCKED_IMPORTS.split("import imatch_tpu_torch")[0] + "import jax\n"
    proc = subprocess.run(
        [sys.executable, "-c", code, REPO], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0 and "blocked import of jax" in proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_without_device_raise_on_a_cpu_machine(no_cuda, tmp_path):
    from imatch_tpu_torch.index.store import VectorStore
    from imatch_tpu_torch.models.clip.configs import TINY
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder
    from imatch_tpu_torch.pipeline.state import AppState
    from imatch_tpu_torch.serving.app import create_app

    for make in (
        lambda: ClipEmbedder(),
        lambda: ClipEmbedder(config=TINY),
        lambda: VectorStore(),
        lambda: AppState(root=str(tmp_path)),
        lambda: create_app(root=str(tmp_path)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert ClipEmbedder(config=TINY, device="cpu").device.type == "cpu"


def test_launcher_without_device_raises_on_a_cpu_machine(no_cuda, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "IMATCH_DEVICE"}
    env.update(PYTHONPATH=REPO, IMATCH_ROOT=str(tmp_path), PORT="0")
    proc = subprocess.run(
        [sys.executable, "-m", "imatch_tpu_torch"],
        capture_output=True,
        text=True,
        env=env,
        cwd=str(tmp_path),
        timeout=300,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(no_cuda, tmp_path, alone):
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True,
        text=True,
        cwd=cwd,
        env=env,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
