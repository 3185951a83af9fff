"""Flat-file checkpoints of the training state, in the JAX package's format.

Counterpart of ``imatch_tpu/parallel/checkpoint.py``: one
``step_<8 digits>.npz`` per step, written to a temp file and then
``os.replace``d, ``latest_step`` for resume. The keys are JAX's, as
``jax.tree_util.tree_flatten_with_path`` names the leaves of its
``TrainState``, so a checkpoint either package writes restores in the
other:

- ``step`` (int32);
- ``params/<vision|text>/...``: the JAX param tree (stacked ``(L, ...)``
  layers, separate ``wq/wk/wv``, the HWIO patch kernel, ``(in, out)``
  dense weights), mapped from the modules by ``models/clip/bridge.py``;
- ``opt_state/1/0/count`` (int32), ``opt_state/1/0/mu/...`` and
  ``opt_state/1/0/nu/...``: optax's ``ScaleByAdamState`` inside
  ``chain(clip_by_global_norm, adamw)``, each moment mapped exactly as the
  parameter it belongs to.

A state sharded over a grid's model axis saves its full arrays (each
split leaf's slices joined, parallel/sharding.py's ``gather_named``), as
JAX's ``np.asarray`` of a sharded leaf does, and ``restore_checkpoint``
splits them again into the template's layout: a checkpoint written at
any model-parallel size, by either package, restores at any other.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.models.clip.bridge import named_to_numpy, numpy_to_named, tree_shapes
from imatch_tpu_torch.parallel.sharding import (
    check_specs,
    clip_param_specs,
    gather_named,
    model_shards,
    shard_named,
)
from imatch_tpu_torch.parallel.mesh import as_grid
from imatch_tpu_torch.parallel.train import AdamState, TrainState

ADAM = "opt_state/1/0"  # optax's chain: index 1 is adamw, its 0 scale_by_adam


def _flatten(tree: Dict, prefix: str) -> Dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict, prefix: str) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1 :].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _expected_shapes(cfg) -> Dict:
    shapes = tree_shapes(cfg)
    return {
        "step": (),
        **_flatten(shapes, "params"),
        f"{ADAM}/count": (),
        **_flatten(shapes, f"{ADAM}/mu"),
        **_flatten(shapes, f"{ADAM}/nu"),
    }


def _state_arrays(state: TrainState) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a full numpy array under its JAX key."""
    model = state.params
    opt = state.opt_state

    def tree(named):
        return named_to_numpy(gather_named(named, model), model.cfg)

    return {
        "step": np.asarray(state.step, dtype=np.int32),
        **_flatten(tree(dict(model.named_parameters())), "params"),
        f"{ADAM}/count": np.asarray(int(opt.count), dtype=np.int32),
        **_flatten(tree(opt.mu), f"{ADAM}/mu"),
        **_flatten(tree(opt.nu), f"{ADAM}/nu"),
    }


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = _state_arrays(state)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)\.npz$", f))
    ]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(
    ckpt_dir: str,
    template: TrainState,
    step: Optional[int] = None,
    mesh: Optional[Sequence] = None,
    param_specs: Optional[Dict] = None,
) -> TrainState:
    """The state saved at ``step`` (default the latest), written into
    ``template``'s tensors in place (its config decides the expected
    shapes; its devices hold the result). A missing leaf raises
    ``KeyError``, a leaf of another shape ``ValueError`` (a checkpoint of
    another config); only a one-element scalar is reshaped. The full
    arrays are split into the template's model shards: ``mesh`` and
    ``param_specs`` (JAX's arguments) must be the template's grid and
    ``clip_param_specs()``, the one layout the port's modules hold."""
    grid = as_grid(mesh)
    check_specs(param_specs, clip_param_specs())
    if grid is not None and grid.shape["model"] != model_shards(template.params):
        raise ValueError(
            f"mesh model axis {grid.shape['model']} != the template's "
            f"{model_shards(template.params)} model shards"
        )
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    cfg = template.params.cfg
    data = {}
    with np.load(path) as z:
        for key, want in _expected_shapes(cfg).items():
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = z[key]
            if arr.shape != want:
                if arr.size == 1 and int(np.prod(want, dtype=np.int64)) == 1:
                    arr = arr.reshape(want)
                else:
                    raise ValueError(
                        f"checkpoint leaf {key} has shape {arr.shape}, "
                        f"template expects {want} — wrong config?"
                    )
            data[key] = arr
    params = template.params
    opt = template.opt_state
    for tree, named in (
        ("params", dict(params.named_parameters())),
        (f"{ADAM}/mu", opt.mu),
        (f"{ADAM}/nu", opt.nu),
    ):
        loaded = shard_named(numpy_to_named(_unflatten(data, tree), cfg), params)
        for n, t in named.items():
            t.copy_(loaded[n])
    opt.count.fill_(int(data[f"{ADAM}/count"]))
    return TrainState(int(data["step"]), params, AdamState(opt.count, opt.mu, opt.nu))
