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

From a grid that spans processes (a state ``init_train_state`` placed on
it) every process calls ``save_checkpoint``: the processes of data row 0
gather their model row's shards, process 0 writes the file, and every
process waits for the rename before it returns. ``restore_checkpoint``
reads the file in every process and places only the local shards.
"""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.models.clip.bridge import named_to_numpy, numpy_to_named, tree_shapes
from imatch_tpu_torch.parallel import distributed
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


def _state_parts(state: TrainState):
    """Every leaf of ``state`` as a full numpy array under its JAX key, a
    tree at a time (the file's key order), so one tree's full arrays are
    held at once; a sharded tree is gathered (over processes, a collective
    over the model row)."""
    model = state.params
    opt = state.opt_state

    def tree(named, prefix):
        return _flatten(named_to_numpy(gather_named(named, model), model.cfg), prefix)

    yield {"step": np.asarray(state.step, dtype=np.int32)}
    yield tree(dict(model.named_parameters()), "params")
    yield {f"{ADAM}/count": np.asarray(int(opt.count), dtype=np.int32)}
    yield tree(opt.mu, f"{ADAM}/mu")
    yield tree(opt.nu, f"{ADAM}/nu")


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """The state's full arrays to ``step_<step>.npz``, written to a temp
    file and renamed; over a grid that spans processes, by process 0 after
    data row 0's processes gathered their shards (every process calls it
    and returns after the rename)."""
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.npz")
    grid = getattr(state.params, "grid", None)
    spanning = grid is not None and grid.spans_processes
    if spanning and 0 not in grid.local_block()[0]:
        distributed.barrier()  # another data row's replica: nothing to gather
        return path
    if not spanning or grid.process == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
        # np.savez's layout (stored .npy members, zip64), written a tree at a time
        with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
            for part in _state_parts(state):
                for key, arr in part.items():
                    with zf.open(f"{key}.npy", "w", force_zip64=True) as member:
                        np.lib.format.write_array(member, np.asanyarray(arr), allow_pickle=False)
                del part
        os.replace(tmp, path)
    else:  # the row's other processes join its gathers
        for _ in _state_parts(state):
            pass
    if spanning:
        distributed.barrier()
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
    expected = _expected_shapes(cfg)
    params = template.params
    opt = template.opt_state
    with np.load(path) as z:
        for key, want in expected.items():  # every leaf checked before any is written
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key}")
            shape = _stored_shape(z, key)
            if shape != want and not (
                int(np.prod(shape, dtype=np.int64)) == 1 and int(np.prod(want, dtype=np.int64)) == 1
            ):
                raise ValueError(
                    f"checkpoint leaf {key} has shape {shape}, template expects {want} — wrong config?"
                )

        def read(prefix):  # one tree's leaves at a time
            return {k: z[k].reshape(w) for k, w in expected.items() if k.startswith(prefix + "/")}

        for tree, named in (
            ("params", dict(params.named_parameters())),
            (f"{ADAM}/mu", opt.mu),
            (f"{ADAM}/nu", opt.nu),
        ):
            # converted on the template's first device, then split to the shards'
            root = params.logit_scale.device
            loaded = shard_named(numpy_to_named(_unflatten(read(tree), tree), cfg, device=root), params)
            for n, t in named.items():
                t.copy_(loaded[n])
            del loaded
        opt.count.fill_(int(z[f"{ADAM}/count"]))
        step = int(z["step"])
    return TrainState(step, params, AdamState(opt.count, opt.mu, opt.nu))


def _stored_shape(z, key: str) -> tuple:
    """A leaf's shape from its .npy header, without reading its data."""
    with z.zip.open(f"{key}.npy") as f:
        version = np.lib.format.read_magic(f)
        header = {(1, 0): np.lib.format.read_array_header_1_0, (2, 0): np.lib.format.read_array_header_2_0}.get(version)
        return header(f)[0] if header is not None else z[key].shape
