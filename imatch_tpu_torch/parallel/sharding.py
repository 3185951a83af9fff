"""Megatron tensor parallelism: the partition specs of the CLIP and
Moondream param trees, and the placement of a model on a grid's model axis.

Counterpart of ``imatch_tpu/parallel/sharding.py``. ``clip_param_specs``
and ``md_param_specs`` are JAX's spec trees, keyed by JAX's tree paths
(stacked ``(L, ...)`` layers, ``(d_in, d_out)`` dense weights); each leaf's
spec names the axis of JAX's array that splits over ``model``. The rule
(the standard column/row split, so each attention and MLP block needs
exactly one reduce at its output):

- q, k, v projections: split the output (heads land whole on a shard);
- the attention output projection: split the input;
- MLP ``w1``: split the output; ``w2``: split the input;
- biases follow their matmul's output split: a row-split layer's bias
  (``bo``, ``b2``) is replicated and added once, after the reduce;
- LayerNorms, embeddings, stems and projections are replicated (small);
- Moondream's projector splits ``w1`` by columns and ``w2`` by rows, and
  its ``lm_head`` splits the vocabulary (the (B, V) logits are gathered).

JAX hands these specs to XLA SPMD; here they place the port's modules.
Each module whose Linears hold split leaves names, in ``jax_sources``,
the dense weights of JAX's tree that each Linear stacks along its output
(the bridge's layout: the fused ``qkv`` is wq | wk | wv, the packed
Moondream ``qkv_mlp`` wq | wk | wv | w1; a bias is its weight's ``b``), and
``_SUBTREES`` where each such module sits in JAX's tree. ``split_rules``
reads the specs through them: JAX's ``(..., d_in, d_out)`` axis that
splits is the port's ``(d_out, d_in)`` weight's dim 1 or 0, and a split
output takes 1/M of each stacked block, so heads land whole on a shard.
The modules' forwards (``shards=M``) run that split and no other, so a
spec tree other than these is refused (``check_specs``).

``shard_model`` places a model on the devices of one row of the grid:
shard 0 keeps every replicated leaf, and its ``peers`` hold the other
shards' slices. ``gather_named`` and ``shard_named`` convert tensors
keyed by a sharded model's parameter names (parameters, optimizer
moments) to the full model's names and back: the checkpoints' path
(parallel/checkpoint.py).

Given a grid whose model row spans processes (parallel/mesh.py), each
process holds only its own model shards' slices (its first local shard
in the root module, the rest in ``peers``) and a replica of every
replicated leaf (the LayerNorms, embeddings, ``logit_scale``, the
``out``/``fc2`` biases and the projector's, which each process adds once
after the row's all-reduce); the root's ``row_group`` is the row's
process group. A CLIP model and a Moondream model alike (the Moondream
encode, prefill and greedy decode run over the row, its LM head's
vocabulary gathered in every process: models/moondream/model.py). Such a
model's ``gather_named`` and ``shard_named`` gather and split across the
row's processes (a collective over the row: a checkpoint's save). Two
layouts stay refused with a ValueError: the int8 modes (on one device
only) and a process that holds two data rows of a spanning grid.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from imatch_tpu_torch.parallel import distributed
from imatch_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Grid

Split = Tuple[int, Tuple[int, ...]]  # (dim, widths of the blocks along it)


class P(tuple):
    """A partition spec: per array axis, the grid axis it splits over, or
    None (``jax.sharding.PartitionSpec``'s shape: a tuple that compares
    equal to JAX's)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def replicated() -> P:
    return P()


def data_spec(ndim: int) -> P:
    """Batch-sharded leading axis, replicated rest."""
    return P(AXIS_DATA, *(None,) * (ndim - 1))


def _encoder_layer_specs(model_axis) -> Dict[str, Any]:
    col = P(None, None, model_axis)  # (L, d, f) split f
    row = P(None, model_axis, None)  # (L, f, d) split f
    bias_col = P(None, model_axis)  # (L, f) split f
    rep2 = P(None, None)
    return {
        "ln1": {"scale": rep2, "bias": rep2},
        "attn": {
            "wq": col,
            "wk": col,
            "wv": col,
            "wo": row,
            "bq": bias_col,
            "bk": bias_col,
            "bv": bias_col,
            "bo": rep2,
        },
        "ln2": {"scale": rep2, "bias": rep2},
        "mlp": {"w1": col, "b1": bias_col, "w2": row, "b2": rep2},
    }


def md_param_specs(model_axis: str = AXIS_MODEL) -> Dict[str, Any]:
    """Specs for the Moondream tree (JAX's ``init_md_params`` layout): the
    vision blocks have separate ln1/ln2, the Phi decoder one parallel-block
    ln; the lm_head column-splits the vocab and its bias follows."""
    rep1, rep2 = P(None), P(None, None)
    attn = {
        "wq": P(None, None, model_axis),
        "wk": P(None, None, model_axis),
        "wv": P(None, None, model_axis),
        "bq": P(None, model_axis),
        "bk": P(None, model_axis),
        "bv": P(None, model_axis),
        "wo": P(None, model_axis, None),
        "bo": rep2,
    }
    mlp = {
        "w1": P(None, None, model_axis),
        "b1": P(None, model_axis),
        "w2": P(None, model_axis, None),
        "b2": rep2,
    }
    return {
        "vision": {
            "patch_embedding": {"w": P(None, None, None, None), "b": rep1},
            "position_embedding": rep2,
            "layers": {
                "ln1": {"scale": rep2, "bias": rep2},
                "attn": dict(attn),
                "ln2": {"scale": rep2, "bias": rep2},
                "mlp": dict(mlp),
            },
            "post_ln": {"scale": rep1, "bias": rep1},
        },
        "projector": {
            "w1": P(None, model_axis),
            "b1": P(model_axis),
            "w2": P(model_axis, None),
            "b2": rep1,
        },
        "text": {
            "token_embedding": rep2,
            "layers": {
                "ln": {"scale": rep2, "bias": rep2},
                "attn": dict(attn),
                "mlp": dict(mlp),
            },
            "final_ln": {"scale": rep1, "bias": rep1},
            "lm_head": {"w": P(None, model_axis), "b": P(model_axis)},
        },
    }


def clip_param_specs(model_axis: str = AXIS_MODEL) -> Dict[str, Any]:
    """Specs matching JAX's ``init_params`` tree exactly."""
    rep1, rep2 = P(None), P(None, None)
    return {
        "vision": {
            "patch_embedding": P(None, None, None, None),
            "class_embedding": rep1,
            "position_embedding": rep2,
            "pre_ln": {"scale": rep1, "bias": rep1},
            "layers": _encoder_layer_specs(model_axis),
            "post_ln": {"scale": rep1, "bias": rep1},
            "projection": rep2,
        },
        "text": {
            "token_embedding": rep2,
            "position_embedding": rep2,
            "layers": _encoder_layer_specs(model_axis),
            "final_ln": {"scale": rep1, "bias": rep1},
            "projection": rep2,
        },
        "logit_scale": P(),
    }


# -- placement ----------------------------------------------------------------

_PEER = re.compile(r"^peers\.(\d+)\.")


def shard_index(name: str) -> int:
    """The local model shard that holds the parameter ``name`` of a
    sharded model (``peers.<j>.`` is shard j + 1; over a row that spans
    processes, add ``model_first``)."""
    m = _PEER.match(name)
    return 0 if m is None else int(m.group(1)) + 1


def local_shards(model: nn.Module) -> int:
    """The model shards this process holds of ``model``."""
    peers = getattr(model, "peers", None)
    return 1 + (len(peers) if peers is not None else 0)


def model_shards(model: nn.Module) -> int:
    """The model axis ``model`` is split over (all processes' shards)."""
    return getattr(model, "model_total", None) or local_shards(model)


def model_first(model: nn.Module) -> int:
    """The model index of this process's first shard of ``model``."""
    return getattr(model, "model_first", 0)


# Where each module with a ``jax_sources`` sits in JAX's tree, by its
# parameter-name prefix in a CLIPModel or MoondreamModel (layer index *).
_SUBTREES = {
    "vision.encoder.layers.*": ("vision", "layers"),  # CLIP, Moondream
    "text.encoder.layers.*": ("text", "layers"),  # CLIP
    "projector": ("projector",),
    "text.layers.*": ("text", "layers"),  # Moondream
    "text": ("text",),  # Moondream's LM head
}


def _model_dim(spec: P) -> Optional[int]:
    """The dim of the port's ``(d_out, d_in)`` weight or ``(d_out,)``
    bias that JAX's ``(..., d_in, d_out)`` or ``(..., d_out)`` leaf of
    ``spec`` splits over ``model``; None if replicated."""
    return len(spec) - 1 - spec.index(AXIS_MODEL) if AXIS_MODEL in spec else None


def _linear_rules(lin: nn.Linear, sources, subtree: Dict) -> Dict[str, Split]:
    """The splits of one Linear's weight and bias from the specs of the
    JAX leaves it stacks (``sources``: (path, width) of each)."""
    rules = {}
    for leaf in ("weight", "bias"):
        dims = set()
        for path, _ in sources:
            *head, name = path.split(".")
            node = subtree
            for k in head:
                node = node[k]
            dims.add(_model_dim(node[name if leaf == "weight" else "b" + name[1:]]))
        if len(dims) != 1:
            raise ValueError(f"the blocks of a {leaf} split on different axes: {[p for p, _ in sources]}")
        dim = dims.pop()
        if dim is not None:
            rules[leaf] = (dim, tuple(w for _, w in sources) if dim == 0 else (lin.in_features,))
    return rules


def split_rules(model: nn.Module, specs: Optional[Dict] = None) -> Dict[str, Split]:
    """Every parameter of ``model`` (shard 0's, for a sharded one) that
    splits over ``model`` by ``specs`` (JAX's spec tree of the model's
    family by default): its name -> (dim, block widths), the widths those
    of ``model``'s own tensors."""
    if specs is None:
        specs = md_param_specs() if hasattr(model, "projector") else clip_param_specs()
    rules = {}
    for prefix, mod in model.named_modules():
        if prefix == "peers" or prefix.startswith("peers."):
            continue
        fn = getattr(mod, "jax_sources", None)
        if fn is None:
            continue
        subtree = specs
        for k in _SUBTREES[re.sub(r"\.\d+(?=\.|$)", ".*", prefix)]:
            subtree = subtree[k]
        for lin, sources in fn().items():
            for leaf, rule in _linear_rules(mod.get_submodule(lin), sources, subtree).items():
                rules[f"{prefix}.{lin}.{leaf}"] = rule
    return rules


def _split(t: torch.Tensor, dim: int, widths: Sequence[int], shards: int) -> List[torch.Tensor]:
    """Shard m's slice: the m-th 1/shards of each block, concatenated."""
    if sum(widths) != t.shape[dim]:
        raise ValueError(f"blocks {tuple(widths)} do not tile dim {dim} of {tuple(t.shape)}")
    blocks = t.split(list(widths), dim)
    for w in widths:
        if w % shards:
            raise ValueError(f"a block of {w} does not split over {shards} model shards")
    parts = [b.chunk(shards, dim) for b in blocks]
    return [torch.cat([p[m] for p in parts], dim) for m in range(shards)]


def _join(pieces: Sequence[torch.Tensor], dim: int, widths: Sequence[int]) -> torch.Tensor:
    """The inverse of ``_split``: ``widths`` are one piece's blocks."""
    split = [p.split(list(widths), dim) for p in pieces]
    return torch.cat([torch.cat([s[j] for s in split], dim) for j in range(len(widths))], dim)


def _template(model: nn.Module, shards: int) -> nn.Module:
    """An empty (meta) module of ``model``'s class and layout at ``shards``."""
    with torch.device("meta"):
        t = type(model)(model.cfg, shards=shards)
    text = getattr(model, "text", None)
    if text is not None and hasattr(getattr(text, "layers", [None])[0], "qkv_mlp"):
        from imatch_tpu_torch.models.moondream.model import pack_text_layers

        pack_text_layers(t)  # the Moondream decoder's packed projections
    return t


def _local_row(grid: Grid):
    """(this process's devices of its model row, the model index of the
    first, the row's process group) on a grid that spans processes."""
    rows, cols = grid.local_block()
    if len(rows) != 1:
        raise ValueError(
            f"process {grid.process} holds data rows {rows} of {grid!r}: a model over a grid "
            "that spans processes takes one data row a process"
        )
    return [grid.device(rows[0], m) for m in cols], cols[0], grid.group(AXIS_MODEL, rows[0])


def shard_model(model: nn.Module, devices: Sequence) -> nn.Module:
    """``model`` (a CLIPModel or MoondreamModel on one device, bf16 or
    fp32, not sharded) placed over ``devices``, one grid row's model
    shards in order: shard 0, on ``devices[0]``, holds its slices and every
    replicated leaf; its ``peers`` hold shard 1.. M-1's slices, each on its
    device. One device returns ``model`` on it. The int8 modes (int8
    weights, the W8A8 tower) are refused: they run on one device.

    ``devices`` may be a ``Grid``: in one process its first row; over a
    grid that spans processes, this process's own model shards of its data
    row (every process calls it on the same ``model``), the replicated
    leaves in each, and the root's ``grid``, ``row_group``,
    ``model_first`` and ``model_total`` set: a CLIP or a Moondream model
    (bf16 or fp32). A process holding two data rows of such a grid raises
    ValueError."""
    if model_shards(model) != 1:
        raise ValueError("the model is sharded already")
    if any(True for _ in model.buffers()):
        raise ValueError("the int8 modes run on one device: shard a bf16 or fp32 model")
    grid = devices if isinstance(devices, Grid) else None
    first, total, group = 0, None, None
    if grid is not None and grid.spans_processes:
        devices, first, group = _local_row(grid)
        total = grid.model
    elif grid is not None:
        devices = grid.row(0)
    devices = [torch.device(d) for d in devices]
    shards = len(devices)
    if total is None and shards == 1:
        return model.to(devices[0])
    total = total or shards
    full = dict(model.named_parameters())
    rules = split_rules(model)
    pieces = {n: _split(full[n], *rules[n], total) for n in rules}
    out = []
    for m, dev in enumerate(devices):
        mod = _template(model, total)
        state = {
            n: (pieces[n][first + m] if n in rules else t).to(dev)
            for n, t in full.items()
            if m == 0 or n in rules
        }
        mod.load_state_dict(state, strict=m == 0, assign=True)
        if m:  # a peer holds its slices alone
            for sub in mod.modules():
                for leaf, p in list(sub._parameters.items()):
                    if p is not None and p.is_meta:
                        sub.register_parameter(leaf, None)
        out.append(mod)
    root = out[0]
    root.peers = nn.ModuleList(out[1:])
    if grid is not None and grid.spans_processes:
        root.grid, root.row_group, root.model_first, root.model_total = grid, group, first, total
    grad = any(p.requires_grad for p in model.parameters())
    return root.train(model.training).requires_grad_(grad)


def gather_named(
    named: Dict[str, torch.Tensor], model: nn.Module, device="cpu"
) -> Dict[str, torch.Tensor]:
    """Tensors keyed by a sharded ``model``'s parameter names (its
    parameters, or optimizer moments) as the full model's, on ``device``:
    each split leaf's slices joined in shard order. Over a model row that
    spans processes the slices of every process of the row are gathered
    (a collective over the row: each of its processes calls it)."""
    rules = split_rules(model)
    group = getattr(model, "row_group", None)
    out = {}
    for n, t in named.items():
        if shard_index(n):
            continue
        if n in rules:
            slices = [t] + [named[f"peers.{j}.{n}"] for j in range(local_shards(model) - 1)]
            if group is not None:  # gathered on ``device`` (gloo crosses the host anyway)
                local = torch.stack([s.detach().to(device) for s in slices])
                slices = [p for g in distributed.all_gather(local, group) for p in g.unbind(0)]
            out[n] = _join([s.to(device) for s in slices], *rules[n])
        else:
            out[n] = t.to(device)
    return out


def shard_named(full: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``gather_named``: the full model's tensors split as
    the sharded ``model`` holds them, each on its parameter's device."""
    shards, first, held = model_shards(model), model_first(model), local_shards(model)
    rules = split_rules(model)
    params = dict(model.named_parameters())
    out = {}
    for n, t in full.items():
        if n not in rules:
            out[n] = t.to(params[n].device)
            continue
        dim, widths = rules[n]
        pieces = _split(t, dim, [w * shards for w in widths], shards)
        for m in range(held):  # this process's shards only
            name = n if m == 0 else f"peers.{m - 1}.{n}"
            out[name] = pieces[first + m].to(params[name].device)
    return out


def check_specs(param_specs: Optional[Dict], expected: Dict) -> None:
    """The port's modules hold one layout, JAX's default specs: refuse
    another."""
    if param_specs is not None and param_specs != expected:
        raise ValueError(
            "the port's modules hold the Megatron split of clip_param_specs() / "
            "md_param_specs(); other partition specs are not supported"
        )
