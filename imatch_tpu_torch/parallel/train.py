"""CLIP contrastive training, on one device or over a (data, model) grid.

Counterpart of ``imatch_tpu/parallel/train.py``: the symmetric InfoNCE
loss over the global batch, optax's ``chain(clip_by_global_norm, adamw)``
and a train step that clamps the logit scale and counts steps.

The JAX step is one jitted function over a param pytree. Here the params
are a ``CLIPModel`` holding fp32 masters (``requires_grad``), the forward
is ``clip_forward`` (each weight cast to the compute dtype where it is
used, attention through ``mha_xla``: K2 has no backward), and the
optimizer is optax's chain written out over the named parameters, in
optax's order and with its state ``(count, mu, nu)``, so that a
checkpoint maps onto JAX's keys (``parallel/checkpoint.py``).
``torch.optim`` is not used: its global-norm clip divides by
``norm + 1e-6`` where optax divides by ``norm``. The step updates the
parameters and moments in place and returns the state with ``step + 1``.

Over a grid (``mesh=``, parallel/mesh.py), as JAX's step over its mesh:

- the masters are placed on the grid's first row by ``clip_param_specs``'
  Megatron split (parallel/sharding.py): shard 0 holds every replicated
  leaf, each model shard its slices, and the towers run each encoder
  layer over the model shards with one reduce per block;
- the batch splits over ``data``: data shard d runs the towers on copies
  of the masters on its row's devices (the weights are replicated over
  ``data``), and InfoNCE runs over the global batch from the gathered
  per-shard embeddings, not logits (open_clip's recipe, which XLA's
  partitioner derives in JAX);
- every leaf's gradient is its data shards' gradients summed in shard
  order; the global-norm clip takes the norm of the logical arrays over
  all shards, then AdamW runs on each model shard's device.

The grid is one process over a device list (no ``torch.distributed``);
every reduce sums in a fixed shard order, so a run repeats bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import CLIPConfig
from imatch_tpu_torch.models.clip.model import CLIPModel, clip_features, clip_forward, init_random
from imatch_tpu_torch.ops.collectives import gather
from imatch_tpu_torch.parallel.mesh import Grid, as_grid
from imatch_tpu_torch.parallel.sharding import model_shards, shard_index, shard_model

# CLIP clamps exp(logit_scale) at 100 (openai/CLIP model.py public impl).
MAX_LOGIT_SCALE = 4.6052
# optax.adamw's moments and epsilon in make_optimizer
B1, B2, EPS = 0.9, 0.98, 1e-6


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: a 0-d int32 step count and the two
    moments, keyed by ``CLIPModel.named_parameters()`` names."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: CLIPModel
    opt_state: AdamState


def clip_loss(logits_per_image: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch (labels = diagonal)."""
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    li = F.cross_entropy(logits_per_image, labels)
    lt = F.cross_entropy(logits_per_image.T, labels)
    return 0.5 * (li + lt)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr, b1=B1,
    b2=B2, eps=EPS, weight_decay))``: clip by the global norm (``g / norm
    * clip`` where the norm reaches ``clip``), the Adam moments, bias
    correction with the incremented count, ``m_hat / (sqrt(v_hat) +
    eps)``, plus ``weight_decay * p`` on every leaf (LayerNorms and logit
    scale included), times ``-lr``."""

    lr: float = 1e-5
    weight_decay: float = 0.2
    grad_clip: float = 1.0

    def init(self, params: CLIPModel) -> AdamState:
        named = dict(params.named_parameters())
        device = params.logit_scale.device
        return AdamState(
            torch.zeros((), dtype=torch.int32, device=device),
            {n: torch.zeros_like(p, requires_grad=False) for n, p in named.items()},
            {n: torch.zeros_like(p, requires_grad=False) for n, p in named.items()},
        )

    @torch.no_grad()
    def update(
        self, grads: Dict[str, torch.Tensor], state: AdamState, params: CLIPModel
    ) -> AdamState:
        """Apply one update to ``params`` and the moments, in place; returns
        the state with the incremented count. A sharded model's leaves are
        updated on each model shard's device; the clip's norm is the
        global norm of every shard's leaves (a split leaf's slices add up
        to the logical array's squares)."""
        named = dict(params.named_parameters())
        groups: Dict[torch.device, list] = {}
        for n in state.mu:
            groups.setdefault(named[n].device, []).append(n)
        root = state.count.device
        norms = [
            x.to(root) for names in groups.values() for x in torch._foreach_norm([grads[n] for n in names])
        ]
        # clip_by_global_norm: select(norm < clip, g, g / norm * clip)
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        below = g_norm < self.grad_clip
        one = torch.ones_like(g_norm)
        div = torch.where(below, one, g_norm)
        mul = torch.where(below, one, torch.full_like(g_norm, self.grad_clip))
        count = state.count + 1
        c = count.float()
        # bias correction 1 - b ** count in fp32, as optax computes it
        bc1 = 1 - torch.pow(torch.full_like(c, B1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, B2), c)
        for dev, names in groups.items():
            self._apply(
                [named[n] for n in names],
                [grads[n] for n in names],
                [state.mu[n] for n in names],
                [state.nu[n] for n in names],
                *(t.to(dev) for t in (div, mul, bc1, bc2)),
            )
        return AdamState(count, state.mu, state.nu)

    def _apply(self, ps, gs, mus, nus, div, mul, bc1, bc2) -> None:
        """The clipped AdamW update of one device's leaves, in place."""
        gs = torch._foreach_div(gs, div)
        torch._foreach_mul_(gs, mul)
        # the moments: (1 - b) * g^k + b * m
        new = torch._foreach_mul(gs, 1 - B1)
        torch._foreach_mul_(mus, B1)
        torch._foreach_add_(mus, new)
        new = torch._foreach_mul(gs, gs)
        del gs
        torch._foreach_mul_(new, 1 - B2)
        torch._foreach_mul_(nus, B2)
        torch._foreach_add_(nus, new)
        del new
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, den)
        del den
        decay = torch._foreach_mul(ps, self.weight_decay)
        torch._foreach_add_(upd, decay)
        del decay
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(ps, upd)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.2, grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def init_train_state(
    key: Union[int, Dict],
    cfg: CLIPConfig,
    tx: Optional[AdamW] = None,
    mesh: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Tuple[TrainState, AdamW]:
    """Step 0: fp32 master parameters from a seed (``init_random``'s
    draws: torch cannot reproduce JAX's RNG) or from a JAX-layout numpy
    tree (the bridge), and zero moments. On ``device`` (the card unless
    the CPU is asked for), or placed on ``mesh``'s first row by
    ``clip_param_specs``' split (the same init on every grid)."""
    tx = tx or make_optimizer()
    grid = as_grid(mesh)
    device = grid.device(0, 0) if grid is not None else resolve_device(device)
    if isinstance(key, (int, np.integer)):
        gen = torch.Generator(device=device).manual_seed(int(key))
        model = init_random(cfg, device=device, dtype=torch.float32, generator=gen)
    else:
        model = params_from_numpy(key, cfg, device=device, dtype=torch.float32)
    model.train().requires_grad_(True)
    if grid is not None:
        model = shard_model(model, grid.row(0))
    return TrainState(0, model, tx.init(model)), tx


def loss_and_grads(
    params: CLIPModel,
    pixels: torch.Tensor,
    tokens: torch.Tensor,
    *,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    mesh: Optional[Grid] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``jax.value_and_grad`` of the contrastive loss: the loss and the
    gradient of every parameter, keyed by name (fp32, as the masters).
    With a grid of more than one data shard, the batch splits over
    ``data`` (``_data_parallel``)."""
    if mesh is not None and mesh.shape["data"] > 1:
        return _data_parallel(params, mesh, pixels, tokens, dtype, attn_impl)
    _, _, logits = clip_forward(params, pixels, tokens, dtype=dtype, attn_impl=attn_impl)
    loss = clip_loss(logits)
    names, ps = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, ps, grads)
    }


def _data_parallel(model, grid, pixels, tokens, dtype, attn_impl):
    """The step's loss and gradients over the data shards: data shard d
    takes rows [d B/D, (d + 1) B/D) and runs the towers on leaf copies of
    the masters on its row's devices (shard 0 on the masters themselves);
    the normalized embeddings are gathered on shard (0, 0), where InfoNCE
    runs over the global batch; each master's gradient is the sum of its
    copies' in data-shard order."""
    n_data = grid.shape["data"]
    b = pixels.shape[0]
    if b % n_data:
        raise ValueError(f"batch {b} does not split over {n_data} data shards")
    per = b // n_data
    names, masters = zip(*model.named_parameters())
    copies = [list(masters)]
    for d in range(1, n_data):
        copies.append(
            [
                p.detach().to(grid.device(d, shard_index(n))).requires_grad_()
                for n, p in zip(names, masters)
            ]
        )
    imgs, txts = [], []
    for d in range(n_data):
        dev = grid.device(d, 0)
        rows = slice(d * per, (d + 1) * per)
        img, txt = clip_features(
            model,
            pixels[rows].to(dev),
            tokens[rows].to(dev),
            dtype=dtype,
            attn_impl=attn_impl,
            params=dict(zip(names, copies[d])),
        )
        imgs.append(img)
        txts.append(txt)
    root = grid.device(0, 0)
    img, txt = gather(imgs, root), gather(txts, root)
    loss = clip_loss(model.logit_scale.exp() * (img @ txt.T))
    flat = [t for c in copies for t in c]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = {}
    for i, (n, p) in enumerate(zip(names, masters)):
        acc = torch.zeros_like(p)
        for d in range(n_data):
            g = got[d * len(names) + i]
            if g is not None:
                acc = acc + g.to(p.device)
        grads[n] = acc
    return loss.detach(), grads


def make_train_step(
    cfg: CLIPConfig,
    tx: AdamW,
    mesh: Optional[Sequence] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The (state, pixels, tokens) -> (state, loss) step. ``pixels``:
    (B, H, W, 3) preprocessed NHWC floats; ``tokens``: (B, S) eos-padded
    ids; numpy arrays or tensors, moved to the state's first device. Over
    ``mesh`` (the grid ``init_train_state`` placed the state on; a state
    of another model-shard count raises) the batch splits over ``data``:
    B must divide by it. The loss is a 0-d tensor
    on the first device (reading it waits for the step)."""
    grid = as_grid(mesh)

    def step(state: TrainState, pixels, tokens):
        if grid is not None and grid.shape["model"] != model_shards(state.params):
            raise ValueError(
                f"mesh model axis {grid.shape['model']} != the state's "
                f"{model_shards(state.params)} model shards"
            )
        device = state.params.logit_scale.device
        pixels = torch.as_tensor(pixels, dtype=torch.float32, device=device)
        tokens = torch.as_tensor(tokens, device=device)
        loss, grads = loss_and_grads(
            state.params, pixels, tokens, dtype=dtype, attn_impl=attn_impl, mesh=grid
        )
        opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            state.params.logit_scale.clamp_(max=MAX_LOGIT_SCALE)
        return TrainState(state.step + 1, state.params, opt_state), loss

    return step
