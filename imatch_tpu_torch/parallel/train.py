"""CLIP contrastive training on one device.

Counterpart of ``imatch_tpu/parallel/train.py``: the symmetric InfoNCE
loss over the batch, optax's ``chain(clip_by_global_norm, adamw)`` and a
train step that clamps the logit scale and counts steps.

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

One device only: a mesh of more than one device raises (data and tensor
parallel training are not ported yet).
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
from imatch_tpu_torch.models.clip.model import CLIPModel, clip_forward, init_random

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
        the state with the incremented count."""
        named = dict(params.named_parameters())
        names = list(state.mu)
        ps = [named[n] for n in names]
        gs = [grads[n] for n in names]
        mus = [state.mu[n] for n in names]
        nus = [state.nu[n] for n in names]
        # clip_by_global_norm: select(norm < clip, g, g / norm * clip)
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        below = g_norm < self.grad_clip
        one = torch.ones_like(g_norm)
        gs = torch._foreach_div(gs, torch.where(below, one, g_norm))
        torch._foreach_mul_(gs, torch.where(below, one, torch.full_like(g_norm, self.grad_clip)))
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
        count = state.count + 1
        c = count.float()
        # bias correction 1 - b ** count in fp32, as optax computes it
        bc1 = 1 - torch.pow(torch.full_like(c, B1), c)
        bc2 = 1 - torch.pow(torch.full_like(c, B2), c)
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
        return AdamState(count, state.mu, state.nu)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.2, grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def check_mesh(mesh: Optional[Sequence]) -> Optional[torch.device]:
    """The one device of ``mesh`` (None for no mesh); raises for more."""
    if mesh is None:
        return None
    if len(mesh) != 1:
        raise NotImplementedError(
            f"a {len(mesh)}-device mesh: data and tensor parallel training are "
            "not ported yet (ROADMAP.md, Queue 1, slice 13); train on one device"
        )
    return torch.device(mesh[0])


def init_train_state(
    key: Union[int, Dict],
    cfg: CLIPConfig,
    tx: Optional[AdamW] = None,
    mesh: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Tuple[TrainState, AdamW]:
    """Step 0 on ``device`` (the card unless the CPU is asked for): fp32
    master parameters from a seed (``init_random``'s draws: torch cannot
    reproduce JAX's RNG) or from a JAX-layout numpy tree (the bridge),
    and zero moments."""
    tx = tx or make_optimizer()
    device = resolve_device(check_mesh(mesh) or device)
    if isinstance(key, (int, np.integer)):
        gen = torch.Generator(device=device).manual_seed(int(key))
        model = init_random(cfg, device=device, dtype=torch.float32, generator=gen)
    else:
        model = params_from_numpy(key, cfg, device=device, dtype=torch.float32)
    model.train().requires_grad_(True)
    return TrainState(0, model, tx.init(model)), tx


def loss_and_grads(
    params: CLIPModel,
    pixels: torch.Tensor,
    tokens: torch.Tensor,
    *,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``jax.value_and_grad`` of the contrastive loss: the loss and the
    gradient of every parameter, keyed by name (fp32, as the masters)."""
    _, _, logits = clip_forward(params, pixels, tokens, dtype=dtype, attn_impl=attn_impl)
    loss = clip_loss(logits)
    names, ps = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, ps, grads)
    }


def make_train_step(
    cfg: CLIPConfig,
    tx: AdamW,
    mesh: Optional[Sequence] = None,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """The (state, pixels, tokens) -> (state, loss) step. ``pixels``:
    (B, H, W, 3) preprocessed NHWC floats; ``tokens``: (B, S) eos-padded
    ids; numpy arrays or tensors, moved to the state's device. The loss
    is a 0-d tensor on the device (reading it waits for the step)."""
    check_mesh(mesh)

    def step(state: TrainState, pixels, tokens):
        device = state.params.logit_scale.device
        pixels = torch.as_tensor(pixels, dtype=torch.float32, device=device)
        tokens = torch.as_tensor(tokens, device=device)
        loss, grads = loss_and_grads(
            state.params, pixels, tokens, dtype=dtype, attn_impl=attn_impl
        )
        opt_state = tx.update(grads, state.opt_state, state.params)
        with torch.no_grad():
            state.params.logit_scale.clamp_(max=MAX_LOGIT_SCALE)
        return TrainState(state.step + 1, state.params, opt_state), loss

    return step
