"""Moondream-class VLM as PyTorch modules: a SigLIP-style vision tower and
projector, and a Phi-style decoder with a KV cache.

Counterpart of ``imatch_tpu/models/moondream/model.py``:

- vision: stride-P patch convolution (with bias) + learned positions, the
  pre-LN encoder of the CLIP towers (models/clip/model.py ``Encoder``, tanh
  GELU, its attention K2 through ``ops/attention.py``), post-LN; then the
  projector MLP into the decoder's width (``encode_image_features``);
- decoder: token embeddings, Phi parallel blocks (one LayerNorm feeds
  attention and the MLP, ``h + attn + mlp``), partial rotary on the first
  ``rotary_dim`` dims of each head (``_rotary``), attention against a KV
  cache or, cache-free, against the call's own keys (``_attend_cached``:
  plain PyTorch with JAX's XLA math, fp32 logits and masked softmax; its
  bf16 products run on the tensor cores with fp32 results), final LN and
  the LM head (``lm_logits``, fp32 logits).

Weights live in the compute dtype (bf16 on the card, fp32 on the CPU)
except the LayerNorms and the LM head, which are fp32: the head's
logits are fp32 sums of the compute-dtype products, as JAX's
``preferred_element_type=float32`` contraction gives them. The JAX param
tree carries across through ``models/moondream/bridge.py``.

The KV cache is ``(L, B, H, S_max, Dh)`` (JAX keeps ``(L, B, H, Dh,
S_max)`` for the TPU's lanes; the numbers are the same). ``decoder_forward``
writes each call's keys and values into it in place, the counterpart of
JAX's donated carry, and attends over the slots written so far. Every row
of a call starts at the same position (``start_pos`` is an int), as JAX's
rows do by construction.

The int8 weight and cache modes and the W8A8 prefill (``quantize_int8``,
``_quant_kv_cols``, ``act_quant``) are not ported (ROADMAP.md Queue 1
step 10); the runtime refuses their environment variables.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imatch_tpu_torch.models.clip.model import Encoder, LayerNorm32
from imatch_tpu_torch.models.moondream.configs import MDTextConfig, MoondreamConfig

NEG_INF = -1e30


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Vision tower + projector
# ---------------------------------------------------------------------------


class MDVisionTower(nn.Module):
    def __init__(self, cfg: MoondreamConfig):
        super().__init__()
        v = cfg.vision
        self.cfg = v
        self.patch_embedding = nn.Conv2d(3, v.hidden_size, v.patch_size, stride=v.patch_size)
        self.position_embedding = nn.Parameter(torch.empty(v.num_patches, v.hidden_size))
        self.encoder = Encoder(
            v.num_layers, v.hidden_size, v.mlp_size, v.num_heads, v.layer_norm_eps, "gelu_tanh"
        )
        self.post_ln = LayerNorm32(v.hidden_size, eps=v.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> (B, P, D_vision)."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixels.to(w.dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major patches
        x = x + self.position_embedding.to(x.dtype)
        return self.post_ln(self.encoder(x, causal=False))


class MDProjector(nn.Module):
    def __init__(self, cfg: MoondreamConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.vision.hidden_size, cfg.proj_hidden)
        self.fc2 = nn.Linear(cfg.proj_hidden, cfg.text.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(x)))


# ---------------------------------------------------------------------------
# Phi-style decoder
# ---------------------------------------------------------------------------


class MDTextLayer(nn.Module):
    """One Phi parallel block. Unpacked: separate q, k, v and MLP-in
    projections (the checkpoint layout); packed (``pack_text_layers``):
    one ``[q | k | v | fc1]`` projection, one matmul instead of four."""

    def __init__(self, t: MDTextConfig):
        super().__init__()
        d, m = t.hidden_size, t.mlp_size
        self.d = d
        self.ln = LayerNorm32(d, eps=t.layer_norm_eps)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.fc1 = nn.Linear(d, m)
        self.out = nn.Linear(d, d)
        self.fc2 = nn.Linear(m, d)

    def project(self, y: torch.Tensor):
        """LN output -> ([q | k], v, MLP-in), each (B, Sq, width): q and k
        side by side, so that one rotary call serves both."""
        if hasattr(self, "qkv_mlp"):
            z = self.qkv_mlp(y)
            d = self.d
            return z[..., : 2 * d], z[..., 2 * d : 3 * d], z[..., 3 * d :]
        return torch.cat([self.q(y), self.k(y)], dim=-1), self.v(y), self.fc1(y)


class MDTextModel(nn.Module):
    def __init__(self, t: MDTextConfig):
        super().__init__()
        self.cfg = t
        self.token_embedding = nn.Embedding(t.vocab_size, t.hidden_size)
        self.layers = nn.ModuleList(MDTextLayer(t) for _ in range(t.num_layers))
        self.final_ln = LayerNorm32(t.hidden_size, eps=t.layer_norm_eps)
        self.lm_head = nn.Linear(t.hidden_size, t.vocab_size)


class MoondreamModel(nn.Module):
    """Vision tower, projector and decoder; see the module docstring for
    the dtypes each holds (``cast_compute``)."""

    def __init__(self, cfg: MoondreamConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = MDVisionTower(cfg)
        self.projector = MDProjector(cfg)
        self.text = MDTextModel(cfg.text)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.text.token_embedding.weight.dtype


def _is_fp32_param(mod: nn.Module, model: MoondreamModel) -> bool:
    return isinstance(mod, LayerNorm32) or mod is model.text.lm_head


@torch.no_grad()
def cast_compute(
    model: MoondreamModel, dtype: torch.dtype, param_dtype: Optional[torch.dtype] = None
) -> MoondreamModel:
    """Every parameter rounded to ``param_dtype`` (the storage precision,
    JAX's IMATCH_MD_PARAM_DTYPE; default ``dtype``), then held in
    ``dtype``, except the LayerNorms and the LM head, held in fp32. The LM
    head's weight is rounded to ``dtype`` first: JAX casts it to the
    compute dtype at use, and its bias not."""
    param_dtype = param_dtype or dtype
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            x = p.data.to(param_dtype)
            if _is_fp32_param(mod, model):
                if mod is model.text.lm_head and name == "weight":
                    x = x.to(dtype)
                p.data = x.float()
            else:
                p.data = x.to(dtype)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def pack_text_layers(model: MoondreamModel) -> MoondreamModel:
    """Replace each decoder layer's q, k, v and fc1 projections by one
    packed ``qkv_mlp`` projection (in place; the separate ones are dropped,
    so the card holds one set of weights). The unpacked layout stays the
    canonical one: checkpoints and the bridge load into it."""
    for layer in model.text.layers:
        if hasattr(layer, "qkv_mlp"):
            continue
        parts = (layer.q, layer.k, layer.v, layer.fc1)
        w = torch.cat([p.weight for p in parts], dim=0)
        b = torch.cat([p.bias for p in parts], dim=0)
        packed = nn.Linear(w.shape[1], w.shape[0], device=w.device, dtype=w.dtype)
        packed.weight.data = w
        packed.bias.data = b
        layer.qkv_mlp = packed.requires_grad_(False)
        del layer.q, layer.k, layer.v, layer.fc1
    return model


@torch.no_grad()
def init_random(
    cfg: MoondreamConfig,
    *,
    seed: int,
    device,
    dtype: torch.dtype,
    param_dtype: Optional[torch.dtype] = None,
    packed: bool = True,
) -> MoondreamModel:
    """JAX ``init_md_params``'s distribution (normal(0.02) weights, zero
    biases, unit LayerNorms) from a ``torch.Generator`` on ``device``
    seeded with ``seed``. Its numbers differ from JAX's (torch cannot
    reproduce JAX's RNG): parity runs carry the JAX tree across with
    ``bridge.md_params_from_numpy`` instead. Weights are drawn in fp32 on
    the unpacked layout whatever ``dtype`` and ``packed``, so one seed
    gives the same master weights in every form."""
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        model = MoondreamModel(cfg)
    model = model.to_empty(device=device)
    for mod in model.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, LayerNorm32):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
    model = cast_compute(model, dtype, param_dtype)
    return pack_text_layers(model) if packed else model


# ---------------------------------------------------------------------------
# Functions on tensors
# ---------------------------------------------------------------------------


@torch.no_grad()
def encode_image_features(model: MoondreamModel, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, P, D_text) LM-space embeds,
    in the compute dtype."""
    return model.projector(model.vision(pixels))


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, S_max, Dh)
    v: torch.Tensor  # (L, B, H, S_max, Dh)


def init_cache(
    cfg: MoondreamConfig, batch: int, *, device, dtype: torch.dtype, cache_len: int = 0
) -> KVCache:
    """cache_len 0 -> the full max_seq."""
    t = cfg.text
    shape = (t.num_layers, batch, t.num_heads, cache_len or t.max_seq, t.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device)
    )


def _rotary_tables(start_pos: int, sq: int, rotary_dim: int, device):
    """cos and sin of the rotary angles at positions start_pos ..
    start_pos + sq - 1: (Sq, 1, 1, rotary_dim // 2) fp32 each, to
    broadcast over (B, Sq, 2, H, half) queries and keys."""
    half = rotary_dim // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    pos = torch.arange(start_pos, start_pos + sq, device=device).float()
    ang = (pos[:, None] * freqs[None, :])[:, None, None, :]
    return torch.cos(ang), torch.sin(ang)


def _rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """Phi-style partial rotary on the first ``rotary_dim`` dims of each
    head of x (..., Dh), in fp32, back in x's dtype."""
    half = rotary_dim // 2
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    return torch.cat([rot, xp], dim=-1)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the leading batch dims with fp32 accumulation and an fp32
    result, JAX's ``preferred_element_type=float32`` contraction: bf16
    operands on the card stay bf16 on the tensor cores (``bmm``'s
    ``out_dtype``), fp32 ones are a full fp32 product."""
    if a.dtype == torch.float32 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
    return out.view(*a.shape[:-2], *out.shape[-2:])


def _attend_cached(
    q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, hidden: Optional[torch.Tensor]
) -> torch.Tensor:
    """q (B, H, Sq, Dh) against keys and values (B, H, S, Dh), where
    ``hidden`` (Sq, S) marks the slots a query position does not see
    (later positions: causal by construction), None when it sees them all.
    fp32 logits and softmax, masked entries at -1e30; the probabilities
    rounded to q's dtype before the fp32-accumulated product with the
    values, as JAX's ``_attend_cached``."""
    scale = q.shape[-1] ** -0.5
    logits = _mm_f32(q, ck.transpose(-1, -2)).mul_(scale)
    if hidden is not None:
        logits.masked_fill_(hidden, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    del logits
    return _mm_f32(probs.to(q.dtype), cv).to(q.dtype)


@torch.no_grad()
def decoder_forward(
    model: MoondreamModel,
    embeds: torch.Tensor,
    cache: Optional[KVCache],
    start_pos: int,
    *,
    collect_kv: bool = False,
) -> Tuple[torch.Tensor, object]:
    """Run Sq tokens at positions start_pos .. start_pos + Sq - 1 through
    the decoder. embeds: (B, Sq, D). Serves prefill and decode (Sq = 1).

    With a cache: writes the new keys and values into its slots in place
    and attends over the slots written so far (the cache's later slots
    are masked in JAX, so leaving them out gives the same numbers);
    returns (hidden (B, Sq, D), cache). ``cache=None``: cache-free,
    start_pos must be 0, attention runs causally over this call's own
    keys and values; returns (hidden, ``(K, V)`` stacked ``(L, B, H, Sq,
    Dh)`` when ``collect_kv``, else None)."""
    t = model.cfg.text
    b, sq, d = embeds.shape
    nh, hd = t.num_heads, t.head_dim
    if cache is None and start_pos != 0:
        raise ValueError("a cache-free forward starts at position 0")
    x = embeds.to(model.dtype)
    cos, sin = _rotary_tables(start_pos, sq, t.rotary_dim, x.device)
    n_vis = start_pos + sq
    hidden = None  # one new token sees every slot written so far
    if sq > 1:
        qpos = torch.arange(start_pos, n_vis, device=x.device)
        hidden = torch.arange(n_vis, device=x.device)[None, :] > qpos[:, None]
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for li, layer in enumerate(model.text.layers):
        y = layer.ln(x)
        qk, v, m1 = layer.project(y)
        qk = _rotary(qk.unflatten(-1, (2, nh, hd)), cos, sin, t.rotary_dim)
        q, k = qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2)
        v = v.unflatten(-1, (nh, hd)).transpose(1, 2)
        if cache is None:
            ck, cv = k, v
            if collect_kv:
                ks.append(k)
                vs.append(v)
        else:
            cache.k[li, :, :, start_pos:n_vis] = k
            cache.v[li, :, :, start_pos:n_vis] = v
            ck, cv = cache.k[li, :, :, :n_vis], cache.v[li, :, :, :n_vis]
        o = _attend_cached(q, ck, cv, hidden)
        o = o.transpose(1, 2).reshape(b, sq, d)
        x = x + layer.out(o) + layer.fc2(_gelu(m1))  # Phi parallel residual
    if cache is None:
        return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)
    return x, cache


@torch.no_grad()
def lm_logits(model: MoondreamModel, hidden: torch.Tensor) -> torch.Tensor:
    """(B, Sq, D) -> (B, Sq, V) fp32 logits."""
    h = model.text.final_ln(hidden)
    head = model.text.lm_head
    return F.linear(h.float(), head.weight, head.bias)


@torch.no_grad()
def embed_tokens(model: MoondreamModel, token_ids: torch.Tensor) -> torch.Tensor:
    return model.text.token_embedding(token_ids).to(model.dtype)
