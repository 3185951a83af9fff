"""CLIP image and text towers as PyTorch modules.

Counterpart of ``imatch_tpu/models/clip/model.py`` (``_vision_stem``,
``_encoder``, ``encode_image``, ``encode_text``), and like it numerically
the HF ``transformers.CLIPModel`` forward:

- quick_gelu, LayerNorm eps 1e-5 computed in fp32, pre-LN residual blocks;
- vision: stride-P patch convolution (no bias) + CLS token + learned
  positions, pre-LN, encoder, post-LN on the CLS token, projection;
- text: token + position embeddings, causal encoder, final LN, pooled at
  the FIRST eos token, projection;
- L2-normalised fp32 embeddings.

Served weights live in the module in the compute dtype (bf16 on the card,
fp32 on the CPU) except the LayerNorms, which stay fp32. Training keeps
every parameter an fp32 master and casts it where it is used
(``clip_forward``), as JAX's ``_dense`` does. Attention goes through
``ops/attention.py``: K2 for CUDA tensors. The public functions keep the
JAX package's layouts: ``encode_image`` takes NHWC pixels, ``encode_text``
eos-padded int token ids. ``models/clip/bridge.py`` converts the JAX
param tree to these modules and back.

Tensor parallelism (parallel/sharding.py's Megatron split, JAX's
``clip_param_specs``): a module built with ``shards=M`` holds one model
shard's slice of each encoder layer: its ``num_heads / M`` heads of q, k
and v (column split; the fused ``qkv`` takes each of q, k and v by heads,
so heads land whole on a shard), the matching input columns of ``out``,
``1 / M`` of the MLP's hidden width (``fc1`` by columns, ``fc2`` by rows).
Shard 0 also holds every replicated leaf (LayerNorms, embeddings, stem,
projections, the biases of ``out`` and ``fc2``); the other shards, its
``peers``, hold only their slices, each on its own device. An encoder
layer over shards runs the LayerNorm on shard 0, each shard's attention
over its own heads (K2 at ``(B, H / M, S, Dh)`` when serving) and its MLP
slice on its device, and one reduce at the attention block's output and
one at the MLP's (ops/collectives.py), the row-split biases added once
after each. The Moondream vision tower reuses ``Encoder``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from imatch_tpu_torch.models.clip.configs import CLIPConfig, TextConfig, VisionConfig
from imatch_tpu_torch.ops.attention import mha
from imatch_tpu_torch.ops.collectives import reduce_sum


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 on any input dtype; returns the input's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(x.dtype)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":  # the Moondream vision tower's (models/moondream)
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def _local(width: int, shards: int, what: str) -> int:
    if width % shards:
        raise ValueError(f"{what} {width} does not split over {shards} model shards")
    return width // shards


class EncoderLayer(nn.Module):
    """One pre-LN residual block: attention then MLP. ``shards=M``: one
    model shard's slice (see the module docstring); ``num_heads`` is then
    the shard's head count."""

    def __init__(
        self, d: int, d_mlp: int, num_heads: int, eps: float, act: str, shards: int = 1
    ):
        super().__init__()
        self.num_heads = _local(num_heads, shards, "num_heads")
        self.head_dim = d // num_heads
        self.act = act
        width = self.num_heads * self.head_dim
        self.ln1 = LayerNorm32(d, eps=eps)
        self.qkv = nn.Linear(d, 3 * width)  # q, k, v stacked along the output
        self.out = nn.Linear(width, d)
        self.ln2 = LayerNorm32(d, eps=eps)
        self.fc1 = nn.Linear(d, _local(d_mlp, shards, "mlp_size"))
        self.fc2 = nn.Linear(self.fc1.out_features, d)

    def jax_sources(self) -> Dict[str, Tuple[Tuple[str, int], ...]]:
        """Each Linear: the dense weights of JAX's layer tree that it
        stacks along its output, with their widths there (the bridge's
        layout; each bias is its weight's ``b``). parallel/sharding.py
        splits them by JAX's specs."""
        w, m, d = self.out.in_features, self.fc1.out_features, self.out.out_features
        return {
            "qkv": (("attn.wq", w), ("attn.wk", w), ("attn.wv", w)),
            "out": (("attn.wo", d),),
            "fc1": (("mlp.w1", m),),
            "fc2": (("mlp.w2", d),),
        }

    def attention(self, y: torch.Tensor, causal: bool, attn_impl: str) -> torch.Tensor:
        """This shard's heads on the normalized stream: (B, S, width),
        before ``out``."""
        b, s, _ = y.shape
        nh = self.num_heads
        qkv = self.qkv(y).view(b, s, 3, nh, self.head_dim)
        # (B, H, S, Dh) views of the fused projection; K2 reads them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = mha(q, k, v, causal=causal, impl=attn_impl)
        return o.transpose(1, 2).reshape(b, s, nh * self.head_dim)

    def forward(
        self,
        h: torch.Tensor,
        causal: bool,
        attn_impl: str = "auto",
        peers: Sequence["EncoderLayer"] = (),
    ) -> torch.Tensor:
        """``peers``: the other model shards' slices of this layer, in
        shard order (none on one device)."""
        if not peers:
            h = h + self.out(self.attention(self.ln1(h), causal, attn_impl))
            return h + self.fc2(_act(self.fc1(self.ln2(h)), self.act))
        shards = (self, *peers)
        y = self.ln1(h)
        parts = [
            F.linear(s.attention(y.to(s.qkv.weight.device), causal, attn_impl), s.out.weight)
            for s in shards
        ]
        h = h + reduce_sum(parts, h.device) + self.out.bias
        y = self.ln2(h)
        parts = [
            F.linear(_act(s.fc1(y.to(s.fc1.weight.device)), self.act), s.fc2.weight)
            for s in shards
        ]
        return h + reduce_sum(parts, h.device) + self.fc2.bias


class Encoder(nn.Module):
    def __init__(self, num_layers, d, d_mlp, num_heads, eps, act, shards: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d, d_mlp, num_heads, eps, act, shards) for _ in range(num_layers)
        )

    def forward(
        self,
        x: torch.Tensor,
        causal: bool,
        attn_impl: str = "auto",
        peers: Sequence["Encoder"] = (),
    ) -> torch.Tensor:
        """``peers``: the other model shards' encoders, in shard order."""
        for i, layer in enumerate(self.layers):
            x = layer(x, causal, attn_impl, [p.layers[i] for p in peers])
        return x


def _run_encoder(encoder: nn.Module, x: torch.Tensor, causal: bool, attn_impl: str, peers) -> torch.Tensor:
    """``encoder`` (bf16 or, on one device, W8A8) over its model shards."""
    if peers:
        return encoder(x, causal, attn_impl, peers)
    return encoder(x, causal=causal, attn_impl=attn_impl)


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionConfig, projection_dim: int, shards: int = 1):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.patch_embedding = nn.Conv2d(
            3, d, cfg.patch_size, stride=cfg.patch_size, bias=False
        )
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(torch.empty(cfg.seq_len, d))
        self.pre_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.encoder = Encoder(
            cfg.num_layers, d, cfg.mlp_size, cfg.num_heads, cfg.layer_norm_eps, cfg.hidden_act, shards
        )
        self.post_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(d, projection_dim, bias=False)

    def stem(self, pixels: torch.Tensor) -> torch.Tensor:
        """Patch conv + CLS + positions + pre-LN: (B, H, W, 3) -> (B, S, D).
        One definition for the bf16 and the W8A8 encoder (clip/quant.py)."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixels.to(w.dtype).permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, patches, D), row-major patches
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(x.dtype)
        return self.pre_ln(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Post-LN of the CLS token and projection -> (B, proj) fp32."""
        return self.projection(self.post_ln(x[:, 0, :])).float()

    def forward(
        self, pixels: torch.Tensor, attn_impl: str = "auto", peers: Sequence["VisionTower"] = ()
    ) -> torch.Tensor:
        """(B, H, W, 3) preprocessed pixels -> (B, proj) unnormalised fp32.
        ``self.encoder`` is the bf16 ``Encoder`` or, once
        ``quantize_vision_tower`` ran, the W8A8 one. ``peers``: the other
        model shards' towers (their encoder slices)."""
        x = _run_encoder(self.encoder, self.stem(pixels), False, attn_impl, [p.encoder for p in peers])
        return self.head(x)


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, projection_dim: int, shards: int = 1):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, d)
        self.position_embedding = nn.Parameter(torch.empty(cfg.max_positions, d))
        self.encoder = Encoder(
            cfg.num_layers, d, cfg.mlp_size, cfg.num_heads, cfg.layer_norm_eps, cfg.hidden_act, shards
        )
        self.final_ln = LayerNorm32(d, eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(d, projection_dim, bias=False)

    def forward(
        self,
        token_ids: torch.Tensor,
        eos_id: int,
        attn_impl: str = "auto",
        peers: Sequence["TextTower"] = (),
    ) -> torch.Tensor:
        """(B, S) eos-padded ids -> (B, proj) unnormalised fp32, pooled at
        the first eos (HF's argmax pooling under eos padding). The rows are
        gathered from the token embedding and then cast to the compute
        dtype (the projection's), as JAX does: in training the embedding
        stays an fp32 master and its gradient is accumulated in fp32."""
        b, s = token_ids.shape
        dt = self.projection.weight.dtype
        x = self.token_embedding(token_ids).to(dt) + self.position_embedding[:s].to(dt)
        x = self.final_ln(_run_encoder(self.encoder, x, True, attn_impl, [p.encoder for p in peers]))
        eos_pos = (token_ids == eos_id).int().argmax(dim=-1)
        pooled = x[torch.arange(b, device=x.device), eos_pos]
        return self.projection(pooled).float()


class CLIPModel(nn.Module):
    """Both towers; LayerNorm parameters fp32, everything else in the
    compute dtype the bridge or ``init_random`` gives it. ``shards=M``:
    model shard 0's slice; ``peers`` holds the other shards' (their
    replicated leaves removed, each on its own device), filled by
    ``parallel/sharding.py``'s ``shard_model``."""

    def __init__(self, cfg: CLIPConfig, shards: int = 1):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision, cfg.projection_dim, shards)
        self.text = TextTower(cfg.text, cfg.projection_dim, shards)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))
        self.peers = nn.ModuleList()

    def forward(
        self, pixels: torch.Tensor, token_ids: torch.Tensor, attn_impl: str = "auto"
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both towers' unnormalised (B, proj) fp32 features, over the
        model shards (``clip_forward`` calls it functionally)."""
        peers = list(self.peers)
        img = self.vision(pixels, attn_impl, [p.vision for p in peers])
        eos = self.cfg.text.eos_token_id
        txt = self.text(token_ids, eos, attn_impl, [p.text for p in peers])
        return img, txt


def init_random(
    cfg: CLIPConfig,
    *,
    device: torch.device,
    dtype: torch.dtype,
    generator: torch.Generator,
    quant: Optional[str] = None,
) -> CLIPModel:
    """The JAX init's distribution (normal(0.02) weights, zero biases, unit
    LayerNorms) from a torch Generator. Its numbers differ from
    ``init_params(jax.random.key(0))``: torch cannot reproduce JAX's RNG,
    so parity runs carry the JAX tree across with the bridge instead.
    The weights are drawn in fp32 whatever ``dtype``, so one seed gives
    the same master weights at every dtype; ``quant="int8"`` quantizes
    the image encoder from them before the cast (clip/quant.py)."""
    with torch.device("meta"):
        model = CLIPModel(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for mod in model.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if isinstance(mod, LayerNorm32):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf == "logit_scale":
                    p.fill_(cfg.logit_scale_init)
                elif leaf == "bias":
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)
    return quantize_and_cast(model, dtype, quant)


def quantize_and_cast(
    model: CLIPModel, dtype: torch.dtype, quant: Optional[str] = None
) -> CLIPModel:
    """``cast_compute`` after an optional ``quant="int8"`` of the image
    encoder, which reads the fp32 master weights: quantizing bf16-rounded
    ones would give other codes than the JAX package's."""
    if quant == "int8":
        # clip/quant.py builds on this module, so it is imported here
        from imatch_tpu_torch.models.clip.quant import quantize_vision_tower

        quantize_vision_tower(model.vision)
    elif quant not in (None, "", "none"):
        raise ValueError(f"quant={quant!r}: expected 'int8' or None")
    return cast_compute(model, dtype)


def cast_compute(model: CLIPModel, dtype: torch.dtype) -> CLIPModel:
    """Everything to ``dtype`` except the LayerNorms and logit scale."""
    for mod in model.modules():
        if isinstance(mod, LayerNorm32):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name != "logit_scale":
                p.data = p.data.to(dtype)
    return model.eval().requires_grad_(False)


def _normalize(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


@torch.no_grad()
def encode_image(model: CLIPModel, pixels: torch.Tensor) -> torch.Tensor:
    """Image tower: (B, H, W, 3) preprocessed NHWC floats -> (B, proj)
    L2-normalised fp32."""
    return _normalize(model.vision(pixels, peers=[p.vision for p in model.peers]))


@torch.no_grad()
def encode_text(
    model: CLIPModel,
    token_ids: torch.Tensor,
    *,
    eos_token_id: Optional[int] = None,
) -> torch.Tensor:
    """Text tower: (B, S) eos-padded ids -> (B, proj) L2-normalised fp32.
    ``eos_token_id`` overrides the config's (alternate vocabularies)."""
    eos = model.cfg.text.eos_token_id if eos_token_id is None else eos_token_id
    return _normalize(model.text(token_ids, eos, peers=[p.text for p in model.peers]))


def _cast_params(
    model: CLIPModel, dtype: torch.dtype, params: Optional[Dict[str, torch.Tensor]] = None
) -> Dict[str, torch.Tensor]:
    """Every parameter (``params``, keyed by ``model``'s names, or the
    model's own) cast to ``dtype`` where it is used, differentiably (JAX's
    ``w.astype(x.dtype)`` over fp32 masters), except those JAX reads in
    fp32 whatever the compute dtype: the LayerNorms' scale and bias, the
    logit scale, and the token embedding (gathered, then cast)."""
    keep = {"logit_scale", "text.token_embedding.weight"}
    for prefix, mod in model.named_modules():
        if isinstance(mod, LayerNorm32):
            keep.update(f"{prefix}.{n}" for n, _ in mod.named_parameters(recurse=False))
    params = dict(model.named_parameters()) if params is None else params
    return {n: p if n in keep else p.to(dtype) for n, p in params.items()}


def clip_features(
    model: CLIPModel,
    pixels: torch.Tensor,
    token_ids: torch.Tensor,
    *,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The L2-normalised image and text embeddings of ``clip_forward``,
    differentiable in ``params`` (keyed by ``model``'s parameter names;
    default the model's own): a data shard runs the towers on its copies
    of the masters (parallel/train.py)."""
    cast = _cast_params(model, dtype, params)
    img, txt = functional_call(model, cast, (pixels, token_ids), {"attn_impl": attn_impl})
    return _normalize(img), _normalize(txt)


def clip_forward(
    model: CLIPModel,
    pixels: torch.Tensor,
    token_ids: torch.Tensor,
    *,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Joint differentiable forward over ``model``'s (fp32 master)
    parameters: L2-normalised image and text embeddings and
    ``exp(logit_scale) * img @ txt.T``, an fp32 product (TF32 is off on
    the card: ``device.resolve_device``). Counterpart of JAX's
    ``clip_forward``; ``attn_impl="xla"`` (``mha_xla``) is the training
    path, since K2 has no backward. The towers run over the model's
    shards (its ``peers``) where it has them."""
    img, txt = clip_features(model, pixels, token_ids, dtype=dtype, attn_impl=attn_impl)
    return img, txt, model.logit_scale.exp() * (img @ txt.T)
