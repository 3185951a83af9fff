"""W8A8 int8 CLIP image encoder — the opt-in embed throughput tier.

Counterpart of ``imatch_tpu/models/clip/quant.py`` (``quantize_vision_tower``,
``_encoder_w8a8``, ``encode_image_w8a8``), the same recipe:

- weights: per-output-channel symmetric int8 with fp32 scales, quantized
  once from the fp32 master weights (``quantize_vision_tower``);
- activations: dynamic per-row int8; each LayerNorm -> quantize site is
  K4 (one quantize feeds q, k and v), the attention output and the MLP
  activation are K3 (ops/quant.py);
- the six dense contractions a layer are int8 x int8 -> int32 with the
  dequant fused into the fp32 accumulator (``qdot_int8``); attention (K2),
  residual stream and biases stay in the compute dtype, LayerNorms fp32;
- the stem, post-LN and projection are ``VisionTower``'s own
  (models/clip/model.py): only its ``encoder`` is replaced.

The layer keeps the bf16 layer's fused ``(3D, D)`` q/k/v projection:
per-output-channel quantization of the stacked weight is exactly JAX's
three separate quantizations side by side, and K2 reads q, k and v through
strided views of the one product.
"""

from __future__ import annotations

import torch
from torch import nn

from imatch_tpu_torch.models.clip.model import (
    CLIPModel,
    Encoder,
    EncoderLayer,
    VisionTower,
    _act,
    encode_image,
)
from imatch_tpu_torch.ops.attention import mha
from imatch_tpu_torch.ops.quant import (
    ln_quant_rows_int8,
    qdot_int8,
    quant_rows_int8,
    quantize_weight_int8,
)

_DENSE = ("qkv", "out", "fc1", "fc2")


class EncoderLayerW8A8(nn.Module):
    """One pre-LN residual block with int8 dense contractions. Holds each
    Linear's int8 weight ``(D_out, D_in)`` and fp32 scale ``(D_out,)`` as
    buffers, its bias as a parameter (cast to the compute dtype with the
    rest of the model), and the fp32 LayerNorms of the layer it came from."""

    def __init__(self, layer: EncoderLayer):
        super().__init__()
        self.num_heads = layer.num_heads
        self.act = layer.act
        self.ln1 = layer.ln1
        self.ln2 = layer.ln2
        for name in _DENSE:
            lin: nn.Linear = getattr(layer, name)
            if lin.weight.dtype != torch.float32:
                raise TypeError(
                    f"quantize from the fp32 master weights, not {lin.weight.dtype}"
                )
            w = quantize_weight_int8(lin.weight.t())  # (D_in, D_out), as in JAX
            self.register_buffer(f"{name}_q", w["q"].t().contiguous())
            self.register_buffer(f"{name}_s", w["s"].contiguous())
            setattr(self, f"{name}_b", nn.Parameter(lin.bias.detach().clone()))

    def _dense(self, xi, scale, name, dtype):
        return qdot_int8(
            xi,
            scale,
            getattr(self, f"{name}_q").t(),
            getattr(self, f"{name}_s"),
            getattr(self, f"{name}_b"),
            dtype,
        )

    def forward(self, h: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, s, d = h.shape
        nh = self.num_heads
        xi, asc = ln_quant_rows_int8(h, self.ln1.weight, self.ln1.bias, self.ln1.eps)
        qkv = self._dense(xi, asc, "qkv", h.dtype).view(b, s, 3, nh, d // nh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = mha(q, k, v, causal=causal).transpose(1, 2).reshape(b, s, d)
        oi, osc = quant_rows_int8(o)
        h = h + self._dense(oi, osc, "out", h.dtype)
        xi, asc = ln_quant_rows_int8(h, self.ln2.weight, self.ln2.bias, self.ln2.eps)
        y = _act(self._dense(xi, asc, "fc1", h.dtype), self.act)
        yi, ysc = quant_rows_int8(y)
        return h + self._dense(yi, ysc, "fc2", h.dtype)


class EncoderW8A8(nn.Module):
    """An ``Encoder`` with every layer in its W8A8 form."""

    def __init__(self, encoder: Encoder):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayerW8A8(layer) for layer in encoder.layers)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, causal)
        return x


@torch.no_grad()
def quantize_vision_tower(vision: VisionTower) -> VisionTower:
    """Replace the image encoder by its W8A8 form, in place. Must run on
    fp32 weights, before ``cast_compute``; the fp32 encoder matrices are
    dropped with the old encoder (at ViT-L/14 about 1.2 GB)."""
    if not isinstance(vision.encoder, EncoderW8A8):
        vision.encoder = EncoderW8A8(vision.encoder)
    return vision


def encode_image_w8a8(model: CLIPModel, pixels: torch.Tensor) -> torch.Tensor:
    """Image tower with W8A8 encoder matmuls: (B, H, W, 3) preprocessed
    NHWC -> (B, proj) L2-normalised fp32. Raises if the model's image
    encoder was not quantized."""
    if not isinstance(model.vision.encoder, EncoderW8A8):
        raise ValueError("the image encoder is not quantized: build the model with quant='int8'")
    return encode_image(model, pixels)
