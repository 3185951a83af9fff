"""U²-Net as PyTorch modules (NCHW): salient-object segmentation.

Counterpart of ``imatch_tpu/models/u2net/model.py`` (``u2net_forward``),
with the submodule names of the released ``u2net.pth``: ``stage1`` ..
``stage6``, ``stage5d`` .. ``stage1d``, ``side1`` .. ``side6`` and
``outconv``; in each RSU block ``rebnconvin``, ``rebnconv{i}`` and
``rebnconv{i}d``, each a ``conv_s1`` convolution and a ``bn_s1``
BatchNorm. A released state dict loads with ``load_state_dict``.

Numerics, as JAX's:

- each conv+BN+ReLU (``_conv_bn_relu``): the convolution in the compute
  dtype (fp32 accumulation, rounded to the compute dtype), ``+ b`` in that
  dtype, then inference BatchNorm as the affine ``(y - mean) * rsqrt(var +
  eps) * scale + bias`` in fp32 (not folded into the convolution), ReLU,
  back to the compute dtype;
- the 2x2 stride-2 max-pool with SAME padding, which is ``ceil_mode`` for
  odd sizes;
- bilinear upsampling with half-pixel centres (``jax.image.resize``;
  ``F.interpolate(align_corners=False)`` gives the same weights when
  upsampling, edges included);
- the side heads' 3x3 and the fused 1x1 ``outconv`` with SAME padding,
  and an fp32 sigmoid.

The BatchNorm buffers stay fp32 whatever the compute dtype
(``cast_compute``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from imatch_tpu_torch.models.u2net.configs import U2NetConfig


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    if x.shape[-2:] == ref.shape[-2:]:
        return x
    return F.interpolate(x, size=ref.shape[-2:], mode="bilinear", align_corners=False)


def _conv_plain(x: torch.Tensor, conv: nn.Conv2d, dilation: int = 1) -> torch.Tensor:
    """Stride-1 convolution padded to keep the size, in x's dtype; the bias
    is added after the rounding, in that dtype."""
    pad = dilation * (conv.kernel_size[0] // 2)
    y = F.conv2d(x, conv.weight, None, padding=pad, dilation=dilation)
    return y + conv.bias.view(1, -1, 1, 1)


class REBNCONV(nn.Module):
    """3x3 conv (dilated), BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, dilation: int, eps: float):
        super().__init__()
        self.dilation = dilation
        self.conv_s1 = nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)
        self.bn_s1 = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_plain(x, self.conv_s1, self.dilation).float()
        bn = self.bn_s1

        def c(t):
            return t.view(1, -1, 1, 1)

        y = (y - c(bn.running_mean)) * torch.rsqrt(c(bn.running_var) + bn.eps)
        y = y * c(bn.weight) + c(bn.bias)
        return torch.relu(y).to(x.dtype)


class RSU(nn.Module):
    """RSU-L: a small U-Net with a residual over its input conv. Pooling
    between levels and dilation 2 at the bottom; RSU-4F (``dilated``)
    replaces the pooling by a dilation pyramid 1, 2, 4, 8."""

    def __init__(self, L: int, cin: int, mid: int, cout: int, dilated: bool, eps: float):
        super().__init__()
        self.L, self.dilated = L, dilated
        self.rebnconvin = REBNCONV(cin, cout, 1, eps)
        for i in range(1, L):
            setattr(self, f"rebnconv{i}", REBNCONV(cout if i == 1 else mid, mid, 2 ** (i - 1) if dilated else 1, eps))
        setattr(self, f"rebnconv{L}", REBNCONV(mid, mid, 2 ** (L - 1) if dilated else 2, eps))
        for i in range(L - 1, 0, -1):
            setattr(
                self,
                f"rebnconv{i}d",
                REBNCONV(2 * mid, cout if i == 1 else mid, 2 ** (i - 1) if dilated else 1, eps),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.L
        hin = self.rebnconvin(x)
        feats = [hin] if self.dilated else []
        h = hin
        for i in range(1, L):
            h = getattr(self, f"rebnconv{i}")(h)
            feats.append(h)
            if not self.dilated and i < L - 1:
                h = _maxpool2(h)
        h = getattr(self, f"rebnconv{L}")(h)
        for i in range(L - 1, 0, -1):
            skip = feats[i] if self.dilated else feats[i - 1]
            h = _upsample_like(h, skip)
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, skip], dim=1))
        return hin + h


class U2Net(nn.Module):
    """(B, 3, H, W) normalized pixels -> (B, H, W) fp32 saliency in [0, 1]."""

    def __init__(self, cfg: U2NetConfig):
        super().__init__()
        self.cfg = cfg
        n = len(cfg.encoder)
        for i, (L, cin, mid, cout, dil) in enumerate(cfg.encoder):
            setattr(self, f"stage{i + 1}", RSU(L, cin, mid, cout, dil, cfg.bn_eps))
        for i, (L, cin, mid, cout, dil) in enumerate(cfg.decoder):
            setattr(self, f"stage{n - 1 - i}d", RSU(L, cin, mid, cout, dil, cfg.bn_eps))
        # side1 reads stage1d, side2..side5 stage2d..stage5d, side6 stage6
        side_ch = [cfg.decoder[-1][3]] + [d[3] for d in reversed(cfg.decoder[:-1])] + [cfg.encoder[-1][3]]
        for i, cs in enumerate(side_ch):
            setattr(self, f"side{i + 1}", nn.Conv2d(cs, 1, 3, padding=1))
        self.outconv = nn.Conv2d(n, 1, 1)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.outconv.weight.dtype

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        n = len(self.cfg.encoder)
        x = pixels.to(self.dtype)
        enc: List[torch.Tensor] = []
        h = x
        for i in range(n):
            h = getattr(self, f"stage{i + 1}")(h)
            enc.append(h)
            if i < n - 1:
                h = _maxpool2(h)
        d = enc[-1]
        dec: List[torch.Tensor] = []
        for i in range(len(self.cfg.decoder)):
            skip = enc[n - 2 - i]
            d = _upsample_like(d, skip)
            d = getattr(self, f"stage{n - 1 - i}d")(torch.cat([d, skip], dim=1))
            dec.append(d)
        srcs = [dec[-1]] + dec[-2::-1] + [enc[-1]]
        sides = [_upsample_like(_conv_plain(s, getattr(self, f"side{i + 1}")), x) for i, s in enumerate(srcs)]
        fused = _conv_plain(torch.cat(sides, dim=1), self.outconv)
        return torch.sigmoid(fused.float())[:, 0]


@torch.no_grad()
def cast_compute(model: U2Net, dtype: torch.dtype) -> U2Net:
    """Convolutions in ``dtype``, BatchNorms in fp32; inference mode."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            mod.to(dtype)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.float()
    return model.eval().requires_grad_(False)
