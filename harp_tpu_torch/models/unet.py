"""U-Net (harp_tpu/models/unet.py; the reference's model/unet_model.py,
dormant there): double 3x3 convolutions with ReLU, 2x2 max-pool down,
nearest 2x up with skip concatenation, an optional latent broadcast and
concatenated at the bottleneck, and a 1x1 head. NCHW, on cuDNN's
convolutions on the card. convert.unet_params_from_numpy carries
harp_tpu's init_unet parameters over."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.c1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.c2 = nn.Conv2d(cout, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.c2(F.relu(self.c1(x))))


class UNet(nn.Module):
    """Channels base, 2 base, 4 base, 8 base on the way down; input
    (B, in_ch, H, W), latent (B, latent_dim) when latent_dim > 0."""

    def __init__(self, in_ch: int = 3, out_ch: int = 3, base: int = 32, latent_dim: int = 0):
        super().__init__()
        chans = [base, base * 2, base * 4, base * 8]
        self.latent_dim = latent_dim
        self.enc = nn.ModuleList(DoubleConv(i, o) for i, o in zip([in_ch] + chans[:-1], chans))
        self.bott = DoubleConv(chans[-1] + latent_dim, chans[-1])
        ups = list(reversed(chans))
        self.dec = nn.ModuleList(DoubleConv(i + o, o) for i, o in zip([chans[-1]] + ups[:-1], ups))
        self.head = nn.Conv2d(base, out_ch, 1)

    def forward(self, x: torch.Tensor, latent: torch.Tensor | None = None) -> torch.Tensor:
        skips = []
        h = x
        for block in self.enc:
            h = block(h)
            skips.append(h)
            h = F.max_pool2d(h, 2)
        if self.latent_dim:
            z = latent[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
            h = torch.cat([h, z], 1)
        h = self.bott(h)
        for block, skip in zip(self.dec, reversed(skips)):
            h = torch.cat([F.interpolate(h, scale_factor=2, mode="nearest"), skip], 1)
            h = block(h)
        return self.head(h)
