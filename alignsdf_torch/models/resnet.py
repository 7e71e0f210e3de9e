"""ResNet image encoder + HeadNet in eval mode (NCHW), the default math of
the JAX package's ``models/resnet.py`` (reference networks/resnet.py:99-255,
networks/model.py:33-76).

Three outputs: ``sdf_feat`` = fc(global average pool), ``mano_feat`` = the
pool itself, ``aux_feat`` = HeadNet, 3 x (ConvTranspose k4 s2 p1 -> BN ->
ReLU), 8x8x512 -> 64x64x256.  Module names follow the reference state_dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

_ARCHS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}

# The stem pool through kernel K7 (``kernels/maxpool.py``), the counterpart
# of the JAX package's ``models/resnet.py:PALLAS_POOL``; off by default, as
# there.  Read at call time.  K7 routes the gradient of a tied window to
# every tied position, F.max_pool2d to the first, so the switch changes
# gradients wherever the stem activation has flat regions.
KERNEL_POOL = False


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    if KERNEL_POOL:
        from alignsdf_torch.kernels.maxpool import maxpool_k3s2p1

        return maxpool_k3s2p1(x)
    return F.max_pool2d(x, 3, 2, 1)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """reference networks/resnet.py:26-55"""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride, 0, bias=False), _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class HeadNet(nn.Module):
    """reference networks/model.py:33-51 (deconvs carry no bias)."""

    def __init__(self, in_planes: int = 512, out_planes: int = 256, num_layers: int = 3):
        super().__init__()
        layers = []
        for i in range(num_layers):
            layers += [
                nn.ConvTranspose2d(in_planes if i == 0 else out_planes, out_planes,
                                   4, 2, 1, bias=False),
                _bn(out_planes),
                nn.ReLU(),
            ]
        self.deconv_layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv_layers(x)


class ResNetEncoder(nn.Module):
    """ResNet trunk + three-way head; input NCHW float32."""

    def __init__(self, backbone: str = "resnet18", latent_size: int = 256,
                 mano_features: bool = False, use_headnet: bool = False,
                 use_pixel_align: bool = False):
        super().__init__()
        if backbone not in _ARCHS:
            raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
        self.mano_features = mano_features
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), _ARCHS[backbone])):
            stride = 1 if stage == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(BasicBlock(in_planes, planes, stride if b == 0 else 1))
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.fc = (None if use_headnet and use_pixel_align
                   else nn.Linear(512, latent_size))
        self.aux_layer = HeadNet() if use_headnet else None

    def forward(self, x: torch.Tensor) -> Tuple[
            Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = stem_pool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        gap = x.mean(dim=(2, 3))
        sdf_feat = self.fc(gap) if self.fc is not None else None
        mano_feat = gap if self.mano_features else None
        aux_feat = self.aux_layer(x) if self.aux_layer is not None else None
        return sdf_feat, mano_feat, aux_feat
