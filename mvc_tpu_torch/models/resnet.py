"""ResNet-101 visual encoder (``mvc_tpu/models/resnet.py``), inference
path, in PyTorch.

The reference's ``VisualEncoder(model="resnet")``: torchvision
``resnet101`` at 224x224 whose final ``fc`` is kept, so the "features" are
the 1000-d ImageNet logits (PARITY.md); ``with_fc=False`` gives the
[N, 2048] pooled trunk.  BatchNorm is folded into per-channel (scale,
shift) at conversion; conv weights are [out, in, kh, kw], the fc's ``w``
is [2048, 1000] as in the JAX tree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from mvc_tpu_torch.models.inception_v3 import fold_bn, state_array

# Bottleneck counts per stage for resnet101 (torchvision layers=[3, 4, 23, 3]).
LAYERS = (3, 4, 23, 3)
EXPANSION = 4


def _affine_conv_init(g: torch.Generator, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=g) * float(np.sqrt(2.0 / fan_in))
    return {"w": w, "scale": torch.ones(cout), "shift": torch.zeros(cout)}


def _affine_conv(params, x, stride=1, padding=0):
    """conv (no bias) + folded-BN affine, no relu (bottlenecks add before it)."""
    y = F.conv2d(x, params["w"], stride=stride, padding=padding)
    return y * params["scale"][:, None, None] + params["shift"][:, None, None]


def _bottleneck_init(g, cin, planes, downsample: bool):
    p = {
        "conv1": _affine_conv_init(g, 1, 1, cin, planes),
        "conv2": _affine_conv_init(g, 3, 3, planes, planes),
        "conv3": _affine_conv_init(g, 1, 1, planes, planes * EXPANSION),
    }
    if downsample:
        p["downsample"] = _affine_conv_init(g, 1, 1, cin, planes * EXPANSION)
    return p


def _bottleneck(params, x, stride):
    identity = x
    y = torch.relu(_affine_conv(params["conv1"], x))
    y = torch.relu(_affine_conv(params["conv2"], y, stride=stride, padding=1))
    y = _affine_conv(params["conv3"], y)
    if "downsample" in params:
        identity = _affine_conv(params["downsample"], x, stride=stride)
    return torch.relu(y + identity)


def _stage_init(g, cin, planes, blocks) -> List[Dict]:
    out = [_bottleneck_init(g, cin, planes, downsample=True)]
    for _ in range(1, blocks):
        out.append(_bottleneck_init(g, planes * EXPANSION, planes, downsample=False))
    return out


def init_resnet101(g: torch.Generator) -> Dict:
    """Random weights (He-normal convs, identity affines, a 1/sqrt(2048)
    normal fc, zero bias) from ``g``."""
    params = {
        "conv1": _affine_conv_init(g, 7, 7, 3, 64),
        "layer1": _stage_init(g, 64, 64, LAYERS[0]),
        "layer2": _stage_init(g, 256, 128, LAYERS[1]),
        "layer3": _stage_init(g, 512, 256, LAYERS[2]),
        "layer4": _stage_init(g, 1024, 512, LAYERS[3]),
    }
    fc_w = torch.randn((512 * EXPANSION, 1000), generator=g) * float(np.sqrt(1.0 / 2048))
    params["fc"] = {"w": fc_w, "b": torch.zeros(1000)}
    return params


def resnet101_features(params, x: torch.Tensor, with_fc: bool = True) -> torch.Tensor:
    """x: [N, 3, H, W] NCHW (already normalized; the reference uses
    224x224) -> [N, 1000] logits (fc kept) or the [N, 2048] trunk."""
    x = torch.relu(_affine_conv(params["conv1"], x, stride=2, padding=3))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2), ("layer4", 2)):
        blocks = params[name]
        x = _bottleneck(blocks[0], x, stride)
        for p in blocks[1:]:
            x = _bottleneck(p, x, 1)
    x = x.mean(dim=(2, 3))                             # adaptive avg pool -> [N, 2048]
    if not with_fc:
        return x
    return x @ params["fc"]["w"] + params["fc"]["b"]


def convert_torchvision_state_dict(state_dict) -> Dict:
    """torchvision resnet101 state_dict -> the port's tree, BatchNorm folded
    (BatchNorm2d's default eps=1e-5)."""

    def fold(conv, bn):
        return fold_bn(state_dict, f"{conv}.weight", bn, 1e-5)

    params: Dict = {"conv1": fold("conv1", "bn1")}
    for li, blocks in enumerate(LAYERS, start=1):
        stage = []
        for b in range(blocks):
            pre = f"layer{li}.{b}"
            block = {"conv1": fold(f"{pre}.conv1", f"{pre}.bn1"),
                     "conv2": fold(f"{pre}.conv2", f"{pre}.bn2"),
                     "conv3": fold(f"{pre}.conv3", f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in state_dict:
                block["downsample"] = fold(f"{pre}.downsample.0", f"{pre}.downsample.1")
            stage.append(block)
        params[f"layer{li}"] = stage
    params["fc"] = {"w": torch.from_numpy(np.array(state_array(state_dict, "fc.weight").T)),
                    "b": torch.from_numpy(np.array(state_array(state_dict, "fc.bias")))}
    return params
