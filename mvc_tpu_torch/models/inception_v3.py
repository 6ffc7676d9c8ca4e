"""Inception-v3 visual encoder (``mvc_tpu/models/inception_v3.py``),
inference path, in PyTorch.

torchvision's ``inception_v3`` with ``aux_logits=False`` and ``fc``
replaced by identity: 299x299 frames -> [N, 2048] pooled features.  The
parameter tree has the JAX package's keys and nesting (stem convs, then
``Mixed_5b``..``Mixed_7c`` as {branch: [conv block, ...]}); each conv
block is ``{"w": [out, in, kh, kw], "scale", "shift"}`` with BatchNorm
folded into the affine at conversion.  Activations are NCHW, so the
branch concatenation is on dim 1.  The convolutions are ``F.conv2d``
(cuDNN on the card), run in full float32 (``full_float32``).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def full_float32():
    """Run convolutions and matmuls in full float32: without this, cuDNN
    takes TF32 for float32 convolutions by default and the card's features
    differ from the CPU's by ~1e-3 relative."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


# ----------------------------------------------------------------- primitives
def conv_block_init(g: torch.Generator, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=g) * float(np.sqrt(2.0 / fan_in))
    return {"w": w, "scale": torch.ones(cout), "shift": torch.zeros(cout)}


def conv_block(params, x, stride=1, padding=0):
    """conv (no bias) + folded-BN affine + relu."""
    y = F.conv2d(x, params["w"], stride=stride, padding=padding)
    return torch.relu(y * params["scale"][:, None, None] + params["shift"][:, None, None])


def max_pool(x, k=3, stride=2, padding=0):
    return F.max_pool2d(x, k, stride, padding)


def avg_pool_3x3(x):
    """3x3 stride-1 pad-1 average pool, count_include_pad=True (torch default)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


# ----------------------------------------------------------------- blocks
def _inception_a_init(g, cin, pool_features):
    return {
        "branch1x1": [conv_block_init(g, 1, 1, cin, 64)],
        "branch5x5": [conv_block_init(g, 1, 1, cin, 48), conv_block_init(g, 5, 5, 48, 64)],
        "branch3x3dbl": [conv_block_init(g, 1, 1, cin, 64), conv_block_init(g, 3, 3, 64, 96),
                         conv_block_init(g, 3, 3, 96, 96)],
        "branch_pool": [conv_block_init(g, 1, 1, cin, pool_features)],
    }


def _inception_a(params, x):
    b1 = conv_block(params["branch1x1"][0], x)
    b5 = conv_block(params["branch5x5"][0], x)
    b5 = conv_block(params["branch5x5"][1], b5, padding=2)
    b3 = conv_block(params["branch3x3dbl"][0], x)
    b3 = conv_block(params["branch3x3dbl"][1], b3, padding=1)
    b3 = conv_block(params["branch3x3dbl"][2], b3, padding=1)
    bp = conv_block(params["branch_pool"][0], avg_pool_3x3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b_init(g, cin):
    return {
        "branch3x3": [conv_block_init(g, 3, 3, cin, 384)],
        "branch3x3dbl": [conv_block_init(g, 1, 1, cin, 64), conv_block_init(g, 3, 3, 64, 96),
                         conv_block_init(g, 3, 3, 96, 96)],
    }


def _inception_b(params, x):
    b3 = conv_block(params["branch3x3"][0], x, stride=2)
    bd = conv_block(params["branch3x3dbl"][0], x)
    bd = conv_block(params["branch3x3dbl"][1], bd, padding=1)
    bd = conv_block(params["branch3x3dbl"][2], bd, stride=2)
    return torch.cat([b3, bd, max_pool(x, 3, 2)], dim=1)


def _inception_c_init(g, cin, c7):
    return {
        "branch1x1": [conv_block_init(g, 1, 1, cin, 192)],
        "branch7x7": [conv_block_init(g, 1, 1, cin, c7), conv_block_init(g, 1, 7, c7, c7),
                      conv_block_init(g, 7, 1, c7, 192)],
        "branch7x7dbl": [conv_block_init(g, 1, 1, cin, c7), conv_block_init(g, 7, 1, c7, c7),
                         conv_block_init(g, 1, 7, c7, c7), conv_block_init(g, 7, 1, c7, c7),
                         conv_block_init(g, 1, 7, c7, 192)],
        "branch_pool": [conv_block_init(g, 1, 1, cin, 192)],
    }


def _inception_c(params, x):
    b1 = conv_block(params["branch1x1"][0], x)
    b7 = conv_block(params["branch7x7"][0], x)
    b7 = conv_block(params["branch7x7"][1], b7, padding=(0, 3))
    b7 = conv_block(params["branch7x7"][2], b7, padding=(3, 0))
    bd = conv_block(params["branch7x7dbl"][0], x)
    bd = conv_block(params["branch7x7dbl"][1], bd, padding=(3, 0))
    bd = conv_block(params["branch7x7dbl"][2], bd, padding=(0, 3))
    bd = conv_block(params["branch7x7dbl"][3], bd, padding=(3, 0))
    bd = conv_block(params["branch7x7dbl"][4], bd, padding=(0, 3))
    bp = conv_block(params["branch_pool"][0], avg_pool_3x3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d_init(g, cin):
    return {
        "branch3x3": [conv_block_init(g, 1, 1, cin, 192), conv_block_init(g, 3, 3, 192, 320)],
        "branch7x7x3": [conv_block_init(g, 1, 1, cin, 192), conv_block_init(g, 1, 7, 192, 192),
                        conv_block_init(g, 7, 1, 192, 192), conv_block_init(g, 3, 3, 192, 192)],
    }


def _inception_d(params, x):
    b3 = conv_block(params["branch3x3"][0], x)
    b3 = conv_block(params["branch3x3"][1], b3, stride=2)
    b7 = conv_block(params["branch7x7x3"][0], x)
    b7 = conv_block(params["branch7x7x3"][1], b7, padding=(0, 3))
    b7 = conv_block(params["branch7x7x3"][2], b7, padding=(3, 0))
    b7 = conv_block(params["branch7x7x3"][3], b7, stride=2)
    return torch.cat([b3, b7, max_pool(x, 3, 2)], dim=1)


def _inception_e_init(g, cin):
    return {
        "branch1x1": [conv_block_init(g, 1, 1, cin, 320)],
        "branch3x3": [conv_block_init(g, 1, 1, cin, 384),
                      conv_block_init(g, 1, 3, 384, 384),     # _2a
                      conv_block_init(g, 3, 1, 384, 384)],    # _2b
        "branch3x3dbl": [conv_block_init(g, 1, 1, cin, 448), conv_block_init(g, 3, 3, 448, 384),
                         conv_block_init(g, 1, 3, 384, 384),  # _3a
                         conv_block_init(g, 3, 1, 384, 384)], # _3b
        "branch_pool": [conv_block_init(g, 1, 1, cin, 192)],
    }


def _inception_e(params, x):
    b1 = conv_block(params["branch1x1"][0], x)
    b3 = conv_block(params["branch3x3"][0], x)
    b3 = torch.cat([conv_block(params["branch3x3"][1], b3, padding=(0, 1)),
                    conv_block(params["branch3x3"][2], b3, padding=(1, 0))], dim=1)
    bd = conv_block(params["branch3x3dbl"][0], x)
    bd = conv_block(params["branch3x3dbl"][1], bd, padding=1)
    bd = torch.cat([conv_block(params["branch3x3dbl"][2], bd, padding=(0, 1)),
                    conv_block(params["branch3x3dbl"][3], bd, padding=(1, 0))], dim=1)
    bp = conv_block(params["branch_pool"][0], avg_pool_3x3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


# ----------------------------------------------------------------- network
def init_inception_v3(g: torch.Generator) -> Dict:
    """Random weights (He-normal convs, identity affines) from ``g``."""
    return {
        "Conv2d_1a_3x3": conv_block_init(g, 3, 3, 3, 32),
        "Conv2d_2a_3x3": conv_block_init(g, 3, 3, 32, 32),
        "Conv2d_2b_3x3": conv_block_init(g, 3, 3, 32, 64),
        "Conv2d_3b_1x1": conv_block_init(g, 1, 1, 64, 80),
        "Conv2d_4a_3x3": conv_block_init(g, 3, 3, 80, 192),
        "Mixed_5b": _inception_a_init(g, 192, 32),
        "Mixed_5c": _inception_a_init(g, 256, 64),
        "Mixed_5d": _inception_a_init(g, 288, 64),
        "Mixed_6a": _inception_b_init(g, 288),
        "Mixed_6b": _inception_c_init(g, 768, 128),
        "Mixed_6c": _inception_c_init(g, 768, 160),
        "Mixed_6d": _inception_c_init(g, 768, 160),
        "Mixed_6e": _inception_c_init(g, 768, 192),
        "Mixed_7a": _inception_d_init(g, 768),
        "Mixed_7b": _inception_e_init(g, 1280),
        "Mixed_7c": _inception_e_init(g, 2048),
    }


def transform_input(x: torch.Tensor) -> torch.Tensor:
    """torchvision's pretrained-model input re-transform (transform_input=True), NCHW."""
    ch0 = x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5
    ch1 = x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5
    ch2 = x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5
    return torch.cat([ch0, ch1, ch2], dim=1)


def inception_v3_features(params, x: torch.Tensor, apply_transform_input: bool = True
                          ) -> torch.Tensor:
    """x: [N, 3, 299, 299] NCHW (already normalized) -> [N, 2048] pooled features."""
    if apply_transform_input:
        x = transform_input(x)
    x = conv_block(params["Conv2d_1a_3x3"], x, stride=2)
    x = conv_block(params["Conv2d_2a_3x3"], x)
    x = conv_block(params["Conv2d_2b_3x3"], x, padding=1)
    x = max_pool(x, 3, 2)
    x = conv_block(params["Conv2d_3b_1x1"], x)
    x = conv_block(params["Conv2d_4a_3x3"], x)
    x = max_pool(x, 3, 2)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params[name], x)
    x = _inception_b(params["Mixed_6a"], x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params[name], x)
    x = _inception_d(params["Mixed_7a"], x)
    x = _inception_e(params["Mixed_7b"], x)
    x = _inception_e(params["Mixed_7c"], x)
    return x.mean(dim=(2, 3))                  # adaptive avg pool -> [N, 2048]


def imagenet_normalize(frames: torch.Tensor, scale_to_unit: bool = False) -> torch.Tensor:
    """[N, H, W, 3] frames -> [N, 3, H, W] float32, per-channel ImageNet
    normalization.  ``scale_to_unit=False`` keeps the reference quirk of
    normalizing raw 0..255 frames without dividing by 255 (PARITY.md)."""
    x = frames.to(torch.float32)
    if scale_to_unit:
        x = x / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


# ----------------------------------------------------------------- conversion
def state_array(state_dict, name) -> np.ndarray:
    """One state-dict entry (a tensor or an array) as a numpy array."""
    v = state_dict[name]
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def fold_bn(state_dict, conv_w: str, bn: str, eps: float) -> Dict:
    """One conv + BatchNorm pair -> {"w" [out, in, kh, kw], "scale", "shift"}."""
    gamma = state_array(state_dict, f"{bn}.weight")
    var = state_array(state_dict, f"{bn}.running_var")
    scale = gamma / np.sqrt(var + eps)
    shift = state_array(state_dict, f"{bn}.bias") - state_array(state_dict, f"{bn}.running_mean") * scale
    return {"w": torch.from_numpy(np.array(state_array(state_dict, conv_w))),
            "scale": torch.from_numpy(np.array(scale)), "shift": torch.from_numpy(np.array(shift))}


def convert_torchvision_state_dict(state_dict) -> Dict:
    """torchvision Inception3 state_dict (tensors or numpy arrays) -> the
    port's tree, BatchNorm folded (BasicConv2d's eps=1e-3)."""

    def fold(prefix):
        return fold_bn(state_dict, f"{prefix}.conv.weight", f"{prefix}.bn", 1e-3)

    def fold_list(prefix, names):
        return [fold(f"{prefix}.{n}") for n in names]

    params: Dict = {}
    for stem in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                 "Conv2d_4a_3x3"):
        params[stem] = fold(stem)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        params[name] = {
            "branch1x1": fold_list(name, ["branch1x1"]),
            "branch5x5": fold_list(name, ["branch5x5_1", "branch5x5_2"]),
            "branch3x3dbl": fold_list(name, ["branch3x3dbl_1", "branch3x3dbl_2",
                                             "branch3x3dbl_3"]),
            "branch_pool": fold_list(name, ["branch_pool"]),
        }
    params["Mixed_6a"] = {
        "branch3x3": fold_list("Mixed_6a", ["branch3x3"]),
        "branch3x3dbl": fold_list("Mixed_6a", ["branch3x3dbl_1", "branch3x3dbl_2",
                                               "branch3x3dbl_3"]),
    }
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        params[name] = {
            "branch1x1": fold_list(name, ["branch1x1"]),
            "branch7x7": fold_list(name, ["branch7x7_1", "branch7x7_2", "branch7x7_3"]),
            "branch7x7dbl": fold_list(name, [f"branch7x7dbl_{i}" for i in range(1, 6)]),
            "branch_pool": fold_list(name, ["branch_pool"]),
        }
    params["Mixed_7a"] = {
        "branch3x3": fold_list("Mixed_7a", ["branch3x3_1", "branch3x3_2"]),
        "branch7x7x3": fold_list("Mixed_7a", [f"branch7x7x3_{i}" for i in range(1, 5)]),
    }
    for name in ("Mixed_7b", "Mixed_7c"):
        params[name] = {
            "branch1x1": fold_list(name, ["branch1x1"]),
            "branch3x3": fold_list(name, ["branch3x3_1", "branch3x3_2a", "branch3x3_2b"]),
            "branch3x3dbl": fold_list(name, ["branch3x3dbl_1", "branch3x3dbl_2",
                                             "branch3x3dbl_3a", "branch3x3dbl_3b"]),
            "branch_pool": fold_list(name, ["branch_pool"]),
        }
    return params

