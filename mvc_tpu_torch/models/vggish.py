"""VGGish audio encoder (``mvc_tpu/models/vggish.py``) in PyTorch.

torchvggish's network: 6 convs of 3x3 with SAME padding (64, 128, 256x2,
512x2), 4 max-pools of 2x2 over [96, 64] log-mel examples, then fc 12288
-> 4096 -> 4096 -> 128; one 128-d embedding per 0.96 s example.  The
activations are NCHW; before fc1 they are flattened in H·W·C order, as
torchvggish (and the TF original) do, so converted fc weights line up.
Conv weights are [out, in, 3, 3]; fc ``w`` is [in, out] as in the JAX tree.

The optional PCA postprocessor (whiten, clip to [-2, 2], 8-bit
quantize) runs when the tree carries ``pca``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mvc_tpu_torch.models.inception_v3 import state_array

EMBEDDING_SIZE = 128
_FLAT = 6 * 4 * 512     # H x W x channels after 4 pools of [96, 64] (HWC flatten)


def _uniform(g, shape, bound):
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def _conv_init(g, cin, cout):
    bound = float(np.sqrt(1.0 / (9 * cin)))
    return {"w": _uniform(g, (cout, cin, 3, 3), bound), "b": _uniform(g, (cout,), bound)}


def _fc_init(g, cin, cout):
    bound = float(np.sqrt(1.0 / cin))
    return {"w": _uniform(g, (cin, cout), bound), "b": _uniform(g, (cout,), bound)}


def init_vggish(g: torch.Generator) -> Dict:
    """Random weights (uniform in +-1/sqrt(fan_in)) from ``g``; no PCA."""
    return {
        "conv1": _conv_init(g, 1, 64),
        "conv2": _conv_init(g, 64, 128),
        "conv3_1": _conv_init(g, 128, 256),
        "conv3_2": _conv_init(g, 256, 256),
        "conv4_1": _conv_init(g, 256, 512),
        "conv4_2": _conv_init(g, 512, 512),
        "fc1_1": _fc_init(g, _FLAT, 4096),
        "fc1_2": _fc_init(g, 4096, 4096),
        "fc2": _fc_init(g, 4096, EMBEDDING_SIZE),
        "pca": None,
    }


def _conv_relu(p, x):
    return torch.relu(F.conv2d(x, p["w"], p["b"], padding=1))


def vggish_embeddings(params, examples: torch.Tensor, postprocess: bool = True) -> torch.Tensor:
    """examples: [N, 96, 64] log-mel -> [N, 128] embeddings."""
    x = examples[:, None]                          # NCHW, C=1
    x = F.max_pool2d(_conv_relu(params["conv1"], x), 2, 2)
    x = F.max_pool2d(_conv_relu(params["conv2"], x), 2, 2)
    x = _conv_relu(params["conv3_1"], x)
    x = F.max_pool2d(_conv_relu(params["conv3_2"], x), 2, 2)
    x = _conv_relu(params["conv4_1"], x)
    x = F.max_pool2d(_conv_relu(params["conv4_2"], x), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # HWC flatten, as torchvggish
    x = torch.relu(x @ params["fc1_1"]["w"] + params["fc1_1"]["b"])
    x = torch.relu(x @ params["fc1_2"]["w"] + params["fc1_2"]["b"])
    x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    if postprocess and params.get("pca") is not None:
        x = pca_postprocess(params["pca"], x)
    return x


def pca_postprocess(pca: Dict, embeddings: torch.Tensor) -> torch.Tensor:
    """AudioSet postprocessor: PCA whiten, clip, 8-bit quantize (values
    0..255, rounded half to even) as the hub model applies by default."""
    x = (pca["matrix"] @ (embeddings.T - pca["means"])).T
    x = torch.clamp(x, -2.0, 2.0)
    q = torch.round((x + 2.0) * (255.0 / 4.0))
    return torch.clamp(q, 0.0, 255.0)


_TORCH_FEATURE_IDX = {  # torchvggish nn.Sequential indices of conv layers
    "conv1": 0, "conv2": 3, "conv3_1": 6, "conv3_2": 8, "conv4_1": 11, "conv4_2": 13,
}
_TORCH_FC_IDX = {"fc1_1": 0, "fc1_2": 2, "fc2": 4}


def convert_torch_state_dict(state_dict, pca_params: Optional[Dict] = None) -> Dict:
    """torchvggish state_dict (``features.N`` / ``embeddings.N``) and
    optional PCA params (``matrix`` [128, 128], ``means`` [128]) -> the
    port's tree."""

    def t(a):
        return torch.from_numpy(np.array(a))

    params: Dict = {}
    for ours, idx in _TORCH_FEATURE_IDX.items():
        params[ours] = {"w": t(state_array(state_dict, f"features.{idx}.weight")),
                        "b": t(state_array(state_dict, f"features.{idx}.bias"))}
    for ours, idx in _TORCH_FC_IDX.items():
        params[ours] = {"w": t(state_array(state_dict, f"embeddings.{idx}.weight").T),
                        "b": t(state_array(state_dict, f"embeddings.{idx}.bias"))}
    params["pca"] = None
    if pca_params is not None:
        params["pca"] = {
            "matrix": t(np.asarray(pca_params["matrix"], np.float32)),
            "means": t(np.asarray(pca_params["means"], np.float32).reshape(-1, 1)),
        }
    return params
