"""The port's extraction CNNs against the JAX package's: Inception-v3 at its
smallest input (75x75) and ResNet-101 at 64x64 from JAX's ``init_*`` trees
through the weights bridge (features within 1e-4 relative in norm per
frame), the bridge's round trip, and each converter of a torch state dict
leaf for leaf against the JAX converter's tree bridged to the port's
layout (exact)."""

import jax
import numpy as np
import pytest
import torch

from mvc_tpu.models import inception_v3 as jiv3
from mvc_tpu.models import resnet as jrn
from mvc_tpu.models import vggish as jvg
from mvc_tpu_torch.models import inception_v3 as tiv3
from mvc_tpu_torch.models import resnet as trn
from mvc_tpu_torch.models import vggish as tvg
from mvc_tpu_torch.utils.jax_weights import encoder_from_jax, encoder_to_jax, from_numpy_tree

JAX_INIT = {"inception_v3": (jiv3.init_inception_v3, 0), "resnet": (jrn.init_resnet101, 1),
            "vggish": (jvg.init_vggish, 2)}
PORT_INIT = {"inception_v3": tiv3.init_inception_v3, "resnet": trn.init_resnet101,
             "vggish": tvg.init_vggish}


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's random trees as numpy, one per model, made once per module."""
    out = {}
    for name, (init, seed) in JAX_INIT.items():
        tree = jax.jit(init)(jax.random.PRNGKey(seed))
        out[name] = jax.tree.map(np.asarray, tree)
    return out


def _rel_err_in_norm(got, want):
    return float((np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)).max())


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def test_inception_v3_at_75px_equals_the_jax_package(jax_trees):
    frames = _frames((2, 75, 75, 3), 0)
    want = np.asarray(jiv3.inception_v3_features(jax_trees["inception_v3"],
                                                 jiv3.imagenet_normalize(frames)))
    params = from_numpy_tree(encoder_from_jax(jax_trees["inception_v3"]))
    with torch.no_grad():
        got = tiv3.inception_v3_features(params, tiv3.imagenet_normalize(torch.from_numpy(frames)))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    assert _rel_err_in_norm(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("with_fc", [True, False], ids=["fc_logits", "trunk"])
def test_resnet101_at_64px_equals_the_jax_package(jax_trees, with_fc):
    frames = _frames((2, 64, 64, 3), 1)
    want = np.asarray(jrn.resnet101_features(jax_trees["resnet"],
                                             jiv3.imagenet_normalize(frames), with_fc=with_fc))
    params = from_numpy_tree(encoder_from_jax(jax_trees["resnet"]))
    with torch.no_grad():
        got = trn.resnet101_features(params, tiv3.imagenet_normalize(torch.from_numpy(frames)),
                                     with_fc=with_fc)
    assert got.shape == (2, 1000 if with_fc else 2048)
    assert _rel_err_in_norm(got.numpy(), want) < 1e-4


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("name", sorted(JAX_INIT))
def test_bridge_round_trip_and_port_layout(jax_trees, name):
    """JAX tree -> port tensors -> JAX layout gives every leaf back bit for
    bit, and the port's layout has the shapes of the port's own init."""
    port = from_numpy_tree(encoder_from_jax(jax_trees[name]))
    back = _leaves(encoder_to_jax(port))
    want = _leaves(jax_trees[name])
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        if b is None:
            assert a is None, path
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), path
    own = _leaves(PORT_INIT[name](torch.Generator().manual_seed(0)))
    assert [(p, tuple(v.shape)) for p, v in own if v is not None] == \
        [(p, tuple(v.shape)) for p, v in _leaves(port) if v is not None]


def _seeded_state_dict(module, seed):
    """A torch oracle's state dict with every float entry (BatchNorm running
    statistics too) redrawn from a numpy seed; variances positive."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy((0.05 * rng.standard_normal(v.shape)).astype(np.float32))
    return sd


def _convert_both(name):
    from mvc_tpu.utils import torch_oracles

    if name == "inception_v3":
        sd = _seeded_state_dict(torch_oracles.build_torch_inception_v3(), 3)
        return tiv3.convert_torchvision_state_dict(sd), jiv3.convert_torchvision_state_dict(sd)
    if name == "resnet":
        sd = _seeded_state_dict(torch_oracles.build_torch_resnet101(), 4)
        return trn.convert_torchvision_state_dict(sd), jrn.convert_torchvision_state_dict(sd)
    oracle = torch_oracles.build_torch_vggish()
    sd = _seeded_state_dict(oracle, 5)
    rng = np.random.default_rng(6)
    pca = {"matrix": rng.standard_normal((128, 128)).astype(np.float32),
           "means": rng.standard_normal(128).astype(np.float32)}
    return tvg.convert_torch_state_dict(sd, pca), jvg.convert_torch_state_dict(sd, pca)


@pytest.mark.parametrize("name", sorted(JAX_INIT))
def test_state_dict_converters_equal_the_jax_package_leaf_for_leaf(name):
    port, jax_tree = _convert_both(name)
    got = _leaves(port)
    want = _leaves(encoder_from_jax(jax.tree.map(np.asarray, jax_tree)))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b), path
