"""The weights bridge and checkpoint loading against the JAX package."""

import jax
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models.captioning import AVCaptioning as JaxAVCaptioning
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu.training.checkpoint import save_checkpoint
from mvc_tpu_torch.training.checkpoint import load_checkpoint
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree


def _assert_same_tree(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_same_tree(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()          # bit for bit


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_decoder_tree_round_trips_bit_for_bit(cell):
    cfg = DecoderConfig(rnn_type=cell, in_feature_size=12, rnn_hidden_size=16,
                        embedding_size=8, attn_size=8, output_size=23)
    tree = jax.tree.map(np.asarray, jdec.init_decoder(jax.random.PRNGKey(0), cfg))
    port = from_numpy_tree(tree)
    # the port keeps the JAX layouts: wi [E+F, G*H], every w [in, out]
    G = 4 if cell == "LSTM" else 3
    assert tuple(port["rnn"]["wi"].shape) == (8 + 12, G * 16)
    assert tuple(port["out"]["w"].shape) == (16, 23)
    _assert_same_tree(to_numpy_tree(port), tree)


@pytest.mark.parametrize("reconstructor", ["none", "global"])
def test_dual_tree_round_trips_bit_for_bit(reconstructor):
    small = dict(rnn_hidden_size=16, embedding_size=8, attn_size=8)
    model = JaxDual(vocab_size=19, reconstructor_type=reconstructor,
                    visual_decoder_config=DecoderConfig(in_feature_size=24, **small),
                    audio_decoder_config=DecoderConfig(in_feature_size=12, **small))
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(1)))
    port = from_numpy_tree(tree)
    assert set(port) == {"v_decoder", "a_decoder", "v_reconstructor", "a_reconstructor"}
    _assert_same_tree(to_numpy_tree(port), tree)


@pytest.mark.parametrize("reconstructor", ["none", "global"])
def test_single_tree_round_trips_bit_for_bit(reconstructor):
    model = JaxAVCaptioning(vocab_size=19, reconstructor_type=reconstructor,
                            decoder_config=DecoderConfig(in_feature_size=20, rnn_hidden_size=16,
                                                         embedding_size=8, attn_size=8))
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(4)))
    port = from_numpy_tree(tree)
    assert set(port) == {"decoder", "reconstructor"}
    assert (port["reconstructor"] is None) == (reconstructor == "none")
    _assert_same_tree(to_numpy_tree(port), tree)


def test_bridge_casts_and_places():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.arange(3)}
    port = from_numpy_tree(tree, device="cpu", dtype=torch.bfloat16)
    assert port["w"].dtype == torch.bfloat16 and port["i"].dtype == torch.int64
    np.testing.assert_array_equal(to_numpy_tree(port)["w"], tree["w"])


def test_own_copies_match_jax_package(tmp_path):
    """The port keeps its own copies of config, bucket ladder and vocabulary
    I/O; they hold the JAX package's values and formats."""
    import dataclasses
    import pickle
    import sys
    import types

    import mvc_tpu.config as jcfg
    import mvc_tpu_torch.config as tcfg
    from mvc_tpu.data import Vocabulary as JaxVocabulary
    from mvc_tpu.data.dataset import _bucket as jax_bucket
    from mvc_tpu_torch.data import Vocabulary
    from mvc_tpu_torch.data.dataset import _bucket

    for name in ("PAD_ID", "SOS_ID", "EOS_ID", "UNK_ID", "AUDIO_FEATURE_DIM",
                 "VISUAL_FEATURE_DIM"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for name in ("VISUAL_DECODER_CONFIG", "AUDIO_DECODER_CONFIG", "SINGLE_DECODER_CONFIG"):
        assert (dataclasses.asdict(getattr(tcfg, name))
                == dataclasses.asdict(getattr(jcfg, name))), name
    for name in ("ReconstructorConfig", "TrainerConfig", "ModelConfig", "MeshConfig",
                 "ExperimentConfig"):
        assert (dataclasses.asdict(getattr(tcfg, name)())
                == dataclasses.asdict(getattr(jcfg, name)())), name
    for sp in (1, 2):
        assert tcfg.MeshConfig(sp=sp).axis_names == jcfg.MeshConfig(sp=sp).axis_names
    from mvc_tpu.models.transformer import TransformerConfig as JaxTConfig

    assert dataclasses.asdict(tcfg.TransformerConfig()) == dataclasses.asdict(JaxTConfig())
    ladder = (8, 16, 32, 48, 64)
    assert [_bucket(t, ladder) for t in range(1, 300)] == \
        [jax_bucket(t, ladder) for t in range(1, 300)]

    jv = JaxVocabulary(freq_threshold=1)
    jv.build_vocabulary(["a man plays a guitar", "a dog runs"])
    jv.save(str(tmp_path / "v.json"))
    port = Vocabulary.load(str(tmp_path / "v.json"))
    assert port.itos == jv.itos and port.stoi == jv.stoi and len(port) == len(jv)
    ids = [jv.stoi["a"], jv.stoi["dog"], tcfg.EOS_ID, jv.stoi["man"]]
    assert port.decode_indexes(ids) == jv.decode_indexes(ids) == "a dog"
    port.save(str(tmp_path / "p.json"))
    assert JaxVocabulary.load(str(tmp_path / "p.json")).itos == jv.itos
    # the reference's pickled Vocabulary instance (a class of that name)
    mod = types.ModuleType("get_loader")
    ref_cls = type("Vocabulary", (), {"__module__": "get_loader"})
    mod.Vocabulary = ref_cls
    ref = ref_cls()
    ref.itos, ref.freq_threshold = dict(jv.itos), 1
    sys.modules["get_loader"] = mod
    try:
        (tmp_path / "v.pkl").write_bytes(pickle.dumps(ref))
    finally:
        del sys.modules["get_loader"]
    from_pkl = Vocabulary.load(str(tmp_path / "v.pkl"))
    assert from_pkl.itos == JaxVocabulary.load(str(tmp_path / "v.pkl")).itos == jv.itos
    assert from_pkl.freq_threshold == 1


def test_checkpoint_from_jax_save_loads(tmp_path):
    import optax

    cfg = DecoderConfig(in_feature_size=12, rnn_hidden_size=16, embedding_size=8,
                        attn_size=8, output_size=23)
    params = {"v_decoder": jdec.init_decoder(jax.random.PRNGKey(2), cfg),
              "a_decoder": jdec.init_decoder(jax.random.PRNGKey(3), cfg),
              "v_reconstructor": None, "a_reconstructor": None}
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "ck" / "model.ckpt")
    save_checkpoint(path, {"epoch": 3, "params": params, "opt_state": opt_state,
                           "history": {"loss": [1.0]}})
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 3 and ckpt["history"] == {"loss": [1.0]}
    port = from_numpy_tree(ckpt["params"])
    _assert_same_tree(to_numpy_tree(port), jax.tree.map(np.asarray, params))
    assert load_checkpoint(str(tmp_path / "absent.ckpt")) is None
    (tmp_path / "bad.ckpt").write_bytes(b"not a pickle")
    assert load_checkpoint(str(tmp_path / "bad.ckpt")) is None


def test_single_model_checkpoint_from_jax_save_loads(tmp_path):
    """The single model's tree {decoder, reconstructor: None} loads bit for
    bit, and the loaded weights decode as the JAX tree does."""
    import optax

    from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
    from mvc_tpu_torch.models import AVCaptioning

    small = dict(in_feature_size=20, rnn_hidden_size=16, embedding_size=8, attn_size=8)
    model = JaxAVCaptioning(vocab_size=23, decoder_config=DecoderConfig(**small))
    params = model.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "single.ckpt")
    save_checkpoint(path, {"epoch": 1, "params": params,
                           "opt_state": optax.adam(1e-3).init(params)})
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 1 and ckpt["params"]["reconstructor"] is None
    port = from_numpy_tree(ckpt["params"])
    _assert_same_tree(to_numpy_tree(port), jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(2, 3, 4)).astype(np.float32)
    visual = rng.normal(size=(2, 3, 16)).astype(np.float32)
    want = np.asarray(model.predict_tokens(params, jax.numpy.asarray(audio),
                                           jax.numpy.asarray(visual), max_caption_len=5))
    tmodel = AVCaptioning(vocab_size=23, decoder_config=TorchDecoderConfig(**small), device="cpu")
    got = tmodel.predict_tokens(port, torch.from_numpy(audio), torch.from_numpy(visual),
                                max_caption_len=5).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_checkpoint_converts_as_the_jax_converter(tmp_path):
    """A state_dict with the reference's names, saved as a torch .ckpt,
    converts to the JAX converter's tree leaf for leaf, and the serve CLI's
    loader takes it."""
    from mvc_tpu.utils.checkpoint_convert import convert_reference_checkpoint as jax_convert
    from mvc_tpu_torch.utils.checkpoint_convert import (
        convert_reference_checkpoint,
        load_params_checkpoint,
    )

    gen = torch.Generator().manual_seed(0)
    V, E, H, A = 19, 8, 16, 8

    def rnn(prefix, n_in, hidden):
        return {f"{prefix}.weight_ih_l0": torch.randn(4 * hidden, n_in, generator=gen),
                f"{prefix}.weight_hh_l0": torch.randn(4 * hidden, hidden, generator=gen),
                f"{prefix}.bias_ih_l0": torch.randn(4 * hidden, generator=gen),
                f"{prefix}.bias_hh_l0": torch.randn(4 * hidden, generator=gen)}

    def attention(prefix, hidden, feat):
        return {f"{prefix}.W.weight": torch.randn(A, hidden, generator=gen),
                f"{prefix}.U.weight": torch.randn(A, feat, generator=gen),
                f"{prefix}.b": torch.randn(A, generator=gen),
                f"{prefix}.w.weight": torch.randn(1, A, generator=gen)}

    def decoder(F):
        return {"embedding.weight": torch.randn(V, E, generator=gen),
                **attention("attention", H, F), **rnn("rnn", E + F, H),
                "out.weight": torch.randn(V, H, generator=gen),
                "out.bias": torch.randn(V, generator=gen)}

    ckpt = {"epoch": 7, "v_decoder": decoder(24), "a_decoder": decoder(12),
            "v_reconstructor": {**rnn("rnn", H, 24), **attention("attention", 24, H)},
            "a_reconstructor": rnn("rnn", 2 * H, 12), "history": {"train_loss": [1.5]}}
    path = str(tmp_path / "reference.ckpt")
    torch.save(ckpt, path)
    got = convert_reference_checkpoint(path)
    want = jax_convert(path)
    assert got["epoch"] == want["epoch"] == 7 and got["history"] == want["history"]
    _assert_same_tree(got["params"], jax.tree.map(np.asarray, want["params"]))
    assert set(got["params"]["v_reconstructor"]) == {"rnn", "attention"}
    assert set(got["params"]["a_reconstructor"]) == {"rnn"}
    _assert_same_tree(load_params_checkpoint(path)["params"], got["params"])
    port = from_numpy_tree(got["params"])
    assert tuple(port["v_decoder"]["rnn"]["wi"].shape) == (E + 24, 4 * H)
