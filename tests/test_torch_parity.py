"""The port's public surface and its plain decodes against the JAX package.

- Every public function, class and method of each ``mvc_tpu/`` module
  (read with ``ast``) and every name in a JAX package's ``__all__`` can be
  imported from the port's twin, apart from the names ROADMAP.md lists
  under "Not to port".
- The names added last: ``AVCaptioningDual.predict``, ``greedy_tokens``,
  ``get_tokenizer``, ``init_lstm`` / ``init_gru``.
- The plain versions the CUDA kernels are held to (dual direct, single
  direct, dual beam) at a clip longer than the kernels keep in shared
  memory at these widths (the kernels move the score rows to a global
  workspace there) and at a beam of 12 (the 16-row tile): tokens equal to
  the JAX package's XLA decodes, which run once per module.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models.captioning import AVCaptioning as JaxSingle
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.models.captioning import AVCaptioningDual
from mvc_tpu_torch.ops import _decode_common as _dc
from mvc_tpu_torch.ops.beam import beam_decode_reference
from mvc_tpu_torch.ops.dual_greedy import dual_greedy_decode_reference
from mvc_tpu_torch.ops.greedy import greedy_decode_reference
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "mvc_tpu"

# ROADMAP.md §1 "Not to port": whole modules, then names, by JAX module
NOT_TO_PORT_MODULES = {"ops/dispatch.py", "utils/runtime.py", "ops/pallas_beam.py",
                       "ops/pallas_decode.py", "ops/pallas_dual_greedy.py"}
NOT_TO_PORT_NAMES = {
    "parallel/mesh.py": {"batch_sharding", "replicate", "param_shardings"},
    "parallel/__init__.py": {"batch_sharding", "replicate", "param_shardings"},
    "training/optimizer.py": {"TorchAmsgradState", "scale_by_torch_amsgrad"},
    "utils/torch_oracles.py": {"install_reference_extractor_stubs"},
    "ops/_gates.py": {"apply_gate_tile"},
}

MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                 if str(p.relative_to(JAX_PKG)) not in NOT_TO_PORT_MODULES)


def _public_names(tree: ast.Module):
    """Top-level public functions and classes, each class's public methods
    (``Class.method``), and the names of ``__all__``."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{sub.name}" for sub in node.body
                        if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_")]
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            out += list(ast.literal_eval(node.value))
    return list(dict.fromkeys(out))


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_match_the_jax_package(rel):
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    port = importlib.import_module(".".join(("mvc_tpu_torch",) + parts))
    names = _public_names(ast.parse((JAX_PKG / rel).read_text()))
    allowed = NOT_TO_PORT_NAMES.get(rel, set())
    missing = []
    for name in names:
        if name.split(".")[0] in allowed:
            continue
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, f"mvc_tpu_torch lacks {missing} of mvc_tpu/{rel}"


def test_not_to_port_list_is_roadmaps():
    """The allowlist above is ROADMAP.md's "Not to port" list, no more."""
    text = ROOT.joinpath("ROADMAP.md").read_text()
    section = text.split("Not to port, with the reason")[1].split("\n### ")[0]
    for rel in NOT_TO_PORT_MODULES - {"ops/pallas_beam.py", "ops/pallas_decode.py",
                                      "ops/pallas_dual_greedy.py"}:
        assert f"`{rel}`" in section, rel
    assert "`ops/pallas_*.py`" in section
    for rel, names in NOT_TO_PORT_NAMES.items():
        for name in names:
            assert f"`{name}`" in section, (rel, name)


def test_package_top_level():
    import mvc_tpu
    import mvc_tpu_torch
    from mvc_tpu_torch.training import Trainer
    from mvc_tpu_torch.training.trainer import Trainer as TrainerDef

    assert mvc_tpu_torch.__version__ == mvc_tpu.__version__
    assert mvc_tpu_torch.config.ExperimentConfig().checkpoint_name == "SA-LSTM"
    assert Trainer is TrainerDef


def test_greedy_tokens_matches_jax():
    from mvc_tpu.models.decoder import greedy_tokens as jax_greedy_tokens
    from mvc_tpu_torch.models.decoder import greedy_tokens

    rng = np.random.default_rng(0)
    logp = rng.normal(size=(7, 5, 29)).astype(np.float32)
    logp[2, 1, [3, 11]] = 9.0                                        # a tie: lowest index
    got = greedy_tokens(torch.from_numpy(logp)).numpy()
    assert got.shape == (5, 7)
    np.testing.assert_array_equal(got, np.asarray(jax_greedy_tokens(jnp.asarray(logp))))


def test_get_tokenizer_matches_jax():
    from mvc_tpu.data.tokenizer import get_tokenizer as jax_get_tokenizer
    from mvc_tpu_torch.data.tokenizer import get_tokenizer

    for text in ["A man is playing a guitar.", "Two dogs don't run (fast)!",
                 "a woman slices a tomato, then an onion", "It's 5 p.m. in the U.S."]:
        assert get_tokenizer()(text) == jax_get_tokenizer()(text)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_init_rnn_shapes_match_jax(cell):
    from mvc_tpu.models import rnn as jrnn
    from mvc_tpu_torch.models import rnn as trnn

    name = "init_lstm" if cell == "LSTM" else "init_gru"
    want = getattr(jrnn, name)(jax.random.PRNGKey(0), 12, 16)
    got = getattr(trnn, name)(torch.Generator().manual_seed(0), 12, 16)
    assert set(got) == set(want)
    for k in want:                       # values come from different generators
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        bound = 1.0 / np.sqrt(16)
        assert float(got[k].abs().max()) <= bound


# ---- the plain decodes at long clips and wide beams, against JAX

V = 29
L = 9
T_LONG = 5000      # above the shared-memory fit of every kernel at these widths:
                   # dual greedy 2335, single greedy 4963 (greedy_layout), beam
                   # (8-row tile, W=5) about 3300


def _cfgs(cls):
    v = cls(rnn_type="LSTM", in_feature_size=24, rnn_hidden_size=16, embedding_size=8,
            attn_size=8, output_size=V)
    a = cls(rnn_type="GRU", in_feature_size=12, rnn_hidden_size=32, embedding_size=10,
            attn_size=16, output_size=V)
    return v, a


def _params(cfgs):
    out = []
    for key, cfg in enumerate(cfgs):
        p = jax.tree.map(np.array, jdec.init_decoder(jax.random.PRNGKey(11 + key), cfg))
        p["out"]["w"] = p["out"]["w"] * 5.0      # no top-W decision on a near-tie
        out.append(p)
    return out


def _inputs(B, T, seed):
    """Features with a mean of their own per clip: over thousands of frames
    the attention then still tells the clips apart."""
    rng = np.random.default_rng(seed)
    vf = (rng.normal(size=(B, T, 24)) + 2 * rng.normal(size=(B, 1, 24))).astype(np.float32)
    af = (rng.normal(size=(B, T, 12)) + 2 * rng.normal(size=(B, 1, 12))).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, T // 3:] = False
    return vf, af, mask


# name: (B, T, mode, W)
DECODES = {"dual-direct-long": (3, T_LONG, "direct", 1),
           "single-direct-long": (3, T_LONG, "direct", 1),
           "dual-beam-long": (2, T_LONG, "beam", 5),
           "dual-beam-w12": (3, 6, "beam", 12)}


def test_long_clip_is_above_the_greedy_kernels_fit():
    vcfg, acfg = _cfgs(TorchDecoderConfig)
    decs = [dict(H=c.rnn_hidden_size, A=c.attn_size, E=c.embedding_size, F=c.in_feature_size,
                 cell=c.rnn_type, factored=False) for c in (vcfg, acfg)]
    single = [dict(decs[0], F=36)]
    for d in (decs, single):
        assert not _dc.greedy_layout(d, 64, V)["att_global"]
        assert _dc.greedy_layout(d, T_LONG, V)["att_global"]


@pytest.fixture(scope="module")
def jax_decodes():
    """The JAX package's XLA decodes of every DECODES case, once."""
    vcfg, acfg = _cfgs(DecoderConfig)
    vp, ap = _params((vcfg, acfg))
    out = {}
    for name, (B, T, mode, W) in DECODES.items():
        vf, af, mask = _inputs(B, T, seed=len(name))
        kw = dict(max_caption_len=L, mode=mode, beam_width=W, feat_mask=jnp.asarray(mask))
        if name.startswith("single"):
            model = JaxSingle(vocab_size=V, decoder_config=vcfg.replace(in_feature_size=36))
            params = {"decoder": _params((model.decoder_config,))[0], "reconstructor": None}
        else:
            model = JaxDual(vocab_size=V, visual_decoder_config=vcfg, audio_decoder_config=acfg)
            params = {"v_decoder": vp, "a_decoder": ap, "v_reconstructor": None,
                      "a_reconstructor": None}
        tokens = np.asarray(model.predict_tokens(jax.tree.map(jnp.asarray, params),
                                                 jnp.asarray(af), jnp.asarray(vf), **kw))
        out[name] = (params, (vf, af, mask), tokens)
    return out


@pytest.mark.parametrize("name", list(DECODES))
def test_plain_decode_matches_jax(name, jax_decodes):
    params, (vf, af, mask), want = jax_decodes[name]
    B, T, mode, W = DECODES[name]
    m = torch.from_numpy(mask)
    if name.startswith("single"):
        got = greedy_decode_reference(from_numpy_tree(params["decoder"]),
                                      torch.cat([torch.from_numpy(af), torch.from_numpy(vf)], -1),
                                      m, max_caption_len=L, rnn_type="LSTM")
    else:
        decs = [from_numpy_tree(params["v_decoder"]), from_numpy_tree(params["a_decoder"])]
        feats = [torch.from_numpy(vf), torch.from_numpy(af)]
        if mode == "direct":
            got = dual_greedy_decode_reference(decs, feats, m, max_caption_len=L,
                                               rnn_types=("LSTM", "GRU"))
        else:
            got = beam_decode_reference(decs, feats, m, max_caption_len=L, beam_width=W,
                                        rnn_types=("LSTM", "GRU"))
    got = got.numpy()
    assert got.shape == want.shape and len(np.unique(got[:, 1:])) > 3
    np.testing.assert_array_equal(got, want)


def _vocabs():
    from mvc_tpu.data import Vocabulary as JaxVocabulary
    from mvc_tpu_torch.data import Vocabulary

    out = []
    for cls in (JaxVocabulary, Vocabulary):
        vocab = cls(freq_threshold=1)
        for i in range(len(vocab), V):
            vocab.itos[i] = f"w{i}"
        vocab.stoi = {w: i for i, w in vocab.itos.items()}
        out.append(vocab)
    return out


@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_dual_predict_matches_jax(mode):
    """``AVCaptioningDual.predict`` (``predict_tokens``, then the captions)
    gives the JAX model's captions for the same bridged float32 weights."""
    vcfg, acfg = _cfgs(DecoderConfig)
    vp, ap = _params((vcfg, acfg))
    params = {"v_decoder": vp, "a_decoder": ap, "v_reconstructor": None, "a_reconstructor": None}
    vf, af, mask = _inputs(4, 7, seed=3)
    jvocab, vocab = _vocabs()
    kw = dict(max_caption_len=L, mode=mode, beam_width=3)
    jmodel = JaxDual(vocab_size=V, visual_decoder_config=vcfg, audio_decoder_config=acfg)
    want = jmodel.predict(jax.tree.map(jnp.asarray, params), jvocab, jnp.asarray(af),
                          jnp.asarray(vf), feat_mask=jnp.asarray(mask), **kw)
    tv, ta = _cfgs(TorchDecoderConfig)
    model = AVCaptioningDual(vocab_size=V, visual_decoder_config=tv, audio_decoder_config=ta,
                             device="cpu")
    got = model.predict(from_numpy_tree(params), vocab, torch.from_numpy(af),
                        torch.from_numpy(vf), feat_mask=torch.from_numpy(mask), **kw)
    assert isinstance(got, list) and len(got) == 4 and len(set(got)) > 1
    assert got == want
    assert model.max_frames(params, 64, mode) is None                # any clip length
