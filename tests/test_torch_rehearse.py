"""The port's real-data rehearsal and the tools around it, against the JAX
package: the torchvision / torchvggish stand-ins (``utils/torch_oracles``),
the vocabulary builds (``cli.build_vocab``), the WordNet tables
(``cli.build_wordnet_tables``), and ``cli.rehearse_real_data`` end to end
on the CPU with synthetic clips, from the stand-ins in memory and from
weight files."""

import csv
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mvc_tpu.models import inception_v3 as jiv3
from mvc_tpu.models import resnet as jrn
from mvc_tpu.models import vggish as jvg
from mvc_tpu.utils import torch_oracles as jor
from mvc_tpu_torch.models import inception_v3 as tiv3
from mvc_tpu_torch.models import resnet as trn
from mvc_tpu_torch.models import vggish as tvg
from mvc_tpu_torch.utils import torch_oracles as tor
from mvc_tpu_torch.utils.jax_weights import encoder_from_jax

ROOT = Path(__file__).resolve().parents[1]
MODELS = {
    "inception_v3": (tor.build_torch_inception_v3, jor.build_torch_inception_v3,
                     tiv3.convert_torchvision_state_dict, jiv3.convert_torchvision_state_dict),
    "resnet101": (tor.build_torch_resnet101, jor.build_torch_resnet101,
                  trn.convert_torchvision_state_dict, jrn.convert_torchvision_state_dict),
    "vggish": (tor.build_torch_vggish, jor.build_torch_vggish,
               tvg.convert_torch_state_dict, jvg.convert_torch_state_dict),
}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracles_have_the_jax_copies_layout_and_seed_reproducibly(name):
    """The port's build functions give the JAX copies' state-dict keys and shapes;
    a seeded generator gives the same weights twice, other weights than
    another seed, and the BatchNorm running statistics the JAX copy has."""
    port, jax_build, _, _ = MODELS[name]
    torch.manual_seed(0)
    want = jax_build().state_dict()
    a = port(generator=torch.Generator().manual_seed(3)).state_dict()
    b = port(generator=torch.Generator().manual_seed(3)).state_dict()
    c = port(generator=torch.Generator().manual_seed(4)).state_dict()
    assert [(k, tuple(v.shape)) for k, v in a.items()] == \
        [(k, tuple(v.shape)) for k, v in want.items()]
    assert all(torch.equal(a[k], b[k]) for k in a)
    floats = [k for k, v in a.items() if v.is_floating_point() and "running" not in k]
    assert all(not torch.equal(a[k], c[k]) for k in floats)
    for k in a:
        if "running" in k:    # buffers: as torchvision (or the JAX copy's resnet) leaves them
            assert torch.equal(a[k], want[k]), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_seeded_state_dict_converts_as_in_the_jax_package(name):
    """One seeded state dict through the port's converter and the JAX
    package's (bridged to the port's layout): every leaf equal."""
    port, _, port_convert, jax_convert = MODELS[name]
    sd = port(generator=torch.Generator().manual_seed(5)).state_dict()
    got = _leaves(port_convert(sd))
    want = _leaves(encoder_from_jax(jax.tree.map(np.asarray, jax_convert(sd))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if b is None:
            assert a is None, path
        else:
            assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b), path


def _rel_in_norm(got, want):
    return float((torch.linalg.norm(got - want, dim=-1) / torch.linalg.norm(want, dim=-1)).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_oracle_forward_equals_the_ports_encoder(name):
    """The stand-in's own forward against the port's functional encoder on
    its converted weights: Inception-v3 at 75x75 (pooled trunk), ResNet-101
    at 64x64 (logits), VGGish on log-mel examples; within 1e-4 relative in
    norm per row."""
    port, _, convert, _ = MODELS[name]
    module = port(generator=torch.Generator().manual_seed(6))
    params = convert(module.state_dict())
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        if name == "vggish":
            wav = torch.randn(16000 * 3, generator=g).numpy() * 0.1
            examples = torch.from_numpy(tor.log_mel_examples_np(wav))
            want, got = module.embed(examples), tvg.vggish_embeddings(params, examples)
        else:
            size = 75 if name == "inception_v3" else 64
            x = torch.randn(2, 3, size, size, generator=g)
            if name == "inception_v3":
                want, got = module.trunk(x), tiv3.inception_v3_features(params, x)
            else:
                want, got = module(x), trn.resnet101_features(params, x, with_fc=True)
    assert got.shape == want.shape and float(want.norm()) > 0
    assert _rel_in_norm(got, want) < 1e-4


def test_log_mel_and_wav_reader_are_the_jax_copies(tmp_path):
    from mvc_tpu_torch.extract.synthetic import write_wav

    wav = (0.3 * np.random.default_rng(8).standard_normal(16000 * 2 + 123)).astype(np.float32)
    assert np.array_equal(tor.log_mel_examples_np(wav), jor.log_mel_examples_np(wav))
    assert tor.log_mel_examples_np(wav[:100]).shape == (0, 96, 64)
    write_wav(str(tmp_path / "a.wav"), wav)
    (data, sr), (want, want_sr) = tor._load_wav(str(tmp_path / "a.wav")), \
        jor._load_wav(str(tmp_path / "a.wav"))
    assert sr == want_sr == 16000 and np.array_equal(data, want)


# ------------------------------------------------------------------ vocabulary
CAPTIONS = ['A man is playing a guitar.', 'a man, "quickly", plays the guitar!', "it's a dog",
            "A dog runs; a DOG runs", "the man can't play", "a woman cooks food, then eats"]


def _write_dataset(root: Path, dataset: str):
    rng = np.random.default_rng(9)
    meta = root / dataset / "metadata"
    meta.mkdir(parents=True)
    if dataset == "MSVD":
        for split, n in (("train", 40), ("val", 12)):
            with open(meta / f"{split}.csv", "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["VideoID", "Start", "End", "Source",
                                                  "Description"])
                w.writeheader()
                for i in range(n):
                    w.writerow({"VideoID": f"{split}{i}", "Start": 0, "End": 5,
                                "Source": "clean" if i % 3 else "unverified",
                                "Description": CAPTIONS[int(rng.integers(len(CAPTIONS)))]
                                + f" w{int(rng.integers(8))}"})
    else:     # ids straddle the train+val range's end (7009)
        ids = list(range(6990, 7030)) + [0, 1, 9999]
        sentences = [{"video_id": f"video{v}", "caption": CAPTIONS[v % len(CAPTIONS)]
                      + f" w{v % 11}", "sen_id": k} for k, v in enumerate(ids * 3)]
        (meta / "train_val_videodatainfo.json").write_text(json.dumps({"sentences": sentences}))


@pytest.mark.parametrize("dataset", ["MSVD", "MSR-VTT"])
def test_build_vocab_writes_the_jax_script_and_function_file(tmp_path, dataset):
    """``cli.build_vocab`` writes the same ``vocab.json`` bytes as
    ``scripts/build_vocab.py`` and as the JAX package's build function."""
    from mvc_tpu.data import vocabulary as jvocab
    from mvc_tpu_torch.cli import build_vocab

    _write_dataset(tmp_path, dataset)
    out = tmp_path / dataset / "metadata" / "vocab.json"
    vocab = build_vocab.main(["--dataset", dataset, "--data_root", str(tmp_path)])
    port = out.read_bytes()
    assert len(vocab) > 4 and json.loads(port)["freq_threshold"] == 5
    r = subprocess.run([sys.executable, "scripts/build_vocab.py", "--dataset", dataset,
                        "--data_root", str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == port
    out.unlink()
    build = jvocab.build_msvd_vocab if dataset == "MSVD" else jvocab.build_msr_vtt_vocab
    build(str(tmp_path / dataset))
    assert out.read_bytes() == port


def test_train_and_predict_clis_point_at_build_vocab(tmp_path):
    from mvc_tpu_torch.cli import predict_captions, train

    (tmp_path / "MSVD" / "metadata").mkdir(parents=True)
    for cli, extra in ((train, ["--reconstructor", "none"]), (predict_captions,
                                                               ["--checkpoint", "x.ckpt"])):
        with pytest.raises(SystemExit, match="mvc_tpu_torch.cli.build_vocab"):
            cli.main(["--dataset", "MSVD", "--data_root", str(tmp_path), "--device", "cpu",
                      *extra])


# ------------------------------------------------------------------ WordNet tables
def test_wordnet_tables_are_byte_identical_to_the_jax_script(tmp_path):
    """``cli.build_wordnet_tables`` on the synthetic WNDB of
    ``tests/test_wordnet_tables.py`` writes the JAX script's bytes, and the
    port's METEOR and SPICE read them."""
    import test_wordnet_tables as wt

    from mvc_tpu_torch.cli import build_wordnet_tables
    from mvc_tpu_torch.evalcap.meteor import SynonymTable
    from mvc_tpu_torch.evalcap.spice import PosLexicon

    d = tmp_path / "dict"
    d.mkdir()
    for name, text in (("data.noun", wt.DATA_NOUN), ("data.verb", wt.DATA_VERB),
                       ("index.noun", wt.INDEX_NOUN), ("index.verb", wt.INDEX_VERB),
                       ("noun.exc", wt.NOUN_EXC), ("verb.exc", wt.VERB_EXC)):
        (d / name).write_text(text)
    stats = build_wordnet_tables.main(["--wndb", str(d), "--synonyms-out",
                                       str(tmp_path / "syn.txt"), "--lexicon-out",
                                       str(tmp_path / "lex.txt")])
    r = subprocess.run([sys.executable, "scripts/build_wordnet_tables.py", "--wndb", str(d),
                        "--synonyms-out", str(tmp_path / "jsyn.txt"), "--lexicon-out",
                        str(tmp_path / "jlex.txt")], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "syn.txt").read_bytes() == (tmp_path / "jsyn.txt").read_bytes()
    assert (tmp_path / "lex.txt").read_bytes() == (tmp_path / "jlex.txt").read_bytes()
    assert stats == {"groups": 2, "lexicon_words": 5, "exc_entries": 4}
    syn = SynonymTable.load(str(tmp_path / "syn.txt"))
    assert syn.ids("puppy") & syn.ids("whelp")
    lex = PosLexicon.load(str(tmp_path / "lex.txt"))
    assert lex.lookup("play") == (("verb", "noun"), "play")
    assert lex.lookup("ran") == (("verb",), "run")
    with pytest.raises(SystemExit):
        build_wordnet_tables.main(["--wndb", str(d)])


# ------------------------------------------------------------------ the rehearsal
# tests/test_scripts.py::test_rehearse_real_data_synthetic's flags
FLAGS = ["--epochs", "1", "--batch_size", "4", "--eval_mode", "direct", "--reconstructor",
         "none", "--n_clips", "3", "--clip_seconds", "2.0", "--frame_bucket", "8",
         "--device", "cpu"]
SUMMARY_KEYS = {"extracted", "epochs", "final_train_loss", "val_score", "real_weights",
                "real_data"}     # scripts/rehearse_real_data.py's summary


def _features(root: Path):
    return {p.relative_to(root): np.load(p) for p in sorted(root.rglob("*.npy"))}


def test_rehearsal_on_the_cpu_from_stand_ins_and_from_weight_files(tmp_path, monkeypatch,
                                                                  capsys):
    """The whole rehearsal with synthetic clips: no extraction failure, a
    finite loss, CIDEr among the scores, the JAX script's summary keys
    (printed as the last line); then again from ``MVC_WEIGHTS_DIR`` holding
    the same stand-ins' state dicts saved with ``torch.save``: the same
    features bit for bit."""
    pytest.importorskip("cv2")
    from mvc_tpu_torch.cli import rehearse_real_data as rr

    monkeypatch.delenv("MVC_WEIGHTS_DIR", raising=False)
    monkeypatch.delenv("MVC_DATA_DIR", raising=False)
    summary = rr.main(["--out", str(tmp_path / "a"), *FLAGS])
    assert set(summary) == SUMMARY_KEYS
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["extracted"]["done"] == 3 and summary["extracted"]["failures"] == 0
    assert summary["real_weights"] is False and summary["real_data"] is False
    assert summary["epochs"] == 1 and np.isfinite(summary["final_train_loss"])
    assert "CIDEr" in summary["val_score"]

    weights = tmp_path / "weights"
    weights.mkdir()
    inception, vggish = rr.oracle_state_dicts()
    torch.save(inception, weights / "inception_v3.pth")
    torch.save(vggish, weights / "vggish.pth")
    monkeypatch.setenv("MVC_WEIGHTS_DIR", str(weights))
    again = rr.run(rr.parse_args(["--out", str(tmp_path / "b"), *FLAGS]))
    assert again.summary["real_weights"] is True and again.summary["extracted"]["done"] == 3
    assert set(again.seconds) == {"convert", "data", "extract", "vocab", "fit"}
    a = _features(tmp_path / "a" / "synthetic_msvd" / "features")
    b = _features(tmp_path / "b" / "synthetic_msvd" / "features")
    assert sorted(a) == sorted(b) and len(a) == 6
    for rel in a:
        assert a[rel].dtype == np.float32 and np.array_equal(a[rel], b[rel]), rel
    assert a[Path("video/clip000_0_2.npy")].shape == (2, 2048)


def test_rehearsal_equals_the_jax_script_on_the_same_weight_files_and_clips(tmp_path,
                                                                           monkeypatch):
    """The port's rehearsal and ``scripts/rehearse_real_data.py`` under one
    ``MVC_WEIGHTS_DIR`` (the seeded stand-ins' state dicts) on the same 3
    synthetic clips: every feature file within 1e-5 relative in norm of the
    JAX script's, and ``vocab.json`` byte for byte."""
    pytest.importorskip("cv2")
    import importlib.util
    import shutil

    from mvc_tpu_torch.cli import rehearse_real_data as rr

    weights = tmp_path / "weights"
    weights.mkdir()
    inception, vggish = rr.oracle_state_dicts()
    torch.save(inception, weights / "inception_v3.pth")
    torch.save(vggish, weights / "vggish.pth")
    monkeypatch.setenv("MVC_WEIGHTS_DIR", str(weights))
    monkeypatch.delenv("MVC_DATA_DIR", raising=False)
    rr.main(["--out", str(tmp_path / "port"), *FLAGS])
    port, ref = tmp_path / "port" / "synthetic_msvd", tmp_path / "jax" / "synthetic_msvd"
    for sub in ("videos", "audios"):            # the JAX script reuses clips it finds
        shutil.copytree(port / sub, ref / sub)
    spec = importlib.util.spec_from_file_location("jax_rehearse_real_data",
                                                  ROOT / "scripts" / "rehearse_real_data.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    summary = script.main(["--out", str(tmp_path / "jax"), *FLAGS[:-2]])    # no --device
    assert summary["real_weights"] is True and summary["extracted"]["done"] == 3
    got, want = _features(port / "features"), _features(ref / "features")
    assert sorted(got) == sorted(want) and len(got) == 6
    for rel in got:
        assert got[rel].shape == want[rel].shape, rel
        err = np.linalg.norm(got[rel] - want[rel]) / np.linalg.norm(want[rel])
        assert err <= 1e-5, (rel, err)
    assert (port / "metadata" / "vocab.json").read_bytes() == \
        (ref / "metadata" / "vocab.json").read_bytes()


def test_rehearsal_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    from mvc_tpu_torch.cli import rehearse_real_data as rr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rr.main(["--out", str(tmp_path), "--n_clips", "1"])
    assert not (tmp_path / "synthetic_msvd").exists()     # nothing ran on the CPU
