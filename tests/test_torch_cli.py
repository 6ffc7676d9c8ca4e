"""The port's train and predict command lines against the JAX package's
(``train.py``, ``scripts/predict_captions.py``) on the CPU.

The sweep that ``train.py`` runs with no selection flags is held to its
``build_experiments``; one run of the new training flags goes end to end
at the reference widths; ``cli.predict_captions`` writes the caption CSVs
that ``scripts/predict_captions.py`` writes from the same checkpoint.
"""

import argparse
import csv
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data_root(synthetic_msvd, tmp_path):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "MSVD").symlink_to(synthetic_msvd)
    return str(tmp_path / "data")


@pytest.mark.parametrize("flags", [[], ["--reconstructor", "global"], ["--video_only"],
                                   ["--single"]],
                         ids=["sweep", "reconstructor", "video_only", "single"])
def test_experiment_selection_matches_train_py(flags):
    """No selection flag: ``build_experiments`` of ``train.py``, six
    experiments in its order; any selection flag: one experiment named as
    ``train.py:126-141`` names it."""
    from mvc_tpu_torch.cli.train import parse_args, select_experiments

    args = parse_args(["--epochs", "7", "--lr", "0.002", "--batch_size", "32"] + flags)
    got = select_experiments(args)
    if not flags:
        want = _load("train.py", "jax_train_cli").build_experiments(
            argparse.Namespace(epochs=7, lr=0.002, batch_size=32, dataset="MSVD"))
        assert got == want and len(got) == 6
        assert [e["checkpoint_name"] for e in got][:2] == ["SA-LSTM_7_epochs_video_none_0.002",
                                                           "SA-LSTM_7_epochs_video_local_0.002"]
        return
    rec = "global" if "--reconstructor" in flags else "none"
    video_only = "--video_only" in flags
    assert got == [{
        "model": {"teacher_forcing_ratio": 1.0, "reconstructor_type": rec},
        "training": {"batch_size": 32, "epochs": 7, "lr": 0.002},
        "loss": {"reg_lambda": 0.0005, "audio_recon_lambda": 0.0 if video_only else 0.00005,
                 "visual_recon_lambda": 0.5},
        "checkpoint_name": f"rnn_7_epochs_custom_{rec}_0.002",
        "log_dir": f"logs/MSVD/rnn_custom_{rec}_0.002",
        "video_only": video_only,
    }]


def test_cli_without_selection_flags_trains_the_sweep(synthetic_msvd, tmp_path, monkeypatch):
    """``python -m mvc_tpu_torch.cli.train --dataset MSVD``: six fits of the
    dual model, in ``build_experiments``'s order, with its checkpoint
    names, log directories and loss weights (the fits are stubbed)."""
    from mvc_tpu_torch.cli.train import main
    from mvc_tpu_torch.training.trainer import Trainer

    data = _data_root(synthetic_msvd, tmp_path)
    monkeypatch.chdir(tmp_path)
    runs = []

    def fit(self, model, params, train_loader, val_loader, test_loader, cfg):
        runs.append((self.checkpoint_name, type(model).__name__, model.reconstructor_type,
                     cfg.audio_recon_lambda, cfg.visual_recon_lambda, cfg.reg_lambda,
                     train_loader.dataset.video_only))
        Path(self.checkpoint_name).parent.mkdir(parents=True, exist_ok=True)
        return params, None, {"train_loss": []}

    monkeypatch.setattr(Trainer, "fit", fit)
    histories = main(["--data_root", data, "--epochs", "3", "--device", "cpu"])
    assert len(histories) == 6
    want = [(f"checkpoints/MSVD/SA-LSTM_3_epochs_{tag}_{rec}_0.0001.ckpt", "AVCaptioningDual",
             rec, lam, 0.5, 0.0005, False)
            for tag, lam in (("video", 0.0), ("video_audio", 0.00005))
            for rec in ("none", "local", "global")]
    assert runs == want
    for tag in ("video", "video_audio"):
        assert (tmp_path / "logs" / "MSVD" / f"SA-LSTM_3_epochs_{tag}_global_0.0001").is_dir()


def test_cli_single_cached_bf16_state_on_the_cpu(synthetic_msvd, tmp_path, monkeypatch):
    """``--single --device_feature_cache --adam_state_dtype bfloat16`` at
    the reference widths for one epoch: ``AVCaptioning`` trains from cached
    features with bf16 moments and writes its checkpoints."""
    from mvc_tpu_torch.cli.train import main
    from mvc_tpu_torch.training.checkpoint import load_checkpoint
    from mvc_tpu_torch.training.trainer import Trainer

    data = _data_root(synthetic_msvd, tmp_path)
    monkeypatch.chdir(tmp_path)
    seen = {}
    real_fit = Trainer.fit

    def fit(self, model, params, train_loader, val_loader, test_loader, cfg):
        out = real_fit(self, model, params, train_loader, val_loader, test_loader, cfg)
        seen.update(model=type(model).__name__, cache=train_loader.feature_cache,
                    moments={s["mu"].dtype for s in out[1].inner.state.values()})
        return out

    monkeypatch.setattr(Trainer, "fit", fit)
    (history,) = main(["--data_root", data, "--epochs", "1", "--batch_size", "16", "--lr",
                       "0.001", "--device", "cpu", "--single", "--device_feature_cache",
                       "--adam_state_dtype", "bfloat16"])
    assert seen["model"] == "AVCaptioning" and seen["cache"] is not None
    assert seen["moments"] == {torch.bfloat16}
    assert np.isfinite(history["train_loss"][0]["total"]) and len(history["val_score"]) == 1
    last = load_checkpoint(str(tmp_path / "checkpoints" / "MSVD"
                               / "rnn_1_epochs_custom_none_0.001_last.ckpt"))
    assert set(last["params"]) == {"decoder", "reconstructor"}


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_predict_captions_cli_matches_the_script(synthetic_msvd, tmp_path, monkeypatch, mode):
    """One JAX checkpoint of the dual model at the reference widths: the
    port's CLI (``--device cpu``) and ``scripts/predict_captions.py`` write
    the same caption CSVs for every split and the same score columns."""
    from mvc_tpu.data import Vocabulary
    from mvc_tpu.models import AVCaptioningDual as JaxDual
    from mvc_tpu.training.checkpoint import save_checkpoint
    from mvc_tpu_torch.cli.predict_captions import main

    data = _data_root(synthetic_msvd, tmp_path)
    vocab = Vocabulary.load(str(synthetic_msvd / "metadata" / "vocab.json"))
    params = JaxDual(vocab_size=len(vocab)).init(jax.random.PRNGKey(2))
    ckpt = str(tmp_path / "dual_best.ckpt")
    save_checkpoint(ckpt, {"epoch": 1, "params": params})
    args = ["--data_root", data, "--checkpoint", ckpt, "--splits", "val", "test", "--mode",
            mode, "--beam_width", "3", "--batch_size", "8"]
    script = _load("scripts/predict_captions.py", "jax_predict_captions")
    monkeypatch.setattr(sys, "argv", ["predict_captions.py", *args, "--out_dir",
                                      str(tmp_path / "jax")])
    script.main()
    rows = main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    assert [r["split"] for r in rows] == ["val", "test"]
    for split in ("val", "test"):
        name = f"captions_dual_best_{split}_{mode}.csv"
        got, want = _read_csv(tmp_path / "port" / name), _read_csv(tmp_path / "jax" / name)
        assert got == want and len(got) > 2
        assert len({r[1] for r in got[1:]}) > 1                 # not one constant caption
    got = _read_csv(tmp_path / "port" / "NLP_score_MSVD.csv")
    want = _read_csv(tmp_path / "jax" / "NLP_score_MSVD.csv")
    assert got[0] == want[0] and [r[:3] for r in got] == [r[:3] for r in want]
