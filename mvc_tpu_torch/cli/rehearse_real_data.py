"""Real-data rehearsal, one command from videos and encoder checkpoints to
caption scores: the port of ``scripts/rehearse_real_data.py``.

    MVC_WEIGHTS_DIR=/mnt/weights MVC_DATA_DIR=/mnt/msvd \\
        python -m mvc_tpu_torch.cli.rehearse_real_data --epochs 50

  MVC_WEIGHTS_DIR  directory with ``inception_v3.pth`` (torchvision
                   Inception-v3 state dict) and ``vggish.pth`` (torchvggish
                   hub state dict), read with ``torch.load(path,
                   map_location="cpu")``; torch's default
                   ``weights_only=True`` takes a plain state dict.  Unset:
                   seeded random-weight stand-ins
                   (``utils/torch_oracles.py``, generators seeded 0 and 1)
                   go through the same converters.
  MVC_DATA_DIR     dataset root with ``videos/`` (and optional ``audios/``
                   WAV sidecars) and ``metadata/{train,val,test}.csv``
                   (VideoID,Start,End,Source,Description).  Unset: a
                   synthetic clip set with caption metadata is written under
                   ``--out``.

The steps (reference src/extract_features.py:109-166 and
src/train.py:351-549 end to end):

  1. convert the torch checkpoints to the port's trees
     (``models/inception_v3.convert_torchvision_state_dict``,
     ``models/vggish.convert_torch_state_dict``)
  2. batched feature extraction (``FeatureExtractor.extract_dataset``) for
     every clip without features
  3. the vocabulary from the train split, unless ``metadata/vocab.json``
     exists
  4. ``Trainer.fit`` of ``AVCaptioningDual`` for ``--epochs`` with the
     device feature cache, scored after the last epoch in ``--eval_mode``
     (beam: ``csrc/beam.cu`` on the card; direct: ``csrc/dual_greedy.cu``)
  5. one JSON line: ``extracted``, ``epochs``, ``final_train_loss``,
     ``val_score``, ``real_weights``, ``real_data``

Everything runs on the card unless ``--device cpu``; with no card,
``--device cuda`` raises.  Checkpoints go to ``<out>/rehearsal*.ckpt``,
and a later run with the same ``--out`` resumes from them.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from mvc_tpu_torch.training.trainer import Trainer

INCEPTION_SEED, VGGISH_SEED = 0, 1     # the stand-ins' generators
SYNTHETIC_CAPTIONS = (
    "a man is playing a guitar", "a woman is cooking food", "a dog runs across a field",
    "a cat sits on a couch", "two men ride bikes down the street", "children play in the water",
)


def oracle_state_dicts() -> Tuple[Dict, Dict]:
    """The seeded stand-ins' state dicts: (Inception-v3, VGGish)."""
    from mvc_tpu_torch.utils.torch_oracles import build_torch_inception_v3, build_torch_vggish

    inception = build_torch_inception_v3(generator=torch.Generator().manual_seed(INCEPTION_SEED))
    vggish = build_torch_vggish(generator=torch.Generator().manual_seed(VGGISH_SEED))
    return inception.state_dict(), vggish.state_dict()


def resolve_encoder_params(weights_dir: Optional[str]):
    """(Inception-v3 params, VGGish params) from the checkpoints in
    ``weights_dir``, or from the seeded stand-ins when it is None."""
    from mvc_tpu_torch.models import inception_v3 as iv3
    from mvc_tpu_torch.models import vggish as vg

    if weights_dir:
        inc_sd = torch.load(os.path.join(weights_dir, "inception_v3.pth"), map_location="cpu")
        vgg_sd = torch.load(os.path.join(weights_dir, "vggish.pth"), map_location="cpu")
        print("converting real checkpoints from", weights_dir)
    else:
        print("MVC_WEIGHTS_DIR not set: using seeded random-weight torch stand-ins "
              "(conversion path identical; quality numbers meaningless)")
        inc_sd, vgg_sd = oracle_state_dicts()
    return iv3.convert_torchvision_state_dict(inc_sd), vg.convert_torch_state_dict(vgg_sd)


def resolve_dataset(data_dir: Optional[str], out_dir: str, n_clips: int = 12,
                    clip_seconds: float = 6.0) -> str:
    """The dataset root; a synthetic one under ``out_dir`` when ``data_dir``
    is None (clips made once, metadata rewritten: two captions a clip, the
    same rows in every split)."""
    if data_dir:
        return data_dir
    from mvc_tpu_torch.extract.synthetic import make_clip_set

    root = os.path.join(out_dir, "synthetic_msvd")
    videos = os.path.join(root, "videos")
    if not (os.path.isdir(videos) and len(os.listdir(videos)) >= n_clips):
        print("MVC_DATA_DIR not set: generating a synthetic clip set")
        make_clip_set(root, n_clips, seconds=clip_seconds)
    rows = []
    for i, f in enumerate(sorted(os.listdir(videos))):
        vid, start, end = os.path.splitext(f)[0].rsplit("_", 2)     # clipNNN_0_6
        for c in range(2):
            rows.append({"VideoID": vid, "Start": int(start), "End": int(end),
                         "Source": "clean",
                         "Description": SYNTHETIC_CAPTIONS[(2 * i + c) % len(SYNTHETIC_CAPTIONS)]})
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)
    for split in ("train", "val", "test"):
        with open(os.path.join(root, "metadata", f"{split}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return root


def extract_features(root: str, inception_params, vggish_params, device, batch_size: int = 16,
                     frame_buckets: Sequence[int] = (64, 128, 256)) -> Dict:
    from mvc_tpu_torch.extract import FeatureExtractor

    fe = FeatureExtractor(inception_params=inception_params, vggish_params=vggish_params, fps=1,
                          frame_buckets=frame_buckets, device=device)
    return fe.extract_dataset(os.path.join(root, "videos"), os.path.join(root, "features"),
                              batch_size=batch_size)


def ensure_vocab(root: str) -> str:
    """``metadata/vocab.json``, built from the train split's captions
    (threshold 1) when missing."""
    from mvc_tpu_torch.data.vocabulary import Vocabulary

    vocab_path = os.path.join(root, "metadata", "vocab.json")
    if not os.path.isfile(vocab_path):
        with open(os.path.join(root, "metadata", "train.csv"), newline="") as f:
            captions = [r["Description"] for r in csv.DictReader(f)]
        vocab = Vocabulary.prebuild(captions, vocab_path, freq_threshold=1)
        print(f"built vocab ({len(vocab)} words) -> {vocab_path}")
    return vocab_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="/tmp/mvc_rehearsal")
    ap.add_argument("--epochs", default=2, type=int)
    ap.add_argument("--batch_size", default=8, type=int)
    ap.add_argument("--lr", default=3e-3, type=float)
    ap.add_argument("--dataset", default="MSVD", choices=["MSVD", "MSR-VTT"])
    ap.add_argument("--reconstructor", default="global", choices=["none", "local", "global"])
    ap.add_argument("--eval_mode", default="beam", choices=["direct", "beam"])
    ap.add_argument("--n_clips", default=12, type=int,
                    help="synthetic stand-in clip count (ignored with MVC_DATA_DIR)")
    ap.add_argument("--clip_seconds", default=6.0, type=float)
    ap.add_argument("--frame_bucket", default=0, type=int,
                    help="smallest extraction frame bucket (0: the default ladder); small "
                         "values keep a CPU run cheap")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


class Rehearsal(NamedTuple):
    summary: Dict           # the printed JSON line
    seconds: Dict           # wall seconds of each step


def run(args) -> Rehearsal:
    """The five steps of the module doc."""
    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    weights_dir = os.environ.get("MVC_WEIGHTS_DIR") or None
    data_dir = os.environ.get("MVC_DATA_DIR") or None
    seconds = {}

    def timed(step, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[step] = time.perf_counter() - t0
        return out

    inception_params, vggish_params = timed("convert", resolve_encoder_params, weights_dir)
    root = timed("data", resolve_dataset, data_dir, args.out, n_clips=args.n_clips,
                 clip_seconds=args.clip_seconds)
    buckets = (args.frame_bucket, 64, 128, 256) if args.frame_bucket else (64, 128, 256)
    stats = timed("extract", extract_features, root, inception_params, vggish_params, device,
                  frame_buckets=buckets)
    print("extraction:", stats)
    vocab_path = timed("vocab", ensure_vocab, root)

    kw = dict(root_dir=root, dataset=args.dataset, vocab_path=vocab_path,
              batch_size=args.batch_size, verbose=False)
    loaders = {split: get_loader(split=split, shuffle=split == "train", **kw)[0]
               for split in ("train", "val", "test")}
    vocab = loaders["train"].dataset.vocab
    model = AVCaptioningDual(vocab_size=len(vocab), reconstructor_type=args.reconstructor,
                             device=device)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = TrainerConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                        device_feature_cache=True, eval_mode=args.eval_mode)
    trainer = Trainer(checkpoint_name=os.path.join(args.out, "rehearsal.ckpt"),
                          log_dir=None, eval_freq=max(1, args.epochs))
    _params, _opt, history = timed("fit", trainer.fit, model, params, loaders["train"],
                                  loaders["val"], loaders["test"], cfg)
    print("step seconds:", json.dumps({k: round(v, 3) for k, v in seconds.items()}))

    summary = {
        "extracted": stats, "epochs": args.epochs,
        "final_train_loss": float(history["train_loss"][-1]["total"]),
        "val_score": ({k: float(v) for k, v in history["val_score"][-1].items()}
                      if history["val_score"] else {}),
        "real_weights": bool(weights_dir), "real_data": bool(data_dir),
    }
    return Rehearsal(summary, seconds)


def main(argv=None) -> Dict:
    summary = run(parse_args(argv)).summary
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
