"""Train the captioner: the reference's experiment sweep, or one experiment.

    python -m mvc_tpu_torch.cli.train --dataset MSVD --data_root datasets \\
        [--epochs 50] [--batch_size 128] [--lr 1e-4] [--reconstructor none|local|global] \\
        [--video_only] [--single] [--model rnn|transformer] [--eval_mode direct|beam] \\
        [--dtype float32|bfloat16] [--device_feature_cache] [--adam_state_dtype bfloat16] \\
        [--seed 0] [--init_checkpoint PATH] [--device cuda|cpu]

The port of ``train.py``.  With none of ``--reconstructor``,
``--video_only`` or ``--single`` it runs the reference's six-experiment
sweep ({video, video_audio} x {none, local, global}, ``build_experiments``)
under the JAX names, log directories and loss weights; with any of them,
one experiment.  ``--single`` trains ``AVCaptioning`` (one decoder over
``[audio | visual]``), else ``AVCaptioningDual``; ``--model transformer``
trains ``TransformerCaptioning`` in every experiment instead (the
reconstructor and teacher-forcing settings do not apply to it; the
experiments keep their names, as ``train.py``'s do).  ``--init_checkpoint``
starts every experiment from a checkpoint of this package, of the JAX
package or of the reference (a torch ``.ckpt``, converted by
``utils/checkpoint_convert.py``).  It trains on the card unless ``--device
cpu`` is given; the per-epoch eval decodes through ``csrc/dual_greedy.cu``
or, with ``--single``, ``csrc/greedy.cu`` (``--eval_mode direct``) or
``csrc/beam.cu`` (``beam``) there; the transformer decodes in plain
PyTorch.  ``--dp/--tp/--sp`` name the mesh, which is not ported yet, and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os

_UNPORTED = ("dp", "tp", "sp")


def build_experiments(args):
    """The reference's experiment sweep (``train.py:24-44``)."""
    exps = []
    for audio_lambda, tag in ((0.0, "video"), (0.00005, "video_audio")):
        for rec in ("none", "local", "global"):
            name = f"SA-LSTM_{args.epochs}_epochs_{tag}_{rec}_{args.lr}"
            exps.append({
                "model": {"teacher_forcing_ratio": 1.0, "reconstructor_type": rec},
                "training": {"batch_size": args.batch_size, "epochs": args.epochs,
                             "lr": args.lr},
                "loss": {"reg_lambda": 0.0005, "audio_recon_lambda": audio_lambda,
                         "visual_recon_lambda": 0.5},
                "checkpoint_name": name,
                "log_dir": os.path.join("logs", args.dataset, name),
            })
    return exps


def select_experiments(args):
    """One experiment when ``--reconstructor``, ``--video_only`` or
    ``--single`` is given (``train.py:126-141``), else the sweep."""
    if args.reconstructor is None and not args.video_only and not args.single:
        return build_experiments(args)
    rec = args.reconstructor or "none"
    return [{
        "model": {"teacher_forcing_ratio": 1.0, "reconstructor_type": rec},
        "training": {"batch_size": args.batch_size, "epochs": args.epochs, "lr": args.lr},
        "loss": {"reg_lambda": 0.0005,
                 "audio_recon_lambda": 0.0 if args.video_only else 0.00005,
                 "visual_recon_lambda": 0.5},
        "checkpoint_name": f"{args.model}_{args.epochs}_epochs_custom_{rec}_{args.lr}",
        "log_dir": os.path.join("logs", args.dataset, f"{args.model}_custom_{rec}_{args.lr}"),
        "video_only": args.video_only,
    }]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", default="-1", help="accepted for the JAX command line; see --device")
    ap.add_argument("--dataset", default="MSVD", choices=["MSVD", "MSR-VTT"])
    ap.add_argument("--epochs", default=50, type=int)
    ap.add_argument("--batch_size", default=128, type=int)
    ap.add_argument("--lr", default=1e-4, type=float)
    ap.add_argument("--data_root", default="datasets")
    ap.add_argument("--split_train", default="train")
    ap.add_argument("--reconstructor", choices=["none", "local", "global"], default=None,
                    help="run a single experiment with this reconstructor")
    ap.add_argument("--video_only", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="single-stream AVCaptioning instead of the dual model")
    ap.add_argument("--model", default="rnn", choices=["rnn", "transformer"])
    ap.add_argument("--eval_freq", default=1, type=int)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--adam_state_dtype", choices=["bfloat16"], default=None,
                    help="store the Adam moments in bf16 (the update math stays float32)")
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--device_feature_cache", action="store_true",
                    help="keep every clip's features on the card; each step sends caption "
                         "ids and cache rows")
    ap.add_argument("--eval_mode", default="direct", choices=["direct", "beam"])
    ap.add_argument("--meteor_synonyms", default=None)
    ap.add_argument("--meteor_paraphrases", default=None)
    ap.add_argument("--meteor_function_words", default=None)
    ap.add_argument("--init_checkpoint", default=None,
                    help="start from these params (this package's, the JAX package's or the "
                         "reference's torch .ckpt)")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX command line; the CUDA kernels always run on "
                         "the card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # not ported yet: given, they raise
    ap.add_argument("--dp", default=None, type=int)
    ap.add_argument("--tp", default=None, type=int)
    ap.add_argument("--sp", default=None, type=int)
    return ap.parse_args(argv)


def main(argv=None):
    """Runs the selected experiments; returns their histories in order."""
    args = parse_args(argv)
    given = [f"--{name}" for name in _UNPORTED if getattr(args, name) is not None]
    if given:
        raise NotImplementedError(f"{', '.join(given)}: not ported yet (ROADMAP.md §1)")

    import torch

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data import Vocabulary, get_loader
    from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual, TransformerCaptioning
    from mvc_tpu_torch.training.trainer import Trainer
    from mvc_tpu_torch.utils.checkpoint_convert import load_params_checkpoint
    from mvc_tpu_torch.utils.device import resolve_device
    from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

    device = resolve_device(args.device)
    dataset_folder = os.path.join(args.data_root, args.dataset)
    vocab_path = os.path.join(dataset_folder, "metadata", "vocab.json")
    if not os.path.isfile(vocab_path):
        legacy = os.path.join(dataset_folder, "metadata", "vocab.pkl")
        if not os.path.isfile(legacy):
            raise SystemExit(f"No vocabulary at {vocab_path}; build one with "
                             "Vocabulary.prebuild (mvc_tpu_torch/data/vocabulary.py)")
        vocab_path = legacy
    vocab = Vocabulary.load(vocab_path)
    print(f"Vocab size: {len(vocab)}")
    init = None
    if args.init_checkpoint:
        init = load_params_checkpoint(args.init_checkpoint)
        if init is None or "params" not in init:
            raise SystemExit(f"{args.init_checkpoint} is not a checkpoint this program reads")

    experiments = select_experiments(args)
    print(f"\nPerforming {len(experiments)} experiments\n")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model_cls = AVCaptioning if args.single else AVCaptioningDual
    histories = []
    for exp in experiments:
        cfg = TrainerConfig(batch_size=exp["training"]["batch_size"],
                            epochs=exp["training"]["epochs"], lr=exp["training"]["lr"],
                            seed=args.seed, compute_dtype=args.dtype,
                            adam_state_dtype=args.adam_state_dtype,
                            device_feature_cache=args.device_feature_cache,
                            eval_mode=args.eval_mode, meteor_synonyms=args.meteor_synonyms,
                            meteor_paraphrases=args.meteor_paraphrases,
                            meteor_function_words=args.meteor_function_words,
                            **exp["loss"])
        video_only = exp.get("video_only", False)
        loader_kwargs = dict(root_dir=dataset_folder, dataset=args.dataset,
                             batch_size=cfg.batch_size, vocab_path=vocab_path,
                             video_only=video_only, frame_buckets=tuple(cfg.frame_buckets),
                             caption_buckets=tuple(cfg.caption_buckets))
        train_loader, _ = get_loader(split=args.split_train, **loader_kwargs)
        val_loader, _ = get_loader(split="val", **loader_kwargs)
        # the reference aliases test to val
        test_loader, _ = get_loader(split="val", **loader_kwargs)

        if args.model == "transformer":
            model = TransformerCaptioning(vocab_size=len(vocab), dtype=dtype, device=device)
        else:
            model = model_cls(vocab_size=len(vocab),
                              teacher_forcing_ratio=exp["model"]["teacher_forcing_ratio"],
                              reconstructor_type=exp["model"]["reconstructor_type"],
                              dtype=dtype, device=device)
        params = model.init(torch.Generator().manual_seed(args.seed))
        if init is not None:
            params = from_numpy_tree(init["params"], device)

        print("Start training")
        print(json.dumps(dict(exp, device=str(device)), sort_keys=True, indent=4))
        os.makedirs(exp["log_dir"], exist_ok=True)
        checkpoint_name = os.path.join("checkpoints", args.dataset,
                                       exp["checkpoint_name"] + ".ckpt")
        trainer = Trainer(checkpoint_name=checkpoint_name, log_dir=exp["log_dir"],
                          eval_freq=args.eval_freq)
        _, _, history = trainer.fit(model, params, train_loader, val_loader, test_loader, cfg)
        with open(checkpoint_name.replace(".ckpt", ".json"), "w") as f:
            json.dump(history, f)
        histories.append(history)
    return histories


if __name__ == "__main__":
    main()
