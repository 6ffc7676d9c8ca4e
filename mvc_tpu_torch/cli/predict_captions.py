"""Checkpoint -> captions CSV -> NLP-scores CSV.

    python -m mvc_tpu_torch.cli.predict_captions --dataset MSVD \\
        --checkpoint checkpoints/MSVD/SA-LSTM_..._best.ckpt \\
        [--splits val test] [--mode direct|beam] [--beam_width 5] [--device cuda|cpu]

The port of ``scripts/predict_captions.py``: the same flags plus
``--device``.  For each split it captions every video with the dual model,
writes ``captions_<checkpoint>_<split>_<mode>.csv`` (video_id, generated,
ground_truth) under ``--out_dir`` (default ``results/<dataset>``), then
appends one row of scores per split to ``NLP_score_<dataset>.csv`` there.
Reads checkpoints of this package, of the JAX package and the reference's
torch ``.ckpt``.  On the card the decode runs ``csrc/dual_greedy.cu``
(``--mode direct``) or ``csrc/beam.cu`` (``beam``); ``--pallas`` is
accepted for the same command line and changes nothing.
"""

from __future__ import annotations

import argparse
import csv
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="MSVD", choices=["MSVD", "MSR-VTT"])
    ap.add_argument("--data_root", default="datasets")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--splits", nargs="+", default=["val", "test"])
    ap.add_argument("--mode", default="direct", choices=["direct", "beam"])
    ap.add_argument("--beam_width", default=5, type=int)
    ap.add_argument("--beam_alpha", default=0.0, type=float)
    ap.add_argument("--max_caption_len", default=30, type=int)
    ap.add_argument("--batch_size", default=64, type=int)
    ap.add_argument("--reconstructor", default="none", choices=["none", "local", "global"])
    ap.add_argument("--video_only", action="store_true")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX command line; the CUDA kernels always run on "
                         "the card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from mvc_tpu_torch.data import Vocabulary, get_loader
    from mvc_tpu_torch.data.dataset import video_dataset_to_video_captions_loader
    from mvc_tpu_torch.evalcap import NLPScore
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.models.captioning import captions_from_tokens
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
                             "python -m mvc_tpu_torch.cli.build_vocab")
        vocab_path = legacy
    vocab = Vocabulary.load(vocab_path)

    ckpt = load_params_checkpoint(args.checkpoint)
    if ckpt is None or "params" not in ckpt:
        raise SystemExit(f"{args.checkpoint} is not a checkpoint this program reads")
    params = from_numpy_tree(ckpt["params"], device)
    model = AVCaptioningDual(vocab_size=len(vocab), reconstructor_type=args.reconstructor,
                             device=device)

    out_dir = args.out_dir or os.path.join("results", args.dataset)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_tag = os.path.splitext(os.path.basename(args.checkpoint))[0]

    # direct mode stops once every row has emitted EOS (the card's kernel
    # runs its fixed schedule); the caption text is the same
    extra = {"stop_at_all_eos": True} if args.mode == "direct" else {}
    score_rows = []
    for split in args.splits:
        _, ds = get_loader(root_dir=dataset_folder, dataset=args.dataset, split=split,
                           batch_size=args.batch_size, vocab_path=vocab_path,
                           video_only=args.video_only, verbose=False)
        loader = video_dataset_to_video_captions_loader(ds, batch_size=args.batch_size,
                                                        video_only=args.video_only)
        vid_gt, vid_gen = {}, {}
        with torch.no_grad():
            for batch in loader:
                tokens = model.predict_tokens(
                    params, torch.from_numpy(batch["audio"]).to(device),
                    torch.from_numpy(batch["visual"]).to(device),
                    max_caption_len=args.max_caption_len, mode=args.mode,
                    beam_alpha=args.beam_alpha, beam_width=args.beam_width,
                    feat_mask=torch.from_numpy(batch["feat_mask"]).to(device), **extra)
                caps = captions_from_tokens(vocab, tokens)
                for vid, gt, cap in zip(batch["video_ids"], batch["captions"], caps):
                    vid_gt[vid] = list(gt)
                    vid_gen[vid] = [cap]

        cap_csv = os.path.join(out_dir, f"captions_{ckpt_tag}_{split}_{args.mode}.csv")
        with open(cap_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["video_id", "generated", "ground_truth"])
            for vid in vid_gen:
                w.writerow([vid, vid_gen[vid][0], " | ".join(vid_gt[vid])])
        print(f"Wrote {cap_csv}")

        scores = NLPScore(vid_gt, vid_gen)
        print(split, scores)
        score_rows.append({"split": split, "mode": args.mode, "checkpoint": ckpt_tag, **scores})

    score_csv = os.path.join(out_dir, f"NLP_score_{args.dataset}.csv")
    exists = os.path.isfile(score_csv)
    with open(score_csv, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(score_rows[0].keys()))
        if not exists:
            w.writeheader()
        w.writerows(score_rows)
    print(f"Appended scores to {score_csv}")
    return score_rows


if __name__ == "__main__":
    main()
