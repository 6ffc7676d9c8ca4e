"""One-time vocabulary build, the port of ``scripts/build_vocab.py``
(reference src/get_loader.py:92-114,451-453):

    python -m mvc_tpu_torch.cli.build_vocab --dataset MSVD [--data_root datasets]

Writes ``<data_root>/<dataset>/metadata/vocab.json``: MSVD from the train
and val CSVs, MSR-VTT from the captions of videos 0..7008 in
``train_val_videodatainfo.json``.  Host only; no device is involved.
"""

from __future__ import annotations

import argparse
import os

from mvc_tpu_torch.data.vocabulary import build_msr_vtt_vocab, build_msvd_vocab


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True, choices=["MSVD", "MSR-VTT"])
    ap.add_argument("--data_root", default="datasets")
    args = ap.parse_args(argv)

    folder = os.path.join(args.data_root, args.dataset)
    build = build_msvd_vocab if args.dataset == "MSVD" else build_msr_vtt_vocab
    vocab = build(folder)
    print(f"Vocab built: {len(vocab)} entries -> {folder}/metadata/vocab.json")
    return vocab


if __name__ == "__main__":
    main()
