"""Feature-extraction CLI, the port of the root ``extract_features.py``:

    python -m mvc_tpu_torch.cli.extract_features --dataset datasets/MSVD
        [--gpu -1] [--batch_size 8] [--fps 1] [--inception_weights W.pkl]
        [--vggish_weights W.pkl] [--visual_model inception_v3|resnet]
        [--device cuda|cpu]

Reads ``<dataset>/videos/*`` (and ``<dataset>/audios/<clip>.wav`` sidecars
where present) and writes ``<dataset>/features/video/<clip>.npy`` [T, 2048]
([T, 1000] with ``--visual_model resnet``) and
``<dataset>/features/audio/<clip>.npy`` [N, 128], float32, skipping clips
whose features exist.  Weight files are pickled torch state dicts (the
VGGish one optionally ``{"state_dict": ..., "pca": {"matrix", "means"}}``),
converted on load; without them the encoders run with seeded random weights
(for pipeline tests only).  Decoding needs OpenCV (``cv2``).  The encoders
run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True, help="dataset root containing videos/")
    ap.add_argument("--gpu", default="-1", help="ignored (the JAX command line's flag)")
    ap.add_argument("--batch_size", default=8, type=int, help="clips per encode batch")
    ap.add_argument("--fps", default=1, type=float)
    ap.add_argument("--inception_weights", default=None,
                    help="pickled torch state_dict for the selected visual model")
    ap.add_argument("--vggish_weights", default=None)
    ap.add_argument("--visual_model", default="inception_v3", choices=("inception_v3", "resnet"),
                    help="visual backbone; resnet = ResNet-101 at 224px, 1000-d logit "
                         "features (PARITY.md)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.dataset):
        raise SystemExit(f"the specified directory does not exist: {args.dataset}")
    videos_dir = os.path.join(args.dataset, "videos")
    features_dir = os.path.join(args.dataset, "features")
    if not os.path.isdir(videos_dir):
        raise SystemExit(f"no videos directory at {videos_dir}")

    from mvc_tpu_torch.extract import FeatureExtractor
    from mvc_tpu_torch.models import inception_v3 as iv3
    from mvc_tpu_torch.models import resnet as rn
    from mvc_tpu_torch.models import vggish as vg

    inception_params = None
    if args.inception_weights:
        with open(args.inception_weights, "rb") as f:
            sd = pickle.load(f)
        convert = (rn.convert_torchvision_state_dict if args.visual_model == "resnet"
                   else iv3.convert_torchvision_state_dict)
        inception_params = convert(sd)
    vggish_params = None
    if args.vggish_weights:
        with open(args.vggish_weights, "rb") as f:
            payload = pickle.load(f)
        is_dict = isinstance(payload, dict)
        sd = payload.get("state_dict", payload) if is_dict else payload
        vggish_params = vg.convert_torch_state_dict(sd, payload.get("pca") if is_dict else None)
    if inception_params is None or vggish_params is None:
        print("WARNING: running with randomly initialized encoder weights "
              "(pass --inception_weights/--vggish_weights for real features)")

    fe = FeatureExtractor(inception_params=inception_params, vggish_params=vggish_params,
                          fps=args.fps, visual_model=args.visual_model, device=args.device)
    stats = fe.extract_dataset(videos_dir, features_dir, batch_size=args.batch_size)
    print(stats)
    return stats


if __name__ == "__main__":
    main()
