"""Serve captions over HTTP from a checkpoint (online continuous batching).

    python -m mvc_tpu_torch.cli.serve_captions --dataset MSVD \\
        --checkpoint checkpoints/MSVD/..._best.ckpt [--port 8000] [--max_batch 64] \\
        [--mode direct|beam] [--beam_width 5] [--beam_alpha 0.0] \\
        [--transfer f32|bf16|int8] [--device cuda|cpu]

The port of ``scripts/serve_captions.py``: the same flags plus ``--device``.
Reads checkpoints written by this package's or the JAX package's
``save_checkpoint``, and the reference's torch ``.ckpt`` (converted by
``utils/checkpoint_convert.py``).  On the
card the decode runs the hand-written CUDA kernels (``--mode direct``:
``csrc/dual_greedy.cu``; ``--mode beam``: ``csrc/beam.cu``, beam width up
to 8); ``--pallas`` is accepted for the same command line and changes
nothing.  Endpoints: POST /caption,
POST /caption_batch, GET /stats, GET /healthz (``serving/http.py``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="MSVD", choices=["MSVD", "MSR-VTT"])
    ap.add_argument("--data_root", default="datasets")
    ap.add_argument("--vocab", default=None,
                    help="explicit vocab path (default: <data_root>/<dataset>/metadata/vocab.*)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--reconstructor", default="none", choices=["none", "local", "global"])
    ap.add_argument("--mode", default="direct", choices=["direct", "beam"])
    ap.add_argument("--beam_width", default=5, type=int)
    ap.add_argument("--beam_alpha", default=0.0, type=float)
    ap.add_argument("--max_caption_len", default=30, type=int)
    ap.add_argument("--max_batch", default=64, type=int)
    ap.add_argument("--max_wait_ms", default=5.0, type=float)
    ap.add_argument("--transfer", default="f32", choices=["f32", "bf16", "int8"],
                    help="feature host-to-device wire format (ServiceConfig.transfer)")
    ap.add_argument("--pipeline_depth", default=2, type=int)
    ap.add_argument("--frame_buckets", nargs="+", type=int, default=[8, 16, 32, 48, 64])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", default=8000, type=int)
    ap.add_argument("--no_warmup", action="store_true",
                    help="skip the ahead-of-traffic dummy batch per frame bucket")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX command line; the CUDA kernel always runs on the card")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mvc_tpu_torch.data import Vocabulary
    from mvc_tpu_torch.models.captioning import AVCaptioningDual
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server
    from mvc_tpu_torch.utils.checkpoint_convert import load_params_checkpoint
    from mvc_tpu_torch.utils.device import resolve_device
    from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

    device = resolve_device(args.device)
    vocab_path = args.vocab
    if vocab_path is None:
        dataset_folder = os.path.join(args.data_root, args.dataset)
        vocab_path = os.path.join(dataset_folder, "metadata", "vocab.json")
        if not os.path.isfile(vocab_path):
            vocab_path = os.path.join(dataset_folder, "metadata", "vocab.pkl")
    vocab = Vocabulary.load(vocab_path)

    ckpt = load_params_checkpoint(args.checkpoint)
    if ckpt is None or "params" not in ckpt:
        raise SystemExit(f"{args.checkpoint} is not a checkpoint this program reads")
    params = from_numpy_tree(ckpt["params"], device)

    model = AVCaptioningDual(vocab_size=len(vocab), reconstructor_type=args.reconstructor,
                             device=device)
    service = CaptionService(model, params, vocab, ServiceConfig(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        frame_buckets=tuple(args.frame_buckets),
        max_caption_len=args.max_caption_len,
        mode=args.mode,
        beam_width=args.beam_width,
        beam_alpha=args.beam_alpha,
        transfer=args.transfer,
        pipeline_depth=args.pipeline_depth,
    ), device=device)
    if not args.no_warmup:
        print("Warming up (one batch per frame bucket)...", flush=True)
        warmed = service.warmup()
        service.reset_stats()
        print(f"Warmed t_pads: {warmed}")

    server = make_http_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"Serving on http://{host}:{port}  (POST /caption, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
