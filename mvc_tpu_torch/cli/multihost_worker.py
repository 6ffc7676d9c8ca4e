"""One rank of the multi-process smoke step (``scripts/multihost_worker.py``).

    python -m mvc_tpu_torch.cli.multihost_worker \\
        --coordinator localhost:12345 --num-processes 2 --process-id 0 \\
        --data-root /path/to/MSVD [--tp N] [--device cpu|cuda] [--backend gloo|nccl]

Each rank joins the process group (``parallel/distributed.py``; the
coordinator is ``host:port`` or a ``file://`` / ``tcp://`` URL), loads its
dp index's strided share of the data (``DataLoader(process_index,
process_count)`` from ``Mesh.data_shard``), takes ONE train step of the
tiny smoke model (``parallel/smoke.py``) whose gradients are summed over
the ranks, and prints a JSON line with the loss, the gradient norm and the
updated parameters' norm: the same on every rank, and the same as one
process taking the step over the union of the dp indices' batches.
``--tp N`` makes the mesh (world / N, N): each rank holds its vocab slices
of the parameters and the N ranks of a dp index read the same rows.
``--local-devices`` (0 or 1: one) counts the shards each rank's mesh
holds, which sets ``global_devices``; the step itself runs on the rank's
one device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T0 = time.time()


def _mark(msg: str) -> None:
    """Phase timestamps to stderr, to place a rendezvous timeout."""
    print(f"[mh {os.environ.get('MH_PID', '?')} +{time.time() - _T0:7.2f}s] {msg}",
          file=sys.stderr, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="shards of this rank's mesh (0 = one)")
    ap.add_argument("--batch-size", type=int, default=4, help="LOCAL batch size")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis")
    ap.add_argument("--device", default="cuda", help="cuda (default: cuda:LOCAL_RANK) or cpu")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on a card, gloo on the CPU")
    args = ap.parse_args(argv)

    import torch

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.parallel import distributed, make_mesh, shard_batch, shard_params
    from mvc_tpu_torch.parallel.smoke import (
        make_smoke_loss,
        make_smoke_model,
        make_smoke_train_step,
    )
    from mvc_tpu_torch.training.optimizer import make_optimizer

    os.environ["MH_PID"] = str(args.process_id)
    _mark("imports done, joining the process group")
    process_index, process_count = distributed.initialize(
        coordinator_address=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, backend=args.backend,
        device="cpu" if args.device == "cpu" else None)
    _mark("process group up")
    device = distributed.local_devices()[0]
    mesh = make_mesh(dp=-1, tp=args.tp, devices=[device] * max(1, args.local_devices))
    shard, n_shards = mesh.data_shard()

    loader, ds = get_loader(
        root_dir=args.data_root, dataset="MSVD", split="train", batch_size=args.batch_size,
        shuffle=False, verbose=False,
        vocab_path=os.path.join(args.data_root, "metadata", "vocab.json"),
        frame_buckets=(8,), caption_buckets=(12,),
        process_index=shard, process_count=n_shards)
    loader.prefetch = 0
    batch = next(iter(loader))
    _mark("local batch loaded")

    model = make_smoke_model(len(ds.vocab), batch["audio"].shape[-1],
                             batch["visual"].shape[-1], device=device)
    params = shard_params(mesh, model.init(torch.Generator().manual_seed(0)))
    opt = make_optimizer(TrainerConfig(), params)
    step = make_smoke_train_step(model, make_smoke_loss(), mesh)
    loss, gnorm, pnorm = step(params, opt, shard_batch(mesh, batch), None)
    _mark("train step executed")
    print(json.dumps({
        "process_index": process_index,
        "process_count": process_count,
        "global_devices": mesh.size,
        "local_batch": int(batch["audio"].shape[0]),
        "loss": loss,
        "grad_norm": gnorm,
        "param_norm": pnorm,
    }), flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
