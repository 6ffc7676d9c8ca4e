"""The multi-process smoke path's shared pieces (``mvc_tpu/parallel/smoke.py``)
and the rank launcher the tests and ``chip_smoke.py`` share.

``cli/multihost_worker.py`` (one rank) and its single-process expectation
run literally the same model, loss and step, so the comparison means
something.  ``spawn_ranks`` starts N ranks of one function in fresh
interpreters (``spawn``, never ``fork``: CUDA may already be initialized
in the caller), joined through a ``file://`` rendezvous in a directory of
the caller's, each with its share of the host's cores as torch threads, and
kills them all at a deadline so a hang fails fast.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from mvc_tpu_torch.config import DecoderConfig
from mvc_tpu_torch.training import losses as loss_lib

SMOKE_LAMBDAS = dict(reg_lambda=0.0005, audio_recon_lambda=0.00005, visual_recon_lambda=0.5)


def make_smoke_model(vocab_size: int, a_dim: int, v_dim: int, device="cpu"):
    """Tiny dual captioner (hidden 16 / emb 8 / attn 6, global recon)."""
    from mvc_tpu_torch.models import AVCaptioningDual

    small = dict(rnn_hidden_size=16, embedding_size=8, attn_size=6)
    return AVCaptioningDual(vocab_size=vocab_size, teacher_forcing_ratio=1.0,
                            reconstructor_type="global",
                            visual_decoder_config=DecoderConfig(in_feature_size=v_dim, **small),
                            audio_decoder_config=DecoderConfig(in_feature_size=a_dim, **small),
                            device=device)


def make_smoke_loss():
    return loss_lib.ModalityWiseReconstructionLossBuilder(rec_type="global", **SMOKE_LAMBDAS)


def make_smoke_train_step(model, loss_fn, mesh=None):
    """step(params, opt, batch, gen) -> (loss, grad_norm, param_norm), the
    cross-process equivalence observables, as floats.  With a mesh whose
    process group holds several ranks, each rank's batch is its shard
    (``shard_batch``) and, on a tp mesh, its params are its vocab slices
    (``shard_params``): the batch means divide by the counts over the
    ranks, each rank's loss is its share of the global loss, and the
    gradients and the loss are summed over the ranks that hold the same
    slice (``training/trainer.py``'s step)."""
    from mvc_tpu_torch.parallel import mesh as mesh_lib

    group = mesh.group if mesh is not None and mesh.world_size > 1 else None

    def step(params, opt, batch, gen):
        fm = batch["feat_mask"]
        counts = shards = None
        if group is not None:
            shards = mesh.shards(model.vocab_size, batch.get("frames_split", False))
            counts = loss_lib.global_counts(batch["captions"], None, fm,
                                            batch["audio"].shape[1], group,
                                            mesh.groups.get("dp", group), shards)
        outputs, a_rec, v_rec = model.forward(params, batch["audio"], batch["visual"],
                                              batch["captions"], gen=gen, feat_mask=fm,
                                              shards=shards)
        loss = loss_fn(outputs, batch["captions"], batch["audio"], a_rec, batch["visual"],
                       v_rec, feat_mask=fm, counts=counts)[0]
        loss.backward()
        loss = loss.detach().reshape(1)
        sharded = [False] * len(opt.leaves)
        if group is not None:
            sharded = mesh_lib.sharded_leaves(mesh, params)
            mesh_lib.sum_gradients(mesh, opt.leaves, sharded, [loss])
        gnorm = _norm([p.grad for p in opt.leaves], sharded, mesh)
        opt.step()
        pnorm = _norm([p.detach() for p in opt.leaves], sharded, mesh)
        return float(loss), gnorm, pnorm

    return step


def _norm(tensors, sharded, mesh) -> float:
    """The 2-norm of the whole tree: a vocab-sharded leaf's squares summed
    over its tp slices."""
    sq = [float((t.double() ** 2).sum()) for t in tensors]
    whole = sum(x for x, s in zip(sq, sharded) if not s)
    parts = sum(x for x, s in zip(sq, sharded) if s)
    if any(sharded):
        t = torch.tensor([parts], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(t, group=mesh.groups["tp"])
        parts = float(t[0])
    return math.sqrt(whole + parts)


def _rank_main(fn, rank: int, world: int, rdzv_dir: str, backend, device, timeout_s, args):
    import faulthandler

    from mvc_tpu_torch.parallel import distributed

    # a rank still running near the deadline prints where it stands
    faulthandler.dump_traceback_later(max(1.0, timeout_s - 10.0), exit=False)
    torch.set_num_threads(_rank_threads(world))
    out = os.path.join(rdzv_dir, f"rank{rank}.pkl")
    try:
        distributed.initialize(f"file://{os.path.join(rdzv_dir, 'rdzv')}", world, rank,
                               backend=backend, device=device, timeout_s=timeout_s)
        result = ("ok", fn(rank, world, *args))
    except BaseException:                      # reported to the parent
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:        # before the group goes: that may wait on a peer
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    distributed.shutdown()


def _rank_threads(world: int) -> int:
    """Torch threads a spawned rank takes: the host's cores shared by the
    ``world`` ranks and, under pytest-xdist, by the other workers' processes
    (``PYTEST_XDIST_WORKER_COUNT``), which would otherwise oversubscribe
    the host."""
    sharers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // (world * sharers))


def spawn_ranks(fn: Callable, world: int, rdzv_dir: str, args: Sequence = (),
                backend: Optional[str] = None, device=None,
                timeout_s: float = 120.0) -> List[object]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    joined to one process group (``parallel.distributed.initialize`` over
    ``file://<rdzv_dir>/rdzv``, with ``backend`` and ``device``, every
    collective bounded by ``timeout_s``), each running its share of the
    host's cores as torch threads (``_rank_threads``).  ``fn`` and ``args``
    must pickle (``fn`` at module level).  Returns the ranks' results in rank order;
    raises with the rank's traceback when one fails, and kills every rank
    still running ``timeout_s`` seconds after the start."""
    rdzv_dir = os.path.abspath(rdzv_dir)
    os.makedirs(rdzv_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, rdzv_dir, backend, device, timeout_s, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        path = os.path.join(rdzv_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: exit code {procs[r].exitcode}, no result")
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            errors.append(f"rank {r} failed:\n{value}")
        results.append(value)
    if hung:
        errors.insert(0, f"ranks {hung} still ran {timeout_s} s after the start")
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
