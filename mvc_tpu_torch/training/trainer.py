"""Training and evaluation engine (``mvc_tpu/training/trainer.py``).

``Trainer.fit`` runs on ``model.device``: every batch is copied there
(features cast on the host to ``transfer_dtype`` first, or quantized to
int8 and dequantized on the card), or, with ``device_feature_cache``, the
features are on the card once and each batch sends caption ids and cache
rows.  The train step is forward + loss + backward + the optimizer, and
the per-epoch eval decodes with ``model.predict_tokens``, which on the card
launches ``csrc/dual_greedy.cu`` (``AVCaptioningDual``) or
``csrc/greedy.cu`` (``AVCaptioning``) with ``eval_mode="direct"``, and
``csrc/beam.cu`` with ``"beam"``.  ``TransformerCaptioning`` has no
``forward_hiddens``: it trains through the materializing loss and decodes
in plain PyTorch with K/V caches.  With ``MVC_PROFILE_DIR`` set, the first
epoch's train loop is traced by ``torch.profiler`` into a Chrome trace
there.  The observable surface is the JAX trainer's: the history
dict's six keys, the TensorBoard tags, 10 example captions per eval, the
checkpoint triggers (best val CIDEr -> main + ``_best``, best val loss ->
main, ``_last`` at the end) and the ``eval_freq`` cadence.

With ``mesh`` (``parallel/mesh.py``) the trainer is one rank of the
mesh's process group: it trains on ``mesh.device`` over its loader's
process shard, padded to its share of the ``dp`` axis.  Each step first
agrees on the batch's caption and frame lengths (the longest over the
ranks, so every rank draws the same teacher-forcing coins), all-reduces
the few counts the batch means divide by (``losses.GlobalCounts``), and
after ``backward`` sums the gradients and the step's metrics in flat
buckets, before the optimizer's value clip.  Rank 0's parameters are
broadcast when ``fit`` starts.  The eval decodes each rank's share of the
videos through the kernels, gathers the captions and scores them on rank
0, which broadcasts the scores so the plateau scheduler and the checkpoint
choice agree; checkpoints and TensorBoard are rank 0's.

On a tp/sp mesh (one process a shard, models whose ``shardable`` is True:
the RNN captioners and the transformer) the loaders of one dp index read
the same rows, ``fit`` keeps each rank's vocab slices of the parameters
(``mesh.shard_params``) and each step this rank's block of the frames
(``mesh.split_frames``); the model and the loss reduce across the shards
(``parallel/collectives.py``), each rank backpropagates its share of the
global loss, and each gradient leaf is summed over the ranks that hold the
same slice of it (``mesh.sum_gradients``: replicated leaves over every
rank, vocab slices over dp·sp).  A model whose log-probs hold the whole
vocab (``vocab_sharded_logits`` False: the transformer, whose only slice
is the embedding) gives the loss no tp group; its terms still count
tp·sp copies.  The fused loss stays off under tp, as in the JAX trainer.
The evals gather the slices once and decode with the whole parameters;
checkpoints hold them whole, with whole Adam moments, so any mesh (or the
JAX package) loads them.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mvc_tpu_torch.config import TrainerConfig
from mvc_tpu_torch.data.dataset import video_dataset_to_video_captions_loader
from mvc_tpu_torch.data.feature_cache import (
    DeviceFeatureCache,
    dequantize_int8,
    gather_features,
    quantize_int8,
)
from mvc_tpu_torch.evalcap import NLPScore, prepare_native
from mvc_tpu_torch.parallel import mesh as mesh_lib
from mvc_tpu_torch.parallel.mesh import pad_batch_to_multiple
from mvc_tpu_torch.training import fused_loss as fused_lib
from mvc_tpu_torch.training import losses as loss_lib
from mvc_tpu_torch.training import optimizer as opt_lib
from mvc_tpu_torch.training.checkpoint import (
    AsyncSaver,
    load_checkpoint,
    restore_params_like,
)

LOSS_KEYS = ("total", "ce", "e", "a_recon", "v_recon")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _make_writer(log_dir: Optional[str]):
    """tensorboardX's writer when it is installed, else one that drops
    every scalar (logging only; the computation is the same)."""
    if not log_dir:
        return _NullWriter()
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(log_dir)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class Trainer:
    def __init__(self, checkpoint_name: str, log_dir: Optional[str] = "logs",
                 display_freq: int = 10, eval_freq: int = 10, mesh=None):
        self._tp_sp = mesh is not None and mesh.tp * mesh.sp > 1
        self._sliced = mesh is not None and mesh.tp > 1       # params held as vocab slices
        if self._tp_sp and mesh.world_size != mesh.size:
            raise ValueError(f"a tp or sp mesh trains one process a shard: {mesh.size} shards "
                             f"over {mesh.world_size} processes")
        self.mesh = mesh
        self._group = mesh.group if mesh is not None else None
        self._world = mesh.world_size if mesh is not None else 1
        self._rank0 = mesh is None or mesh.rank == 0
        self.checkpoint_name = checkpoint_name
        self.display_freq = display_freq
        self.eval_freq = eval_freq
        self.summary_writer = _make_writer(log_dir if self._rank0 else None)
        self._transfer_dtype: Optional[torch.dtype] = None
        self._transfer_int8 = False
        self._device_prefetch = False
        self.previous_epochs = 0
        self._meteor_synonyms = None
        self._meteor_paraphrases = None
        self._meteor_function_words = None
        self._saver = AsyncSaver()
        prepare_native()        # the metrics runtime's compile, outside the timed evals

    # ------------------------------------------------------------ steps
    def _build_train_step(self, model, cfg: TrainerConfig):
        """(train_step, eval_loss_step).  The fused CE + entropy path
        (``training/fused_loss.py``) unless ``fused_loss`` is off or
        ``compat_batch_axis_entropy`` asks for the batch-axis entropy, which
        only the materializing path computes."""
        loss_fn = loss_lib.ModalityWiseReconstructionLossBuilder(
            reg_lambda=cfg.reg_lambda, audio_recon_lambda=cfg.audio_recon_lambda,
            visual_recon_lambda=cfg.visual_recon_lambda, rec_type=model.reconstructor_type,
            compat_batch_axis_entropy=cfg.compat_batch_axis_entropy)
        mask_feats = cfg.mask_padded_features
        compute = model.dtype
        use_fused = (cfg.fused_loss and not cfg.compat_batch_axis_entropy
                     and hasattr(model, "forward_hiddens")
                     and (self.mesh is None or self.mesh.tp == 1))

        def cast_params(params):
            # bf16 compute: cast the f32 masters once per step, outside the
            # scans; gradients flow back through the cast to the masters
            if compute != torch.bfloat16:
                return params
            return _tree_map(lambda p: p.to(compute) if p.dtype == torch.float32 else p, params)

        def compute_loss(params, batch, gen, tf_ratio):
            shards = loss_shards = None
            if self._tp_sp:
                batch, split = mesh_lib.split_frames(self.mesh, batch)
                shards = loss_shards = self.mesh.shards(model.vocab_size, split)
                if not model.vocab_sharded_logits:      # whole log-probs: no vocab slice
                    loss_shards = dataclasses.replace(shards, tp_group=None)
            kw = {} if shards is None else {"shards": shards}
            feat_mask = batch["feat_mask"] if mask_feats else None
            counts = self._global_counts(batch, feat_mask, loss_shards)
            sample_mask = batch.get("sample_mask")
            p = cast_params(params)
            captions = batch["captions"]
            if use_fused:
                h_list, outs, a_rec, v_rec = model.forward_hiddens(
                    p, batch["audio"], batch["visual"], captions, gen=gen,
                    teacher_forcing_ratio=tf_ratio, feat_mask=feat_mask, **kw)
                ce, ent = fused_lib.ce_entropy_from_hiddens(
                    h_list, outs, captions, sample_mask=sample_mask, compute_dtype=compute,
                    counts=counts)
                a_l = loss_lib._single_reconstruction_loss(
                    captions, batch["audio"], a_rec, model.reconstructor_type, feat_mask,
                    sample_mask, counts)
                v_l = loss_lib._single_reconstruction_loss(
                    captions, batch["visual"], v_rec, model.reconstructor_type, feat_mask,
                    sample_mask, counts)
                ce, ent, a_l, v_l = loss_lib.rank_shares(ce, ent, a_l, v_l,
                                                         model.reconstructor_type, counts)
                loss = (ce + cfg.reg_lambda * ent + cfg.audio_recon_lambda * a_l
                        + cfg.visual_recon_lambda * v_l)
            else:
                outputs, a_rec, v_rec = model.forward(
                    p, batch["audio"], batch["visual"], captions, gen=gen,
                    teacher_forcing_ratio=tf_ratio, feat_mask=feat_mask, **kw)
                loss, ce, ent, a_l, v_l = loss_fn(
                    outputs, captions, batch["audio"], a_rec, batch["visual"], v_rec,
                    feat_mask=feat_mask, sample_mask=sample_mask, counts=counts)
            return loss, torch.stack([loss, ce, ent, a_l, v_l]).detach().float()

        def train_step(params, opt, batch, gen):
            loss, metrics = compute_loss(params, batch, gen, None)
            loss.backward()
            if self._group is not None:      # before the optimizer's value clip
                mesh_lib.sum_gradients(self.mesh, opt.leaves,
                                       mesh_lib.sharded_leaves(self.mesh, params), [metrics])
            opt.step()
            return params, metrics

        @torch.no_grad()
        def eval_loss_step(params, batch, gen):
            metrics = compute_loss(params, batch, gen, 0.0)[1]
            if self._group is not None:
                dist.all_reduce(metrics, group=self._group)
            return metrics

        # the feature-cache variants: the batch holds caption ids and cache
        # rows; features and frame mask are gathered on the device
        def with_features(batch, cache_arrays, t_pad):
            audio, visual, feat_mask = gather_features(cache_arrays, batch["video_rows"], t_pad,
                                                       sample_mask=batch.get("sample_mask"))
            return dict(batch, audio=audio, visual=visual, feat_mask=feat_mask)

        def train_step_cached(params, opt, batch, cache_arrays, gen, t_pad):
            return train_step(params, opt, with_features(batch, cache_arrays, t_pad), gen)

        def eval_loss_step_cached(params, batch, cache_arrays, gen, t_pad):
            return eval_loss_step(params, with_features(batch, cache_arrays, t_pad), gen)

        self._train_step_cached = train_step_cached
        self._eval_loss_step_cached = eval_loss_step_cached
        return train_step, eval_loss_step

    # ------------------------------------------------------------ data parallelism
    def _global_counts(self, batch, feat_mask, shards) -> Optional[loss_lib.GlobalCounts]:
        """The batch means' denominators summed over the ranks (None without
        a process group); the batch-axis entropy spans the dp ranks."""
        if self._group is None:
            return None
        rows = self.mesh.groups.get("dp", self._group) if self._world > 1 else None
        return loss_lib.global_counts(batch["captions"], batch.get("sample_mask"), feat_mask,
                                      batch["audio"].shape[1], self._group, rows, shards)

    def _max_over_ranks(self, values) -> List[int]:
        """Host integers' maxima over the ranks: through the host under gloo,
        through the card under NCCL (which takes no host tensor)."""
        on_card = dist.get_backend(self._group) == "nccl"
        t = torch.tensor(values, dtype=torch.int64,
                         device=self.mesh.device if on_card else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return t.tolist()

    def _rank_batches(self, dataloader):
        """The loader's batches, then (when another rank has more) batches of
        padding rows only, so every rank takes the same number of steps.
        The step count is agreed here, on the calling thread, before the
        prefetch thread starts."""
        if self._world == 1:
            return dataloader
        return self._padded_steps(dataloader, self._max_over_ranks([len(dataloader)])[0])

    @staticmethod
    def _padded_steps(dataloader, n_steps):
        last, taken = None, 0
        for batch in dataloader:
            yield batch
            last, taken = batch, taken + 1
        if taken < n_steps and last is None:
            raise ValueError("this rank's data shard is empty; give every rank a batch")
        for _ in range(n_steps - taken):
            yield {k: np.zeros_like(v) if isinstance(v, np.ndarray) else v
                   for k, v in last.items()}

    def _agree_lengths(self, batch):
        """Pad the device batch to the longest caption and clip of any rank
        (PAD tokens, zero and masked frames), as one program over the union
        batch would see it."""
        if self._world == 1:
            return batch
        L = batch["captions"].shape[0]
        T = batch["t_pad"] if "t_pad" in batch else batch["feat_mask"].shape[1]
        L2, T2 = self._max_over_ranks([L, T])
        out = dict(batch)
        if L2 > L:
            caps = batch["captions"]
            out["captions"] = torch.cat([caps, caps.new_zeros((L2 - L, caps.shape[1]))])
        if T2 > T:
            if "t_pad" in batch:
                out["t_pad"] = T2
            else:
                for k in ("audio", "visual", "feat_mask"):
                    x = batch[k]
                    out[k] = torch.cat([x, x.new_zeros((x.shape[0], T2 - T, *x.shape[2:]))],
                                       dim=1)
        return out

    def _put_batch(self, batch, device: torch.device):
        """Host batch -> tensors on ``device``: float32 arrays cast to the
        transfer dtype on the host (int8: ``quantize_int8``'s payload and
        scales, dequantized to float32 on the device after the copy), then
        a pinned, non-blocking copy to the card.  Lists (video ids, caption
        strings) and host ints (``t_pad``) stay as they are.  With a mesh the
        rank's rows are first padded to a multiple of its share of ``dp``
        (``pad_batch_to_multiple``; the padding rows have sample_mask=False)."""
        if self.mesh is not None:
            ref = batch["audio" if "audio" in batch else "video_rows"]
            if "sample_mask" not in batch:
                batch = dict(batch, sample_mask=np.ones((ref.shape[0],), bool))
            dp_ranks = self.mesh.data_shard()[1]
            batch = pad_batch_to_multiple(batch, max(1, self.mesh.shape["dp"] // dp_ranks))
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if self._transfer_int8:
            for k in ("audio", "visual"):
                if k in arrays:
                    arrays[k], arrays[f"{k}_scale"] = quantize_int8(arrays[k])
        out = dict(batch)
        for k, v in arrays.items():
            t = torch.from_numpy(v)
            if self._transfer_dtype is not None and t.dtype == torch.float32:
                t = t.to(self._transfer_dtype)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        for k in ("audio", "visual"):
            if f"{k}_scale" in out:
                out[k] = dequantize_int8(out[k], out.pop(f"{k}_scale"))
        if "sample_mask" in batch:
            out["_n_real"] = int(batch["sample_mask"].sum())
        return out

    def _device_batches(self, dataloader, device: torch.device):
        """Device-resident batches; with ``device_prefetch`` the next copy is
        staged on a background thread while the current step runs."""
        if not self._device_prefetch:
            for batch in dataloader:
                yield self._put_batch(batch, device)
            return
        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()
        err = []

        def stage():
            try:
                for batch in dataloader:
                    q.put(self._put_batch(batch, device))
            except BaseException as e:       # re-raised in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        threading.Thread(target=stage, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item

    # ------------------------------------------------------------ checkpoints
    def _whole(self, model, params):
        """The parameters with every vocab slice gathered (a collective on a
        tp mesh); ``params`` themselves elsewhere."""
        if not self._sliced:
            return params
        return mesh_lib.gather_params(self.mesh, params, model.vocab_size)

    def _whole_opt_state(self, model, opt):
        """The optimizer state with whole moments (their vocab slices
        gathered on a tp mesh, a collective there); None on ranks other
        than 0."""
        whole = {}
        for i, (p, spec) in enumerate(zip(opt.leaves, self._specs)):
            st = opt.inner.state.get(p)
            if self._sliced and st and "tp" in spec:
                whole[i] = {k: mesh_lib.gather_leaf(self.mesh, spec, st[k].float(),
                                                    model.vocab_size).cpu().numpy()
                            for k in opt_lib.MOMENTS}
        if not self._rank0:
            return None
        sd = opt.state_dict()
        for i, moments in whole.items():
            sd["state"][i].update(moments)
        return sd

    def _sliced_opt_state(self, sd):
        """A checkpoint's whole optimizer state cut to this rank's slices."""
        if not self._sliced or not isinstance(sd, dict) or "state" not in sd:
            return sd
        state = {}
        for i, st in sd["state"].items():
            spec = self._specs[int(i)] if int(i) < len(self._specs) else ()
            state[i] = {k: mesh_lib.shard_leaf(self.mesh, spec, v) if k in opt_lib.MOMENTS
                        else v for k, v in st.items()}
        return dict(sd, state=state)

    def _main_payload(self, epoch, model, params, opt):
        """The main checkpoint (whole parameters and moments); None on ranks
        other than 0, which only take part in the gathers."""
        params, opt_state = self._whole(model, params), self._whole_opt_state(model, opt)
        if not self._rank0:
            return None
        return {
            "epoch": epoch,
            "params": params,
            "opt_state": opt_state,
            "scheduler": self.lr_scheduler.state_dict(),
            "history": copy.deepcopy(self.history),
            "best_loss": self.best_loss,
            "best_CIDEr": self.best_CIDEr,
        }

    def _load(self, params):
        ckpt = load_checkpoint(self.checkpoint_name)
        if ckpt is None:
            print("No checkpoint found, using default parameters...")
            return params, None
        print(f"Resuming training from checkpoint: {self.checkpoint_name}")
        try:
            params = restore_params_like(params, ckpt["params"])
        except (ValueError, TypeError, KeyError) as e:
            print(f"Error loading from checkpoint: {self.checkpoint_name} ({e}).\n"
                  "Using default parameters...")
            return params, None
        return params, ckpt

    # ------------------------------------------------------------ fit
    def fit(self, model, params, train_loader, val_loader, test_loader,
            train_config: TrainerConfig):
        """Train for ``cfg.epochs`` epochs (resuming from the checkpoint at
        ``checkpoint_name`` when there is one); returns (params, optimizer,
        history): the whole parameters, also on a tp mesh, where the
        optimizer holds this rank's slices.  The caller's tensors are not
        modified."""
        cfg = train_config
        td = cfg.transfer_dtype
        if td not in (None, "int8", *_DTYPES):
            raise ValueError(f"transfer_dtype must be None, float32, bfloat16 or int8, got {td!r}")
        self._transfer_int8 = td == "int8"
        self._transfer_dtype = _DTYPES[td] if td and not self._transfer_int8 else None
        self._device_prefetch = bool(cfg.device_prefetch)
        self._meteor_synonyms = cfg.meteor_synonyms
        self._meteor_paraphrases = cfg.meteor_paraphrases
        self._meteor_function_words = cfg.meteor_function_words
        self.lr_scheduler = opt_lib.PlateauScheduler(
            lr=cfg.lr, factor=cfg.lr_decay_gamma, patience=cfg.lr_decay_patience,
            min_lr=cfg.min_lr, mode=cfg.plateau_mode)
        self.history = {"train_loss": [], "train_score": [], "val_loss": [],
                        "val_score": [], "test_loss": [], "test_score": []}
        self.previous_epochs = 0
        self.best_loss = 1e6
        self.best_CIDEr = 0.0
        self._vocab = train_loader.dataset.vocab
        if self.mesh is not None and model.device != self.mesh.device:
            raise ValueError(f"the model is on {model.device}, this rank's mesh device is "
                             f"{self.mesh.device}")
        if self._tp_sp and not getattr(model, "shardable", False):
            raise NotImplementedError(f"{type(model).__name__}.forward takes no shards=: it "
                                      "cannot train on a tp or sp mesh")

        params, ckpt = self._load(params)
        # the leaves the optimizer trains in place
        params = _tree_map(lambda t: t.detach().clone(), params)
        if self._group is not None:
            for leaf in opt_lib.tree_leaves(params):
                dist.broadcast(leaf, src=0, group=self._group)
        if self._sliced:
            params = mesh_lib.shard_params(self.mesh, params)
        self._specs = opt_lib.tree_leaves(mesh_lib.param_specs(params))
        self._optimizer = opt_lib.make_optimizer(cfg, params)
        if ckpt is not None:
            self.previous_epochs = ckpt.get("epoch", 0)
            self.history = ckpt.get("history", self.history)
            self.best_loss = ckpt.get("best_loss", self.best_loss)
            self.best_CIDEr = ckpt.get("best_CIDEr", self.best_CIDEr)
            if ckpt.get("scheduler"):
                self.lr_scheduler.load_state_dict(ckpt["scheduler"])
            if ckpt.get("opt_state") is not None:
                try:
                    self._optimizer.load_state_dict(self._sliced_opt_state(ckpt["opt_state"]))
                except (ValueError, KeyError, TypeError, RuntimeError) as e:
                    print(f"Optimizer state not restored ({e}); reinitializing")
        opt = opt_lib.set_learning_rate(self._optimizer, self.lr_scheduler.lr)
        self._train_step, self._eval_loss_step = self._build_train_step(model, cfg)
        if cfg.device_feature_cache:
            self._attach_feature_caches(cfg, model.device, (train_loader, val_loader), self.mesh)

        eval_kwargs = dict(batch_size=cfg.batch_size, frame_buckets=tuple(cfg.frame_buckets))
        if self.mesh is not None:
            # every rank decodes its own videos, also on a tp/sp mesh: the
            # evals decode with the whole parameters
            eval_kwargs.update(process_index=self.mesh.rank, process_count=self._world)
        vidcaps = {phase: video_dataset_to_video_captions_loader(
            loader.dataset, video_only=loader.dataset.video_only, **eval_kwargs)
            for phase, loader in (("train", train_loader), ("val", val_loader))}

        for epoch in range(self.previous_epochs + 1, cfg.epochs + 1):
            print(f"\nEpoch {epoch}/{cfg.epochs}:")
            t0 = time.time()
            gen = torch.Generator().manual_seed(cfg.seed * 100_003 + epoch)
            params, opt, train_loss = self.train(model, params, opt, train_loader, epoch, gen)
            val_loss = self.test(model, params, val_loader, "val", epoch)
            self.history["train_loss"].append(train_loss)
            self.history["val_loss"].append(val_loss)

            save_main = save_best = False
            if epoch % self.eval_freq == 0 or epoch == cfg.epochs:
                eval_kw = dict(max_caption_len=cfg.eval_max_caption_len, mode=cfg.eval_mode,
                               beam_width=cfg.eval_beam_width, beam_alpha=cfg.eval_beam_alpha)
                whole = self._whole(model, params)
                train_score, _, _ = self.eval(model, whole, vidcaps["train"], "train", epoch,
                                              **eval_kw)
                val_score, _, _ = self.eval(model, whole, vidcaps["val"], "val", epoch,
                                            **eval_kw)
                del whole
                self.history["train_score"].append(train_score)
                self.history["val_score"].append(val_score)
                opt_lib.set_learning_rate(opt, self.lr_scheduler.step(val_score["CIDEr"]))
                if val_score["CIDEr"] > self.best_CIDEr:
                    print(f"CIDEr improved from {self.best_CIDEr} to {val_score['CIDEr']}.")
                    print(f"Saving checkpoint to: {self.checkpoint_name}")
                    self.best_CIDEr = val_score["CIDEr"]
                    save_main = save_best = True

            if val_loss["total"] < self.best_loss:
                print(f"Validation loss improved from {self.best_loss} to {val_loss['total']}.")
                print(f"Saving checkpoint to: {self.checkpoint_name}")
                self.best_loss = val_loss["total"]
                save_main = True

            # one snapshot per epoch whatever the triggers; the pickle and
            # the write run on the saver's thread
            jobs = []
            main = self._main_payload(epoch, model, params, opt) if save_main else None
            if main is not None:
                jobs.append((self.checkpoint_name, main))
            if save_best and self._rank0:
                jobs.append((self.checkpoint_name.replace(".ckpt", "_best.ckpt"),
                             {"epoch": epoch, "params": main["params"],
                              "history": copy.deepcopy(self.history)}))
            if jobs:
                self._saver.submit(jobs)
            print(f"Epoch time: {time.time() - t0:.1f}s")

        params = self._whole(model, params)
        if self._rank0:
            self._saver.submit([(self.checkpoint_name.replace(".ckpt", "_last.ckpt"),
                                 {"epoch": cfg.epochs, "params": params,
                                  "history": self.history})])
        self._saver.wait()
        self.summary_writer.close()
        return params, opt, self.history

    @staticmethod
    def _attach_feature_caches(cfg: TrainerConfig, device, loaders, mesh=None):
        """One ``DeviceFeatureCache`` per dataset, stored in
        ``transfer_dtype`` (float32 when None) and stacked to the frame
        bucket of the loader's own ladder that covers its longest clip; on
        the rank's device with a mesh, every rank holding all of it."""
        caches = {}
        for loader in loaders:
            if not hasattr(loader, "attach_feature_cache"):
                continue
            key = id(loader.dataset)
            if key not in caches:
                caches[key] = cache = DeviceFeatureCache(
                    loader.dataset, dtype=cfg.transfer_dtype or "float32", device=device,
                    frame_buckets=tuple(loader.frame_buckets), mesh=mesh)
                print(f"Device feature cache: {cache.nbytes() / 1e6:.1f} MB "
                      f"({len(cache.row_of)} clips, T_top={cache.t_top})")
            loader.attach_feature_cache(caches[key])

    # ------------------------------------------------------------ loops
    def train(self, model, params, opt, dataloader, epoch, gen: torch.Generator):
        """One epoch of train steps.  Each step's metrics stay on the device
        until the epoch ends and come to the host in one copy."""
        sums = {k: 0.0 for k in LOSS_KEYS}
        n_samples = 0
        step_metrics = []
        cache = getattr(dataloader, "feature_cache", None)
        profiler = self._start_profiler(model.device, epoch)
        t0 = time.time()
        for batch in self._device_batches(self._rank_batches(dataloader), model.device):
            n_samples += batch.pop("_n_real", batch["captions"].shape[1])
            batch = self._agree_lengths(batch)
            if cache is not None:
                t_pad = batch.pop("t_pad")
                params, metrics = self._train_step_cached(params, opt, batch, cache.arrays(), gen,
                                                          t_pad)
            else:
                params, metrics = self._train_step(params, opt, batch, gen)
            step_metrics.append(metrics)
        for i, m in enumerate(self._fetch(step_metrics)):
            self._log_metrics("train", epoch * len(dataloader) + i, m, sums)
        dt = time.time() - t0
        if profiler is not None:
            self._stop_profiler(profiler, epoch)
        n = max(len(step_metrics), 1)
        avg = {k: sums[k] / n for k in LOSS_KEYS}
        for k in LOSS_KEYS:
            tag = "train_epoch/loss" if k == "total" else f"train_epoch/loss/{k}"
            self.summary_writer.add_scalar(tag, avg[k], epoch)
        throughput = n_samples / max(dt, 1e-9)
        self.summary_writer.add_scalar("train_epoch/samples_per_sec", throughput, epoch)
        print("TRAIN", {k: round(v, 4) for k, v in avg.items()}, f"[{throughput:.1f} samples/s]")
        return params, opt, avg

    def _start_profiler(self, device, epoch):
        """A running ``torch.profiler`` trace of the first epoch this fit
        trains when ``MVC_PROFILE_DIR`` is set (CPU and, on the card, CUDA
        activity), else None."""
        if not os.environ.get("MVC_PROFILE_DIR") or epoch != self.previous_epochs + 1:
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    @staticmethod
    def _stop_profiler(prof, epoch):
        prof.stop()
        out_dir = os.environ["MVC_PROFILE_DIR"]
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"train_epoch{epoch}.trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace of epoch {epoch}: {path}")

    @staticmethod
    def _fetch(step_metrics):
        """[n_steps] metric vectors -> one host array [n_steps, 5]."""
        if not step_metrics:
            return np.zeros((0, len(LOSS_KEYS)))
        return torch.stack(step_metrics).cpu().numpy().astype(np.float64)

    def _log_metrics(self, phase, step_no, metrics, sums):
        for k, v in zip(LOSS_KEYS, metrics):
            v = float(v)
            tag = f"{phase}/loss" if k == "total" else f"{phase}/loss/{k}"
            self.summary_writer.add_scalar(tag, v, step_no)
            sums[k] += v

    def test(self, model, params, dataloader, phase, epoch):
        """Validation/test loss pass with teacher forcing off."""
        sums = {k: 0.0 for k in LOSS_KEYS}
        step_metrics = []
        cache = getattr(dataloader, "feature_cache", None)
        for batch in self._device_batches(self._rank_batches(dataloader), model.device):
            batch.pop("_n_real", None)
            batch = self._agree_lengths(batch)
            if cache is not None:
                t_pad = batch.pop("t_pad")
                step_metrics.append(self._eval_loss_step_cached(params, batch, cache.arrays(),
                                                                None, t_pad))
            else:
                step_metrics.append(self._eval_loss_step(params, batch, None))
        for i, m in enumerate(self._fetch(step_metrics)):
            self._log_metrics(phase, epoch * len(dataloader) + i, m, sums)
        n = max(len(step_metrics), 1)
        avg = {k: sums[k] / n for k in LOSS_KEYS}
        for k in LOSS_KEYS:
            tag = f"{phase}_epoch/loss" if k == "total" else f"{phase}_epoch/loss/{k}"
            self.summary_writer.add_scalar(tag, avg[k], epoch)
        print("TEST ", {k: round(v, 4) for k, v in avg.items()})
        return avg

    def eval(self, model, params, videocaptions_loader, phase, epoch, mode="direct",
             get_scores=True, max_caption_len=30, beam_width=5, beam_alpha=0.0):
        """Caption-generation eval through ``model.predict_tokens`` (direct:
        greedy, the reference's fit-time setting; or beam).  Direct mode
        asks for the all-EOS early stop where ``predict_tokens`` takes it
        (the RNN captioners; their card kernels ignore it: fixed schedule,
        the same caption text; the transformer has none)."""
        vocab = getattr(videocaptions_loader.dataset, "vocab", None) or self._vocab
        vid_gt: Dict[str, list] = {}
        vid_gen: Dict[str, list] = {}
        stop_eos = (mode == "direct"
                    and "stop_at_all_eos" in inspect.signature(model.predict_tokens).parameters)
        extra = {"stop_at_all_eos": True} if stop_eos else {}
        if self.mesh is not None:
            extra["mesh"] = self.mesh
        t0 = time.time()
        with torch.no_grad():
            for batch in videocaptions_loader:
                b = self._put_batch(batch, model.device)
                tokens = model.predict_tokens(
                    params, b["audio"], b["visual"], max_caption_len=max_caption_len, mode=mode,
                    beam_width=beam_width, beam_alpha=beam_alpha, feat_mask=b["feat_mask"],
                    **extra)
                tokens = tokens.cpu().numpy()
                for row, vid, caps in zip(tokens, batch["video_ids"], batch["captions"]):
                    vid_gt[vid] = list(caps)
                    vid_gen[vid] = [vocab.decode_indexes(row[1:])]
        captions_per_sec = len(vid_gen) / max(time.time() - t0, 1e-9)
        self.summary_writer.add_scalar(f"{phase}/captions_per_sec", captions_per_sec, epoch)
        if self._world > 1:
            vid_gt, vid_gen = self._gather_captions(vid_gt, vid_gen)

        print("\nExample captions: key >> [generated] (ground_truth)")
        for i, key in enumerate(vid_gt):
            print(f"{key} >> [{vid_gen[key][0]}] ({vid_gt[key][0]})")
            if i >= 10:
                break
        print()

        scores = None
        if get_scores:
            if self._rank0:
                scores = NLPScore(vid_gt, vid_gen, meteor_synonyms=self._meteor_synonyms,
                                  meteor_paraphrases=self._meteor_paraphrases,
                                  meteor_function_words=self._meteor_function_words)
            if self._world > 1:
                box = [scores]
                dist.broadcast_object_list(box, src=0, group=self._group)
                scores = box[0]
            for name in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR"):
                self.summary_writer.add_scalar(f"{phase}/score/{mode}/{name}", scores[name],
                                               epoch)
            print(scores)
        return scores, vid_gt, vid_gen

    def _gather_captions(self, vid_gt, vid_gen):
        """Every rank's (references, captions) in the single-process order:
        rank r decoded the videos r, r + world, ... (``EvalDataLoader``'s
        strided shard).  Through ``all_gather_object``, which gloo and NCCL
        both take."""
        parts = [None] * self._world
        dist.all_gather_object(parts, (list(vid_gt.items()), list(vid_gen.items())),
                               group=self._group)
        gt: Dict[str, list] = {}
        gen: Dict[str, list] = {}
        for j in range(max(len(p[0]) for p in parts)):
            for p_gt, p_gen in parts:
                if j < len(p_gt):
                    gt[p_gt[j][0]] = p_gt[j][1]
                    gen[p_gen[j][0]] = p_gen[j][1]
        return gt, gen

    def set_vocab(self, vocab):
        self._vocab = vocab
