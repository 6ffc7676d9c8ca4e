"""The port's data-parallel mesh (``mvc_tpu_torch/parallel``,
``ops/sharded.py``, the trainer's, service's and extractor's ``mesh=``)
against the JAX package on the CPU.

Multi-rank cases run 2 spawned ranks over gloo, joined through a
``file://`` rendezvous in the test's own directory (no TCP port, so xdist
workers cannot collide), with a 60 s bound on every collective and on
the whole run.  Decode comparisons use the plain versions only (no Pallas
interpret mode): tokens equal the JAX package's unsharded XLA decode.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvc_tpu_torch.config import TrainerConfig
from mvc_tpu_torch.data import get_loader
from mvc_tpu_torch.ops import sharded
from mvc_tpu_torch.parallel import make_mesh, pad_batch_to_multiple
from mvc_tpu_torch.parallel import smoke as tsmoke
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package, imported on first use rather than with the module:
    the spawned ranks import this module for their functions and need none
    of it."""
    import jax
    import jax.numpy as jnp

    from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
    from mvc_tpu.data import get_loader as jax_get_loader
    from mvc_tpu.ops import sharded as jsharded
    from mvc_tpu.parallel import make_mesh as jax_make_mesh
    from mvc_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
    from mvc_tpu.parallel.smoke import make_smoke_model as jax_smoke_model
    from mvc_tpu.training import optimizer as jopt
    from mvc_tpu.training.trainer import Trainer as JaxTrainer

    return SimpleNamespace(**{k: v for k, v in locals().items()})


class _LazyJax:
    def __getattr__(self, name):
        return getattr(_jax(), name)


J = _LazyJax()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RANK_TIMEOUT_S = 120.0


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------------ the mesh
@pytest.mark.parametrize("dp,tp,sp,n", [(-1, 1, 1, 8), (-1, 2, 1, 8), (2, 2, 2, 8), (4, 1, 1, 8),
                                        (-1, 1, 1, 3), (2, 1, 1, 3)])
def test_make_mesh_shapes_match_jax(dp, tp, sp, n):
    got = make_mesh(dp=dp, tp=tp, sp=sp, devices=[CPU] * n)
    want = J.jax_make_mesh(dp=dp, tp=tp, sp=sp, devices=J.jax.devices()[:n])
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert len(got.devices) == want.size == got.size
    assert got.world_size == 1 and got.group is None


def test_make_mesh_refuses_what_jax_refuses():
    for kw in (dict(dp=-1, tp=3), dict(dp=4, tp=2, sp=2)):
        with pytest.raises(AssertionError):
            J.jax_make_mesh(devices=J.jax.devices(), **kw)
        with pytest.raises(ValueError):
            make_mesh(devices=[CPU] * 8, **kw)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 2), (8, 1), (2, 2, 2)])
def test_batch_axes_and_axes_size_match_jax(shape):
    dp, tp, sp = (*shape, 1)[:3]
    n = dp * tp * sp
    jm = J.jax_make_mesh(dp=dp, tp=tp, sp=sp, devices=J.jax.devices()[:n])
    tm = make_mesh(dp=dp, tp=tp, sp=sp, devices=[CPU] * n)
    for b in (1, 2, 3, 4, 6, 8, 12, 16, 62, 64):
        want = J.jsharded.batch_axes(jm, b)
        assert sharded.batch_axes(tm, b) == want, (shape, b)
        assert sharded.axes_size(tm, want) == J.jsharded.axes_size(jm, want)
    assert sharded.batch_axes(None, 5) == ()


def test_pad_batch_to_multiple_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    batch = {"audio": rng.normal(size=(5, 3, 4)).astype(np.float32),
             "visual": rng.normal(size=(5, 3, 6)).astype(np.float32),
             "captions": rng.integers(0, 9, (7, 5)).astype(np.int32),
             "feat_mask": rng.random((5, 3)) > 0.3, "sample_mask": np.ones(5, bool),
             "video_ids": [f"v{i}" for i in range(5)], "t_pad": 3}
    for m in (1, 2, 4, 5, 8):
        got, want = pad_batch_to_multiple(batch, m), J.jax_pad(batch, m)
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (m, k)
            else:
                assert got[k] == want[k]


# ------------------------------------------------------------------ the loader
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_process_shards_match_jax(synthetic_msvd, shuffle):
    kw = dict(root_dir=str(synthetic_msvd), dataset="MSVD", split="train", batch_size=3,
              shuffle=shuffle, verbose=False, frame_buckets=(8,), caption_buckets=(12,),
              vocab_path=str(synthetic_msvd / "metadata" / "vocab.json"), seed=7)
    seen = []
    for pi in range(2):
        tl, _ = get_loader(process_index=pi, process_count=2, **kw)
        jl, _ = J.jax_get_loader(process_index=pi, process_count=2, **kw)
        assert np.array_equal(tl._my_indices(), jl._my_indices()) and len(tl) == len(jl)
        tl.prefetch = jl.prefetch = 0
        for tb, jb in zip(tl, jl):
            for k in ("audio", "visual", "captions", "feat_mask", "sample_mask"):
                assert np.array_equal(tb[k], jb[k]), k
        seen += list(tl._my_indices())
    assert sorted(seen) == list(range(len(tl.dataset)))


# ------------------------------------------------------------------ the train step
SB, ST, SL, SVOC, SAD, SVD = 5, 4, 7, 23, 5, 9


def _smoke_batch():
    """``test_parallel.py``'s smoke batch at B=5, padded to 6 rows as a
    loader pads its last batch: rank 0 takes rows 0-2 (3 real), rank 1
    rows 3-5 (2 real and the padding row)."""
    rng = np.random.default_rng(11)
    caps = rng.integers(3, SVOC, size=(SL, SB)).astype(np.int32)
    caps[0] = 1
    caps[5:, 1] = 0                       # PAD tails of unequal length
    caps[4:, 3] = 0
    feat_mask = np.ones((SB, ST), bool)
    feat_mask[2, 2:] = False
    batch = {"audio": rng.normal(size=(SB, ST, SAD)).astype(np.float32),
             "visual": rng.normal(size=(SB, ST, SVD)).astype(np.float32),
             "captions": caps, "feat_mask": feat_mask, "sample_mask": np.ones((SB,), bool)}
    return batch, J.jax_pad(batch, 3)


def _rank_rows(batch, rank, rows=3):
    sl = slice(rank * rows, (rank + 1) * rows)
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl] if k == "captions" else v[sl]))
            for k, v in batch.items()}


def _rank_train_steps(rank, world, padded, params_np):
    """One rank of the 2-rank data-parallel step through the trainer, in
    both entropy modes."""
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    mesh = make_global_mesh()
    model = tsmoke.make_smoke_model(SVOC, SAD, SVD, device="cpu")
    out = {}
    for compat in (False, True):
        cfg = TrainerConfig(batch_size=3, compat_batch_axis_entropy=compat)
        trainer = Trainer("unused.ckpt", log_dir=None, mesh=mesh)
        step, _ = trainer._build_train_step(model, cfg)
        params = from_numpy_tree(params_np)
        opt = topt.make_optimizer(cfg, params)
        params, metrics = step(params, opt, _rank_rows(padded, rank), None)
        out[compat] = (metrics.numpy(), to_numpy_tree(params))
    return out


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    batch, padded = _smoke_batch()
    params = J.jax.tree.map(np.asarray, J.jax_smoke_model(SVOC, SAD, SVD).init(
        J.jax.random.PRNGKey(0)))
    ranks = tsmoke.spawn_ranks(_rank_train_steps, 2, str(tmp_path_factory.mktemp("rdzv")),
                               args=(padded, params), timeout_s=RANK_TIMEOUT_S)
    return batch, padded, params, ranks


@pytest.mark.parametrize("compat", [False, True], ids=["vocab_entropy", "batch_axis_entropy"])
def test_two_rank_gloo_step_equals_the_jax_single_device_step(two_rank_steps, compat):
    """Ranks with unequal real rows and PAD tokens: a per-rank mean, as
    DDP takes, would be wrong here.  The default entropy equals JAX's step
    on the 5 real rows; the batch-axis entropy is a softmax over every
    row of the global batch, padding row included, as JAX's dp program
    takes it over the padded batch, so it is held to JAX on those 6 rows.
    Loss, metrics and updated parameters within 1e-5 relative; the ranks
    agree bit for bit."""
    batch, padded, params, ranks = two_rank_steps
    jm = J.jax_smoke_model(SVOC, SAD, SVD)
    jcfg = J.JaxTrainerConfig(batch_size=3, compat_batch_axis_entropy=compat)
    tr = J.JaxTrainer("unused", log_dir=None)
    tr._optimizer = J.jopt.make_optimizer(jcfg)
    jstep, _ = tr._build_train_step(jm, jcfg)
    ref = padded if compat else batch
    jparams = J.jax.tree.map(J.jnp.asarray, params)
    want_params, _, want = jstep(jparams, tr._optimizer.init(jparams),
                                 {k: J.jnp.asarray(v) for k, v in ref.items()},
                                 J.jax.random.PRNGKey(3))
    want_metrics = [float(want[k]) for k in ("total", "ce", "e", "a_recon", "v_recon")]
    (m0, p0), (m1, p1) = (r[compat] for r in ranks)
    np.testing.assert_array_equal(m0, m1)
    for g, w in zip(m0, want_metrics):
        assert abs(g - w) <= 1e-5 * max(abs(w), 1e-6), (m0, want_metrics)
    flat0, flat1 = J.jax.tree.leaves(p0), J.jax.tree.leaves(p1)
    for a, b in zip(flat0, flat1):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(flat0, J.jax.tree.leaves(J.jax.tree.map(np.asarray, want_params))):
        assert _rel(g, w) <= 1e-5, _rel(g, w)


# ------------------------------------------------------------------ sharded decode
DV, DA, DVOC, DL = 24, 12, 29, 9


def _decode_case(B, single=False, seed=0):
    from mvc_tpu.config import DecoderConfig
    from mvc_tpu.models import decoder as jdec

    rng = np.random.default_rng(seed)
    small = dict(rnn_hidden_size=16, embedding_size=8, attn_size=8, output_size=DVOC)
    if single:
        cfg = DecoderConfig(in_feature_size=DA + DV, **small)
        params = {"decoder": J.jax.tree.map(np.array, jdec.init_decoder(
            J.jax.random.PRNGKey(5), cfg)), "reconstructor": None}
        cfgs = (cfg,)
    else:
        vcfg = DecoderConfig(in_feature_size=DV, **small)
        acfg = DecoderConfig(rnn_type="GRU", in_feature_size=DA, **small)
        params = {"v_decoder": J.jax.tree.map(np.array, jdec.init_decoder(
                      J.jax.random.PRNGKey(3), vcfg)),
                  "a_decoder": J.jax.tree.map(np.array, jdec.init_decoder(
                      J.jax.random.PRNGKey(4), acfg)),
                  "v_reconstructor": None, "a_reconstructor": None}
        cfgs = (vcfg, acfg)
    T = 5
    visual = rng.normal(size=(B, T, DV)).astype(np.float32)
    audio = rng.normal(size=(B, T, DA)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 3:] = False
    mask[B - 1, 2:] = False
    return cfgs, params, audio, visual, mask


def _models_for(cfgs):
    from mvc_tpu.models.captioning import AVCaptioning as JSingle
    from mvc_tpu.models.captioning import AVCaptioningDual as JDual
    from mvc_tpu_torch.config import DecoderConfig as TCfg
    from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual

    tcfgs = [TCfg(**{k: getattr(c, k) for k in ("rnn_type", "in_feature_size",
                                                   "rnn_hidden_size", "embedding_size",
                                                   "attn_size", "output_size")}) for c in cfgs]
    if len(cfgs) == 1:
        return (JSingle(vocab_size=DVOC, decoder_config=cfgs[0]),
                AVCaptioning(vocab_size=DVOC, decoder_config=tcfgs[0], device="cpu"))
    return (JDual(vocab_size=DVOC, visual_decoder_config=cfgs[0], audio_decoder_config=cfgs[1]),
            AVCaptioningDual(vocab_size=DVOC, visual_decoder_config=tcfgs[0],
                             audio_decoder_config=tcfgs[1], device="cpu"))


@pytest.mark.parametrize("kind,B", [("dual_direct", 8), ("dual_beam", 8), ("single_direct", 8),
                                    ("dual_direct", 6)],
                         ids=["dual_direct", "dual_beam", "single_direct", "indivisible"])
def test_sharded_decode_equals_the_jax_unsharded_decode(kind, B, monkeypatch):
    """Over a dp=4 mesh of CPU shards each shard decodes its rows through the
    plain version; the tokens equal the JAX model's unsharded XLA decode
    exactly.  B=6 divides no axis: the port pads it to 8 (the JAX package
    would take its XLA scan) and drops the padding rows' tokens."""
    cfgs, params, audio, visual, mask = _decode_case(B, single=kind.startswith("single"))
    jm, tm = _models_for(cfgs)
    kw = dict(max_caption_len=DL, mode="beam" if kind.endswith("beam") else "direct",
              beam_width=3, beam_alpha=0.0)
    want = np.asarray(jm.predict_tokens(J.jax.tree.map(J.jnp.asarray, params),
                                        J.jnp.asarray(audio), J.jnp.asarray(visual),
                                        feat_mask=J.jnp.asarray(mask), **kw))
    rows = []
    inner = type(tm)._predict_local

    def spy(self, p, x, *args):
        rows.append(int(x.shape[0]))
        return inner(self, p, x, *args)

    monkeypatch.setattr(type(tm), "_predict_local", spy)
    mesh = make_mesh(dp=4, devices=[CPU] * 4)
    tp = from_numpy_tree(params)
    got = tm.predict_tokens(tp, torch.from_numpy(audio), torch.from_numpy(visual),
                            feat_mask=torch.from_numpy(mask), mesh=mesh, **kw).numpy()
    assert rows == [2, 2, 2, 2]
    assert got.shape == want.shape and len(np.unique(got[:, 1:])) > 3
    np.testing.assert_array_equal(got, want)
    rows.clear()
    alone = tm.predict_tokens(tp, torch.from_numpy(audio), torch.from_numpy(visual),
                              feat_mask=torch.from_numpy(mask), **kw).numpy()
    assert rows == [B]
    np.testing.assert_array_equal(alone, want)


def test_replicas_are_made_once_per_device_and_parameter_set():
    t = {"w": torch.ones(3), "inner": [torch.zeros(2), None]}
    assert sharded.replica(t, CPU) is t               # already there: no copy
    meta = torch.device("meta")
    a = sharded.replica(t, meta)
    assert a is not t and a["w"].device == meta and a["inner"][1] is None
    assert sharded.replica(dict(t), meta) is a        # same leaves, new container
    t["w"].add_(1.0)                                  # an in-place update: a new copy
    assert sharded.replica(t, meta) is not a


# ------------------------------------------------------------------ the worker
def _run_workers(synthetic_msvd, tmp_path, extra):
    """Two ``cli.multihost_worker`` ranks over a ``file://`` rendezvous; their
    JSON lines."""
    env = dict(os.environ, PYTHONPATH=REPO)
    rdzv = f"file://{tmp_path / 'rdzv'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mvc_tpu_torch.cli.multihost_worker", "--coordinator", rdzv,
         "--num-processes", "2", "--process-id", str(i), "--data-root", str(synthetic_msvd),
         "--batch-size", "4", "--device", "cpu", *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert [ln["process_index"] for ln in lines] == [0, 1]
    for k in ("loss", "grad_norm", "param_norm"):
        assert lines[0][k] == lines[1][k], k
    return lines


def _one_process_step(synthetic_msvd, process_count):
    """One process's smoke step over the first batches of ``process_count``
    loader shards, side by side: (loss, grad_norm, param_norm)."""
    batches, ds = [], None
    for i in range(process_count):
        loader, ds = get_loader(root_dir=str(synthetic_msvd), dataset="MSVD", split="train",
                                batch_size=4, shuffle=False, verbose=False,
                                vocab_path=str(synthetic_msvd / "metadata" / "vocab.json"),
                                frame_buckets=(8,), caption_buckets=(12,),
                                process_index=i, process_count=process_count)
        loader.prefetch = 0
        batches.append(next(iter(loader)))
    union = {k: torch.from_numpy(np.concatenate([b[k] for b in batches],
                                                axis=1 if k == "captions" else 0))
             for k in ("audio", "visual", "captions", "feat_mask")}
    model = tsmoke.make_smoke_model(len(ds.vocab), union["audio"].shape[-1],
                                    union["visual"].shape[-1])
    params = model.init(torch.Generator().manual_seed(0))
    opt = topt.make_optimizer(TrainerConfig(), params)
    return tsmoke.make_smoke_train_step(model, tsmoke.make_smoke_loss())(params, opt, union, None)


def test_multihost_worker_two_ranks_equal_one_process(synthetic_msvd, tmp_path):
    """``python -m mvc_tpu_torch.cli.multihost_worker`` as 2 gloo ranks (a
    ``file://`` rendezvous): both print the same loss and norms, equal to
    one process's step over the union of their batches (rel 1e-4, as
    ``tests/test_multihost.py`` holds the JAX worker)."""
    lines = _run_workers(synthetic_msvd, tmp_path, ["--local-devices", "2"])
    assert all(ln["process_count"] == 2 and ln["global_devices"] == 4 and ln["local_batch"] == 4
               for ln in lines)
    loss, gnorm, pnorm = _one_process_step(synthetic_msvd, 2)
    for k, want in (("loss", loss), ("grad_norm", gnorm), ("param_norm", pnorm)):
        assert abs(lines[0][k] - want) <= 1e-4 * abs(want), (k, lines[0][k], want)


def test_multihost_worker_tp_ranks_equal_one_process(synthetic_msvd, tmp_path):
    """The same worker with ``--tp 2``, as ``scripts/multihost_worker.py``
    takes it: a (dp=1, tp=2) mesh whose ranks both read the first batch and
    each hold half of every vocab leaf.  Both print the same loss and norms
    (the sharded leaves' norms summed over tp), equal to one process's step
    over that batch (rel 1e-4)."""
    lines = _run_workers(synthetic_msvd, tmp_path, ["--tp", "2"])
    assert all(ln["process_count"] == 2 and ln["global_devices"] == 2 and ln["local_batch"] == 4
               for ln in lines)
    loss, gnorm, pnorm = _one_process_step(synthetic_msvd, 1)
    for k, want in (("loss", loss), ("grad_norm", gnorm), ("param_norm", pnorm)):
        assert abs(lines[0][k] - want) <= 1e-4 * abs(want), (k, lines[0][k], want)


# ------------------------------------------------------------------ the service
@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_service_over_a_mesh_equals_the_meshless_service(mode):
    """``CaptionService(mesh=)`` over 2 CPU shards answers every request as
    the meshless service does; a ``max_batch`` the dp axis does not divide
    is refused, as in the JAX service."""
    from mvc_tpu_torch.config import DecoderConfig
    from mvc_tpu_torch.data import Vocabulary
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig

    vocab = Vocabulary(freq_threshold=1)
    vocab.build_vocabulary(["a man plays a guitar", "a dog runs on grass",
                            "someone slices a tomato"])
    small = dict(rnn_hidden_size=12, embedding_size=8, attn_size=6)
    model = AVCaptioningDual(vocab_size=len(vocab), device="cpu",
                             visual_decoder_config=DecoderConfig(in_feature_size=16, **small),
                             audio_decoder_config=DecoderConfig(in_feature_size=8, **small))
    params = model.init(torch.Generator().manual_seed(0))
    cfg = ServiceConfig(max_batch=4, max_wait_ms=200.0, frame_buckets=(4, 8), max_caption_len=6,
                        audio_dim=8, visual_dim=16, mode=mode, beam_width=3)
    rng = np.random.default_rng(2)
    reqs = [(rng.normal(size=(t, 16)).astype(np.float32),
             rng.normal(size=(t, 8)).astype(np.float32)) for t in (5, 8, 3, 7, 6, 4, 8, 2)]
    with CaptionService(model, params, vocab, cfg, device="cpu") as svc:
        want = [f.result(timeout=60) for f in [svc.submit(v, a) for v, a in reqs]]
    mesh = make_mesh(dp=2, devices=[CPU] * 2)
    with CaptionService(model, params, vocab, cfg, device="cpu", mesh=mesh) as svc:
        got = [f.result(timeout=60) for f in [svc.submit(v, a) for v, a in reqs]]
        assert svc._shards() == 2
    assert got == want and len(set(want)) > 1
    with pytest.raises(ValueError, match="max_batch"):
        CaptionService(model, params, vocab, cfg, device="cpu",
                       mesh=make_mesh(dp=3, devices=[CPU] * 3))


# ------------------------------------------------------------------ the trainer's fit
class _UnionLoader:
    """The batches one process must see to take the 2-rank fit's steps: at
    each step the ranks' batches, padded to the longer caption and clip as
    the trainer pads them (``Trainer._agree_lengths``), side by side."""

    def __init__(self, loaders):
        self.loaders = loaders
        self.dataset = loaders[0].dataset

    def __len__(self):
        return max(len(ld) for ld in self.loaders)

    def __iter__(self):
        its = [iter(ld) for ld in self.loaders]
        for _ in range(len(self)):
            parts = [b for b in (next(it, None) for it in its) if b is not None]
            L = max(b["captions"].shape[0] for b in parts)
            T = max(b["feat_mask"].shape[1] for b in parts)
            out = {}
            for k in ("captions", "audio", "visual", "feat_mask", "sample_mask"):
                padded = []
                for b in parts:
                    v = b[k]
                    if k == "captions":
                        v = np.pad(v, ((0, L - v.shape[0]), (0, 0)))
                    elif k != "sample_mask":
                        v = np.pad(v, [(0, 0), (0, T - v.shape[1])] + [(0, 0)] * (v.ndim - 2))
                    padded.append(v)
                out[k] = np.concatenate(padded, axis=1 if k == "captions" else 0)
            yield out


def _fit(synthetic_msvd, workdir, rank=0, world=1):
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    os.makedirs(workdir, exist_ok=True)
    kw = dict(root_dir=str(synthetic_msvd), dataset="MSVD", batch_size=4, verbose=False,
              vocab_path=str(synthetic_msvd / "metadata" / "vocab.json"), seed=3,
              frame_buckets=(4, 8), caption_buckets=(8, 12), process_count=2)
    if world == 1:       # one process over what both ranks read
        train = _UnionLoader([get_loader(split="train", process_index=i, **kw)[0]
                              for i in range(2)])
        val = _UnionLoader([get_loader(split="val", process_index=i, **kw)[0] for i in range(2)])
    else:
        train, val = (get_loader(split=s, process_index=rank, **kw)[0] for s in ("train", "val"))
    model = tsmoke.make_smoke_model(len(train.dataset.vocab), 128, 2048)
    cfg = TrainerConfig(batch_size=4, epochs=1, lr=1e-3, frame_buckets=(4, 8),
                        caption_buckets=(8, 12), eval_max_caption_len=10,
                        **tsmoke.SMOKE_LAMBDAS)
    mesh = make_global_mesh() if world > 1 else None
    trainer = Trainer(os.path.join(workdir, "ck", "m.ckpt"), log_dir=None, eval_freq=1,
                      mesh=mesh)
    caps = {}
    inner = trainer.eval

    def keep(*a, **k):
        out = inner(*a, **k)
        caps[a[3]] = out[2]
        return out

    trainer.eval = keep
    _, _, history = trainer.fit(model, model.init(torch.Generator().manual_seed(0)), train, val,
                                val, cfg)
    ck = os.path.join(workdir, "ck")
    return history, caps, sorted(os.listdir(ck)) if os.path.isdir(ck) else []


def _rank_fit(rank, world, synthetic_msvd, workdir):
    return _fit(synthetic_msvd, os.path.join(workdir, f"rank{rank}"), rank, world)


def test_two_rank_fit_equals_the_single_process_fit(synthetic_msvd, tmp_path):
    """``Trainer(mesh=).fit`` over 2 gloo ranks (strided shards of unequal
    length, padded last batches, caption and frame buckets that differ
    between the ranks' batches) against one process's fit over the same
    union batches: the same losses (rel 1e-5), the same scores and captions
    (gathered on rank 0 in the single-process order), every rank with the
    same history; only rank 0 writes checkpoints."""
    want, want_caps, _ = _fit(synthetic_msvd, str(tmp_path / "single"))
    ranks = tsmoke.spawn_ranks(_rank_fit, 2, str(tmp_path / "rdzv"),
                               args=(synthetic_msvd, str(tmp_path)), timeout_s=RANK_TIMEOUT_S)
    (h0, caps0, files0), (h1, caps1, files1) = ranks
    assert h0 == h1 and caps0 == caps1
    assert files0 and not files1
    for phase in ("train_loss", "val_loss"):
        for g, w in zip(h0[phase], want[phase]):
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1e-6), (phase, k, g, w)
    assert h0["val_score"] == want["val_score"]
    for phase in ("train", "val"):
        assert list(caps0[phase].items()) == list(want_caps[phase].items())
