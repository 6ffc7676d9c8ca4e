"""Tensor and sequence parallelism (tp, sp) of the port's RNN captioners
(``mvc_tpu_torch/parallel/{mesh,collectives}.py``, the models' and the
losses' ``shards``, ``Trainer(mesh=)``) against the JAX package on the CPU.

Each mesh shape is one module-scoped spawn of gloo ranks joined through a
``file://`` rendezvous in the test's own directory, with a 120-s bound on
every collective and on the whole run (360 s for the fits); the rank functions live at module
level and the module imports JAX lazily, so a rank starts in seconds.  The
JAX side is the single-device program: GSPMD's sharded step equals it
(``tests/test_parallel.py:130-182``), so the port's ranks are held to it
with that test's tolerances (loss rtol 2e-5, atol 1e-6; parameters rtol
2e-4, atol 1e-6).  V=23 is odd, so tp=2 slices it 12 + 11.
"""

from __future__ import annotations

import functools
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvc_tpu_torch.config import PAD_ID, DecoderConfig, TrainerConfig
from mvc_tpu_torch.parallel import collectives, gather_params, param_specs, shard_params
from mvc_tpu_torch.parallel import mesh as tmesh
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

    from mvc_tpu.config import DecoderConfig as JaxDecoderConfig
    from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
    from mvc_tpu.models import attention as jattn
    from mvc_tpu.models.captioning import AVCaptioning as JaxSingle
    from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
    from mvc_tpu.parallel import make_mesh as jax_make_mesh
    from mvc_tpu.parallel import param_shardings
    from mvc_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
    from mvc_tpu.training import losses as jlosses
    from mvc_tpu.training import optimizer as jopt
    from mvc_tpu.training.checkpoint import load_checkpoint as jax_load
    from mvc_tpu.training.checkpoint import restore_params_like as jax_restore
    from mvc_tpu.training.trainer import Trainer as JaxTrainer

    return SimpleNamespace(**{k: v for k, v in locals().items()})


class _LazyJax:
    def __getattr__(self, name):
        return getattr(_jax(), name)


J = _LazyJax()
CPU = torch.device("cpu")
RANK_TIMEOUT_S = 120.0
B, T, L, V, AD, VD = 5, 6, 7, 23, 5, 9
SMALL = dict(rnn_hidden_size=16, embedding_size=8, attn_size=6)
STEP_TOL = dict(loss=dict(rtol=2e-5, atol=1e-6), params=dict(rtol=2e-4, atol=1e-6))


def _port_model(rec):
    from mvc_tpu_torch.models import AVCaptioningDual

    return AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type=rec,
                            visual_decoder_config=DecoderConfig(in_feature_size=VD, **SMALL),
                            audio_decoder_config=DecoderConfig(in_feature_size=AD, **SMALL),
                            device="cpu")


def _jax_model(rec):
    return J.JaxDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type=rec,
                     visual_decoder_config=J.JaxDecoderConfig(in_feature_size=VD, **SMALL),
                     audio_decoder_config=J.JaxDecoderConfig(in_feature_size=AD, **SMALL))


def _batch(t=T, seed=11):
    """B=5 clips of ``t`` frames and PAD tails of unequal length.  At sp=2
    and t=6 row 1's mask edge falls inside the second frame block and row
    2 has no real frame in it; row 4 has one frame in all."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(3, V, size=(L, B)).astype(np.int32)
    caps[0] = 1
    caps[5:, 1] = 0
    caps[4:, 3] = 0
    feat_mask = np.ones((B, t), bool)
    feat_mask[1, 4:] = False
    feat_mask[2, 3:] = False
    feat_mask[4, 1:] = False
    return {"audio": rng.normal(size=(B, t, AD)).astype(np.float32),
            "visual": rng.normal(size=(B, t, VD)).astype(np.float32),
            "captions": caps, "feat_mask": feat_mask, "sample_mask": np.ones((B,), bool)}


def _rows(batch, d, dp):
    """Data-parallel index ``d``'s rows of a batch whose rows divide dp."""
    n = batch["audio"].shape[0] // dp
    sl = slice(d * n, (d + 1) * n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl] if k == "captions" else v[sl]))
            for k, v in batch.items()}


# ------------------------------------------------------------------ ranks
SHAPES = {"tp2": (1, 2, 1), "sp2": (1, 1, 2), "dp2tp2sp2": (2, 2, 2)}
CASES = {  # name -> (reconstructor, batch-axis entropy, T)
    "tp2": {"global": ("global", False, T), "local": ("local", False, T)},
    "sp2": {"global": ("global", False, T), "local": ("local", False, T),
            "t_not_divisible": ("global", False, 5)},
    "dp2tp2sp2": {"global": ("global", False, T), "local": ("local", False, T),
                  "batch_axis_entropy": ("global", True, T)},
}


def _rank_steps(rank, world, shape, cases, params, extra):
    """One rank of a (dp, tp, sp) mesh: the trainer's step for each case
    on the rank's rows and, inside the step, frames; returns its metrics,
    the parameters gathered whole and its own slices."""
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    mesh = make_global_mesh(*shape)
    out = {"coords": mesh.coords(), "data_shard": mesh.data_shard()}
    for name, (rec, compat, batch) in cases.items():
        model = _port_model(rec)
        cfg = TrainerConfig(batch_size=B, compat_batch_axis_entropy=compat)
        step, _ = Trainer("unused.ckpt", log_dir=None, mesh=mesh)._build_train_step(model, cfg)
        p = shard_params(mesh, from_numpy_tree(params[rec]))
        opt = topt.make_optimizer(cfg, p)
        p, metrics = step(p, opt, _rows(batch, mesh.coords()[0], shape[0]), None)
        out[name] = (metrics.numpy(), to_numpy_tree(gather_params(mesh, p, V)),
                     to_numpy_tree(p))
    for name, fn in extra.items():
        out[name] = fn(mesh, params)
    return out


def _loss_terms(mesh, _params):
    """tp: the dual fusion, the CE and both entropies over vocab slices, and
    the gradient of their sum with respect to each decoder's logit slice."""
    from mvc_tpu_torch.training import losses as tl

    lv, la, caps = _logits_case()
    shards = mesh.shards(V, False)
    xs = [torch.from_numpy(tmesh.shard_leaf(mesh, (None, None, "tp"), x)).requires_grad_(True)
          for x in (lv, la)]
    out = collectives.log_softmax(xs[0], shards) + collectives.log_softmax(xs[1], shards)
    capt = torch.from_numpy(caps)
    counts = tl.global_counts(capt, None, None, 1, mesh.group, None, shards)
    ce = tl.nll_loss(out, capt, counts)
    ents = [tl.entropy_loss(out[1:], capt[1:] == PAD_ID, compat, counts=counts)
            for compat in (False, True)]
    (sum([ce, *ents]) / mesh.tp).backward()
    return {"terms": [float(ce), *map(float, ents)], "grads": [x.grad.numpy() for x in xs],
            "argmax": collectives.argmax(out, shards).numpy(),
            "embed": collectives.embed(torch.from_numpy(tmesh.shard_leaf(
                mesh, ("tp", None), _table())), capt, shards).numpy()}


def _round_trip(mesh, _params):
    """tp: ``gather_params`` of ``shard_params`` at V=23 and V=5 (slices of
    3 + 2), the dual and the single model."""
    from mvc_tpu_torch.models import AVCaptioning

    trees = [_port_model("global").init(torch.Generator().manual_seed(4)),
             AVCaptioning(vocab_size=5, reconstructor_type="local",
                          decoder_config=DecoderConfig(in_feature_size=AD + VD, **SMALL),
                          device="cpu").init(torch.Generator().manual_seed(5))]
    out = []
    for tree, v in zip(trees, (V, 5)):
        sliced = shard_params(mesh, tree)
        out.append((to_numpy_tree(tree), to_numpy_tree(gather_params(mesh, sliced, v)),
                    to_numpy_tree(sliced)))
    return out


def _attention(mesh, _params):
    """sp: ``attend`` over this rank's frame block; the context and the
    weights, and the gradients of a weighted sum of the context."""
    from mvc_tpu_torch.models import attention as tattn

    params_np, h, feats, mask, r = _attention_case()
    shards = mesh.shards(V, True)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in params_np.items()}
    ht = torch.tensor(h, requires_grad=True)
    ctx, w = tattn.attend(params, ht, shards.own_frames(torch.from_numpy(feats)),
                          mask=shards.own_frames(torch.from_numpy(mask)), shards=shards)
    ((ctx * torch.from_numpy(r)).sum() / mesh.sp).backward()
    grads = [params[k].grad for k in sorted(params)] + [ht.grad]
    tmesh.sum_over_ranks(grads, mesh.group)
    return {"context": ctx.detach().numpy(), "weights": w.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def _cached_step(mesh, params):
    """sp: the trainer's feature-cache step (the frames gathered on the
    device from cache rows, then split) on the "global" case's batch."""
    from mvc_tpu_torch.training.trainer import Trainer

    batch = _batch()
    cache = {"audio": torch.from_numpy(batch["audio"]),
             "visual": torch.from_numpy(batch["visual"]),
             "lengths": torch.from_numpy(batch["feat_mask"].sum(axis=1))}
    cfg = TrainerConfig(batch_size=B)
    trainer = Trainer("unused.ckpt", log_dir=None, mesh=mesh)
    trainer._build_train_step(_port_model("global"), cfg)
    p = from_numpy_tree(params["global"])
    ids = {"captions": torch.from_numpy(batch["captions"]),
           "video_rows": torch.arange(B), "sample_mask": torch.ones(B, dtype=torch.bool)}
    p, metrics = trainer._train_step_cached(p, topt.make_optimizer(cfg, p), ids, cache, None, T)
    return metrics.numpy(), to_numpy_tree(p)


def _logits_case():
    rng = np.random.default_rng(5)
    caps = _batch()["captions"]
    return (rng.normal(size=(L, B, V)).astype(np.float32) * 2,
            rng.normal(size=(L, B, V)).astype(np.float32) * 2, caps)


def _table():
    return np.random.default_rng(6).normal(size=(V, 4)).astype(np.float32)


def _attention_case():
    rng = np.random.default_rng(7)
    Hs, F, A = 6, 4, 5
    params = {"W": rng.normal(size=(Hs, A)), "U": rng.normal(size=(F, A)),
              "b": rng.normal(size=(A,)), "w": rng.normal(size=(A,))}
    mask = np.ones((4, T), bool)
    mask[0, 4:] = False            # the edge inside the second block
    mask[1, 3:] = False            # the second block all masked
    mask[2, :3] = False            # the first block all masked
    mask[3, :] = False             # no frame at all: zero weights
    return ({k: v.astype(np.float32) for k, v in params.items()},
            rng.normal(size=(4, Hs)).astype(np.float32),
            rng.normal(size=(4, T, F)).astype(np.float32), mask,
            rng.normal(size=(4, F)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _step_params():
    return {rec: J.jax.tree.map(np.asarray, _jax_model(rec).init(J.jax.random.PRNGKey(0)))
            for rec in ("global", "local")}


def _case_batch(shape, t):
    batch = _batch(t)
    return J.jax_pad(batch, 2) if shape[0] == 2 else batch


EXTRA = {"tp2": {"loss_terms": _loss_terms, "round_trip": _round_trip},
         "sp2": {"attention": _attention, "cached": _cached_step}, "dp2tp2sp2": {}}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """name -> the ranks' results, one spawn per mesh shape, made when a
    test first asks for its shape."""
    runs = {}

    def get(name):
        if name not in runs:
            shape = SHAPES[name]
            cases = {c: (rec, compat, _case_batch(shape, t))
                     for c, (rec, compat, t) in CASES[name].items()}
            runs[name] = tsmoke.spawn_ranks(
                _rank_steps, int(np.prod(shape)), str(tmp_path_factory.mktemp(f"rdzv_{name}")),
                args=(shape, cases, _step_params(), EXTRA[name]), timeout_s=RANK_TIMEOUT_S)
        return runs[name]

    return get


# ------------------------------------------------------------------ the mesh
@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2), (2, 2, 2), (4, 2, 1), (2, 1, 4)])
def test_rank_coordinates_and_data_shards_match_the_jax_grid(shape):
    """Rank r stands where device r stands in JAX's ``devices.reshape(dp,
    tp, sp)``; its loaders read the rows of its dp index."""
    dp, tp, sp = shape
    n = dp * tp * sp
    jm = J.jax_make_mesh(dp=dp, tp=tp, sp=sp, devices=J.jax.devices()[:n])
    grid = np.vectorize(lambda d: d.id)(jm.devices).reshape(dp, tp, sp)
    for r in range(n):
        m = tmesh.Mesh({"dp": dp, "tp": tp, **({"sp": sp} if sp > 1 else {})}, [CPU], rank=r,
                       world_size=n)
        want = tuple(int(i) for i in np.argwhere(grid == J.jax.devices()[r].id)[0])
        assert m.coords() == want, (r, m.coords(), want)
        assert m.data_shard() == (want[0], dp)


@pytest.mark.parametrize("model", ["dual_global", "single_local"])
def test_param_specs_equal_jax_param_shardings(model):
    from mvc_tpu_torch.models import AVCaptioning

    if model == "dual_global":
        params = _step_params()["global"]
        port = _port_model("global").init(torch.Generator().manual_seed(0))
    else:
        cfg = dict(in_feature_size=AD + VD, **SMALL)
        params = J.jax.tree.map(np.asarray, J.JaxSingle(
            vocab_size=V, reconstructor_type="local",
            decoder_config=J.JaxDecoderConfig(**cfg)).init(J.jax.random.PRNGKey(1)))
        port = AVCaptioning(vocab_size=V, reconstructor_type="local",
                            decoder_config=DecoderConfig(**cfg),
                            device="cpu").init(torch.Generator().manual_seed(1))
    want = J.param_shardings(J.jax_make_mesh(dp=4, tp=2), params)
    want_specs = J.jax.tree.map(lambda s: tuple(s.spec), want,
                                is_leaf=lambda x: hasattr(x, "spec"))
    got = param_specs(port)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    assert flat(got) == flat(want_specs)
    assert sum("tp" in s for s in flat(got).values()) == (6 if model == "dual_global" else 3)


def test_split_frames_follows_the_jax_shard_batch_rule():
    """Frames split over sp when sp divides T, else stay whole; captions
    never split."""
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for r, lo in ((0, 0), (1, 3)):
        m = tmesh.Mesh({"dp": 1, "tp": 1, "sp": 2}, [CPU], rank=r, world_size=2)
        got, split = tmesh.split_frames(m, batch)
        assert split and torch.equal(got["visual"], batch["visual"][:, lo:lo + 3])
        assert torch.equal(got["feat_mask"], batch["feat_mask"][:, lo:lo + 3])
        assert torch.equal(got["captions"], batch["captions"])
        odd = {k: torch.from_numpy(v) for k, v in _batch(t=5).items()}
        assert tmesh.split_frames(m, odd) == (odd, False)


def test_shard_then_gather_is_the_identity(mesh_runs):
    r0, r1 = mesh_runs("tp2")
    for (whole, gathered, s0), (_, gathered1, s1) in zip(r0["round_trip"], r1["round_trip"]):
        for a, b, c in zip(*(J.jax.tree.leaves(t) for t in (whole, gathered, gathered1))):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        for path, x0, x1 in (("embedding", s0, s1),):
            key = next(k for k in x0 if k.endswith("decoder"))
            t0, t1 = x0[key]["embedding"]["table"], x1[key]["embedding"]["table"]
            n = whole[key]["embedding"]["table"].shape[0]
            assert t0.shape[0] == -(-n // 2) and t0.shape[0] + t1.shape[0] == n, path


def test_vocab_parallel_loss_terms_equal_jax(mesh_runs):
    """tp=2: the dual fusion Σ_d log_softmax(l_d), the CE, the vocab-axis
    and the batch-axis entropies equal ``mvc_tpu``'s losses, and so do the
    gradients of their sum with respect to each decoder's logits; the
    cross-tp argmax and embedding lookup equal the whole-vocab ones."""
    lv, la, caps = _logits_case()
    jnp = J.jnp

    def terms(a, b):
        out = J.jax.nn.log_softmax(a, -1) + J.jax.nn.log_softmax(b, -1)
        ign = jnp.asarray(caps[1:] == PAD_ID)
        return [J.jlosses.nll_loss(out, jnp.asarray(caps)),
                J.jlosses.entropy_loss(out[1:], ign, False),
                J.jlosses.entropy_loss(out[1:], ign, True)], out

    (want, out) = terms(jnp.asarray(lv), jnp.asarray(la))
    gv, ga = J.jax.grad(lambda a, b: sum(terms(a, b)[0]), argnums=(0, 1))(jnp.asarray(lv),
                                                                        jnp.asarray(la))
    ranks = [r["loss_terms"] for r in mesh_runs("tp2")]
    for r in ranks:
        np.testing.assert_allclose(r["terms"], [float(x) for x in want], rtol=2e-6)
        np.testing.assert_array_equal(r["argmax"], np.argmax(np.asarray(out), -1))
        np.testing.assert_array_equal(r["embed"], _table()[caps])
    for d, g in enumerate((gv, ga)):
        got = np.concatenate([r["grads"][d] for r in ranks], axis=-1)
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-7)


def test_sp_attention_equals_jax_attend(mesh_runs):
    """sp=2 with the mask edge inside a block, a row whose block is all
    masked (each block) and a row with no frame: context, weights and the
    gradients of a weighted context equal ``mvc_tpu``'s ``attend``."""
    params, h, feats, mask, r = _attention_case()
    jp = {k: J.jnp.asarray(v) for k, v in params.items()}
    ctx, w = J.jattn.attend(jp, J.jnp.asarray(h), J.jnp.asarray(feats),
                            mask=J.jnp.asarray(mask))

    def f(p, hh):
        return (J.jattn.attend(p, hh, J.jnp.asarray(feats), mask=J.jnp.asarray(mask))[0]
                * r).sum()

    gp, gh = J.jax.grad(f, argnums=(0, 1))(jp, J.jnp.asarray(h))
    ranks = [x["attention"] for x in mesh_runs("sp2")]
    for x in ranks:
        np.testing.assert_allclose(x["context"], np.asarray(ctx), rtol=1e-5, atol=1e-6)
        for g, want in zip(x["grads"], [*(gp[k] for k in sorted(gp)), gh]):
            np.testing.assert_allclose(g, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([x["weights"] for x in ranks], axis=1),
                               np.asarray(w), rtol=1e-5, atol=1e-7)
    assert not np.asarray(w)[3].any()


# ------------------------------------------------------------------ the train step
def _jax_step(rec, compat, batch):
    jcfg = J.JaxTrainerConfig(batch_size=B, compat_batch_axis_entropy=compat)
    tr = J.JaxTrainer("unused", log_dir=None)
    tr._optimizer = J.jopt.make_optimizer(jcfg)
    jstep, _ = tr._build_train_step(_jax_model(rec), jcfg)
    jparams = J.jax.tree.map(J.jnp.asarray, _step_params()[rec])
    new, _, metrics = jstep(jparams, tr._optimizer.init(jparams),
                            {k: J.jnp.asarray(v) for k, v in batch.items()},
                            J.jax.random.PRNGKey(3))
    return ([float(metrics[k]) for k in ("total", "ce", "e", "a_recon", "v_recon")],
            J.jax.tree.map(np.asarray, new))


@pytest.mark.parametrize("mesh_name,case", [(m, c) for m in SHAPES for c in CASES[m]])
def test_train_step_equals_the_jax_single_device_step(mesh_runs, mesh_name, case):
    """The trainer's step on every rank of the mesh: the metrics summed over
    the ranks equal the JAX single-device step's over the whole batch (the
    padded one for the batch-axis entropy, whose softmax takes every row),
    and so do the updated parameters, gathered; replicated parameters and
    the slices of one tp index are equal bit for bit across the ranks."""
    shape = SHAPES[mesh_name]
    rec, compat, t = CASES[mesh_name][case]
    batch = _case_batch(shape, t) if compat else _batch(t)
    want_metrics, want_params = _jax_step(rec, compat, batch)
    ranks = mesh_runs(mesh_name)
    metrics, whole, own = zip(*(r[case] for r in ranks))
    for m in metrics:
        np.testing.assert_array_equal(m, metrics[0])
        np.testing.assert_allclose(m, want_metrics, **STEP_TOL["loss"])
    leaves = J.jax.tree.leaves(whole[0])
    for g, w in zip(leaves, J.jax.tree.leaves(want_params)):
        np.testing.assert_allclose(g, w, **STEP_TOL["params"])
    for r, x in zip(ranks, own):
        peer = next(o for q, o in zip(ranks, own) if q["coords"][1] == r["coords"][1])
        for a, b in zip(J.jax.tree.leaves(x), J.jax.tree.leaves(peer)):
            np.testing.assert_array_equal(a, b)
    for x in whole:
        for a, b in zip(J.jax.tree.leaves(x), leaves):
            np.testing.assert_array_equal(a, b)


def test_feature_cache_step_splits_its_gathered_frames(mesh_runs):
    """sp=2: the cached step gathers whole frames from the cache rows and
    splits them as the uncached step does: the same metrics and update."""
    ranks = mesh_runs("sp2")
    for r in ranks:
        np.testing.assert_array_equal(r["cached"][0], r["global"][0])
        for a, b in zip(J.jax.tree.leaves(r["cached"][1]), J.jax.tree.leaves(r["global"][1])):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ the fit
def _fit(synthetic_msvd, workdir, epochs, tp=1, resume_from=None):
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    ck = os.path.join(workdir, "ck")
    os.makedirs(ck, exist_ok=True)
    if resume_from is not None:
        shutil.copy(resume_from, os.path.join(ck, "m.ckpt"))
    kw = dict(root_dir=str(synthetic_msvd), dataset="MSVD", batch_size=8, verbose=False,
              vocab_path=str(synthetic_msvd / "metadata" / "vocab.json"), seed=3,
              frame_buckets=(4, 8), caption_buckets=(8, 12))
    train, val = (get_loader(split=s, **kw)[0] for s in ("train", "val"))
    model = tsmoke.make_smoke_model(len(train.dataset.vocab), 128, 2048)
    cfg = TrainerConfig(batch_size=8, epochs=epochs, lr=1e-3, frame_buckets=(4, 8),
                        caption_buckets=(8, 12), eval_max_caption_len=10,
                        **tsmoke.SMOKE_LAMBDAS)
    trainer = Trainer(os.path.join(ck, "m.ckpt"), log_dir=None, eval_freq=2,
                      mesh=make_global_mesh(tp=tp) if tp > 1 else None)
    caps = {}
    inner = trainer.eval

    def keep(*a, **k):
        out = inner(*a, **k)
        caps[a[3]] = out[2]
        return out

    trainer.eval = keep
    params, opt, history = trainer.fit(model, model.init(torch.Generator().manual_seed(0)),
                                       train, val, val, cfg)
    steps = sorted({s["step"] for s in opt.inner.state_dict()["state"].values()})
    return history, caps, to_numpy_tree(params), os.path.join(ck, "m.ckpt"), steps


def _rank_fit(rank, world, synthetic_msvd, workdir, single_ckpt):
    """A 2-epoch fit at tp=2, then a third epoch resumed from the
    one-process fit's checkpoint."""
    history, caps, params, ckpt, steps = _fit(synthetic_msvd,
                                              os.path.join(workdir, f"tp{rank}"), 2, tp=2)
    resumed = _fit(synthetic_msvd, os.path.join(workdir, f"resume{rank}"), 3, tp=2,
                   resume_from=single_ckpt)
    return history, caps, params, ckpt, steps, resumed[0], resumed[4]


def _close_history(got, want, rel=1e-6):
    for phase in ("train_loss", "val_loss"):
        assert len(got[phase]) == len(want[phase])
        for g, w in zip(got[phase], want[phase]):
            for k in w:
                assert abs(g[k] - w[k]) <= rel * max(abs(w[k]), 1e-6), (phase, k, g, w)


@pytest.fixture
def emptied_after(tmp_path):
    """Removes the test's ``tmp_path`` when it ends: its fits' checkpoints
    take ~2.7 GB, and pytest keeps the directories of its last runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.usefixtures("emptied_after")
def test_tp_fit_equals_the_one_process_fit_and_checkpoints_cross_meshes(synthetic_msvd,
                                                                      tmp_path):
    """A 2-epoch ``Trainer.fit`` over 2 tp ranks against one process's fit
    of the same batches: the history within 1e-6, the same scores and
    gathered captions, each whole parameter leaf within 1e-3 in norm.  Its
    checkpoint holds whole parameters and moments: the JAX package loads
    it, and one process resumes it for a third epoch, as 2 tp ranks resume
    the one process's checkpoint; the three third epochs agree within
    1e-5."""
    want, want_caps, want_params, single_ckpt, want_steps = _fit(synthetic_msvd,
                                                                 str(tmp_path / "one"), 2)
    saved_single = str(tmp_path / "single.ckpt")
    shutil.copy(single_ckpt, saved_single)
    ranks = tsmoke.spawn_ranks(_rank_fit, 2, str(tmp_path / "rdzv"),
                               args=(synthetic_msvd, str(tmp_path), saved_single),
                               timeout_s=RANK_TIMEOUT_S * 3)
    (h0, caps0, p0, ck0, steps0, res0, rsteps0), (h1, caps1, p1, _, _, res1, _) = ranks
    assert h0 == h1 and caps0 == caps1 and res0 == res1
    _close_history(h0, want)
    assert h0["val_score"] == want["val_score"]
    for phase in ("train", "val"):
        assert list(caps0[phase].items()) == list(want_caps[phase].items())
    worst = 0.0
    for a, b, c in zip(*(J.jax.tree.leaves(t) for t in (p0, p1, want_params))):
        np.testing.assert_array_equal(a, b)
        worst = max(worst, float(np.linalg.norm(a - c) / np.linalg.norm(c)))
    assert worst <= 1e-3, worst       # Adam moves near-zero gradients' elements by ~lr

    from mvc_tpu.parallel.smoke import make_smoke_model as jax_smoke

    ckpt = J.jax_load(ck0)
    for s, w in zip(ckpt["opt_state"]["state"].values(), topt.tree_leaves(p0)):
        assert s["mu"].shape == s["nu_max"].shape == np.shape(w)
    jm = jax_smoke(p0["v_decoder"]["out"]["b"].shape[0], 128, 2048)
    restored = J.jax_restore(jm.init(J.jax.random.PRNGKey(0)), ckpt["params"])
    for a, b in zip(J.jax.tree.leaves(restored), J.jax.tree.leaves(p0)):
        np.testing.assert_array_equal(np.asarray(a), b)

    one_from_tp = _fit(synthetic_msvd, str(tmp_path / "one_from_tp"), 3, resume_from=ck0)
    one_from_one = _fit(synthetic_msvd, str(tmp_path / "one_from_one"), 3,
                        resume_from=saved_single)
    assert steps0 == want_steps and len(steps0) == 1
    assert rsteps0 == one_from_tp[4] == one_from_one[4] == [steps0[0] * 3 // 2]
    for got in (one_from_tp[0], res0):      # one more epoch from parameters 1e-4 apart
        _close_history(got, one_from_one[0], rel=1e-5)


CLI_ARGS = ["--data_root", "data", "--epochs", "1", "--batch_size", "16", "--lr", "0.001",
            "--device", "cpu", "--reconstructor", "none"]


def _cli_workdir(synthetic_msvd, workdir):
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    link = os.path.join(workdir, "data", "MSVD")
    if not os.path.exists(link):
        os.symlink(synthetic_msvd, link)
    os.chdir(workdir)


def _rank_cli(rank, world, synthetic_msvd, workdir, extra):
    from mvc_tpu_torch.cli.train import main

    _cli_workdir(synthetic_msvd, os.path.join(workdir, f"rank{rank}"))
    (history,) = main(CLI_ARGS + extra)
    return history, sorted(os.listdir("checkpoints/MSVD")) if rank == 0 else []


@pytest.fixture(scope="module")
def cli_one_process(synthetic_msvd, tmp_path_factory):
    from mvc_tpu_torch.cli.train import main

    cwd, workdir = os.getcwd(), str(tmp_path_factory.mktemp("cli_one"))
    try:
        _cli_workdir(synthetic_msvd, workdir)
        (history,) = main(CLI_ARGS)
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir)          # ~1 GB of reference-width checkpoints
    return history


@pytest.mark.parametrize("extra", [["--tp", "2"], ["--sp", "2"]], ids=["tp", "sp"])
def test_train_cli_over_two_cpu_ranks_equals_one_process(cli_one_process, synthetic_msvd,
                                                        tmp_path, extra):
    """``python -m mvc_tpu_torch.cli.train --tp 2`` (or ``--sp 2``) for one
    epoch at the reference widths on two CPU ranks: both ranks read every
    row, the history is one process's within 1e-6 and the scores are the
    same; only rank 0 writes checkpoints."""
    try:
        (h0, files), (h1, none) = tsmoke.spawn_ranks(
            _rank_cli, 2, str(tmp_path / "rdzv"), args=(synthetic_msvd, str(tmp_path), extra),
            timeout_s=RANK_TIMEOUT_S * 3)
    finally:
        shutil.rmtree(tmp_path / "rank0", ignore_errors=True)     # its checkpoints: ~1 GB
    assert h0 == h1 and files and not none
    _close_history(h0, cli_one_process)
    assert h0["val_score"] == cli_one_process["val_score"]

