"""The port's transformer captioner on a (dp, tp, sp) mesh
(``mvc_tpu_torch/models/transformer.py``'s ``shards``, ``parallel/mesh.py``
over the layer lists, ``collectives.gather_frames``, ``Trainer(mesh=)``
and ``cli.train --model transformer --tp``) against the JAX package on the
CPU.

The JAX layout (``mvc_tpu/parallel/mesh.py:param_shardings``) slices only
``embedding/table`` over tp: the layer lists and the generator are
replicated.  Each mesh shape is one module-scoped spawn of gloo ranks, as
in ``tests/test_torch_tensor_parallel.py``, whose tolerances hold here too
(loss rtol 2e-5, atol 1e-6; parameters rtol 2e-4, atol 1e-6), against the
JAX single-device step; that JAX's own GSPMD step on (2, 2, 2) equals that
step is checked first.  A small transformer: d_model 16, 2 heads, d_ff 32,
2 layers, V=23, so tp=2 slices the embedding 12 + 11.
"""

from __future__ import annotations

import functools
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mvc_tpu_torch.config import TrainerConfig, TransformerConfig
from mvc_tpu_torch.parallel import gather_params, param_specs, shard_params
from mvc_tpu_torch.parallel import mesh as tmesh
from mvc_tpu_torch.parallel import smoke as tsmoke
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX package, imported on first use: the spawned ranks import
    this module for their functions and need none of it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
    from mvc_tpu.models.transformer import TransformerCaptioning as JaxTransformer
    from mvc_tpu.models.transformer import TransformerConfig as JaxTConfig
    from mvc_tpu.parallel import make_mesh as jax_make_mesh
    from mvc_tpu.parallel import param_shardings
    from mvc_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
    from mvc_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from mvc_tpu.training import optimizer as jopt
    from mvc_tpu.training.checkpoint import load_checkpoint as jax_load
    from mvc_tpu.training.checkpoint import restore_params_like as jax_restore
    from mvc_tpu.training.trainer import Trainer as JaxTrainer

    return SimpleNamespace(**{k: v for k, v in locals().items()})


class _LazyJax:
    def __getattr__(self, name):
        return getattr(_jax(), name)


J = _LazyJax()
RANK_TIMEOUT_S = 120.0
B, T, L, V, AD, VD = 5, 6, 7, 23, 5, 9
SMALL = dict(d_model=16, num_heads=2, num_layers=2, d_ff=32, max_len=64)
STEP_TOL = dict(loss=dict(rtol=2e-5, atol=1e-6), params=dict(rtol=2e-4, atol=1e-6))
LOSS_KEYS = ("total", "ce", "e", "a_recon", "v_recon")


def _port_model(vocab_size=V, a_dim=AD, v_dim=VD):
    from mvc_tpu_torch.models import TransformerCaptioning

    return TransformerCaptioning(vocab_size, TransformerConfig(visual_dim=v_dim, audio_dim=a_dim,
                                                               **SMALL), device="cpu")


def _jax_model(vocab_size=V, a_dim=AD, v_dim=VD):
    return J.JaxTransformer(vocab_size, J.JaxTConfig(visual_dim=v_dim, audio_dim=a_dim, **SMALL))


def _batch(t=T, seed=11, vocab_size=V):
    """B=5 clips of ``t`` frames and PAD tails of unequal length.  At sp=2
    and t=6: row 1's mask edge falls inside the second frame block, row 2
    has no real frame in the second block and row 4 none in the first; row
    3 has no frame at all (uniform attention over every frame)."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(3, vocab_size, size=(L, B)).astype(np.int32)
    caps[0] = 1
    caps[5:, 1] = 0
    caps[4:, 3] = 0
    feat_mask = np.ones((B, t), bool)
    feat_mask[1, 4:] = False
    feat_mask[2, 3:] = False
    feat_mask[3, :] = False
    feat_mask[4, :3] = False
    return {"audio": rng.normal(size=(B, t, AD)).astype(np.float32),
            "visual": rng.normal(size=(B, t, VD)).astype(np.float32),
            "captions": caps, "feat_mask": feat_mask, "sample_mask": np.ones((B,), bool)}


def _rows(batch, d, dp):
    """Data-parallel index ``d``'s rows of a batch whose rows divide dp."""
    n = batch["audio"].shape[0] // dp
    sl = slice(d * n, (d + 1) * n)
    return {k: torch.from_numpy(np.ascontiguousarray(v[:, sl] if k == "captions" else v[sl]))
            for k, v in batch.items()}


def _leaf_paths(tree, prefix=""):
    """(path, leaf) in ``tree_leaves`` order, through dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaf_paths(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


# ------------------------------------------------------------------ ranks
SHAPES = {"tp2": (1, 2, 1), "sp2": (1, 1, 2), "dp2tp2sp2": (2, 2, 2)}
CASES = {  # name -> (batch-axis entropy, T)
    "tp2": {"frames": (False, T)},
    "sp2": {"frames": (False, T), "t_not_divisible": (False, 5)},
    "dp2tp2sp2": {"frames": (False, T), "t_not_divisible": (False, 5),
                  "batch_axis_entropy": (True, T)},
}


def _rank_steps(rank, world, shape, cases, params, extra):
    """One rank of a (dp, tp, sp) mesh: the trainer's step for each case
    on the rank's rows and, inside the step, frames; returns its metrics,
    the parameters gathered whole and its own slices."""
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    mesh = make_global_mesh(*shape)
    out = {"coords": mesh.coords()}
    for name, (compat, batch) in cases.items():
        cfg = TrainerConfig(batch_size=B, compat_batch_axis_entropy=compat)
        step, _ = Trainer("unused.ckpt", log_dir=None, mesh=mesh)._build_train_step(
            _port_model(), cfg)
        p = shard_params(mesh, from_numpy_tree(params))
        opt = topt.make_optimizer(cfg, p)
        p, metrics = step(p, opt, _rows(batch, mesh.coords()[0], shape[0]), None)
        out[name] = (metrics.numpy(), to_numpy_tree(gather_params(mesh, p, V)),
                     to_numpy_tree(p), tmesh.sharded_leaves(mesh, p))
    for name, fn in extra.items():
        out[name] = fn(mesh, params)
    return out


def _round_trip(mesh, params):
    """tp: ``gather_params`` of ``shard_params`` and the rank's slices."""
    tree = from_numpy_tree(params)
    sliced = shard_params(mesh, tree)
    return to_numpy_tree(gather_params(mesh, sliced, V)), to_numpy_tree(sliced)


def _encoder_blocks(mesh, params):
    """sp: the encoder over this rank's block of the frames (its memories,
    before the decoder's gather) and the key mask over every frame."""
    model = _port_model()
    shards = mesh.shards(V, True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    a, v, mask = model._encode(from_numpy_tree(params), shards.own_frames(batch["audio"]),
                               shards.own_frames(batch["visual"]),
                               shards.own_frames(batch["feat_mask"]), shards)
    return {"a": a.numpy(), "v": v.numpy(), "mask": mask.numpy()}


@functools.lru_cache(maxsize=None)
def _step_params():
    return J.jax.tree.map(np.asarray, _jax_model().init(J.jax.random.PRNGKey(0)))


def _case_batch(shape, t):
    batch = _batch(t)
    return J.jax_pad(batch, 2) if shape[0] == 2 else batch


EXTRA = {"tp2": {"round_trip": _round_trip}, "sp2": {"encoder": _encoder_blocks},
         "dp2tp2sp2": {}}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """name -> the ranks' results, one spawn per mesh shape, made when a
    test first asks for its shape."""
    runs = {}

    def get(name):
        if name not in runs:
            shape = SHAPES[name]
            cases = {c: (compat, _case_batch(shape, t)) for c, (compat, t) in CASES[name].items()}
            runs[name] = tsmoke.spawn_ranks(
                _rank_steps, int(np.prod(shape)), str(tmp_path_factory.mktemp(f"rdzv_{name}")),
                args=(shape, cases, _step_params(), EXTRA[name]), timeout_s=RANK_TIMEOUT_S)
        return runs[name]

    return get


# ------------------------------------------------------------------ the layout
def test_param_specs_equal_jax_param_shardings_leaf_by_leaf():
    """JAX's ``param_shardings`` gives each layer list one replicated
    sharding as a prefix; expanded to the leaves it equals ``param_specs``,
    whose leaves line up with ``tree_leaves(params)``: only
    ``embedding/table`` is ``("tp", None)``."""
    params = _step_params()
    shardings = J.param_shardings(J.jax_make_mesh(dp=4, tp=2), params)

    def expand(sh, tree, prefix=""):
        if isinstance(sh, dict):
            return {p: s for k in sh for p, s in expand(sh[k], tree[k], f"{prefix}/{k}").items()}
        assert isinstance(sh, J.NamedSharding), prefix
        return {p: tuple(sh.spec) for p, _ in _leaf_paths(tree, prefix)}

    want = expand(shardings, params)
    assert all(isinstance(shardings[k], J.NamedSharding)
               for k in ("v_encoder", "a_encoder", "v_decoder", "a_decoder"))
    port = _port_model().init(torch.Generator().manual_seed(0))
    specs = param_specs(port)
    got = dict(_leaf_paths(specs))
    assert got == want
    assert {p for p, s in got.items() if s} == {"/embedding/table"}
    assert want["/embedding/table"] == ("tp", None)
    assert want["/v_decoder/0/ffn/out/w"] == want["/generator/w"] == ()
    leaves = topt.tree_leaves(port)
    assert len(topt.tree_leaves(specs)) == len(leaves) > 100
    assert [p for p, _ in _leaf_paths(specs)] == [p for p, _ in _leaf_paths(port)]
    mesh = tmesh.Mesh({"dp": 1, "tp": 2}, [torch.device("cpu")], rank=1, world_size=2)
    flags = tmesh.sharded_leaves(mesh, port)
    assert len(flags) == len(leaves) and sum(flags) == 1
    assert leaves[flags.index(True)] is port["embedding"]["table"]


def test_shard_then_gather_is_the_identity(mesh_runs):
    whole = _step_params()
    ranks = [r["round_trip"] for r in mesh_runs("tp2")]
    for gathered, sliced in ranks:
        for (pa, a), (pb, b) in zip(_leaf_paths(whole), _leaf_paths(gathered)):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
        for (path, a), (_, b) in zip(_leaf_paths(whole), _leaf_paths(sliced)):
            if path != "/embedding/table":
                np.testing.assert_array_equal(a, b)
    t0, t1 = (s["embedding"]["table"] for _, s in ranks)
    assert (t0.shape[0], t1.shape[0]) == (12, 11)
    np.testing.assert_array_equal(np.concatenate([t0, t1]), whole["embedding"]["table"])


def test_sp_encoder_with_the_offset_encoding_equals_the_whole_frame_encoder(mesh_runs):
    """sp=2: each rank's encoder over its own block of the frames, at its
    offset into the positional encoding and with keys over every frame,
    equals that block of the whole-frame encoder's memories (the port's
    and JAX's ``_encode``); its key mask is the whole one."""
    batch = _batch()
    a, v, mask = _port_model()._encode(from_numpy_tree(_step_params()),
                                       *(torch.from_numpy(batch[k])
                                         for k in ("audio", "visual", "feat_mask")))
    jp = J.jax.tree.map(J.jnp.asarray, _step_params())
    ja, jv, _ = _jax_model()._encode(jp, *(J.jnp.asarray(batch[k])
                                           for k in ("audio", "visual", "feat_mask")))
    t = T // 2
    for s, r in enumerate(mesh_runs("sp2")):
        block = slice(s * t, (s + 1) * t)
        for got, whole, jwhole in ((r["encoder"]["a"], a, ja), (r["encoder"]["v"], v, jv)):
            np.testing.assert_allclose(got, whole.numpy()[:, block], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, np.asarray(jwhole)[:, block], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["encoder"]["mask"], mask.numpy())
    # the offset matters: the second block at pe[:t] is another encoder
    assert not np.allclose(mesh_runs("sp2")[1]["encoder"]["v"], v.numpy()[:, :t], atol=1e-3)


# ------------------------------------------------------------------ the train step
@functools.lru_cache(maxsize=None)
def _jax_train_step(compat):
    """(trainer, jitted step) of the JAX package, one per entropy setting."""
    jcfg = J.JaxTrainerConfig(batch_size=B, compat_batch_axis_entropy=compat)
    tr = J.JaxTrainer("unused", log_dir=None)
    tr._optimizer = J.jopt.make_optimizer(jcfg)
    return tr, tr._build_train_step(_jax_model(), jcfg)[0]


@functools.lru_cache(maxsize=None)
def _jax_step(compat, t, padded):
    """The JAX single-device step's metrics and parameters over ``_batch(t)``
    (padded for dp=2 when ``padded``)."""
    tr, jstep = _jax_train_step(compat)
    batch = J.jax_pad(_batch(t), 2) if padded else _batch(t)
    jparams = J.jax.tree.map(J.jnp.asarray, _step_params())
    new, _, metrics = jstep(jparams, tr._optimizer.init(jparams),
                            {k: J.jnp.asarray(v) for k, v in batch.items()},
                            J.jax.random.PRNGKey(3))
    return [float(metrics[k]) for k in LOSS_KEYS], J.jax.tree.map(np.asarray, new)


def test_jax_gspmd_step_on_a_2x2x2_mesh_equals_its_single_device_step():
    """The oracle premise: JAX's own trainer step of the transformer at
    V=24, its parameters placed by ``param_shardings`` and the batch by
    ``shard_batch`` (frames over sp) on the (2, 2, 2) CPU mesh, equals its
    single-device step."""
    jm = _jax_model(vocab_size=24)
    params = jm.init(J.jax.random.PRNGKey(0))
    batch = J.jax_pad(_batch(vocab_size=24), 2)
    jcfg = J.JaxTrainerConfig(batch_size=B)
    tr = J.JaxTrainer("unused", log_dir=None)
    tr._optimizer = J.jopt.make_optimizer(jcfg)
    step, _ = tr._build_train_step(jm, jcfg)
    key = J.jax.random.PRNGKey(3)
    ref_params, _, ref_metrics = step(params, tr._optimizer.init(params),
                                      {k: J.jnp.asarray(v) for k, v in batch.items()}, key)
    mesh = J.jax_make_mesh(dp=2, tp=2, sp=2)
    params = jm.init(J.jax.random.PRNGKey(0))
    placed = J.jax.device_put(params, J.param_shardings(mesh, params))
    assert len(placed["embedding"]["table"].addressable_shards[0].data) == 12
    got_params, _, got_metrics = step(placed, tr._optimizer.init(placed),
                                      J.jax_shard_batch(mesh, batch), key)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(np.asarray(got_metrics[k]), np.asarray(ref_metrics[k]),
                                   **STEP_TOL["loss"])
    for a, b in zip(J.jax.tree.leaves(got_params), J.jax.tree.leaves(ref_params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **STEP_TOL["params"])


@pytest.mark.parametrize("mesh_name,case", [(m, c) for m in SHAPES for c in CASES[m]])
def test_train_step_equals_the_jax_single_device_step(mesh_runs, mesh_name, case):
    """The trainer's step of the transformer on every rank of the mesh: the
    metrics summed over the ranks equal the JAX single-device step's over
    the whole batch (the padded one for the batch-axis entropy, whose
    softmax takes every row), and so do the updated parameters, gathered;
    replicated parameters and the slices of one tp index are equal bit for
    bit across the ranks.  The batch holds a row with no real frame in one
    sp block and a row with no frame at all; at dp=2 it is padded."""
    shape = SHAPES[mesh_name]
    compat, t = CASES[mesh_name][case]
    want_metrics, want_params = _jax_step(compat, t, compat and shape[0] == 2)
    ranks = mesh_runs(mesh_name)
    metrics, whole, own, flags = zip(*(r[case] for r in ranks))
    for m in metrics:
        np.testing.assert_array_equal(m, metrics[0])
        np.testing.assert_allclose(m, want_metrics, **STEP_TOL["loss"])
    leaves = [x for _, x in _leaf_paths(whole[0])]
    want = dict(_leaf_paths(want_params))
    for path, g in _leaf_paths(whole[0]):
        np.testing.assert_allclose(g, want[path], **STEP_TOL["params"], err_msg=path)
    for r, x in zip(ranks, own):
        peer = next(o for q, o in zip(ranks, own) if q["coords"][1] == r["coords"][1])
        for (_, a), (_, b) in zip(_leaf_paths(x), _leaf_paths(peer)):
            np.testing.assert_array_equal(a, b)
    for x in whole:
        for (_, a), b in zip(_leaf_paths(x), leaves):
            np.testing.assert_array_equal(a, b)
    assert all(sum(f) == (1 if shape[1] > 1 else 0) for f in flags)


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
    n = len(train.dataset.vocab)
    model = _port_model(n, 128, 2048)
    init = model.init(torch.Generator().manual_seed(0))
    # spread generator biases keep the eval's argmaxes clear of near-ties
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n).astype(np.float32))
    init["generator"]["b"] += perm * 2e-3
    cfg = TrainerConfig(batch_size=8, epochs=epochs, lr=1e-3, frame_buckets=(4, 8),
                        caption_buckets=(8, 12), eval_max_caption_len=10, reg_lambda=5e-4)
    trainer = Trainer(os.path.join(ck, "m.ckpt"), log_dir=None, eval_freq=2,
                      mesh=make_global_mesh(tp=tp) if tp > 1 else None)
    caps = {}
    inner = trainer.eval

    def keep(*a, **k):
        out = inner(*a, **k)
        caps[a[3]] = out[2]
        return out

    trainer.eval = keep
    params, opt, history = trainer.fit(model, init, train, val, val, cfg)
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


def test_tp_fit_equals_the_one_process_fit_and_checkpoints_cross_meshes(synthetic_msvd,
                                                                      tmp_path):
    """A 2-epoch ``Trainer.fit`` of the transformer over 2 tp ranks against
    one process's fit of the same batches: the history within 1e-6, the
    same scores and gathered captions, each whole leaf within 1e-3 in norm.
    Its checkpoint holds whole parameters and moments: the JAX package
    loads it, and one process resumes it for a third epoch, as 2 tp ranks
    resume the one process's checkpoint; the third epochs agree within
    1e-5."""
    want, want_caps, want_params, single_ckpt, want_steps = _fit(synthetic_msvd,
                                                                 str(tmp_path / "one"), 2)
    saved_single = str(tmp_path / "single.ckpt")
    shutil.copy(single_ckpt, saved_single)
    ranks = tsmoke.spawn_ranks(_rank_fit, 2, str(tmp_path / "rdzv"),
                               args=(synthetic_msvd, str(tmp_path), saved_single),
                               timeout_s=RANK_TIMEOUT_S * 2)
    (h0, caps0, p0, ck0, steps0, res0, rsteps0), (h1, caps1, p1, _, _, res1, _) = ranks
    assert h0 == h1 and caps0 == caps1 and res0 == res1
    _close_history(h0, want)
    assert h0["val_score"] == want["val_score"]
    for phase in ("train", "val"):
        assert list(caps0[phase].items()) == list(want_caps[phase].items())
    worst = 0.0
    for (_, a), (_, b), (_, c) in zip(*(_leaf_paths(t) for t in (p0, p1, want_params))):
        np.testing.assert_array_equal(a, b)
        worst = max(worst, float(np.linalg.norm(a - c) / np.linalg.norm(c)))
    assert worst <= 1e-3, worst

    ckpt = J.jax_load(ck0)
    for s, (_, w) in zip(ckpt["opt_state"]["state"].values(), _leaf_paths(p0)):
        assert s["mu"].shape == s["nu_max"].shape == np.shape(w)
    jm = _jax_model(p0["generator"]["b"].shape[0], 128, 2048)
    restored = dict(_leaf_paths(J.jax.tree.map(
        np.asarray, J.jax_restore(jm.init(J.jax.random.PRNGKey(0)), ckpt["params"]))))
    assert len(restored) == len(_leaf_paths(p0))
    for path, b in _leaf_paths(p0):
        np.testing.assert_array_equal(restored[path], b)

    one_from_tp = _fit(synthetic_msvd, str(tmp_path / "one_from_tp"), 3, resume_from=ck0)
    one_from_one = _fit(synthetic_msvd, str(tmp_path / "one_from_one"), 3,
                        resume_from=saved_single)
    assert steps0 == want_steps and len(steps0) == 1
    assert rsteps0 == one_from_tp[4] == one_from_one[4] == [steps0[0] * 3 // 2]
    for got in (one_from_tp[0], res0):
        _close_history(got, one_from_one[0], rel=1e-5)


CLI_ARGS = ["--data_root", "data", "--epochs", "1", "--batch_size", "16", "--lr", "0.001",
            "--device", "cpu", "--reconstructor", "none", "--model", "transformer"]


def _cli_workdir(synthetic_msvd, workdir):
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    link = os.path.join(workdir, "data", "MSVD")
    if not os.path.exists(link):
        os.symlink(synthetic_msvd, link)
    os.chdir(workdir)


def _rank_cli(rank, world, synthetic_msvd, workdir):
    from mvc_tpu_torch.cli.train import main

    _cli_workdir(synthetic_msvd, os.path.join(workdir, f"rank{rank}"))
    (history,) = main(CLI_ARGS + ["--tp", "2"])
    return history, sorted(os.listdir("checkpoints/MSVD")) if rank == 0 else []


def test_train_cli_transformer_over_two_tp_ranks_equals_one_process(synthetic_msvd, tmp_path):
    """``python -m mvc_tpu_torch.cli.train --model transformer --tp 2`` for
    one epoch at ``TransformerConfig``'s widths on two CPU ranks: both
    ranks read every row, the history is one process's within 1e-6 and the
    scores are the same; only rank 0 writes checkpoints."""
    from mvc_tpu_torch.cli.train import main

    cwd = os.getcwd()
    try:
        _cli_workdir(synthetic_msvd, str(tmp_path / "one"))
        (want,) = main(CLI_ARGS)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp_path / "one", ignore_errors=True)
    try:
        (h0, files), (h1, none) = tsmoke.spawn_ranks(
            _rank_cli, 2, str(tmp_path / "rdzv"), args=(synthetic_msvd, str(tmp_path)),
            timeout_s=RANK_TIMEOUT_S * 2)
    finally:
        shutil.rmtree(tmp_path / "rank0", ignore_errors=True)
    assert h0 == h1 and files and not none
    assert any(f.startswith("transformer_1_epochs_custom_none") for f in files)
    _close_history(h0, want)
    assert h0["val_score"] == want["val_score"]
