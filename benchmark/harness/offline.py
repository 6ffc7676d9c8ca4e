"""Offline scoring of a fixed list of clips (traffic runner ``offline``):
batches in list order through the model's ``predict_tokens``, each copied
to the card from pinned host memory, as a loader with ``pin_memory`` hands
it over, its tokens brought back and turned to text; the window loops over
the list.  The copy is the harness's, not the program's: ``predict_tokens``
takes features on the card.  After the window a sample of the clips drawn from the
seed, the longest among them, is decoded by the plain reference at each
clip's own length, and the share of sampled clips whose served caption
differs from the reference's is compared.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from benchmark.harness import common, counts, traffic
from benchmark.reference import recnet

# candidates whose cumulative scores lie within this many nats go either way
# by rounding (float32 scores of ~60 nats differ by ~1e-5 between the kernel
# and the reference after 31 steps)
TIE_NATS = 5e-5


class Setup:
    """The model, its weights and the list's padded batches in pinned host
    memory, warmed on each batch shape the list has."""

    def __init__(self, config: dict, mix: dict, seed: int, device, fault=None):
        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.phases = common.Phases()
        self.params = common.weights_for(config, seed, self.device)
        self.vocab = common.vocab(config)
        self.calls = common.Calls(common.model(config, self.device), fault=fault)
        self.phases.mark("weights and model")
        n, bs = int(mix["clips"]), int(mix["batch"])
        self.lengths = traffic.sizes(mix["frames"], n, seed, 1)
        self.batches = []                 # (audio, visual, mask, real rows)
        for b, start in enumerate(range(0, n, bs)):
            lens = self.lengths[start:start + bs]
            T = traffic.bucket(int(lens.max()), mix["frame_buckets"])
            padded = np.zeros(bs, dtype=np.int64)
            padded[:len(lens)] = lens
            audio, visual = common.clip_features(config, bs, T, padded, seed, 10 + b,
                                                 self.device)
            mask = np.arange(T)[None, :] < padded[:, None]
            self.batches.append((_host(audio, self.device), _host(visual, self.device),
                                 _host(mask, self.device), len(lens)))
        self.phases.mark("clips")
        warmed = set()
        for k, (audio, visual, mask, _) in enumerate(self.batches):
            if audio.shape[1] not in warmed:
                self.call(k)
                warmed.add(audio.shape[1])
        common.sync(self.device)
        self.phases.mark("warm-up")

    def call(self, k: int) -> List[str]:
        """Batch k through the program: copy, decode, tokens back, text."""
        from mvc_tpu_torch.models.captioning import captions_from_tokens

        audio, visual, mask, rows = self.batches[k]
        dev, mix = self.device, self.mix
        tokens = self.calls.predict_tokens(
            self.params, audio.to(dev), visual.to(dev),
            max_caption_len=mix["max_caption_len"], mode=mix["mode"],
            beam_width=mix["beam_width"], beam_alpha=mix["beam_alpha"],
            feat_mask=mask.to(dev))
        return captions_from_tokens(self.vocab, tokens.cpu()[:rows])

    def clip(self, i: int):
        """Clip i's unpadded (audio, visual) host features."""
        bs = int(self.mix["batch"])
        audio, visual, _, _ = self.batches[i // bs]
        t = int(self.lengths[i])
        return audio[i % bs, :t], visual[i % bs, :t]


def _host(x: np.ndarray, device) -> torch.Tensor:
    """``x`` as a host tensor, pinned where the model is on the card."""
    t = torch.from_numpy(x)
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def drive(setup: Setup, seconds: float, on_window_start=None):
    """Loop over the list's batches until ``seconds`` have passed.  Returns
    (captions completed, elapsed s, the last captions served for each
    batch)."""
    setup.calls.reset()
    served = {}
    done = 0
    if on_window_start is not None:
        on_window_start()
    t0 = time.perf_counter()
    k = 0
    while True:
        caps = setup.call(k)
        served[k] = caps
        done += len(caps)
        k = (k + 1) % len(setup.batches)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return done, elapsed, served


def sample(setup: Setup, served: dict, n_check: int, seed: int) -> List[int]:
    """The clips checked, among those the window answered: the longest and a
    sample drawn from the seed."""
    bs = int(setup.mix["batch"])
    answered = [i for i in range(len(setup.lengths)) if i // bs in served]
    return common.sample(answered, setup.lengths, n_check, seed)


def reference_tokens(setup: Setup, pick: List[int], tf32: bool = False):
    """({clip: reference beam tokens (without the SOS column)}, {clip: its
    search's least margin, ``recnet.beam``}) for the clips ``pick``,
    grouped by length; ``tf32`` is the control's precision."""
    cfg, mix, dev = setup.config, setup.mix, setup.device
    decoders = common.decoder_params(cfg, setup.params)
    out, margins = {}, {}
    for T, idx in recnet.by_length([int(setup.lengths[i]) for i in pick]).items():
        clips = [setup.clip(pick[j]) for j in idx]
        audio = torch.stack([a for a, _ in clips]).to(dev)
        visual = torch.stack([v for _, v in clips]).to(dev)
        with recnet.precision(tf32=tf32):
            tokens, _, margin = recnet.beam(decoders, common.reference_feats(cfg, audio, visual),
                                            mix["beam_width"], mix["max_caption_len"],
                                            mix["beam_alpha"])
        for j, row, m in zip(idx, tokens.cpu().tolist(), margin.cpu().tolist()):
            out[pick[j]] = _until_eos(row[1:])
            margins[pick[j]] = m
    return out, margins


def _until_eos(ids: List[int]) -> List[int]:
    return ids[:ids.index(recnet.EOS_ID)] if recnet.EOS_ID in ids else ids


def differ_share(setup: Setup, served: dict, pick: List[int], want: dict, notes=None) -> float:
    """Share of the clips ``pick`` whose served caption is not the
    reference's; each differing clip is named in ``notes``."""
    bs = int(setup.mix["batch"])
    wrong = 0
    for i in pick:
        caps = served.get(i // bs)
        got = common.text_to_ids(caps[i % bs]) if caps is not None else None
        if got != want[i]:
            wrong += 1
            if notes is not None:
                at = next((j for j, (a, b) in enumerate(zip(got or [], want[i])) if a != b), None)
                notes.append(f"clip {i} (T={int(setup.lengths[i])}) differs from the reference "
                             f"from word {at}: {(got or [])[at:at + 3] if at is not None else got} "
                             f"against {want[i][at:at + 3] if at is not None else want[i]}")
    return wrong / len(pick)


def clip_flops(config: dict, mix: dict, lengths) -> float:
    """Model FLOPs of the given clips at their own lengths."""
    d = common.decs(config)
    steps = int(mix["max_caption_len"]) + 1
    return float(sum(counts.decode_flops(d, int(t), 1, mix["beam_width"], steps)
                     for t in lengths))


def run(ctx) -> "common.Outcome":
    """One run of an ``offline`` cell (``ctx``: see ``run.py``)."""
    mix, cfg = ctx.mix, ctx.config
    setup = Setup(cfg, mix, ctx.seed, ctx.device, fault=ctx.fault)
    prof = ctx.profiler()
    setup_s = time.perf_counter() - ctx.t_start
    done, elapsed, served = drive(setup, ctx.seconds, on_window_start=prof.start if prof else None)
    if prof:
        prof.stop(lambda: common.sync(setup.device))
    memory = ctx.memory_peak()
    calls = list(setup.calls.log)
    setup.calls = None
    pick = sample(setup, served, mix["check_clips"], ctx.seed)
    want, margins = reference_tokens(setup, pick)
    compared = [i for i in pick if margins[i] >= TIE_NATS]
    diffs: List[str] = []
    share = differ_share(setup, served, compared, want, diffs)
    out = common.Outcome(
        setup_s=setup_s, metrics={"captions_per_s": done / elapsed}, attempted=done, failed=0,
        checks=[("clips_differ_share", share, ctx.limits.get("clips_differ_share"))],
        memory_peak_bytes=memory)
    out.notes += [f"{done} captions in {elapsed:.4f} s over {len(calls)} calls; compared "
                  f"{len(compared)} of {len(pick)} clips (the rest pass within {TIE_NATS} nats "
                  f"of a tie)", str(setup.phases)] + diffs
    n_batches, bs = len(setup.batches), int(mix["batch"])
    per_call_flops = [clip_flops(cfg, mix, setup.lengths[b * bs:(b + 1) * bs])
                      for b in range(n_batches)]
    out.layer = {"calls": calls, "window_s": elapsed,
                 "useful_flops": sum(per_call_flops[k % n_batches] for k in range(len(calls)))}
    out.summary = prof.summary() if prof else None
    if ctx.control:
        # the control: the reference in the program's place, in TF32
        control = reference_tokens(setup, pick, tf32=True)[0]
        out.layer["control"] = sum(control[i] != want[i] for i in compared) / len(compared)
        # both readings at other ties, for choosing TIE_NATS (readings.py)
        served = {i: common.text_to_ids(served[i // int(mix["batch"])][i % int(mix["batch"])])
                  for i in pick}
        out.layer["by_tie"] = {
            tie: [sum(got[i] != want[i] for i in ids) / max(len(ids), 1), len(ids)]
            for tie in (0.0, 1e-5, 2e-5, 5e-5, 1e-4)
            for ids in [[i for i in pick if margins[i] >= tie]]
            for got in [served]} | {
            f"control {tie}": [sum(control[i] != want[i] for i in ids) / max(len(ids), 1)]
            for tie in (0.0, 1e-5, 2e-5, 5e-5, 1e-4)
            for ids in [[i for i in pick if margins[i] >= tie]]}
    return out
