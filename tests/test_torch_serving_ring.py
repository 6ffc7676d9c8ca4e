"""The caption service's staging ring: batches packed back to back into a
ring of ``pipeline_depth + 1`` host buffers answer every request as the
request served alone is answered.  On the card the copies are asynchronous,
so a slot refilled while its copy is in flight would hand a batch another
batch's frames; on the CPU the same test holds the packing and the device
pad.  No JAX here: the card runs this file."""

import numpy as np
import pytest
import torch

from mvc_tpu_torch.config import DecoderConfig
from mvc_tpu_torch.data import Vocabulary
from mvc_tpu_torch.models import AVCaptioningDual
from mvc_tpu_torch.serving import CaptionService, ServiceConfig

A_DIM, V_DIM = 8, 16
DEC_V = dict(rnn_type="LSTM", in_feature_size=V_DIM, rnn_hidden_size=16, embedding_size=8,
             attn_size=8)
DEC_A = dict(rnn_type="LSTM", in_feature_size=A_DIM, rnn_hidden_size=12, embedding_size=8,
             attn_size=8)
N_CLIPS = 320


def _service(device, depth):
    vocab = Vocabulary(freq_threshold=1)
    vocab.build_vocabulary(["a man plays a guitar on a stage", "a dog runs on green grass",
                            "someone slices a red tomato with a knife",
                            "two women cook food in a kitchen"])
    model = AVCaptioningDual(vocab_size=len(vocab), reconstructor_type="none", device=device,
                             visual_decoder_config=DecoderConfig(**DEC_V),
                             audio_decoder_config=DecoderConfig(**DEC_A))
    params = model.init(torch.Generator().manual_seed(0))
    cfg = ServiceConfig(max_batch=8, max_wait_ms=2.0, frame_buckets=(4, 8, 16),
                        max_caption_len=8, audio_dim=A_DIM, visual_dim=V_DIM,
                        pipeline_depth=depth)
    return CaptionService(model, params, vocab, cfg, device=device)


def _clips():
    """Distinct clips of 2-24 frames: some above the ladder's top rung, so
    slots grow while batches are in flight."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(N_CLIPS):
        t = int(rng.integers(2, 25))
        out.append(((rng.normal(size=(t, V_DIM)) * 3).astype(np.float32),
                    (rng.normal(size=(t, A_DIM)) * 3).astype(np.float32)))
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def test_back_to_back_batches_caption_each_clip_as_alone(device, depth):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging copies are asynchronous only there")
    clips = _clips()
    with _service(device, depth) as svc:
        alone = [svc.caption(v, a, timeout=120) for v, a in clips]
        assert svc.stats()["batches"] == N_CLIPS
        svc.reset_stats()
        futures = [svc.submit(v, a) for v, a in clips]
        together = [f.result(timeout=300) for f in futures]
        stats = svc.stats()
    print(f"{device} pipeline_depth={depth}: {stats['batches']} batches, "
          f"staging_waits={stats['staging_waits']}, h2d_bytes={stats['h2d_bytes']}")
    assert together == alone
    assert len(set(alone)) >= N_CLIPS // 4           # the captions follow the frames
    assert stats["batches"] < N_CLIPS // 2           # clips shared batches
    assert 0 <= stats["staging_waits"] <= stats["batches"]
    frames = sum(len(v) for v, _ in clips)
    assert stats["h2d_bytes"] == frames * (8 + 4 * (A_DIM + V_DIM))
