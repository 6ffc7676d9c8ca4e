"""Configuration: the port's own copy of the special ids, the decoder,
reconstructor, trainer and model configs (``mvc_tpu/config.py:24-81,
84-162, 184-195``) and the transformer's (``mvc_tpu/models/transformer.py:32-45``),
with the same default values."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

# Special token ids — identical to the reference Vocabulary.
PAD_ID = 0
SOS_ID = 1
EOS_ID = 2
UNK_ID = 3

AUDIO_FEATURE_DIM = 128    # VGGish embedding size
VISUAL_FEATURE_DIM = 2048  # Inception-v3 pool features


@dataclass(frozen=True)
class DecoderConfig:
    """SoftAttention-LSTM caption decoder configuration."""

    rnn_type: str = "LSTM"            # "LSTM" | "GRU"
    rnn_num_layers: int = 1
    rnn_hidden_size: int = 512
    rnn_dropout: float = 0.0
    in_feature_size: int = VISUAL_FEATURE_DIM + AUDIO_FEATURE_DIM
    embedding_size: int = 300
    attn_size: int = 256
    output_size: int = 1024           # vocab size; overwritten by the model builder

    def replace(self, **kw) -> "DecoderConfig":
        return dataclasses.replace(self, **kw)


# The single-stream model's decoder: [audio | visual] concatenated, F=2176.
SINGLE_DECODER_CONFIG = DecoderConfig()
# The dual model's per-modality decoder configs.
VISUAL_DECODER_CONFIG = DecoderConfig(in_feature_size=VISUAL_FEATURE_DIM)
AUDIO_DECODER_CONFIG = DecoderConfig(in_feature_size=AUDIO_FEATURE_DIM, output_size=512)


@dataclass(frozen=True)
class ReconstructorConfig:
    """RecNet reconstructor configuration.  ``hidden_size`` (the reconstructed
    feature width) and ``decoder_size`` (the decoder's hidden width) are
    overwritten by the model builder."""

    type: str = "global"              # "none" | "global" | "local"
    rnn_type: str = "LSTM"
    rnn_num_layers: int = 1
    hidden_size: int = VISUAL_FEATURE_DIM + AUDIO_FEATURE_DIM
    rnn_dropout: float = 0.5
    decoder_size: int = 512
    attn_size: int = 256              # only used by the local reconstructor

    def replace(self, **kw) -> "ReconstructorConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class TrainerConfig:
    """Training hyperparameters, with the JAX package's defaults
    (``mvc_tpu/config.py:84-162``)."""

    batch_size: int = 128
    epochs: int = 50
    lr: float = 1e-4
    weight_decay: float = 1e-5         # L2 into the gradient, torch-Adam style
    amsgrad: bool = True
    gradient_clip_value: float = 5.0   # element-wise value clip

    # ReduceLROnPlateau, stepped on val CIDEr.  "min" reproduces the
    # reference's min-mode scheduler on a higher-is-better metric.
    lr_decay_gamma: float = 0.5
    lr_decay_patience: int = 5
    min_lr: float = 1e-7
    plateau_mode: str = "max"

    reg_lambda: float = 0.001
    audio_recon_lambda: float = 10.0
    visual_recon_lambda: float = 10.0
    # Entropy over the batch axis, as the reference computes it; False takes
    # the entropy of the word distribution.
    compat_batch_axis_entropy: bool = False

    seed: int = 0
    compute_dtype: str = "float32"     # "float32" | "bfloat16"
    # Features are cast to this dtype on the host before the copy to the
    # card ("int8": quantized per frame, dequantized on the card); None
    # keeps float32.  With the feature cache, the cache's storage dtype.
    transfer_dtype: Optional[str] = "bfloat16"
    # Copy the next batch to the card on a background thread.
    device_prefetch: bool = True
    # Every clip's features on the card once; steps send ids and rows.
    device_feature_cache: bool = False
    frame_buckets: Sequence[int] = (8, 16, 32, 48, 64)
    caption_buckets: Sequence[int] = (12, 16, 20, 26, 34)
    # CE + entropy straight from the decoder hiddens in vocab tiles
    # (training/fused_loss.py); the materializing path is taken under
    # compat_batch_axis_entropy.
    fused_loss: bool = True
    # "bfloat16": store the Adam moments in bf16 (the math stays float32)
    adam_state_dtype: Optional[str] = None
    # Mask attention and the reconstruction losses over padded frames.
    mask_padded_features: bool = True

    # Optional METEOR tables (evalcap/meteor.py).
    meteor_synonyms: Optional[str] = None
    meteor_paraphrases: Optional[str] = None
    meteor_function_words: Optional[str] = None

    eval_max_caption_len: int = 30
    eval_mode: str = "direct"          # "direct" | "beam"
    eval_beam_width: int = 5
    eval_beam_alpha: float = 0.0


@dataclass
class ModelConfig:
    """Top-level model selection."""

    dual: bool = True
    teacher_forcing_ratio: float = 1.0
    reconstructor_type: str = "none"    # "none" | "global" | "local"
    vocab_size: int = 1024              # overwritten once the vocab is built
    max_frames: int = 64
    max_caption_len: int = 34


@dataclass(frozen=True)
class TransformerConfig:
    """The transformer captioner's widths (``models/transformer.py``)."""

    vocab_size: int = 1024
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 2
    d_ff: int = 2048
    visual_dim: int = VISUAL_FEATURE_DIM
    audio_dim: int = AUDIO_FEATURE_DIM
    max_len: int = 3660     # positional-encoding cap: the longest clip and caption

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)
