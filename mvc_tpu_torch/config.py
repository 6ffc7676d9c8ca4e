"""Decoder configuration: the port's own copy of the special ids, the single
model's decoder config and the dual model's per-modality decoder configs
(``mvc_tpu/config.py:24-59``), with the same default values."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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
