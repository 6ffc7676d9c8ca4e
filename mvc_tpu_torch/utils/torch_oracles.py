"""torchvision / torchvggish-layout stand-ins for the pretrained encoders
(``mvc_tpu/utils/torch_oracles.py``, the port's own copy).

The reference builds its encoders from torchvision and torch.hub
(reference src/models/visual_encoder.py:28, src/models/audio_encoder.py:13);
neither is importable without the network.  The functions here build
``nn.Module``s whose state-dict keys and shapes are torchvision's and
torchvggish's, so the converters (``models/inception_v3``, ``models/resnet``
and ``models/vggish``'s ``convert_*``) take ``module.state_dict()`` as they
take a real checkpoint.  ``cli/rehearse_real_data.py`` uses them when no
weight files are mounted; the tests use them as conversion oracles.

- ``build_torch_inception_v3``: torchvision's Inception-v3 (BasicConv2d =
  conv without bias + BatchNorm(eps=1e-3) + relu, Mixed_5b..Mixed_7c),
  aux logits stripped
- ``build_torch_resnet101``: torchvision's resnet101, BatchNorm running
  statistics drawn from ``torch.Generator().manual_seed(0)`` so that the
  BN fold is exercised
- ``build_torch_vggish``: the torchvggish hub model's forward contract
  (waveform and sample rate in, [N, 128] embeddings out) over the AudioSet
  log-mel frontend in numpy (``log_mel_examples_np``)

Each ``build_*`` function takes ``generator``: None keeps torch's default init (the
global RNG); a ``torch.Generator`` draws every weight and bias from it
(convolutions and linears He-normal, biases uniform in +-1/sqrt(fan_in),
BatchNorm scales 1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1)), so a seed gives
the same module on every machine.  The modules are in eval mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _redraw(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Every parameter of ``model`` drawn from ``generator`` (module order)."""
    if generator is None:
        return model.eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * float(np.sqrt(2.0 / fan_in)))
                if m.bias is not None:
                    bound = float(np.sqrt(1.0 / fan_in))
                    m.bias.copy_((torch.rand(m.bias.shape, generator=generator) * 2 - 1) * bound)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=generator))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
    return model.eval()


# --------------------------------------------------------------- inception
class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, bd, bp], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        bp = F.max_pool2d(x, 3, stride=2)
        return torch.cat([b3, b7, bp], 1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(F.avg_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([b1, b3, bd, bp], 1)


class TorchInceptionV3(nn.Module):
    """torchvision's Inception-v3 with ``aux_logits=False``; ``fc`` stays (the
    reference replaces it with an identity, src/models/visual_encoder.py:29)."""

    def __init__(self, transform_input: bool = True):
        super().__init__()
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000)

    def trunk(self, x):
        """[N, 3, H, W] -> [N, 2048] pooled features (before ``fc``)."""
        if self.transform_input:
            x0 = x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5
            x1 = x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5
            x2 = x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5
            x = torch.cat([x0, x1, x2], 1)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        x = self.Mixed_6e(self.Mixed_6d(self.Mixed_6c(self.Mixed_6b(self.Mixed_6a(x)))))
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return F.adaptive_avg_pool2d(x, (1, 1)).flatten(1)

    def forward(self, x):
        return self.fc(self.trunk(x))


def build_torch_inception_v3(transform_input: bool = True,
                             generator: Optional[torch.Generator] = None) -> nn.Module:
    """torchvision's Inception-v3 layout in eval mode (see the module doc
    for ``generator``)."""
    return _redraw(TorchInceptionV3(transform_input), generator)


# ------------------------------------------------------------------ resnet
class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        return self.relu(self.bn3(self.conv3(y)) + identity)


class TorchResNet101(nn.Module):
    """torchvision's resnet101: Bottleneck blocks [3, 4, 23, 3]; the
    reference keeps ``fc`` (1000-d logits, src/models/visual_encoder.py:23-25)."""

    def __init__(self, layers=(3, 4, 23, 3)):
        super().__init__()
        self.inplanes = 64
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = self._make_layer(64, layers[0], 1)
        self.layer2 = self._make_layer(128, layers[1], 2)
        self.layer3 = self._make_layer(256, layers[2], 2)
        self.layer4 = self._make_layer(512, layers[3], 2)
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(512 * 4, 1000)

    def _make_layer(self, planes, blocks, stride):
        downsample = None
        if stride != 1 or self.inplanes != planes * 4:
            downsample = nn.Sequential(
                nn.Conv2d(self.inplanes, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4),
            )
        mods = [Bottleneck(self.inplanes, planes, stride, downsample)]
        self.inplanes = planes * 4
        mods += [Bottleneck(self.inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x).flatten(1))


def build_torch_resnet101(generator: Optional[torch.Generator] = None) -> nn.Module:
    """torchvision's resnet101 layout in eval mode.  Its BatchNorm running
    statistics are drawn from ``torch.Generator().manual_seed(0)`` whatever
    ``generator`` is (a fresh BatchNorm's mean 0 / variance 1 would hide a
    transpose or eps mistake in the fold)."""
    model = _redraw(TorchResNet101(), generator)
    stats = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=stats) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=stats) + 0.5)
    return model


# ------------------------------------------------------------------ vggish
# AudioSet frontend constants (torchvggish mel_features.py defaults).
_SR = 16000
_WIN = int(round(_SR * 0.025))      # 400
_HOP = int(round(_SR * 0.010))      # 160
_NFFT = 512
_NMEL = 64
_FMIN, _FMAX = 125.0, 7500.0
_LOG_OFFSET = 0.01
_EX_FRAMES = 96                      # 0.96 s per example


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_matrix() -> np.ndarray:
    """[_NFFT//2+1, _NMEL] triangular mel weights (AudioSet style)."""
    spec_mel = _hz_to_mel(np.linspace(0.0, _SR / 2.0, _NFFT // 2 + 1))
    edges = np.linspace(_hz_to_mel(_FMIN), _hz_to_mel(_FMAX), _NMEL + 2)
    lo, ctr, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (spec_mel[:, None] - lo[None, :]) / (ctr - lo)[None, :]
    down = (hi[None, :] - spec_mel[:, None]) / (hi - ctr)[None, :]
    w = np.maximum(0.0, np.minimum(up, down))
    w[0] = 0.0                       # the DC bin carries no mel energy
    return w.astype(np.float32)


def log_mel_examples_np(wav: np.ndarray) -> np.ndarray:
    """float32 mono 16 kHz waveform -> [N, 96, 64] log-mel examples, numpy:
    the framing math of ``ops/logmel.py`` (periodic Hann, magnitude
    spectrogram, log(mel + 0.01), non-overlapping 96-frame examples)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if wav.shape[0] < _WIN:
        return np.zeros((0, _EX_FRAMES, _NMEL), np.float32)
    n_frames = 1 + (wav.shape[0] - _WIN) // _HOP
    idx = np.arange(_WIN)[None, :] + _HOP * np.arange(n_frames)[:, None]
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi / _WIN * np.arange(_WIN))).astype(np.float32)
    spec = np.abs(np.fft.rfft(wav[idx] * window, _NFFT, axis=-1)).astype(np.float32)
    mel = np.log(spec @ _mel_matrix() + _LOG_OFFSET)
    n_ex = n_frames // _EX_FRAMES
    return mel[: n_ex * _EX_FRAMES].reshape(n_ex, _EX_FRAMES, _NMEL)


class TorchVGGish(nn.Module):
    """The torchvggish hub model's contract: ``model(waveform, fs)`` ->
    [N, 128] embeddings (frontend, VGG trunk, fc head; the hub model's PCA
    postprocess is left out)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(1, 64, 3, padding=1), nn.ReLU(True), nn.MaxPool2d(2, 2),
            nn.Conv2d(64, 128, 3, padding=1), nn.ReLU(True), nn.MaxPool2d(2, 2),
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(True),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(True), nn.MaxPool2d(2, 2),
            nn.Conv2d(256, 512, 3, padding=1), nn.ReLU(True),
            nn.Conv2d(512, 512, 3, padding=1), nn.ReLU(True), nn.MaxPool2d(2, 2),
        )
        self.embeddings = nn.Sequential(
            nn.Linear(512 * 4 * 6, 4096), nn.ReLU(True),
            nn.Linear(4096, 4096), nn.ReLU(True),
            nn.Linear(4096, 128), nn.ReLU(True),
        )

    def embed(self, examples: torch.Tensor) -> torch.Tensor:
        """[N, 96, 64] log-mel examples -> [N, 128]."""
        f = self.features(examples.unsqueeze(1))
        # torchvggish permutes to NHWC before flattening (vggish.py)
        return self.embeddings(f.permute(0, 2, 3, 1).contiguous().flatten(1))

    def forward(self, audio, fs=_SR):
        wav = np.asarray(audio, np.float32).reshape(-1)
        if fs != _SR:               # naive host resample, like the frontend
            n = int(round(wav.shape[0] * _SR / fs))
            wav = np.interp(np.linspace(0.0, wav.shape[0] - 1.0, n),
                            np.arange(wav.shape[0]), wav).astype(np.float32)
        ex = log_mel_examples_np(wav)
        if ex.shape[0] == 0:
            return torch.zeros((0, 128))
        return self.embed(torch.from_numpy(ex))


def build_torch_vggish(generator: Optional[torch.Generator] = None) -> nn.Module:
    """The torchvggish hub model's layout in eval mode (see the module doc
    for ``generator``)."""
    return _redraw(TorchVGGish(), generator)


def _load_wav(path: str) -> Tuple[np.ndarray, int]:
    """stdlib-wave PCM16 reader -> (float32 [C, n] in [-1, 1], sample_rate)."""
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        raw = w.readframes(w.getnframes())
    data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    return data.reshape(-1, ch).T, sr
