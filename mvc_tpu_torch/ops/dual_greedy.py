"""Whole dual-decoder greedy decode: the wrapper of ``csrc/dual_greedy.cu``
and its plain PyTorch version.

Port of ``mvc_tpu/ops/pallas_dual_greedy.py:dual_greedy_decode_pallas``.
Each decoder free-runs on its OWN per-step argmax while the reported token
argmaxes the fused logits ``l_v + l_a`` (argmax of the summed log-probs:
the per-row log-sum-exp shift is constant).  Ties go to the lowest index.
Tokens are ``[B, max_caption_len]`` int32 with column 0 = 0, then L-1
steps on a fixed schedule (no early exit).

Outside the kernel, with ``torch.matmul`` as the JAX wrapper leaves it to
XLA: the attention keys ``feats @ U`` and, for a factored decoder, the slab
``P = feats @ wi_ctx`` (``_use_factored``), both rounded to the weight
dtype.  ``dual_greedy_decode`` launches the kernel for CUDA tensors and
takes ``dual_greedy_decode_reference`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from mvc_tpu_torch.config import SOS_ID
from mvc_tpu_torch.ops import _build
from mvc_tpu_torch.ops._gates import apply_gates

MAX_SMEM_BYTES = 232448          # dynamic shared memory a Hopper block may opt into
NEG = -1e30                      # masked attention energy, as the TPU kernel
_CELLS = {"LSTM": 0, "GRU": 1}


def _use_factored(BT: int, F: int, H4: int) -> bool:
    """Factored context-gates (``mvc_tpu/ops/pallas_beam.py:69-81``): context
    enters the cell only through ``context @ wi_ctx`` and is linear in the
    features, so ``P = feats @ wi_ctx`` can be computed once per call and
    each step takes the attention-weighted sum over P.  Worth it when that
    trades FLOPs down: wide features (visual F=2048) yes, narrow ones
    (audio F=128 at serving batch sizes) no."""
    return BT * H4 < BT * F + F * H4


def _prepare(decoder_params, feats_list, weight_dtype, rnn_types) -> List[dict]:
    """Per-decoder operands in the TPU wrapper's layout and rounding points
    (``pallas_dual_greedy.py:369-416``)."""
    wd = weight_dtype
    out = []
    for params, feats, cell in zip(decoder_params, feats_list, rnn_types):
        if cell not in _CELLS:
            raise ValueError(f"rnn type must be LSTM or GRU, got {cell!r}")
        B, T, F = feats.shape
        emb = params["embedding"]["table"]
        E = emb.shape[1]
        ap, rp = params["attention"], params["rnn"]
        wi = rp["wi"]
        H4 = wi.shape[1]
        G = 4 if cell == "LSTM" else 3
        if H4 % G or wi.shape[0] != E + F or rp["wh"].shape != (H4 // G, H4):
            raise ValueError(
                f"{cell} weights wi {tuple(wi.shape)} / wh {tuple(rp['wh'].shape)} do not "
                f"match E={E}, F={F}")
        H = H4 // G
        factored = _use_factored(B * T, F, H4)
        feats_h = feats.to(wd)
        keys = (feats_h @ ap["U"].to(wd)).to(wd)
        slab = (feats_h @ wi[E:].to(wd)).to(wd) if factored else feats_h
        if cell == "LSTM":
            b_gates = (rp["bi"] + rp["bh"]).float()
            b_h = torch.zeros_like(b_gates)
        else:
            b_gates, b_h = rp["bi"].float(), rp["bh"].float()
        out.append(dict(
            slab=slab.contiguous(), keys=keys.contiguous(),
            emb=emb.to(wd).contiguous(), attn_W=ap["W"].to(wd).contiguous(),
            wi=wi.to(wd).contiguous(), wh=rp["wh"].to(wd).contiguous(),
            wout=params["out"]["w"].to(wd).contiguous(),
            attn_b=ap["b"].float().contiguous(), w_row=ap["w"].float().contiguous(),
            b_gates=b_gates.contiguous(), b_h=b_h.contiguous(),
            b_out=params["out"]["b"].float().contiguous(),
            F=F, H=H, A=ap["W"].shape[1], E=E, cell=cell, factored=factored,
        ))
    return out


def _check(decoder_params, feats_list, feat_mask, max_caption_len, weight_dtype, rnn_types):
    if len(decoder_params) != 2 or len(feats_list) != 2 or len(rnn_types) != 2:
        raise ValueError("the dual decode takes exactly two decoders (visual, audio)")
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be torch.float32 or torch.bfloat16, got {weight_dtype}")
    if int(max_caption_len) < 2:
        raise ValueError("max_caption_len must be >= 2")
    B, T = feats_list[0].shape[:2]
    for f in feats_list:
        if f.dim() != 3 or tuple(f.shape[:2]) != (B, T):
            raise ValueError(f"feats must be [B={B}, T={T}, F], got {tuple(f.shape)}")
    if B < 1 or T < 1:
        raise ValueError(f"empty batch or clip: B={B}, T={T}")
    if feat_mask is not None and tuple(feat_mask.shape) != (B, T):
        raise ValueError(f"feat_mask must be [B={B}, T={T}], got {tuple(feat_mask.shape)}")
    V = decoder_params[0]["embedding"]["table"].shape[0]
    for p in decoder_params:
        if p["embedding"]["table"].shape[0] != V or p["out"]["w"].shape[1] != V:
            raise ValueError("both decoders must share the vocabulary")
    return B, T, V


def _mask_f32(feat_mask, B, T, device):
    if feat_mask is None:
        return torch.ones((B, T), dtype=torch.float32, device=device)
    return feat_mask.to(torch.float32).contiguous()


def dual_greedy_decode_reference(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic, rounding
    points and tie-break, step by step with whole-batch tensor ops."""
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len,
                     weight_dtype, rnn_types)
    device = feats_list[0].device
    wd = weight_dtype
    prep = _prepare(decoder_params, feats_list, wd, rnn_types)
    mask = _mask_f32(feat_mask, B, T, device) > 0
    hs = [torch.zeros((B, p["H"]), dtype=torch.float32, device=device) for p in prep]
    cs = [torch.zeros_like(h) for h in hs]
    prevs = [torch.full((B,), sos_id, dtype=torch.long, device=device) for _ in prep]
    tokens = torch.zeros((B, int(max_caption_len)), dtype=torch.int32, device=device)

    def rnd(x):                         # value once stored in the weight dtype
        return x.to(wd).float()

    for step in range(int(max_caption_len) - 1):
        xs, ctxgs = [], []
        for d, p in enumerate(prep):
            embedded = p["emb"][prevs[d]].float()
            q = rnd(hs[d]) @ p["attn_W"].float() + p["attn_b"]
            energies = (torch.tanh(p["keys"].float() + q[:, None, :]) * p["w_row"]).sum(-1)
            energies = torch.where(mask, energies, torch.full_like(energies, NEG))
            m = energies.amax(dim=1, keepdim=True)
            m = torch.where(m > NEG / 2, m, torch.zeros_like(m))
            unnorm = torch.where(mask, torch.exp(energies - m), torch.zeros_like(energies))
            weights = unnorm / torch.clamp(unnorm.sum(dim=1, keepdim=True), min=1e-30)
            wsum = torch.einsum("bt,bts->bs", weights, p["slab"].float())
            if p["factored"]:
                ctxgs.append(wsum)
                xs.append(embedded)
            else:
                ctxgs.append(None)
                xs.append(torch.cat([embedded, rnd(wsum)], dim=1))
        for d, p in enumerate(prep):
            x = xs[d]
            gv = x @ p["wi"][: x.shape[1]].float() + p["b_gates"]
            if p["factored"]:
                gv = gv + ctxgs[d]
            gh = rnd(hs[d]) @ p["wh"].float() + p["b_h"]
            if p["cell"] == "LSTM":
                gv = gv + gh
            hs[d], c = apply_gates(p["cell"], gv, gh, hs[d], cs[d])
            if c is not None:
                cs[d] = c
        fused = torch.zeros((B, V), dtype=torch.float32, device=device)
        for d, p in enumerate(prep):
            logits = rnd(hs[d]) @ p["wout"].float() + p["b_out"]
            fused = fused + logits
            prevs[d] = torch.argmax(logits, dim=1)      # first maximum = lowest index
        tokens[:, step + 1] = torch.argmax(fused, dim=1).to(torch.int32)
    return tokens


class _DecoderArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "slab", "keys", "emb", "attn_W", "wi", "wh", "wout",
        "attn_b", "w_row", "b_gates", "b_h", "b_out")] + [
        (n, ctypes.c_int) for n in ("F", "H", "A", "E", "cell", "factored")]


class _DualGreedyArgs(ctypes.Structure):
    _fields_ = [("dec", _DecoderArgs * 2), ("mask", ctypes.c_void_p),
                ("tokens", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("B", "T", "max_len", "V", "sos_id")]


def _library():
    lib = _build.load("dual_greedy")
    if not getattr(lib, "_mvc_bound", False):
        lib.dual_greedy_smem_bytes.argtypes = [ctypes.POINTER(_DualGreedyArgs)]
        lib.dual_greedy_smem_bytes.restype = ctypes.c_size_t
        lib.dual_greedy_launch.argtypes = [ctypes.POINTER(_DualGreedyArgs), ctypes.c_int,
                                           ctypes.c_void_p]
        lib.dual_greedy_launch.restype = ctypes.c_int
        lib.dual_greedy_error_string.argtypes = [ctypes.c_int]
        lib.dual_greedy_error_string.restype = ctypes.c_char_p
        lib._mvc_bound = True
    return lib


def _kernel_args(prep, mask, tokens, B, T, V, max_caption_len, sos_id) -> _DualGreedyArgs:
    args = _DualGreedyArgs()
    for d, p in enumerate(prep):
        a = args.dec[d]
        for name in ("slab", "keys", "emb", "attn_W", "wi", "wh", "wout",
                     "attn_b", "w_row", "b_gates", "b_h", "b_out"):
            setattr(a, name, p[name].data_ptr())
        a.F, a.H, a.A, a.E = p["F"], p["H"], p["A"], p["E"]
        a.cell, a.factored = _CELLS[p["cell"]], int(p["factored"])
    args.mask, args.tokens = mask.data_ptr(), tokens.data_ptr()
    args.B, args.T, args.max_len, args.V, args.sos_id = B, T, int(max_caption_len), V, sos_id
    return args


def _launch(args: _DualGreedyArgs, weight_dtype, device) -> None:
    """One kernel launch on the current stream of ``device``; raises if the
    launch is refused.  The tensors behind ``args`` must outlive the call's
    enqueue (PyTorch's allocator orders their reuse on the same stream)."""
    lib = _library()
    smem = lib.dual_greedy_smem_bytes(ctypes.byref(args))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"T={args.T} frames needs {smem} bytes of shared memory per block at these "
            f"widths; the kernel's limit is {MAX_SMEM_BYTES} (cut the clip or split it)")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.dual_greedy_launch(ctypes.byref(args), int(weight_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dual_greedy kernel launch failed: "
                           f"{lib.dual_greedy_error_string(err).decode()} ({err})")
    dual_greedy_decode.launches += 1


def prepare_kernel_call(decoder_params, feats_list, feat_mask=None, max_caption_len=30,
                        weight_dtype=torch.float32, rnn_types=("LSTM", "LSTM"),
                        sos_id: int = SOS_ID):
    """Checks and the work outside the kernel for CUDA tensors.  Returns
    (args, tokens, keepalive): ``_launch(args, ...)`` fills ``tokens``;
    ``keepalive`` holds the operand tensors ``args`` points into."""
    device = feats_list[0].device
    if device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {device}")
    B, T, V = _check(decoder_params, feats_list, feat_mask, max_caption_len,
                     weight_dtype, rnn_types)
    tensors = [feats_list[1]] + ([feat_mask] if feat_mask is not None else [])
    tensors += [leaf for p in decoder_params for sub in p.values() for leaf in sub.values()]
    if any(t.device != device for t in tensors):
        raise ValueError(f"every feature, mask and weight tensor must be on {device}")
    prep = _prepare(decoder_params, feats_list, weight_dtype, rnn_types)
    mask = _mask_f32(feat_mask, B, T, device)
    tokens = torch.empty((B, int(max_caption_len)), dtype=torch.int32, device=device)
    args = _kernel_args(prep, mask, tokens, B, T, V, max_caption_len, sos_id)
    return args, tokens, (prep, mask)


def dual_greedy_decode(
    decoder_params: Sequence[dict],
    feats_list: Sequence[torch.Tensor],
    feat_mask: Optional[torch.Tensor] = None,
    max_caption_len: int = 30,
    weight_dtype=torch.float32,
    rnn_types: Sequence[str] = ("LSTM", "LSTM"),
    sos_id: int = SOS_ID,
) -> torch.Tensor:
    """Dual direct-mode greedy decode -> int32 tokens [B, max_caption_len].

    ``decoder_params``: [visual, audio] decoder trees (JAX layout);
    ``feats_list``: [[B, T, Fv], [B, T, Fa]]; ``feat_mask``: [B, T] bool.
    CUDA tensors launch the kernel on the current stream (asynchronously;
    ``dual_greedy_decode.launches`` counts launches, from one thread at a
    time); CPU tensors take the plain version.  Anything the kernel cannot
    take raises, including a clip longer than the shared memory of a block
    holds: at the serving widths (H=512, A=256, V=4000) the kernel takes
    T <= 839 frames and raises ValueError above (the plain version has no
    limit)."""
    device = feats_list[0].device
    if device.type == "cpu":
        return dual_greedy_decode_reference(decoder_params, feats_list, feat_mask,
                                            max_caption_len, weight_dtype, rnn_types, sos_id)
    args, tokens, _keepalive = prepare_kernel_call(decoder_params, feats_list, feat_mask,
                                                   max_caption_len, weight_dtype,
                                                   rnn_types, sos_id)
    _launch(args, weight_dtype, device)
    return tokens


dual_greedy_decode.launches = 0
