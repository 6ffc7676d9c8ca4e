"""What the whole-decode kernels share: the operands' preparation, input
checks, the ``ctypes`` view of one decoder's operands, the plain version
of one step of every decoder's attention and cell, and, for the two
greedy kernels (``greedy.cu``, ``dual_greedy.cu``: one step loop over 1 or
2 decoders in ``csrc/greedy_common.cuh``), their plain version and
argument block.

Outside the kernels, with ``torch.matmul`` as the JAX wrappers leave it to
XLA: the attention keys ``feats @ U`` and, for a factored decoder, the slab
``P = feats @ wi_ctx`` (``_use_factored``), both rounded to the weight
dtype (``mvc_tpu/ops/pallas_dual_greedy.py:369-416``,
``mvc_tpu/ops/pallas_beam.py:694-729``).
"""

from __future__ import annotations

import ctypes
from typing import List

import torch

from mvc_tpu_torch.ops import _build
from mvc_tpu_torch.ops._gates import apply_gates

MAX_SMEM_BYTES = 232448          # dynamic shared memory a Hopper block may opt into
                                 # (csrc/decode_common.cuh: SMEM_LIMIT)
NEG = -1e30                      # masked attention energy, as the TPU kernels
CELLS = {"LSTM": 0, "GRU": 1}


def _use_factored(BT: int, F: int, H4: int) -> bool:
    """Factored context-gates (``mvc_tpu/ops/pallas_beam.py:69-81``): context
    enters the cell only through ``context @ wi_ctx`` and is linear in the
    features, so ``P = feats @ wi_ctx`` can be computed once per call and
    each step takes the attention-weighted sum over P.  Worth it when that
    trades FLOPs down: wide features (visual F=2048) yes, narrow ones
    (audio F=128 at serving batch sizes) no."""
    return BT * H4 < BT * F + F * H4


def _prepare(decoder_params, feats_list, weight_dtype, rnn_types) -> List[dict]:
    """Per-decoder operands in the TPU wrappers' layout and rounding points."""
    wd = weight_dtype
    out = []
    for params, feats, cell in zip(decoder_params, feats_list, rnn_types):
        if cell not in CELLS:
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


def _check(decoder_params, feats_list, feat_mask, weight_dtype, rnn_types, n_decoders):
    """Shapes, dtypes and decoder count (one of ``n_decoders``); returns
    (B, T, V)."""
    n = len(decoder_params)
    if n not in n_decoders or len(feats_list) != n or len(rnn_types) != n:
        raise ValueError(f"the decode takes {' or '.join(map(str, n_decoders))} decoder(s) "
                         f"with one feature tensor and rnn type each, got {n}")
    if weight_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weight_dtype must be torch.float32 or torch.bfloat16, got {weight_dtype}")
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
            raise ValueError("the decoders must share the vocabulary")
    return B, T, V


def _check_devices(decoder_params, feats_list, feat_mask):
    """The kernels take CUDA tensors, all on one device; returns it."""
    device = feats_list[0].device
    if device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {device}")
    tensors = list(feats_list) + ([feat_mask] if feat_mask is not None else [])
    tensors += [leaf for p in decoder_params for sub in p.values() for leaf in sub.values()]
    if any(t.device != device for t in tensors):
        raise ValueError(f"every feature, mask and weight tensor must be on {device}")
    return device


def _mask_f32(feat_mask, B, T, device):
    if feat_mask is None:
        return torch.ones((B, T), dtype=torch.float32, device=device)
    return feat_mask.to(torch.float32).contiguous()


class DecoderArgs(ctypes.Structure):
    """``struct DecoderArgs`` of ``csrc/decode_common.cuh``."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "slab", "keys", "emb", "attn_W", "wi", "wh", "wout",
        "attn_b", "w_row", "b_gates", "b_h", "b_out")] + [
        (n, ctypes.c_int) for n in ("F", "H", "A", "E", "cell", "factored")]


def fill_decoder_args(a: DecoderArgs, p: dict) -> None:
    for name in ("slab", "keys", "emb", "attn_W", "wi", "wh", "wout",
                 "attn_b", "w_row", "b_gates", "b_h", "b_out"):
        setattr(a, name, p[name].data_ptr())
    a.F, a.H, a.A, a.E = p["F"], p["H"], p["A"], p["E"]
    a.cell, a.factored = CELLS[p["cell"]], int(p["factored"])


def library(name: str, args_type, n_extra: int = 0):
    """The loaded ``csrc/<name>.cu`` with its three C functions typed:
    ``<name>_smem_bytes(args, *extra)``, ``<name>_launch(args, weight_bf16,
    *extra, stream)`` and ``<name>_error_string``; ``extra`` is ``n_extra``
    C ints (the beam kernel's row tile)."""
    lib = _build.load(name)
    if not getattr(lib, "_mvc_bound", False):
        extra = [ctypes.c_int] * n_extra
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.POINTER(args_type)] + extra, ctypes.c_size_t
        launch_fn = getattr(lib, f"{name}_launch")
        launch_fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_int] + extra + [ctypes.c_void_p]
        launch_fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        lib._mvc_bound = True
    return lib


def launch(name: str, lib, args, weight_dtype, device, *extra: int) -> None:
    """One launch of ``csrc/<name>.cu`` on the current stream of ``device``
    (``extra``: the C ints ``library`` typed); raises ValueError when a
    block would need more shared memory than the card gives one,
    RuntimeError when the launch is refused."""
    smem = getattr(lib, f"{name}_smem_bytes")(ctypes.byref(args), *extra)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"T={args.T} frames needs {smem} bytes of shared memory per block at these "
            f"widths; the kernel's limit is {MAX_SMEM_BYTES} (cut the clip or split it)")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"{name}_launch")(ctypes.byref(args),
                                          int(weight_dtype == torch.bfloat16), *extra, stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def check_greedy(decoder_params, feats_list, feat_mask, max_caption_len, weight_dtype,
                 rnn_types, n_decoders: int):
    """The greedy decodes' checks; returns (B, T, V)."""
    if int(max_caption_len) < 2:
        raise ValueError("max_caption_len must be >= 2")
    return _check(decoder_params, feats_list, feat_mask, weight_dtype, rnn_types, (n_decoders,))


def greedy_reference(decoder_params, feats_list, feat_mask, max_caption_len, weight_dtype,
                     rnn_types, sos_id, n_decoders: int) -> torch.Tensor:
    """Plain version of the free-running greedy kernels (``csrc/greedy.cu``,
    ``csrc/dual_greedy.cu``): the same arithmetic, rounding points and
    tie-break, step by step with whole-batch tensor ops.  Each decoder
    embeds its OWN previous argmax; the token is the argmax of the
    decoders' summed logits (one decoder: its own argmax), lowest index on
    ties.  Returns int32 [B, max_caption_len], column 0 = 0."""
    B, T, V = check_greedy(decoder_params, feats_list, feat_mask, max_caption_len,
                           weight_dtype, rnn_types, n_decoders)
    device = feats_list[0].device
    wd = weight_dtype
    prep = _prepare(decoder_params, feats_list, wd, rnn_types)
    mask = _mask_f32(feat_mask, B, T, device) > 0
    hs = [torch.zeros((B, p["H"]), dtype=torch.float32, device=device) for p in prep]
    cs = [torch.zeros_like(h) for h in hs]
    prevs = [torch.full((B,), sos_id, dtype=torch.long, device=device) for _ in prep]
    tokens = torch.zeros((B, int(max_caption_len)), dtype=torch.int32, device=device)
    for step in range(int(max_caption_len) - 1):
        hs, cs = step_cells(prep, mask, hs, cs, prevs, wd)
        fused = None
        for d, p in enumerate(prep):
            logits = hs[d].to(wd).float() @ p["wout"].float() + p["b_out"]
            fused = logits if fused is None else fused + logits
            prevs[d] = torch.argmax(logits, dim=1)      # first maximum = lowest index
        tokens[:, step + 1] = torch.argmax(fused, dim=1).to(torch.int32)
    return tokens


def greedy_kernel_call(args_type, decoder_params, feats_list, feat_mask, max_caption_len,
                       weight_dtype, rnn_types, sos_id, n_decoders: int):
    """Checks and the work outside a greedy kernel for CUDA tensors.
    Returns (args, tokens, keepalive): launching ``args`` fills ``tokens``;
    ``keepalive`` holds the operand tensors ``args`` points into."""
    device = _check_devices(decoder_params, feats_list, feat_mask)
    B, T, V = check_greedy(decoder_params, feats_list, feat_mask, max_caption_len,
                           weight_dtype, rnn_types, n_decoders)
    prep = _prepare(decoder_params, feats_list, weight_dtype, rnn_types)
    mask = _mask_f32(feat_mask, B, T, device)
    tokens = torch.empty((B, int(max_caption_len)), dtype=torch.int32, device=device)
    args = args_type()
    for d, p in enumerate(prep):
        fill_decoder_args(args.dec[d], p)
    args.mask, args.tokens = mask.data_ptr(), tokens.data_ptr()
    args.B, args.T, args.max_len, args.V, args.sos_id = B, T, int(max_caption_len), V, sos_id
    return args, tokens, (prep, mask)


def greedy_args_type(n_decoders: int):
    """``struct GreedyArgsT<n_decoders>`` of ``csrc/greedy_common.cuh``."""
    return type(f"GreedyArgs{n_decoders}", (ctypes.Structure,), {"_fields_": [
        ("dec", DecoderArgs * n_decoders), ("mask", ctypes.c_void_p),
        ("tokens", ctypes.c_void_p)] + [
        (n, ctypes.c_int) for n in ("B", "T", "max_len", "V", "sos_id")]})


def step_cells(prep, mask, hs, cs, prevs, weight_dtype, rows_per_clip: int = 1):
    """One step of every decoder's attention and cell with the kernels'
    arithmetic and rounding points: decoder d embeds ``prevs[d]`` [R], and
    its state row r reads clip ``r // rows_per_clip`` (a beam search keeps
    ``rows_per_clip = W`` rows per clip).  ``mask`` is [B, T] bool.
    Returns the new (hs, cs); a GRU's c stays None."""
    wd = weight_dtype

    def rnd(x):                         # value once stored in the weight dtype
        return x.to(wd).float()

    W = rows_per_clip
    B, T = mask.shape
    xs, ctxgs = [], []
    for d, p in enumerate(prep):
        embedded = p["emb"][prevs[d]].float()
        q = rnd(hs[d]) @ p["attn_W"].float() + p["attn_b"]                   # [R, A]
        keys = p["keys"].float()[:, None]                                    # [B, 1, T, A]
        energies = (torch.tanh(keys + q.view(B, W, 1, -1)) * p["w_row"]).sum(-1)
        mrows = mask[:, None, :].expand(B, W, T)
        energies = torch.where(mrows, energies, torch.full_like(energies, NEG))
        m = energies.amax(dim=2, keepdim=True)
        m = torch.where(m > NEG / 2, m, torch.zeros_like(m))
        unnorm = torch.where(mrows, torch.exp(energies - m), torch.zeros_like(energies))
        weights = unnorm / torch.clamp(unnorm.sum(dim=2, keepdim=True), min=1e-30)
        wsum = torch.einsum("bwt,bts->bws", weights, p["slab"].float()).reshape(B * W, -1)
        if p["factored"]:
            ctxgs.append(wsum)
            xs.append(embedded)
        else:
            ctxgs.append(None)
            xs.append(torch.cat([embedded, rnd(wsum)], dim=1))
    new_hs, new_cs = [], []
    for d, p in enumerate(prep):
        x = xs[d]
        gv = x @ p["wi"][: x.shape[1]].float() + p["b_gates"]
        if p["factored"]:
            gv = gv + ctxgs[d]
        gh = rnd(hs[d]) @ p["wh"].float() + p["b_h"]
        if p["cell"] == "LSTM":
            gv = gv + gh
        h, c = apply_gates(p["cell"], gv, gh, hs[d], cs[d])
        new_hs.append(h)
        new_cs.append(c)
    return new_hs, new_cs
