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
import functools
import threading
from typing import List

import torch

from mvc_tpu_torch.ops import _build
from mvc_tpu_torch.ops._gates import apply_gates

MAX_SMEM_BYTES = 232448          # dynamic shared memory a Hopper block may opt into
                                 # (csrc/decode_common.cuh: SMEM_LIMIT)
NEG = -1e30                      # masked attention energy, as the TPU kernels
MAX_FRAMES_SEARCH = 1 << 16      # max_frames searches T up to here
N_MARKS, TIMER_HEAD = 8, 4       # the greedy kernels' phase timers (csrc/greedy_common.cuh)
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


# ---- the greedy kernels' weight stream (csrc/greedy_common.cuh)
CL, ROWS, NWARPS = 8, 8, 16      # blocks per cluster, rows per cluster, consumer warps
STREAM_RB = 16                   # weight rows per row block (RB)
STAGE_BYTES = 32768              # one ring stage (STAGE_BYTES)
MIN_STAGES, MAX_STAGES = 2, 6    # the ring's stages, within these bounds
CHUNK = 512                      # widest column slice of one matvec (CHUNK)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round(x: int, m: int) -> int:
    return _cdiv(x, m) * m


def stream_dims(H: int, A: int, E: int, F: int, cell: str, factored: bool, V: int) -> dict:
    """One decoder's stream dimensions (``greedy_common.cuh: sdims``): own
    units U, query columns Ac and vocab columns Vc of a block; the padded
    K of h (Hp) and of the step input (Kxp); the padded slice widths of the
    query (ncq) and gates (ncg); the vocab slice in nch chunks of cw
    columns; the resident bias block's width nb."""
    G = 4 if cell == "LSTM" else 3
    U, Ac, Vc = _cdiv(H, CL), _cdiv(A, CL), _cdiv(V, CL)
    nch = _cdiv(Vc, CHUNK)
    cw = _round(_cdiv(Vc, nch), 8)
    ncq, ncg, Ap = _round(Ac, 8), _round(G * U, 8), _round(A, 4)
    return dict(G=G, U=U, Ac=Ac, Vc=Vc, Hp=_round(H, STREAM_RB),
                Kxp=_round(E if factored else E + F, STREAM_RB), ncq=ncq, ncg=ncg, nch=nch,
                cw=cw, Ap=Ap, nb=_round(nch * cw + 2 * ncg + 2 * Ap, 4))


def k_groups(ncp: int) -> int:
    """Warp groups that split K for a slice of ncp columns."""
    return NWARPS // _cdiv(ncp, 32)


def stage_rows(Kp: int, ncp: int, weight_bytes: int) -> int:
    """Weight rows per ring stage of a slice."""
    return min(Kp, STAGE_BYTES // (ncp * weight_bytes) // STREAM_RB * STREAM_RB)


def stream_plan(decoders, V: int, weight_bytes: int):
    """One step of a block's weight stream, in order (the last step takes no
    query): (name, K rows, columns, bytes of each stage).  ``decoders``: dicts with H, A, E, F, cell,
    factored."""
    dims = [stream_dims(d["H"], d["A"], d["E"], d["F"], d["cell"], d["factored"], V)
            for d in decoders]
    segs = []
    for d, s in enumerate(dims):
        segs += [(f"wi{d}", s["Kxp"], s["ncg"]), (f"wh{d}", s["Hp"], s["ncg"])]
    segs += [(f"wout{d}.{c}", s["Hp"], s["cw"]) for c in range(dims[0]["nch"])
             for d, s in enumerate(dims)]
    segs += [(f"query{d}", s["Hp"], s["ncq"]) for d, s in enumerate(dims)]
    plan = []
    for name, Kp, ncp in segs:
        rows = stage_rows(Kp, ncp, weight_bytes)
        plan.append((name, Kp, ncp, [min(rows, Kp - k0) * ncp * weight_bytes
                                     for k0 in range(0, Kp, rows)]))
    return plan


def greedy_layout(decoders, T: int, V: int) -> dict:
    """Python replica of ``greedy_common.cuh: layout``: offsets (floats),
    ring stages and the bytes a block needs (``TOO_LARGE``-like 1 << 40 for
    shapes the kernel cannot take)."""
    S = 1 if len(decoders) == 1 else len(decoders) + 1
    r4 = lambda x: _round(x, 4)
    o, pq, pg, pv, gru, ok, L = 0, 0, 0, 0, False, True, {}
    for d, dec in enumerate(decoders):
        s = stream_dims(dec["H"], dec["A"], dec["E"], dec["F"], dec["cell"], dec["factored"], V)
        ok = ok and s["ncq"] <= CHUNK and s["ncg"] <= CHUNK
        for name, size in (("h", ROWS * s["Hp"]), ("hs", ROWS * s["U"]), ("c", ROWS * s["U"]),
                           ("x", ROWS * s["Kxp"]), ("q", dec["A"]), ("att", ROWS * T),
                           ("ps", ROWS * s["ncg"] if dec["factored"] else 0)):
            L[f"{name}{d}"] = o
            o = r4(o + size)
        L[f"bias{d}"] = o
        o += s["nb"]
        pq = max(pq, k_groups(s["ncq"]) * ROWS * s["ncq"])
        pg = max(pg, k_groups(s["ncg"]) * ROWS * s["ncg"])
        pv = r4(k_groups(s["cw"]) * ROWS * s["cw"])
        gru = gru or dec["cell"] == "GRU"
    L["part"], L["px"], L["pv"] = o, o + r4(pg), max(pv, r4(pq))
    o += max(r4(pg) * (2 if gru else 1), len(decoders) * L["pv"])
    for name, size in (("red_v", NWARPS * S * ROWS), ("red_i", NWARPS * S * ROWS),
                       ("gather_v", CL * S * ROWS), ("gather_i", CL * S * ROWS),
                       ("prev", len(decoders) * ROWS), ("bars", 2 * (MAX_STAGES + 1))):
        L[name] = o
        o = r4(o + size)
    L["ring"] = o = _round(o, 32)
    fixed = 4 * o
    L["stages"] = min(MAX_STAGES, max(MIN_STAGES, (MAX_SMEM_BYTES - fixed) // STAGE_BYTES
                                      if fixed < MAX_SMEM_BYTES else 0))
    L["bytes"] = fixed + L["stages"] * STAGE_BYTES if ok else 1 << 40
    return L


def query_columns(H: int, A: int, E: int, F: int, cell: str, factored: bool, V: int,
                  device="cpu"):
    """[CL, ncq]: the attn_W column of each packed query column (-1: padding)."""
    s = stream_dims(H, A, E, F, cell, factored, V)
    r, j = torch.arange(CL, device=device)[:, None], torch.arange(s["ncq"], device=device)[None, :]
    col = r * s["Ac"] + j
    return torch.where((j < s["Ac"]) & (col < A), col, -1)


def gate_columns(H: int, A: int, E: int, F: int, cell: str, factored: bool, V: int,
                 device="cpu"):
    """[CL, ncg]: the wi/wh column (gate g, unit n: g*H + n) of each packed
    gate column j = g*U + u of rank r (unit n = r*U + u; -1: padding)."""
    s = stream_dims(H, A, E, F, cell, factored, V)
    r, j = torch.arange(CL, device=device)[:, None], torch.arange(s["ncg"], device=device)[None, :]
    g, u = j // s["U"], j % s["U"]
    n = r * s["U"] + u
    return torch.where((j < s["G"] * s["U"]) & (n < H), g * H + n, -1)


def vocab_columns(H: int, A: int, E: int, F: int, cell: str, factored: bool, V: int,
                  device="cpu"):
    """[CL, nch, cw]: the wout column of each packed vocab column (-1:
    padding)."""
    s = stream_dims(H, A, E, F, cell, factored, V)
    r = torch.arange(CL, device=device)[:, None, None]
    c = torch.arange(s["nch"], device=device)[None, :, None]
    j = torch.arange(s["cw"], device=device)[None, None, :]
    k = c * s["cw"] + j
    col = r * s["Vc"] + k
    return torch.where((k < s["Vc"]) & (col < V), col, -1)


def pack_columns(W: torch.Tensor, cols: torch.Tensor, Kp: int) -> torch.Tensor:
    """W [K, N] -> [*cols.shape[:-1], Kp, cols.shape[-1]]: each slice's
    columns (``cols``, -1 = zero padding) as contiguous rows, K padded with
    zero rows to Kp."""
    K, N = W.shape
    Wz = torch.cat([W, W.new_zeros(K, 1)], dim=1)
    out = Wz[:, torch.where(cols < 0, N, cols).reshape(-1)].reshape(K, *cols.shape).movedim(0, -2)
    return torch.nn.functional.pad(out, (0, 0, 0, Kp - K)).contiguous()


def _pad_slices(Wv: torch.Tensor, Kp: int, ncp: int) -> torch.Tensor:
    """A [..., K, n] view of the slices -> contiguous [..., Kp, ncp], zero
    padded: one copy."""
    pad = (0, ncp - Wv.shape[-1], 0, Kp - Wv.shape[-2])
    return (torch.nn.functional.pad(Wv, pad) if any(pad) else Wv).contiguous()


@functools.lru_cache(maxsize=64)
def _stream_columns(dims: tuple, V: int, device: torch.device):
    """The column maps of a decoder's slices on ``device`` (constant for its
    dims): query, gates, vocab, and the gather indices of b_out and of
    b_gates / b_h, where padding takes the index one past the end."""
    qc, gc, vc = (f(*dims, V, device=device) for f in (query_columns, gate_columns, vocab_columns))
    G, H = (4 if dims[4] == "LSTM" else 3), dims[0]
    return (qc, gc, vc, torch.where(vc < 0, V, vc).reshape(CL, -1),
            torch.where(gc < 0, G * H, gc))


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v.new_zeros(1)])[idx]


def stream_operands(p: dict, V: int) -> dict:
    """The weight stream's operands of one prepared decoder (``_prepare``):
    attn_W, wi's step-input rows, wh and wout repacked so that each rank's
    columns are contiguous, and each rank's resident bias block: its b_out,
    b_gates and b_h columns, then attn_b and w_row whole.  Where CL divides
    the columns evenly a slice is a strided view of the weight, copied once
    with its padding; otherwise the columns are gathered by index."""
    dims = (p["H"], p["A"], p["E"], p["F"], p["cell"], p["factored"])
    s = stream_dims(*dims, V)
    qc, gc, vc, out_idx, gate_idx = _stream_columns(dims, V, p["wout"].device)
    H, A, G, U = p["H"], p["A"], s["G"], s["U"]
    Kx = p["E"] if p["factored"] else p["E"] + p["F"]
    wi = p["wi"][:Kx]
    if A == CL * s["Ac"]:
        q = _pad_slices(p["attn_W"].view(H, CL, s["Ac"]).permute(1, 0, 2), s["Hp"], s["ncq"])
    else:
        q = pack_columns(p["attn_W"], qc, s["Hp"])
    if H == CL * U:
        def gates(W, Kp):
            K = W.shape[0]
            return _pad_slices(W.view(K, G, CL, U).permute(2, 0, 1, 3).reshape(CL, K, G * U),
                               Kp, s["ncg"])
    else:
        def gates(W, Kp):
            return pack_columns(W, gc, Kp)
    if V == CL * s["Vc"] and s["nch"] == 1:
        wout = _pad_slices(p["wout"].view(H, CL, 1, s["Vc"]).permute(1, 2, 0, 3), s["Hp"], s["cw"])
    else:
        wout = pack_columns(p["wout"], vc, s["Hp"])
    bias = torch.cat([
        _take(p["b_out"], out_idx), _take(p["b_gates"], gate_idx), _take(p["b_h"], gate_idx),
        *(torch.nn.functional.pad(p[k], (0, s["Ap"] - A)).expand(CL, -1)
          for k in ("attn_b", "w_row"))], dim=1)
    return dict(q=q, wi=gates(wi, s["Kxp"]), wh=gates(p["wh"], s["Hp"]), wout=wout,
                bias=torch.nn.functional.pad(bias, (0, s["nb"] - bias.shape[1])).contiguous())


class StreamArgs(ctypes.Structure):
    """``struct StreamArgs`` of ``csrc/greedy_common.cuh``."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("q", "wi", "wh", "wout", "bias")]


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
        timed = getattr(lib, f"{name}_launch_timed", None)
        if timed is not None:
            timed.argtypes = [ctypes.POINTER(args_type), ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
            timed.restype = ctypes.c_int
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


_LAUNCH_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """``wrapper.launches += 1`` under one lock: the services behind a
    router launch the same kernel from several worker threads at once."""
    with _LAUNCH_COUNT_LOCK:
        wrapper.launches += 1


def launch_timed(name: str, lib, args, weight_dtype, device) -> torch.Tensor:
    """One launch of a greedy kernel's timed instantiation
    (``<name>_launch_timed``); returns its int64 clock record on the card
    (``csrc/greedy_common.cuh``: ``TIMER_HEAD`` wall/clock pairs, then
    ``N_MARKS`` clock64 marks per step).  For measurement only."""
    timer = torch.zeros(TIMER_HEAD + (args.max_len - 1) * N_MARKS, dtype=torch.int64,
                        device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, f"{name}_launch_timed")(ctypes.byref(args),
                                                int(weight_dtype == torch.bfloat16),
                                                timer.data_ptr(), stream)
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} timed kernel launch failed: {msg} ({err})")
    return timer


def max_frames(smem_fn, args, decoder_params, rnn_types, batch: int, *extra: int) -> int:
    """The largest T whose block fits the card's shared memory
    (``MAX_SMEM_BYTES``), asked of the kernel's own ``<name>_smem_bytes``
    at the decoders' widths (F is read from ``wi``) and a batch of
    ``batch`` clips, which sets each decoder's branch (factored or direct)
    at every T; 0 when no T fits.  ``args`` is the kernel's argument block
    with its other fields (V, W, ...) set; only its dims are read."""
    dims = []
    for p, cell in zip(decoder_params, rnn_types):
        E = p["embedding"]["table"].shape[1]
        K, GH = p["rnn"]["wi"].shape
        dims.append((K - E, GH // (4 if cell == "LSTM" else 3), p["attention"]["W"].shape[1], E,
                     CELLS[cell], GH))
    best = 0
    for T in range(1, MAX_FRAMES_SEARCH + 1):
        for a, (F, H, A, E, cell, GH) in zip(args.dec, dims):
            a.F, a.H, a.A, a.E, a.cell = F, H, A, E, cell
            a.factored = int(_use_factored(batch * T, F, GH))
        args.T = T
        if smem_fn(ctypes.byref(args), *extra) > MAX_SMEM_BYTES:
            break
        best = T
    return best


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
    streams = [stream_operands(p, V) for p in prep]
    mask = _mask_f32(feat_mask, B, T, device)
    tokens = torch.empty((B, int(max_caption_len)), dtype=torch.int32, device=device)
    args = args_type()
    for d, (p, st) in enumerate(zip(prep, streams)):
        fill_decoder_args(args.dec[d], p)
        for name, t in st.items():
            setattr(args.st[d], name, t.data_ptr())
    args.mask, args.tokens = mask.data_ptr(), tokens.data_ptr()
    args.B, args.T, args.max_len, args.V, args.sos_id = B, T, int(max_caption_len), V, sos_id
    return args, tokens, (prep, streams, mask)


def greedy_args_type(n_decoders: int):
    """``struct GreedyArgsT<n_decoders>`` of ``csrc/greedy_common.cuh``."""
    return type(f"GreedyArgs{n_decoders}", (ctypes.Structure,), {"_fields_": [
        ("dec", DecoderArgs * n_decoders), ("st", StreamArgs * n_decoders),
        ("mask", ctypes.c_void_p),
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
