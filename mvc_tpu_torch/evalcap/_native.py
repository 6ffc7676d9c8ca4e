"""The native metrics runtime: ``mvc_tpu_torch/csrc/native.cpp`` built with
``g++`` at first use and loaded with ``ctypes``.

The library goes to ``build/mvc_tpu_torch/libnative-<hash>.so`` at the root
of the checkout (``build/`` is git-ignored); the hash covers the source and
the flags, so an edited source is rebuilt and a built one is reused.  When
``g++`` is missing or fails, one ``RuntimeWarning`` says so and the metrics
take their pure-Python paths, which give the same results.
``prepare()`` builds it ahead of the first call (``Trainer`` and
``COCOEvalCap`` call it when they are constructed), ``native_status()``
says which path runs, and ``use_native(False)`` turns the runtime off (for
timing the Python paths).

Words cross as integer ids assigned here, one table per call, so equal ids
mean equal strings.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvc_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall"]
BEAM_WIDTH = 512     # meteor-1.5's Aligner uses 40; wider costs little here

_lock = threading.Lock()
_state: Dict = {"lib": None, "tried": False, "path": None, "error": None, "build_s": None}
_enabled = True

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnative-{h.hexdigest()[:12]}.so"


def _compile(target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{cxx} failed for native.cpp (exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, target)        # atomic: concurrent builds race harmlessly


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_double = ctypes.c_int, ctypes.c_double
    words = [_i32p, _i32p, c_int, _i32p, _i32p, c_int, c_double, c_double,
             _i64p, _i64p, _i64p, _i64p, c_double]
    lib.meteor_stats.argtypes = [*words, c_int, _f64p, c_int, _i32p]
    lib.meteor_align_spans.argtypes = [*words, _i32p, _i32p, _i32p, _i32p, _f64p, c_int,
                                       _i32p, _i32p, _i32p, _i32p, _f64p, c_int]
    lib.lcs.argtypes = [_i32p, c_int, _i32p, c_int]
    lib.ptb_tokenize.argtypes = [ctypes.c_char_p, c_int, _i32p, _i32p, c_int]
    for fn in (lib.meteor_stats, lib.meteor_align_spans, lib.lcs, lib.ptb_tokenize):
        fn.restype = c_int
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The loaded runtime, built first if needed; None when it cannot be
    built (warned once) or is turned off."""
    if not _enabled:
        return None
    if _state["tried"]:
        return _state["lib"]
    with _lock:
        if not _state["tried"]:
            target = _library_path()
            _state["path"] = str(target)
            try:
                if not target.exists():
                    t0 = time.perf_counter()
                    _compile(target)
                    _state["build_s"] = time.perf_counter() - t0
                _state["lib"] = _bind(ctypes.CDLL(str(target)))
            except (OSError, RuntimeError) as e:
                _state["error"] = str(e)
                warnings.warn(f"native metrics runtime unavailable, using the pure-Python "
                              f"paths: {e}", RuntimeWarning)
            _state["tried"] = True
    return _state["lib"]


def prepare() -> Dict:
    """Build and load the runtime now, when it is on, so that the compile
    lands where the scorer is set up and not inside its first metric call;
    returns ``native_status()``."""
    library()
    return native_status()


def available() -> bool:
    return library() is not None


def native_status() -> Dict:
    """{"built": whether the runtime is loaded, "path": its library file (None
    before first use), "error": why it could not be built, "build_s": the
    compile seconds of this process (None when it was already built),
    "enabled": False after ``use_native(False)``}."""
    return {"built": _state["lib"] is not None, "path": _state["path"],
            "error": _state["error"], "build_s": _state["build_s"], "enabled": _enabled}


def use_native(enabled: bool) -> bool:
    """Turn the runtime on or off for this process; returns the old setting."""
    global _enabled
    old, _enabled = _enabled, bool(enabled)
    return old


# ------------------------------------------------------------------ calls
def _ids(seqs: Sequence[Sequence[str]]) -> List[ctypes.Array]:
    """Each sequence as a C int32 array of ids from one shared table."""
    table: Dict[str, int] = {}
    return [(ctypes.c_int32 * len(s))(*[table.setdefault(w, len(table)) for w in s])
            for s in seqs]


def _csr(groups) -> Tuple:
    """Per-word id lists -> (offsets, ids) int64 arrays; (None, None) for None."""
    if groups is None:
        return None, None
    offsets, flat = [0], []
    for g in groups:
        flat.extend(g)
        offsets.append(len(flat))
    return (ctypes.c_int64 * len(offsets))(*offsets), (ctypes.c_int64 * max(len(flat), 1))(*flat)


def _word_args(hyp, ref, hyp_stems, ref_stems, w_exact, w_stem, hyp_syn, ref_syn, w_syn):
    if len(ref) > 64:
        raise ValueError("reference longer than 64 words (mask width); use the Python aligner")
    h, r = _ids([hyp, ref])
    hs, rs = _ids([hyp_stems, ref_stems])
    if hyp_syn is None or ref_syn is None:
        hyp_syn = ref_syn = None
    hso, hsi = _csr(hyp_syn)
    rso, rsi = _csr(ref_syn)
    return [h, hs, len(hyp), r, rs, len(ref), w_exact, w_stem, hso, hsi, rso, rsi, w_syn]


def meteor_stats(hyp, ref, hyp_stems, ref_stems, w_exact=1.0, w_stem=0.6, hyp_syn=None,
                 ref_syn=None, w_syn=0.8, beam=BEAM_WIDTH) -> Tuple[float, int, int]:
    """(weighted, matches, chunks) of the best word alignment; ``hyp_syn`` /
    ``ref_syn``: per-word synonym-group ids, or None without that stage.
    ``weighted`` is Python's ``sum`` of the matches' stage weights in
    hypothesis order, as the Python path forms it."""
    args = _word_args(hyp, ref, hyp_stems, ref_stems, w_exact, w_stem, hyp_syn, ref_syn, w_syn)
    cap = max(len(hyp), 1)
    weights, chunks = (ctypes.c_double * cap)(), ctypes.c_int32()
    n = library().meteor_stats(*args, beam, weights, cap, ctypes.byref(chunks))
    if n < 0:
        raise RuntimeError(f"meteor_stats failed ({n})")
    return sum(weights[:n]), n, chunks.value


def meteor_align_spans(hyp, ref, hyp_stems, ref_stems, w_exact, w_stem, hyp_syn, ref_syn,
                       w_syn, span_cands, beam=BEAM_WIDTH) -> List[Tuple]:
    """The best span matching [(hs, hl, rs, rl, w)]; ``span_cands``: per
    hypothesis start position, the paraphrase spans (hl, rs, rl, w), or None."""
    args = _word_args(hyp, ref, hyp_stems, ref_stems, w_exact, w_stem, hyp_syn, ref_syn, w_syn)
    if span_cands is None:
        spans = [None] * 5
    else:
        flat = [c for row in span_cands for c in row]
        offsets = [0]
        for row in span_cands:
            offsets.append(offsets[-1] + len(row))
        k = max(len(flat), 1)
        spans = [(ctypes.c_int32 * len(offsets))(*offsets),
                 *[(ctypes.c_int32 * k)(*[c[f] for c in flat]) for f in range(3)],
                 (ctypes.c_double * k)(*[c[3] for c in flat])]
    cap = max(len(hyp), 1)          # matches take disjoint hypothesis positions
    out = [(ctypes.c_int32 * cap)() for _ in range(4)] + [(ctypes.c_double * cap)()]
    n = library().meteor_align_spans(*args, *spans, beam, *out, cap)
    if n < 0:
        raise RuntimeError(f"meteor_align_spans failed ({n})")
    return [(out[0][q], out[1][q], out[2][q], out[3][q], out[4][q]) for q in range(n)]


def lcs(a: Sequence[str], b: Sequence[str]) -> int:
    ia, ib = _ids([a, b])
    return library().lcs(ia, len(a), ib, len(b))


def ptb_tokenize(line: str) -> List[str]:
    """PTB tokens of an ASCII line (``tokenizer.ptb_tokenize_line``)."""
    data = line.encode("ascii")
    cap = max(len(data), 1)         # every token holds at least one character
    start, length = (ctypes.c_int32 * cap)(), (ctypes.c_int32 * cap)()
    n = library().ptb_tokenize(data, len(data), start, length, cap)
    if n < 0:
        raise RuntimeError("ptb_tokenize: more tokens than characters")
    low = line.lower()
    return [low[start[q]:start[q] + length[q]] for q in range(n)]
