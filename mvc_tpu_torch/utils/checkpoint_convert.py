"""Convert a reference torch checkpoint into the port's parameter tree
(``mvc_tpu/utils/checkpoint_convert.py``).

The reference saves ``{epoch, v_decoder, a_decoder, v_reconstructor,
a_reconstructor, history}`` of torch state_dicts.  Layout mapping per
module (weights are stored [in, out] here, [out, in] in torch):

    embedding.weight      [V, E]    -> embedding.table          [V, E]
    attention.W.weight    [A, H]    -> attention.W (transposed) [H, A]
    attention.U.weight    [A, F]    -> attention.U (transposed) [F, A]
    attention.b           [A]       -> attention.b
    attention.w.weight    [1, A]    -> attention.w              [A]
    rnn.weight_ih_l0      [G*H, in] -> rnn.wi (transposed)      [in, G*H]
    rnn.weight_hh_l0      [G*H, H]  -> rnn.wh (transposed)      [H, G*H]
    rnn.bias_ih_l0 / bias_hh_l0     -> rnn.bi / rnn.bh
    out.weight            [V, H]    -> out.w (transposed)       [H, V]
    out.bias              [V]       -> out.b

Reconstructors use the same rnn / attention mappings.  The trees hold
numpy float32 leaves (``utils/jax_weights.from_numpy_tree`` places them).
"""

from __future__ import annotations

import zipfile
from typing import Dict, Optional

import numpy as np


def _arr(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v, np.float32)


def _convert_rnn(sd: Dict, prefix: str) -> Dict:
    return {
        "wi": _arr(sd[f"{prefix}.weight_ih_l0"]).T.copy(),
        "wh": _arr(sd[f"{prefix}.weight_hh_l0"]).T.copy(),
        "bi": _arr(sd[f"{prefix}.bias_ih_l0"]),
        "bh": _arr(sd[f"{prefix}.bias_hh_l0"]),
    }


def _convert_attention(sd: Dict, prefix: str) -> Dict:
    return {
        "W": _arr(sd[f"{prefix}.W.weight"]).T.copy(),
        "U": _arr(sd[f"{prefix}.U.weight"]).T.copy(),
        "b": _arr(sd[f"{prefix}.b"]),
        "w": _arr(sd[f"{prefix}.w.weight"])[0],
    }


def convert_decoder_state_dict(sd: Dict) -> Dict:
    return {
        "embedding": {"table": _arr(sd["embedding.weight"])},
        "attention": _convert_attention(sd, "attention"),
        "rnn": _convert_rnn(sd, "rnn"),
        "out": {"w": _arr(sd["out.weight"]).T.copy(), "b": _arr(sd["out.bias"])},
    }


def convert_reconstructor_state_dict(sd: Optional[Dict]) -> Optional[Dict]:
    if sd is None:
        return None
    out = {"rnn": _convert_rnn(sd, "rnn")}
    if any(k.startswith("attention.") for k in sd):
        out["attention"] = _convert_attention(sd, "attention")
    return out


def convert_reference_checkpoint(path: str) -> Dict:
    """Load a reference ``.ckpt`` (a torch pickle; load only files you
    trust) and return ``{epoch, params, history}`` with the dual model's
    tree layout."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params = {
        "v_decoder": convert_decoder_state_dict(ckpt["v_decoder"]),
        "a_decoder": convert_decoder_state_dict(ckpt["a_decoder"]),
        "v_reconstructor": convert_reconstructor_state_dict(ckpt.get("v_reconstructor")),
        "a_reconstructor": convert_reconstructor_state_dict(ckpt.get("a_reconstructor")),
    }
    return {"epoch": ckpt.get("epoch", 0), "params": params, "history": ckpt.get("history")}


def load_params_checkpoint(path: str) -> Optional[Dict]:
    """A checkpoint of either format: the reference's torch ``.ckpt`` (a zip
    archive, converted) or this package's / the JAX package's pickle.
    Returns the payload with ``params``, or None when the file is absent or
    unreadable."""
    from mvc_tpu_torch.training.checkpoint import load_checkpoint

    if zipfile.is_zipfile(path):
        return convert_reference_checkpoint(path)
    return load_checkpoint(path)
