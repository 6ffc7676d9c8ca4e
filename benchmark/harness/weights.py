"""A configuration's parameters, made on the card from the seed in two
generator calls (one uniform draw, one normal draw over flat buffers),
in float32, with the layout the program and the reference both take:
per decoder ``embedding.table [V, E]``, ``attention.{W [H, A], U [F, A],
b [A], w [A]}``, ``rnn.{wi [E+F, 4H], wh [H, 4H], bi, bh}``,
``out.{w [H, V], b [V]}``.

Scales follow torch's layer defaults (a linear layer U(+-1/sqrt(fan_in)),
an LSTM U(+-1/sqrt(hidden)), an embedding N(0, 1), the attention bias
ones).  The vocabulary biases are spread (a seeded permutation times
``spread``) with EOS ``eos_below`` under the largest, below every other
word, so no pick is a near-tie and every caption runs its full length.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

EOS_ID = 1 + 1


def _decoder_leaves(F, E, H, A, V) -> List[Tuple[Tuple[str, str], tuple, str, float]]:
    GH = 4 * H
    return [
        (("embedding", "table"), (V, E), "normal", 1.0),
        (("attention", "W"), (H, A), "uniform", 1 / math.sqrt(H)),
        (("attention", "U"), (F, A), "uniform", 1 / math.sqrt(F)),
        (("attention", "b"), (A,), "ones", 1.0),
        (("attention", "w"), (A,), "uniform", 1 / math.sqrt(A)),
        (("rnn", "wi"), (E + F, GH), "uniform", 1 / math.sqrt(H)),
        (("rnn", "wh"), (H, GH), "uniform", 1 / math.sqrt(H)),
        (("rnn", "bi"), (GH,), "uniform", 1 / math.sqrt(H)),
        (("rnn", "bh"), (GH,), "uniform", 1 / math.sqrt(H)),
        (("out", "w"), (H, V), "uniform", 1 / math.sqrt(H)),
        (("out", "b"), (V,), "uniform", 1 / math.sqrt(H)),
    ]


def layout(config: dict) -> Dict[str, list]:
    """{tree name: leaves} of a configuration's decoders, each with its
    feature width ``F``."""
    E, H, A, V = (config[k] for k in ("embedding_size", "hidden_size", "attn_size",
                                      "vocab_size"))
    trees = {}
    for name, F in config["decoders"].items():
        trees[name] = _decoder_leaves(F, E, H, A, V)
    return trees


def make(config: dict, seed: int, device, spread: float = 2e-3,
         eos_below: float = -10.0) -> Dict[str, dict]:
    """The parameter trees of ``config`` on ``device`` from ``seed``."""
    trees = layout(config)
    leaves = [leaf for t in trees.values() for leaf in t]
    count = {k: sum(math.prod(s) for _, s, kind, _ in leaves if kind == k)
             for k in ("uniform", "normal")}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = {"uniform": torch.empty(count["uniform"], device=device).uniform_(-1, 1,
                                                                             generator=gen),
            "normal": torch.empty(count["normal"], device=device).normal_(generator=gen)}
    offset = {"uniform": 0, "normal": 0}
    V = config["vocab_size"]
    perm = torch.randperm(V, generator=gen, device=device).float() * spread
    perm[EOS_ID] = perm.max() + eos_below
    out: Dict[str, dict] = {}
    for name, tree in trees.items():
        params: Dict[str, dict] = {}
        for (group, leaf), shape, kind, scale in tree:
            if kind == "ones":
                x = torch.ones(shape, device=device)
            else:
                n = math.prod(shape)
                x = flat[kind][offset[kind]:offset[kind] + n].view(shape)
                offset[kind] += n
                if scale != 1.0:
                    x.mul_(scale)
            params.setdefault(group, {})[leaf] = x
        params["out"]["b"] = params["out"]["b"] + perm
        out[name] = params
    return out
