"""Optimizer and learning-rate schedule (``mvc_tpu/training/optimizer.py``).

The JAX package's chain, ``make_optimizer``: clip each gradient element to
[-gradient_clip_value, gradient_clip_value], add ``weight_decay * p`` to the
gradient, then Adam with AMSGrad as torch does it (the max accumulator
tracks the raw second moment and the bias correction divides the
denominator), scaled by the learning rate.  ``ClippedAdam`` is
``torch.optim.Adam(amsgrad=True, weight_decay=wd)``'s multi-tensor update
after ``clip_grad_value_``, with one change: its bias corrections
1 - b ** step are taken in float32, as the JAX chain takes them.  torch
takes them in float64 (at step 1, 1 - 0.999 is 1.0e-3 there and
0.999987e-3 from float32's 0.999), and its first updates then differ from
the JAX chain's by up to 6e-6 relative, more than the parity test's rtol
of 1e-6.

With ``state_dtype=torch.bfloat16`` (``adam_state_dtype``, PARITY #11)
the three moment trees are stored in bf16: each step upcasts them to
float32, runs the same float32 math (bias corrections included) and
rounds the new moments on store, as the JAX chain's ``state_dtype`` does.

``PlateauScheduler`` is the host-side ReduceLROnPlateau stepped on the
validation CIDEr, with the same ``state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from mvc_tpu_torch.config import TrainerConfig

STATE_FORMAT = "mvc_tpu_torch.adam"


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts (in key order) and lists (None
    skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


MOMENTS = ("mu", "nu", "nu_max")
_STATE_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class ClippedAdam(torch.optim.Optimizer):
    """``make_optimizer``'s chain over a list of tensors, a few multi-tensor
    ops per step.  A leaf without a gradient steps on a zero gradient, as
    the JAX chain updates every leaf.  The learning rate is
    ``param_groups[0]["lr"]``.  ``state_dtype`` (None: the parameter's)
    is the dtype the moments are stored in."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, clip: float = 0.0,
                 amsgrad: bool = True, betas=(0.9, 0.999), eps: float = 1e-8,
                 state_dtype=None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, clip=clip,
                                      amsgrad=amsgrad, betas=betas, eps=eps))
        self.state_dtype = state_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, clip, ps = group["weight_decay"], group["clip"], group["params"]
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if not self.state[p]:
                    self.state[p].update(step=0, **{k: torch.zeros_like(p, dtype=self.state_dtype)
                                                    for k in MOMENTS})
                self.state[p]["step"] += 1
            gs = [p.grad for p in ps]
            stored = [[self.state[p][k] for p in ps] for k in MOMENTS]
            # reduced-precision moments: the math runs on float32 copies
            mus, nus, maxs = ([m.float() for m in ms] if self.state_dtype is not None else ms
                              for ms in stored)
            if clip:
                torch._foreach_clamp_min_(gs, -clip)
                torch._foreach_clamp_max_(gs, clip)
            if wd:
                torch._foreach_add_(gs, ps, alpha=wd)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, gs, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
            count = np.float32(self.state[ps[0]]["step"])
            bc1 = np.float32(1) - np.float32(b1) ** count
            bc2 = np.float32(1) - np.float32(b2) ** count
            if group["amsgrad"]:
                torch._foreach_maximum_(maxs, nus)
                den = torch._foreach_sqrt(maxs)
                torch._foreach_div_(den, float(np.sqrt(bc2)))
            else:
                den = torch._foreach_div(nus, float(bc2))
                torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_addcdiv_(ps, mus, den,
                                    value=-float(np.float32(group["lr"])) / float(bc1))
            if self.state_dtype is not None:          # round on store
                for dst, src in zip(stored, (mus, nus, maxs)):
                    torch._foreach_copy_(dst, src)
        return None

    def moment_bytes(self) -> int:
        """Bytes of the stored moment tensors."""
        return sum(s[k].numel() * s[k].element_size() for s in self.state.values()
                   for k in MOMENTS if k in s)


class Optimizer:
    """The optimizer of a parameter tree: ``ClippedAdam`` over its leaves,
    which it trains in place."""

    def __init__(self, params, cfg: TrainerConfig):
        self.leaves = tree_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        if cfg.adam_state_dtype not in _STATE_DTYPES:
            raise ValueError(f"adam_state_dtype must be None or 'bfloat16', "
                             f"got {cfg.adam_state_dtype!r}")
        # as in the JAX chain, the state dtype applies to the AMSGrad path only
        state_dtype = _STATE_DTYPES[cfg.adam_state_dtype] if cfg.amsgrad else None
        self.inner = ClippedAdam(self.leaves, lr=cfg.lr, weight_decay=cfg.weight_decay or 0.0,
                                 clip=cfg.gradient_clip_value or 0.0, amsgrad=bool(cfg.amsgrad),
                                 state_dtype=state_dtype)

    @property
    def lr(self) -> float:
        return float(self.inner.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = float(value)

    def step(self) -> None:
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The port's own format: the optimizer's state with numpy leaves
        (bf16 moments as their exact float32 values)."""
        sd = self.inner.state_dict()

        def host(v):
            if not isinstance(v, torch.Tensor):
                return v
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()

        state = {i: {k: host(v) for k, v in s.items()} for i, s in sd["state"].items()}
        return {"format": STATE_FORMAT, "state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, d) -> None:
        """Loads ``state_dict``'s format; raises ValueError for another."""
        if not isinstance(d, dict) or d.get("format") != STATE_FORMAT:
            raise ValueError(f"not a {STATE_FORMAT} optimizer state")
        state = {int(i): {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
                          for k, v in s.items()} for i, s in d["state"].items()}
        self.inner.load_state_dict({"state": state, "param_groups": d["param_groups"]})
        sdt = self.inner.state_dtype
        if sdt is not None:                 # torch's loader casts them to the params' dtype
            for s in self.inner.state.values():
                for k in MOMENTS:
                    if k in s:
                        s[k] = s[k].to(sdt)


def make_optimizer(cfg: TrainerConfig, params) -> Optimizer:
    """clip(value) -> + wd * p -> AMSGrad (torch's) or Adam -> lr."""
    return Optimizer(params, cfg)


def get_learning_rate(opt: Optimizer) -> float:
    return opt.lr


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    opt.lr = lr
    return opt


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau: factor 0.5, patience 5, min_lr 1e-7.  ``mode``
    "max" suits CIDEr; "min" reproduces the reference's min-mode scheduler
    stepped on a higher-is-better metric."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-7
    mode: str = "max"
    threshold: float = 1e-4

    def __post_init__(self):
        self.best = None
        self.num_bad = 0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Returns the (possibly decayed) learning rate."""
        if self._improved(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_lr = max(self.lr * self.factor, self.min_lr)
                if new_lr < self.lr:
                    print(f"Plateau: reducing lr {self.lr:.2e} -> {new_lr:.2e}")
                self.lr = new_lr
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]
