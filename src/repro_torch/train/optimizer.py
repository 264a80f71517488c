"""AdamW with f32 or blockwise-int8 optimizer state, global-norm
clipping and a warmup + cosine schedule: the port of
``repro.train.optimizer``.

Trees are nested dicts of tensors under the parameter tree's keys.  The
update runs under ``torch.no_grad()`` and writes parameters and moments
in place; as in the reference there is no f32 master copy: each
parameter is updated through its f32 view and written back in its own
dtype.

``state_dtype`` picks the moments, as in the reference:
- ``float32``: f32 m and v;
- ``int8``: m and v each as ``{"q", "scale"}``, int8 codes with one f32
  scale per row of the last axis (8-bit Adam), dequantized on use and
  requantized after the update;
- ``int8_factored``: int8 m and, for a leaf of two or more dims, an
  Adafactor-style ``{"vr", "vc"}`` second moment (the mean of g² over the
  last axis and over the second last).

Big leaves are updated in views of at most ``CHUNK_ELEMS`` elements.  The
f32 and int8 updates are row-local, so any cut of rows gives the bits of
the whole leaf's.  The factored second moment spans every row of a
matrix: it is cut along leading axes only (the reference's ``lax.map``),
and a matrix too big for whole-matrix f32 temporaries is read twice in
row blocks, once to sum g² over its columns and once to update.  Its
means are sums in another order than XLA's, so ``vr``, ``vc`` and what
follows from them agree with the reference to rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

# A leaf above this many elements is updated in views of at most this
# many (0.5 GB of f32 per temporary): a layer-stacked weight one
# leading-axis slice at a time, as the reference's ``upd_leaf`` maps over
# it, and further down the stack (Grok-1's experts, (L, 8, 6144, 32768),
# per expert), a matrix (an embedding, one expert) in blocks of rows.
CHUNK_ELEMS = 1 << 27
QUANTIZED = ("int8", "int8_factored")
STATE_DTYPES = ("float32",) + QUANTIZED


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # float32       : f32 m and v (classic AdamW)
    # int8          : blockwise-int8 m and v (8-bit Adam)
    # int8_factored : int8 m + Adafactor-style factored v (row/col moments)
    state_dtype: str = "float32"


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    decay to ``min_lr_ratio * peak_lr``; f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio
                                 + (1 - cfg.min_lr_ratio) * cos)


# ---------------------------------------------------------------------------
# int8 blockwise quantization (per-row scale over the last axis)
# ---------------------------------------------------------------------------

def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device: PyTorch's CUDA kernel
    multiplies by ``1 / c`` when ``c`` is a Python number, which may lose
    a bit; a divisor tensor on ``x``'s device is divided by."""
    return x / x.new_full((), c)


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """f32 ``x`` -> ``{"q": int8, "scale": f32}``, the reference's rule:
    ``scale = max(amax, 1e-12) / 127`` over the last axis, ``q =
    round_half_even(x / scale)`` clipped to +-127 (a 0-d ``x`` is its own
    row and is not clipped)."""
    if x.dim() == 0:
        scale = divide(torch.clamp(x.abs(), min=1e-12), 127.0)
        return {"q": torch.round(x / scale).to(torch.int8), "scale": scale}
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = divide(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.float()}


def _dequantize(qs: Dict[str, torch.Tensor]) -> torch.Tensor:
    return qs["q"].float() * qs["scale"]


def _is_vfactor(x) -> bool:
    return isinstance(x, dict) and set(x) == {"vr", "vc"}


def _factorable(shape) -> bool:
    return len(shape) >= 2


def _check_state_dtype(cfg: OptimizerConfig) -> None:
    if cfg.state_dtype not in STATE_DTYPES:
        raise ValueError(f"optimizer state_dtype={cfg.state_dtype!r} is not "
                         f"one of {STATE_DTYPES}")


# ---------------------------------------------------------------------------
# Views of big leaves
# ---------------------------------------------------------------------------

def _index(shape) -> List[tuple]:
    """Indices of views of a leaf of ``shape``, each of at most
    ``CHUNK_ELEMS`` elements: the leaf whole, or cut down its leading axes
    to matrices, and a matrix into blocks of rows (a single row, or a
    vector, stays whole).  The same index cuts a per-row tensor
    (``scale``, ``vr``: ``shape[:-1] + (1,)``) along the same rows."""
    if math.prod(shape) <= CHUNK_ELEMS or len(shape) < 2:
        return [()]
    if len(shape) == 2:
        rows = max(1, CHUNK_ELEMS // shape[1])
        return [(slice(r, r + rows),) for r in range(0, shape[0], rows)]
    return [(i,) + rest for i in range(shape[0]) for rest in _index(shape[1:])]


def _lead_index(shape) -> List[tuple]:
    """Indices that cut a leaf of ``shape`` along its leading axes only,
    down to views of at most ``CHUNK_ELEMS`` elements or to a matrix."""
    if math.prod(shape) <= CHUNK_ELEMS or len(shape) <= 2:
        return [()]
    return [(i,) + rest for i in range(shape[0])
            for rest in _lead_index(shape[1:])]


def _parts(t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` as the views ``_index`` cuts it into."""
    return [t[i] for i in _index(t.shape)]


def _at(x: Any, i: tuple) -> Any:
    """The view ``i`` of a tensor or of each tensor of a moment's dict."""
    if isinstance(x, dict):
        return {k: v[i] for k, v in x.items()}
    return x[i]


def _leaves_like(tree: Any, like: Any) -> list:
    """``tree``'s subtrees at the leaves of ``like`` (the reference's
    ``flatten_up_to``): a quantized moment comes as its dict."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _leaves_like(tree[k], like[k])]
    return [tree]


# ---------------------------------------------------------------------------
# Init / abstract state
# ---------------------------------------------------------------------------

def _zero_q(shape, device) -> Dict[str, torch.Tensor]:
    """``_quantize`` of f32 zeros of ``shape``, without the f32 zeros."""
    scale = _quantize(torch.zeros((), device=device))["scale"]
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "scale": scale.expand(tuple(shape[:-1]) + (1,) if shape else ())
            .clone()}


def adamw_init(params: Any, cfg: OptimizerConfig) -> Dict:
    """Zero moments shaped like ``params`` as ``cfg.state_dtype`` says, and
    ``step`` a 0-d int32 tensor, all on the parameters' device."""
    _check_state_dtype(cfg)
    quant_m = cfg.state_dtype in QUANTIZED

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def make_m(p):
        return _zero_q(p.shape, p.device) if quant_m else zeros(p)

    def make_v(p):
        if cfg.state_dtype == "int8":
            return _zero_q(p.shape, p.device)
        if cfg.state_dtype == "int8_factored" and _factorable(p.shape):
            return {"vr": torch.zeros(p.shape[:-1] + (1,), device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + (1, p.shape[-1]),
                                      device=p.device)}
        return zeros(p)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(make_m, params), "v": tree_map(make_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_opt_state(abstract_params: Any, cfg: OptimizerConfig) -> Dict:
    """``adamw_init``'s tree as tensors on the ``meta`` device (shapes and
    dtypes, no storage): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree."""
    _check_state_dtype(cfg)

    def q_spec(p):
        scale_shape = tuple(p.shape[:-1]) + (1,) if p.dim() else ()
        return {"q": _meta(p.shape, torch.int8),
                "scale": _meta(scale_shape, torch.float32)}

    def one_m(p):
        if cfg.state_dtype in QUANTIZED:
            return q_spec(p)
        return _meta(p.shape, torch.float32)

    def one_v(p):
        if cfg.state_dtype == "int8":
            return q_spec(p)
        if cfg.state_dtype == "int8_factored" and _factorable(p.shape):
            return {"vr": _meta(tuple(p.shape[:-1]) + (1,), torch.float32),
                    "vc": _meta(tuple(p.shape[:-2]) + (1, p.shape[-1]),
                                torch.float32)}
        return _meta(p.shape, torch.float32)

    return {"m": tree_map(one_m, abstract_params),
            "v": tree_map(one_v, abstract_params),
            "step": _meta((), torch.int32)}


def opt_state_logical_axes(param_axes: Any, cfg: OptimizerConfig) -> Dict:
    """The logical-axis tuples of ``adamw_init``'s tree, from the
    parameters' (``model.param_logical_axes()``)."""
    _check_state_dtype(cfg)

    def one_m(axes):
        if cfg.state_dtype in QUANTIZED:
            scale_axes = tuple(axes[:-1]) + (None,) if axes else ()
            return {"q": tuple(axes), "scale": scale_axes}
        return tuple(axes)

    def one_v(axes):
        if cfg.state_dtype == "int8":
            return one_m(axes)
        if cfg.state_dtype == "int8_factored" and len(axes) >= 2:
            return {"vr": tuple(axes[:-1]) + (None,),
                    "vc": tuple(axes[:-2]) + (None, axes[-1])}
        return tuple(axes)

    return {"m": tree_map(one_m, param_axes),
            "v": tree_map(one_v, param_axes), "step": ()}


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    total = None
    for leaf in tree_leaves(tree):
        for part in _parts(leaf):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _ema(s: Any, beta: float, term: torch.Tensor) -> torch.Tensor:
    """``beta * s + term`` written back into the moment ``s`` (f32, or
    requantized into its ``{"q", "scale"}``); returns the f32 value before
    quantization, which the update uses."""
    if isinstance(s, dict):
        new = beta * _dequantize(s) + term
        qs = _quantize(new)
        s["q"].copy_(qs["q"])
        s["scale"].copy_(qs["scale"])
        return new
    return s.mul_(beta).add_(term)


def _apply(p: torch.Tensor, m_hat: torch.Tensor, v_hat: torch.Tensor,
           lr: torch.Tensor, cfg: OptimizerConfig) -> None:
    p32 = p.float()
    delta = m_hat / (torch.sqrt(v_hat) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - lr * delta)


def _update_rows(p, g, m, v, clip, lr, bc1, bc2, cfg) -> None:
    """The row-local update of one view: f32 or int8 m, and f32 or int8
    v (or, for a leaf that is not factored, the f32 v of
    ``int8_factored``)."""
    g = g.float() * clip
    m_new = _ema(m, cfg.b1, (1 - cfg.b1) * g)
    v_new = _ema(v, cfg.b2, (1 - cfg.b2) * g * g)
    _apply(p, m_new / bc1, v_new / bc2, lr, cfg)


def _update_factored(p, g, m, v, clip, lr, bc1, bc2, cfg) -> None:
    """``int8_factored`` on one view with two or more dims, whose ``vr``
    and ``vc`` span all its rows and columns.  A matrix above
    ``CHUNK_ELEMS`` is read twice in blocks of rows: first its row means
    (into ``vr``) and column sums, then the update."""
    b2 = cfg.b2
    blocks = _index(p.shape)
    if len(blocks) == 1:
        g32 = g.float() * clip
        g2 = g32 * g32 + 1e-30
        v["vr"].mul_(b2).add_((1 - b2) * g2.mean(dim=-1, keepdim=True))
        v["vc"].mul_(b2).add_((1 - b2) * g2.mean(dim=-2, keepdim=True))
    else:
        colsum = torch.zeros_like(v["vc"])
        for i in blocks:
            g32 = g[i].float() * clip
            g2 = g32 * g32 + 1e-30
            v["vr"][i].mul_(b2).add_((1 - b2) * g2.mean(dim=-1,
                                                         keepdim=True))
            colsum += g2.sum(dim=-2, keepdim=True)
        v["vc"].mul_(b2).add_((1 - b2) * divide(colsum, p.shape[-2]))
    vr, vc = v["vr"], v["vc"]
    denom = torch.clamp(vr.mean(dim=-2, keepdim=True), min=1e-30)
    for i in blocks:
        g32 = g[i].float() * clip
        m_new = _ema(_at(m, i), cfg.b1, (1 - cfg.b1) * g32)
        v_hat = (vr[i] * vc / denom) / bc2
        _apply(p[i], m_new / bc1, v_hat, lr, cfg)


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict, params: Any,
                 cfg: OptimizerConfig) -> Tuple[Any, Dict, Dict]:
    """One AdamW step.  Returns (params, opt_state, stats) with
    ``stats = {"grad_norm", "lr"}``; ``params`` and the moments (for int8
    their ``q`` and ``scale``, for a factored v its ``vr`` and ``vc``) are
    the same tensors, updated in place, and ``step`` is a new tensor."""
    _check_state_dtype(cfg)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    lr = _update_leaves(_leaf_groups(grads, opt_state, params), gnorm, step,
                        cfg)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, stats


def _leaf_groups(grads: Any, opt_state: Dict, params: Any) -> list:
    """(param, grad, m, v) of each leaf."""
    return list(zip(tree_leaves(params), tree_leaves(grads),
                    _leaves_like(opt_state["m"], params),
                    _leaves_like(opt_state["v"], params)))


def _update_leaves(leaves: list, gnorm: torch.Tensor, step: torch.Tensor,
                   cfg: OptimizerConfig) -> torch.Tensor:
    """AdamW on each (param, grad, m, v) of ``leaves`` in place, the
    gradients clipped by ``gnorm``, at ``step``; returns the lr."""
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in leaves:
        if _is_vfactor(v):
            for i in _lead_index(p.shape):
                _update_factored(p[i], g[i], _at(m, i), _at(v, i), clip, lr,
                                 bc1, bc2, cfg)
        else:
            for i in _index(p.shape):
                _update_rows(p[i], g[i], _at(m, i), _at(v, i), clip, lr,
                             bc1, bc2, cfg)
    return lr


__all__ = ["OptimizerConfig", "lr_at", "adamw_init", "adamw_update",
           "abstract_opt_state", "opt_state_logical_axes", "global_norm",
           "divide", "CHUNK_ELEMS", "STATE_DTYPES"]
