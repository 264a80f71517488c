"""State carried across from ``repro`` to the port.

The image lane has no weights: its checkpoint is what the consumer sees,
``feed.state()`` (``{"epoch", "cursor", "consumed"}``) plus, for adaptive
flow control, ``loader.flow_snapshot()``.  ``repro``'s training loop stores
the snapshot inside the position dict under ``"flow"``; both spellings are
taken.

Model weights cross as numpy, leaf by leaf under the same key paths:
``params_from_reference`` takes a tree of numpy arrays (the reference's
parameter tree after ``np.asarray`` on each leaf) and ``params_to_numpy``
gives one back.  A training state, ``{"params", "opt": {"m", "v",
"step"}}``, crosses the same way through ``state_from_reference`` and
``state_to_numpy``, whatever its ``state_dtype``: an int8 moment is a
``{"q", "scale"}`` dict (int8 codes stay int8) and a factored second
moment a ``{"vr", "vc"}`` dict, each leaf under its own key path.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import resolve_device
from repro_torch.models.params import tree_map

_POSITION_KEYS = ("epoch", "cursor")
_OPTIONAL_KEYS = ("consumed", "flow")


def feed_state_from_reference(state: Mapping, flow: Optional[Mapping] = None
                              ) -> Tuple[dict, Optional[dict]]:
    """Validate a position that ``repro``'s feed wrote and return
    ``(start_kwargs, flow)``: the port resumes with
    ``loader.start(**start_kwargs)`` and ``loader.restore_flow(flow)``."""
    if not isinstance(state, Mapping):
        raise TypeError(f"feed state must be a mapping, got "
                        f"{type(state).__name__}")
    unknown = set(state) - set(_POSITION_KEYS) - set(_OPTIONAL_KEYS)
    if unknown:
        raise ValueError(f"unknown feed-state keys {sorted(unknown)}")
    missing = [k for k in _POSITION_KEYS if k not in state]
    if missing:
        raise ValueError(f"feed state lacks {missing}")
    for key in ("epoch", "cursor", "consumed"):
        value = state.get(key, 0)
        if isinstance(value, bool) or not isinstance(value, int) or value < 0:
            raise ValueError(f"feed state {key!r} must be an int >= 0, got "
                             f"{value!r}")
    if flow is not None and state.get("flow") is not None:
        raise ValueError("flow snapshot given twice: in the state and as "
                         "flow=")
    flow = flow if flow is not None else state.get("flow")
    if flow is not None and not isinstance(flow, Mapping):
        raise TypeError(f"flow snapshot must be a mapping, got "
                        f"{type(flow).__name__}")
    return ({"epoch": state["epoch"], "cursor": state["cursor"]},
            copy.deepcopy(dict(flow)) if flow is not None else None)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bfloat16, as JAX gives
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_reference(tree: Any, device="cuda") -> Any:
    """A tree (nested dicts) of numpy arrays -> the same tree of tensors on
    ``device`` (``"cuda"`` by default; raises without a card), dtypes
    kept."""
    device = resolve_device(device)
    if not isinstance(tree, dict):
        raise TypeError(f"params must be a nested dict, got "
                        f"{type(tree).__name__}")
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`params_from_reference`: tensors -> numpy
    arrays under the same key paths.  numpy has no bfloat16, so bf16 leaves
    come back widened to float32, exactly."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


def _check_state(state: Any) -> None:
    if not isinstance(state, Mapping) or set(state) != {"params", "opt"}:
        got = (sorted(state) if isinstance(state, Mapping)
               else type(state).__name__)
        raise ValueError(f"a training state is {{'params', 'opt'}}, got "
                         f"{got}")
    if not isinstance(state["opt"], Mapping) or \
            set(state["opt"]) != {"m", "v", "step"}:
        raise ValueError("the optimizer state is {'m', 'v', 'step'} (each "
                         "moment f32, {'q', 'scale'} or {'vr', 'vc'})")


def state_from_reference(state: Any, device="cuda") -> Any:
    """``repro``'s training state as numpy (``jax.tree.map(np.asarray,
    state)``) -> the port's, on ``device``: parameters, the moments (f32,
    or int8 codes with f32 scales, or f32 ``vr``/``vc``) and the int32
    ``step``, dtypes kept."""
    _check_state(state)
    return params_from_reference(dict(state), device)


def state_to_numpy(state: Any) -> Any:
    """The inverse of :func:`state_from_reference` (bf16 leaves widened
    to float32, exactly)."""
    _check_state(state)
    return params_to_numpy(dict(state))


__all__ = ["feed_state_from_reference", "params_from_reference",
           "params_to_numpy", "state_from_reference", "state_to_numpy"]
