"""Fault-tolerant checkpointing, atomic, versioned and async: the port of
``repro.train.checkpoint`` in its on-disk format.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (``step``,
``time``, the sorted ``keys`` and ``extra``), written to ``step_<N>.tmp``
and renamed into place, so a crash mid-save never corrupts the latest
checkpoint.  Keys are the ``/``-joined paths of the state's nested dicts.
The loader position rides in ``extra`` (see ``train.loop``), which makes a
mid-epoch restart exact at batch granularity.

numpy has no bfloat16: a bf16 leaf is stored as the reference stores one
(``ml_dtypes`` bfloat16 lands in the file as raw 2-byte ``V2`` records)
and read back by viewing those bytes as bfloat16, so a bf16 checkpoint
crosses between the packages without ``ml_dtypes``.  int8 codes stay
int8; an int8 moment's ``q`` and ``scale`` and a factored moment's ``vr``
and ``vc`` are leaves under their own paths, as in the reference.

``restore(..., shardings=)`` loads onto a device mesh, which may differ
from the one the checkpoint was saved from (elastic rescale): each leaf
comes back as a DTensor placed by its ``sharding.rules.NamedSharding``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.models.params import tree_map

_BF16_RECORD = np.dtype("V2")


def _paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/b": leaf} for a tree of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device (on the host
    for a ``meta`` template, e.g. ``abstract_state``'s)."""
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    device = torch.device("cpu") if like.is_meta else like.device
    return t.to(device=device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> str:
        """Copy ``state`` to host memory now; write it now or, with
        ``blocking=False``, on a thread (one save in flight at most)."""
        self.wait()
        flat = {k: _to_numpy(v) for k, v in _paths(state).items()}
        manifest = {"step": int(step), "time": time.time(),
                    "keys": sorted(flat), "extra": extra or {}}
        final = os.path.join(self.directory, f"step_{step:08d}")

        def write():
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self._async_thread = threading.Thread(target=write, daemon=True)
            self._async_thread.start()
        return final

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def all_steps(self):
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Tuple[Any, Dict]:
        """Load into the structure of ``template`` (a tree of tensors, or
        of ``meta`` tensors from ``abstract_state``): each leaf comes back
        with the template leaf's dtype and device (the host for ``meta``).
        Returns (state, manifest); raises on a missing key or a shape
        mismatch.

        ``shardings``: optional matching tree of
        ``sharding.rules.NamedSharding`` for the target mesh; each leaf
        then comes back as a DTensor on that mesh's devices
        (``distribute_tensor``), every rank reading the whole file."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            loaded = {}
            for key, tmpl in _paths(template).items():
                if key not in data:
                    raise KeyError(f"checkpoint missing key {key}")
                arr = data[key]
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(f"shape mismatch for {key}: "
                                     f"{arr.shape} vs {tuple(tmpl.shape)}")
                loaded[key] = _to_tensor(arr, tmpl)
        if shardings is not None:
            placed = _paths(shardings)
            if set(placed) != set(loaded):
                raise ValueError(f"shardings do not match the template: "
                                 f"{sorted(set(placed) ^ set(loaded))}")
            for key, sh in placed.items():
                loaded[key] = distribute_tensor(loaded[key], sh.mesh,
                                                sh.placements)
        keys = iter(_paths(template))
        return tree_map(lambda _: loaded[next(keys)], template), manifest


__all__ = ["CheckpointManager"]
