"""Automatic split creation from metadata (paper Sec. 3.2).

Splits are lists of UUIDs generated from the ``metadata`` table under two
constraints:
  * entity independence — all samples of one entity (patient, session, ...)
    land in the same split (no leakage);
  * target proportions — both split fractions and per-class balance are
    matched as closely as entity granularity allows.

Greedy balanced assignment: entities are processed in seeded-shuffled order
(largest first for better packing) and each is assigned to the split that
minimizes a weighted deviation from the split-size and class-mix targets.
"""

from __future__ import annotations

import uuid as _uuid
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .kvstore import MetaRow


@dataclass
class SplitSpec:
    fractions: Sequence[float]                  # e.g. (0.8, 0.1, 0.1)
    names: Optional[Sequence[str]] = None
    class_weights: Optional[Dict[int, float]] = None  # target class mix (all splits)
    seed: int = 0

    def __post_init__(self) -> None:
        tot = float(sum(self.fractions))
        self.fractions = [f / tot for f in self.fractions]
        if self.names is None:
            base = ["train", "val", "test", "extra"]
            self.names = [base[i] if i < len(base) else f"split{i}"
                          for i in range(len(self.fractions))]


def create_splits(meta_rows: List[MetaRow], spec: SplitSpec
                  ) -> Dict[str, List[_uuid.UUID]]:
    """Return {split_name: [uuid, ...]} satisfying the constraints."""
    by_entity: Dict[str, List[MetaRow]] = defaultdict(list)
    for row in meta_rows:
        by_entity[row.entity_id].append(row)

    entities = list(by_entity.keys())
    rng = np.random.default_rng(spec.seed)
    rng.shuffle(entities)
    entities.sort(key=lambda e: -len(by_entity[e]))  # stable: big groups first

    n_splits = len(spec.fractions)
    total = len(meta_rows)
    split_counts = np.zeros(n_splits)
    classes = sorted({r.label for r in meta_rows})
    cls_index = {c: i for i, c in enumerate(classes)}
    split_cls = np.zeros((n_splits, len(classes)))
    if spec.class_weights:
        w = np.asarray([spec.class_weights.get(c, 0.0) for c in classes])
        target_mix = w / max(w.sum(), 1e-12)
    else:
        counts = np.zeros(len(classes))
        for r in meta_rows:
            counts[cls_index[r.label]] += 1
        target_mix = counts / counts.sum()

    fracs = np.asarray(spec.fractions)
    target_counts = np.maximum(fracs * total, 1e-9)
    target_cls_counts = np.maximum(np.outer(fracs, target_mix) * total, 1e-9)

    out: Dict[str, List[_uuid.UUID]] = {name: [] for name in spec.names}
    for ent in entities:
        rows = by_entity[ent]
        ent_cls = np.zeros(len(classes))
        for r in rows:
            ent_cls[cls_index[r.label]] += 1
        # assign to the split with the largest *relative deficit* — this fills
        # all splits proportionally; the class term steers entities toward
        # splits whose class mix they improve.
        best, best_score = 0, -float("inf")
        ent_frac = ent_cls / len(rows)
        for s in range(n_splits):
            rel_deficit = (target_counts[s] - split_counts[s]) / target_counts[s]
            rel_cls_def = (target_cls_counts[s] - split_cls[s]) / target_cls_counts[s]
            score = rel_deficit + 0.5 * float(ent_frac @ rel_cls_def)
            if score > best_score:
                best, best_score = s, score
        split_counts[best] += len(rows)
        split_cls[best] += ent_cls
        out[spec.names[best]].extend(r.uuid for r in rows)

    import zlib

    for name in out:  # deterministic within-split shuffle
        rng_s = np.random.default_rng((spec.seed, zlib.crc32(name.encode())))
        order = rng_s.permutation(len(out[name]))
        out[name] = [out[name][i] for i in order]
    return out


def check_entity_independence(meta_rows: List[MetaRow],
                              splits: Dict[str, List[_uuid.UUID]]) -> bool:
    owner: Dict[str, str] = {}
    by_uuid = {r.uuid: r for r in meta_rows}
    for name, uuids in splits.items():
        for u in uuids:
            ent = by_uuid[u].entity_id
            if owner.setdefault(ent, name) != name:
                return False
    return True


__all__ = ["SplitSpec", "create_splits", "check_entity_independence"]
