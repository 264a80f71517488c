"""The one place that turns a configuration file into the program's objects.

The benchmark takes from the program (``repro_torch``, the PyTorch port)
only the system under test: its model, serving engine, training loop,
loader and data store.  A configuration file names the model by the
port's own fields, so a later configuration is a new file and no code.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

ARCH_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab", "head_dim", "rope_theta", "norm_eps", "n_experts",
               "top_k", "capacity_factor", "dtype", "remat", "family")


def arch(config: Dict):
    """The port's ``ArchConfig`` for a configuration file."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name=config["name"],
                      **{k: config[k] for k in ARCH_FIELDS if k in config})


def build(config: Dict, device):
    """The port's model for a configuration file, on ``device``."""
    from repro_torch.models import build_model
    return build_model(arch(config), device=device)


__all__ = ["ROOT", "arch", "build"]
