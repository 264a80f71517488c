from .base import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, all_cells,
                   applicable_shapes, get_arch)

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "all_cells",
           "applicable_shapes", "get_arch"]
