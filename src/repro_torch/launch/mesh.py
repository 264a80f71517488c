"""Production mesh builders and the H100's constants: the port of
``repro.launch.mesh``.

Each builder is a FUNCTION, so that importing this module touches no
process group.  A mesh is a ``DeviceMesh`` over a *fake* process group of
the mesh's size (``torch.testing._internal.distributed.fake_pg``; torch
2.11 and 2.13 both have it): this process is rank 0, collectives return at
once with tensors of the right shapes, and DTensors on ``meta`` run on it
with their local shards, which is all the dry run needs.  The mesh is
typed ``cuda``, so that DTensor moves a split with the card's collectives
(an all-to-all; on a ``cpu`` mesh it falls back to an all-gather and a
chunk), though no card is touched.  The group is
process-global: ``fake_group(n)`` makes it (replacing one of another size)
and ``destroy()`` tears it down.  The single-pod mesh is 16 x 16 = 256
devices; multi-pod adds a leading "pod" axis (2 pods, 512 devices), as the
reference's meshes are.

``HW`` holds one NVIDIA H100 80GB HBM3 (SXM) from NVIDIA's data sheet, the
figures ``kernels.cost.PEAKS`` uses: 989.4e12 dense bf16 FLOP/s, 3.35e12
B/s of HBM, 80 GB.  Collectives are charged one rate, as the reference
charges one ICI link: a 16-wide mesh axis leaves the 8-GPU NVLink domain of
one HGX H100 node, so its rings cross the network, and the honest single
rate is one GPU's inter-node link: a ConnectX-7 400 Gb/s NDR InfiniBand
port, 50e9 B/s (NVIDIA DGX H100 data sheet: eight such ports a node, one
per GPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

HW = {
    "peak_bf16_flops": 989.4e12,      # FLOP/s, dense, tensor cores
    "hbm_bandwidth": 3.35e12,         # B/s
    "link_bandwidth": 50e9,           # B/s, one 400 Gb/s NDR port per GPU
    "hbm_bytes": 80 * 10 ** 9,        # 80 GB
}


def fake_group(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process rank 0; an existing fake group of another size is torn
    down first, one of this size kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy() -> None:
    """Tear down the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over a fake
    group of its size."""
    n = 1
    for s in shape:
        n *= s
    fake_group(n)
    return DeviceMesh("cuda", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> DeviceMesh:
    """Small mesh for CI-scale sharding tests (8 devices)."""
    return make_mesh((n_data, n_model), ("data", "model"))


def mesh_name(mesh: DeviceMesh) -> str:
    """"16x16", "2x16x16", ...: the reference's record key."""
    return "x".join(map(str, mesh.shape))


__all__ = ["make_production_mesh", "make_test_mesh", "make_mesh",
           "mesh_name", "fake_group", "destroy", "HW"]
