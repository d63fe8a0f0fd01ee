"""The serving mesh (port of ``repro.launch.mesh.parse_mesh`` /
``make_serving_mesh``) over an initialized default process group.

Rank ``r`` of a world of ``n_data * n_model`` ranks sits at ``(r //
n_model, r % n_model)``, row-major, as the reference's ``(data, model)``
device mesh lays devices out.  Every data row gets one process group (its
model axis: the ranks that split one copy of the weights) and every model
column one (its data axis: the ranks that hold the same weight shard and
split the slots).  A rank's device is ``cuda:{rank % device_count}``
unless the caller names one (the CPU tests pass ``"cpu"``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> (data, model) axis sizes (e.g. ``"2x4"`` -> (2, 4))."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh spec must look like '2x4', got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be positive, got {spec!r}")
    return d, m


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group, the number
    of ranks along it and this rank's index on it."""
    group: object
    size: int
    index: int


class ServingMesh:
    """This rank's place on a (data, model) mesh of the default group."""

    def __init__(self, n_data: int, n_model: int, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ServingMesh needs an initialized default process group "
                "(torch.distributed.init_process_group, or "
                "serve.sharded.launch)")
        world = dist.get_world_size()
        if n_data * n_model != world:
            raise ValueError(f"mesh {n_data}x{n_model} needs "
                             f"{n_data * n_model} ranks, the group has "
                             f"{world}")
        self.n_data, self.n_model = n_data, n_model
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, n_model)
        self.backend = dist.get_backend()
        # every rank creates every group, in the same order (new_group is
        # collective over the default group)
        model_group = data_group = None
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == self.data_index:
                model_group = g
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == self.model_index:
                data_group = g
        self.model = Axis(model_group, n_model, self.model_index)
        self.data = Axis(data_group, n_data, self.data_index)
        self.device = _rank_device(self.rank, device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)


def _rank_device(rank: int, device: Optional[object]) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to serve the "
            "mesh on the CPU")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def make_serving_mesh(spec: str, *, device=None) -> ServingMesh:
    """The (data, model) mesh of a ``"DxM"`` spec over the default group."""
    n_data, n_model = parse_mesh(spec)
    return ServingMesh(n_data, n_model, device=device)
