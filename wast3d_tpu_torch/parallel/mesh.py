"""The rank mesh and the row layout of a sharded Gaussian scene.

Port of `wast3d_tpu/parallel/mesh.py`. JAX runs one process over a `Mesh`
of devices; the port runs one process per rank under `torch.distributed`
(`multihost.py` starts or joins them), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, model) over
every rank of the group, with dim names ("data", "model"):
- "model" shards the Gaussian axis: each rank of a model group holds a
  contiguous slice of the rows of the scene, its Adam moments and its
  densification statistics (`scene_sharding`, `shard_train_state`);
- "data" splits independent work: the cameras of a training batch, the
  styles of a sweep.
Rows split as evenly as they go, the first `n % model` ranks holding one
more; the port's scene changes its row count as it densifies, so shards may
be uneven, where JAX needs the capacity to divide by the model axis.

The mesh's device type names the backend's home: "cuda" for nccl, "cpu" for
gloo, whose groups also carry CUDA tensors through host memory
(`collectives.py`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from wast3d_tpu_torch.scene.gaussians import FIELDS

AXES = ("data", "model")


def make_mesh(n_devices: Optional[int] = None, data: int = 1) -> DeviceMesh:
    """Mesh of shape (data, model) over the group's ranks, in rank order.
    `n_devices` defaults to the world size and must equal it (every rank
    of the process group is in the mesh)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"n_devices {n} must equal the world size {world}: "
                         "start one rank per device")
    if n % data != 0:
        raise ValueError(f"n_devices {n} not divisible by data axis {data}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(data, n // data),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[AXES.index(axis)])


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's position in the mesh, data-major (JAX's P(("data", "model")))."""
    return axis_index(mesh, "data") * axis_size(mesh, "model") + axis_index(mesh, "model")


def row_range(n: int, parts: int, index: int) -> slice:
    """Part `index` of `parts` contiguous, near-equal slices of n rows."""
    base, extra = divmod(int(n), int(parts))
    start = index * base + min(index, extra)
    return slice(start, start + base + (1 if index < extra else 0))


def scene_sharding(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous rows of an n-row Gaussian axis (the model axis)."""
    return row_range(n, axis_size(mesh, "model"), axis_index(mesh, "model"))


def replicated(mesh: DeviceMesh, n: int) -> slice:
    """Every row: what each rank holds of a replicated axis."""
    del mesh
    return slice(0, int(n))


def shard_train_state(state, mesh: DeviceMesh):
    """This rank's rows of a `train.reconstruct.TrainState`: the scene's
    per-Gaussian fields, the Adam moments and the densification statistics;
    the step counts stay as they are."""
    rows = scene_sharding(mesh, state.scene.capacity)
    scene = state.scene.replace(**{f: getattr(state.scene, f)[rows] for f in FIELDS})
    opt = state.opt_state._replace(mu={k: v[rows] for k, v in state.opt_state.mu.items()},
                                   nu={k: v[rows] for k, v in state.opt_state.nu.items()})
    stats = type(state.stats)(*(a[rows] for a in state.stats))
    return state._replace(scene=scene, opt_state=opt, stats=stats)
