"""The ``(data, rays)`` mesh of a process group's ranks and its slicing rules
(port of ``avr_tpu/parallel/mesh.py``).

One process per device.  Rank ``d * R + r`` sits at mesh coordinates ``(d,
r)`` of a ``(D, R)`` mesh (JAX's ``np.reshape`` of the device list):

* ``data`` shards the scenes (the SB axis), ``rays`` the per-scene ray batch;
* parameters and optimizer state are replicated on every rank;
* the conditioning follows ``data``: every rank of one data index encodes the
  same scenes, and every ray reads all views' latents;
* the gradient mean over the mesh is one ``torch.distributed`` all-reduce
  (``parallel/sharded_step.py``).

JAX's shardings (``NamedSharding`` of a ``PartitionSpec``) become the slicing
rules they stand for: :func:`replicated`, :func:`batch_sharding` and
:func:`ray_sharding` return a :class:`Sharding`, which takes a rank's block of
a global tensor.

A mesh of one rank needs no launcher: without a process group its
collectives are skipped (there is nothing to reduce).  With one
(``parallel/multihost.py`` ``initialize``), every collective runs, a world of
one included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharding",
    "make_mesh",
    "replicated",
    "batch_sharding",
    "ray_sharding",
    "shard_train_inputs",
]


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``(data, rays)`` mesh.

    ``shape`` maps each axis name to its size (JAX's ``Mesh.shape``);
    ``data_group`` is the process group of the ranks that share this rank's
    rays index (``D`` ranks, which hold the global batch's scenes between
    them), ``None`` where ``D`` is 1 or there is no process group."""

    shape: Dict[str, int]
    axis_names: Tuple[str, str]
    rank: int
    grouped: bool  # a process group exists: collectives run
    data_group: Optional[object] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        rays = self.shape[self.axis_names[1]]
        return self.rank // rays if axis == self.axis_names[0] else self.rank % rays

    def block(self, SB: int, R: int):
        """Where this rank's ``(SB, R)`` block of rays lies in the global
        batch: ``((SB_global, R_global), (sb0, r0))``."""
        data, rays = (self.shape[a] for a in self.axis_names)
        d, r = (self.index(a) for a in self.axis_names)
        return (SB * data, R * rays), (d * SB, r * R)


def make_mesh(mesh_shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "rays")) -> Mesh:
    """Build the 2D ``(data, rays)`` mesh over the process group's ranks (one
    rank and no group when ``torch.distributed`` is not initialised).

    The default shape puts every rank on the ``rays`` axis; pass
    ``mesh_shape=(D, R)`` to split.  A shape whose product is not the
    number of ranks raises.  Every rank of the group must call this, in the
    same order: it makes the data axis's process groups."""
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if mesh_shape is None:
        mesh_shape = (1, n)
    mesh_shape = tuple(int(x) for x in mesh_shape)
    if len(mesh_shape) != 2 or math.prod(mesh_shape) != n:
        raise ValueError(f"mesh shape {mesh_shape} != #ranks {n}")
    D, R = mesh_shape
    data_group = None
    if grouped and D > 1:
        if R == 1:
            data_group = dist.group.WORLD
        else:
            for r in range(R):  # every rank makes every group, in one order
                g = dist.new_group([d * R + r for d in range(D)])
                if rank % R == r:
                    data_group = g
    return Mesh(dict(zip(axis_names, mesh_shape)), tuple(axis_names), rank, grouped,
                data_group)


@dataclass(frozen=True)
class Sharding:
    """``spec[i]`` names the mesh axis that splits axis ``i`` of a global
    tensor into equal blocks (``None``, or past the spec's end: whole);
    calling it takes this rank's block."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def __call__(self, t):
        if not self.spec:
            return t
        if t.ndim < len(self.spec):
            raise ValueError(f"{t.ndim}-D tensor for the spec {self.spec}")
        for axis, name in enumerate(self.spec):
            if name is None:
                continue
            n, size = self.mesh.shape[name], t.shape[axis]
            if size % n:
                raise ValueError(f"axis {axis} of {tuple(t.shape)} not divisible by the "
                                 f"mesh's {name} axis ({n})")
            t = t.narrow(axis, self.mesh.index(name) * (size // n), size // n)
        return t.contiguous()


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard axis 0 (scenes) over ``data``, replicate the rest."""
    return Sharding(mesh, (mesh.axis_names[0],) + (None,) * (ndim - 1))


def ray_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard axis 0 over ``data`` and axis 1 (rays) over ``rays``."""
    return Sharding(mesh, tuple(mesh.axis_names) + (None,) * (ndim - 2))


def shard_train_inputs(mesh: Mesh, src_images, src_poses, focal, c, model_input: Dict, gt):
    """This rank's block of one train step's global-batch-shaped inputs.

    Every process assembles a whole global-batch-shaped step (the per-step
    RNG is ``(seed, global step)`` on every process) from its own dataset
    shard, and keeps only its block: the rows of ``data`` index ``d`` come
    from the processes at ``d``, and under a ``rays`` axis that spans
    processes the halves of one row's rays come from different processes'
    instances (JAX's multi-process rule, ``avr_tpu/parallel/mesh.py``).
    ``intrinsics`` follows ``data``; ``focal`` and ``c`` are replicated."""
    src_images = batch_sharding(mesh, 5)(src_images)
    src_poses = batch_sharding(mesh, 4)(src_poses)
    focal = replicated(mesh)(focal)
    c = replicated(mesh)(c)
    model_input = {
        "x_pix": ray_sharding(mesh, 3)(model_input["x_pix"]),
        "cam2world": ray_sharding(mesh, 4)(model_input["cam2world"]),
        "intrinsics": batch_sharding(mesh, 3)(model_input["intrinsics"]),
    }
    gt = ray_sharding(mesh, 3)(gt)
    return src_images, src_poses, focal, c, model_input, gt
