"""Production mesh descriptions (torch twin of ``repro.launch.mesh``).

One card cannot hold the reference's 16x16 device mesh, so a mesh here is
a *description*: axis names and sizes, the ``shape`` mapping jax's
``Mesh.shape`` gives, and the device count.  Building one touches no
device and no process group.  The single-pod production mesh is 16x16 =
256 devices ("data", "model"); the multi-pod mesh adds a leading "pod"
axis (2 pods = 512 devices); ``card`` is the one device the port runs on,
("data", "model") = (1, 1).  Batch/FSDP shard over ("pod", "data"),
tensor/expert parallel over "model"; the AMG solver uses the same devices
flattened to a 1-D "rank" axis (PETSc-style slabs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: mesh name (the dry run's ``--mesh``) -> (axis names, axis sizes)
MESHES: Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]] = {
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
    "card": (("data", "model"), (1, 1)),
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device grid: no devices behind it."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (jax's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The device count."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_mesh(name: str) -> Mesh:
    """The mesh the dry run calls ``name`` (``single``, ``multi`` or
    ``card``)."""
    names, sizes = MESHES[name]
    return Mesh(names, sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    return make_mesh("multi" if multi_pod else "single")


def make_amg_mesh(ndev: int) -> Mesh:
    """Flattened 1-D mesh for the distributed AMG row slabs."""
    return Mesh(("rank",), (ndev,))


def data_axes(mesh) -> tuple:
    """Axes that shard the global batch (pod folds into data parallel)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
