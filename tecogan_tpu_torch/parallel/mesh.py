"""Device meshes, shardings and the process group (counterpart of
``tecogan_tpu/parallel/mesh.py``).

A :class:`Mesh` names the axes of a grid of ``torch.device``s. A device may
appear more than once: two shards on ``[cuda:0, cuda:0]`` run every sharded
path at its real shard shapes on one card, as the JAX package's tests run
its meshes on virtual CPU devices. On the CPU, ``devices="cpu"`` stands for
as many devices as the axes ask for (the counterpart of
``jax_num_cpu_devices``).

:func:`batch_sharding` and :func:`replicated` return a :class:`Sharding`,
which says how a tensor is laid over the mesh and puts it there: its
leading dimension split over one axis, or a whole copy on every device.
The slot pool of ``serve/engine.py`` and :func:`shard_batch` read them.

:func:`init_distributed` joins a ``torch.distributed`` process group: one
process per GPU (``parallel/dp.py``), where the JAX package runs one
process over every local device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Devices = Union[str, torch.device, Sequence[Union[str, torch.device]]]


class Mesh:
    """Ordered axis names over an n-d grid of devices."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_list(devices: Optional[Devices], wanted: int) -> List[torch.device]:
    if devices is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        device = torch.device(devices)
        if device.type != "cpu":
            raise ValueError(f"a single device stands for many only on the CPU, not {device}")
        return [device] * wanted
    return [canonical_device(d) for d in devices]


def make_mesh(axes: Optional[dict] = None, devices: Optional[Devices] = None) -> Mesh:
    """Build a Mesh from an {axis_name: size} spec.

    Defaults to a 1-D ``data`` mesh over every visible CUDA device. Sizes
    may use -1 for "all remaining devices" (at most one). ``devices``: a
    list of devices (one may repeat), or ``"cpu"`` for the CPU standing for
    as many devices as the sizes ask for (a -1 then takes 1).
    """
    axes = dict(axes or {"data": -1})
    sizes = list(axes.values())
    known = int(np.prod([s for s in sizes if s != -1]))
    devs = _device_list(devices, known)
    if -1 in sizes:
        sizes[sizes.index(-1)] = len(devs) // known
    total = int(np.prod(sizes))
    if total > len(devs) or total == 0:
        raise ValueError(f"mesh {axes} needs {max(total, 1)} devices, have {len(devs)}")
    grid = np.empty(total, dtype=object)
    grid[:] = devs[:total]
    return Mesh(grid.reshape(sizes), tuple(axes.keys()))


class Sharding:
    """A tensor's layout over a mesh: the leading dimension split over
    ``axis`` into equal pieces, one per device along it, or (``axis``
    None) a whole copy on every device of the mesh."""

    def __init__(self, mesh: Mesh, axis: Optional[str] = None):
        if axis is not None and axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
        self.mesh, self.axis = mesh, axis

    @property
    def devices(self) -> List[torch.device]:
        """One device per piece, in order."""
        if self.axis is None:
            return list(self.mesh.devices.flat)
        return self.mesh.axis_devices(self.axis)

    def bounds(self, n: int) -> List[Tuple[int, int]]:
        """The [start, stop) rows of each piece of a leading dimension n."""
        k = len(self.devices)
        if self.axis is None:
            return [(0, n)] * k
        if n % k:
            raise ValueError(f"leading dimension {n} does not split evenly over the "
                             f"{k}-device {self.axis!r} axis")
        per = n // k
        return [(i * per, (i + 1) * per) for i in range(k)]

    def put(self, x: Union[np.ndarray, torch.Tensor]) -> List[torch.Tensor]:
        """The pieces of ``x`` (host or device), each on its device."""
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        return [t[a:b].to(d) for (a, b), d in zip(self.bounds(t.shape[0]), self.devices)]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dimension over ``axis``."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    """A whole copy on every device of the mesh."""
    return Sharding(mesh, None)


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """Split a host batch on its leading dimension over ``axis``: a list of
    per-device tensors, or a tuple, list or dict of such lists for a tuple,
    list or dict of arrays. In a process group of world size > 1 the batch
    a process loads is already its own piece (``parallel/dp.py``)."""
    sharding = batch_sharding(mesh, axis)
    if isinstance(batch, dict):
        return {k: sharding.put(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(sharding.put(v) for v in batch)
    return sharding.put(batch)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> int:
    """Join the process group of a multi-process run; returns its size.

    With every argument omitted nothing is initialised and the count is
    that of a group already joined, else 1. Otherwise
    ``torch.distributed.init_process_group`` at ``tcp://<coordinator_address>``
    (``host:port``) with the given world size and rank, once: a second call
    finds the group and returns its size. ``backend`` defaults to NCCL where
    a CUDA device is visible and gloo on the CPU. ``torchrun`` gives a
    process its address, size and rank in ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (``cli/main.py`` reads them).
    """
    if coordinator_address or num_processes or process_id is not None:
        if not dist.is_initialized():
            if not (coordinator_address and num_processes and process_id is not None):
                raise ValueError("init_distributed needs coordinator_address, "
                                 "num_processes and process_id together")
            address = coordinator_address
            if "://" not in address:
                address = f"tcp://{address}"
            backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
            dist.init_process_group(backend, init_method=address,
                                    world_size=int(num_processes), rank=int(process_id))
    return dist.get_world_size() if dist.is_initialized() else 1

