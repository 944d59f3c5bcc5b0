"""Device meshes: the client mesh of the client-sharded round engines,
the LM's ``(data, model)`` mesh, and the named shape of the reference's
production mesh.

The JAX package shards the fleet's client axis over a 1-D ``clients``
``jax.sharding.Mesh``, and the LM over a ``(data, model)`` mesh
(``("pod", "data", "model")`` with pods), and runs every shard from one
Python process (``shard_map`` and GSPMD).  The port keeps that
single-controller model: a :class:`ClientMesh` is a tuple of
``torch.device`` s, one per shard, an :class:`LMMesh` a grid of them, and
one process drives every shard.  A mesh may repeat one device — virtual
shards — so a one-card machine runs the whole multi-shard step (padding,
per-shard partials, the collectives) on its one card, as the JAX
package's tests run P CPU devices with
``--xla_force_host_platform_device_count``.  A mesh of virtual shards is
only ever asked for by name (:meth:`LMMesh.virtual`); the host meshes
use distinct cards.  Data of shards on distinct cards moves by copies.

No constant here touches a device at import time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """A 1-D mesh of client shards: shard p's rows live on ``devices[p]``.

    ``axis_names`` names the mesh's axis, ``("clients",)`` for the round
    engines (they reject a mesh without that axis)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("clients",)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ClientMesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def num_shards(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class ProductionMesh:
    """A named mesh shape with no devices behind it: what the dry-run and
    the pods' sync read per device (``models.sharding.spec``,
    ``local_shape``)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        """The device count, as ``jax.sharding.Mesh.devices.size``."""
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """The reference's production mesh, as a named shape: ``("data",
    "model")`` ``(16, 16)`` = 256 devices a pod, or ``("pod", "data",
    "model")`` ``(2, 16, 16)`` = 512 with two pods (``pod`` is the
    cross-pod axis FedDD's sparse collectives compress).

    No such cluster exists here, and the port has no SPMD partitioner:
    the shape only sizes each device's block of a leaf."""
    if multi_pod:
        return ProductionMesh(("pod", "data", "model"), (2, 16, 16))
    return ProductionMesh(("data", "model"), (16, 16))


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """The LM's device mesh: ``devices`` in row-major order over
    ``axis_sizes``, named ``("data", "model")`` or ``("pod", "data",
    "model")``.  Device ``k`` sits at ``coords(k)``; ``model`` is the
    minor axis, so the devices of one model group (a *row*) are
    consecutive.  Its names and sizes feed ``models.sharding.spec`` as a
    :class:`ProductionMesh`'s do.  A device may repeat (virtual shards,
    :meth:`virtual`)."""

    devices: Tuple[torch.device, ...]
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        sizes = tuple(int(n) for n in self.axis_sizes)
        names = tuple(self.axis_names)
        if names not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"an LMMesh has axes ('data', 'model') or "
                             f"('pod', 'data', 'model'); got {names}")
        if len(sizes) != len(names) or min(sizes) < 1:
            raise ValueError(f"axis sizes {sizes} for axes {names}")
        if len(devs) != math.prod(sizes):
            raise ValueError(f"{len(devs)} devices for a {sizes} mesh")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @classmethod
    def virtual(cls, device: DeviceLike, data: int, model: int,
                pod: Optional[int] = None) -> "LMMesh":
        """A mesh whose every shard is the one ``device``: the whole
        multi-shard program on one card (or the CPU)."""
        dev = resolve_device(device)
        sizes = (data, model) if pod is None else (pod, data, model)
        names = ("data", "model") if pod is None else ("pod", "data",
                                                       "model")
        return cls((dev,) * math.prod(sizes), sizes, names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_model(self) -> int:
        """Devices in a row: the size of the ``model`` axis."""
        return self.axis_sizes[-1]

    @property
    def n_rows(self) -> int:
        """Rows: the product of the ``pod`` and ``data`` axes."""
        return self.size // self.n_model

    def coords(self, k: int) -> dict:
        """Device ``k``'s index along each axis."""
        out = {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            out[name] = k % n
            k //= n
        return out

    def row(self, k: int) -> int:
        return k // self.n_model

    def col(self, k: int) -> int:
        """Device ``k``'s index on the ``model`` axis."""
        return k % self.n_model


def _visible(device: DeviceLike) -> Tuple[torch.device, ...]:
    """The devices of ``device``'s type this run can use, in index order:
    every visible card for ``cuda``, the one CPU for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k`` (k >= 1)."""
    k = max(1, min(int(k), n))
    while n % k:
        k -= 1
    return k


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> LMMesh:
    """A small (data, model) :class:`LMMesh` of the visible devices, each
    axis size clamped to a divisor of the device count so ``data * model``
    tiles a prefix of them exactly (asking for (3, 1) on 8 devices gives
    (2, 1); a one-card host gives (1, 1)).  The counterpart of the JAX
    package's ``make_host_mesh``."""
    devs = _visible(device)
    n = len(devs)
    data = _largest_divisor_leq(n, data)
    model = _largest_divisor_leq(n // data, model)
    return LMMesh(devs[:data * model], (data, model))


def lm_mesh_from_flags(device: DeviceLike = None, *,
                       shape: Optional[str] = None, virtual: bool = False,
                       production: bool = False,
                       multi_pod: bool = False) -> LMMesh:
    """The mesh the serve and train entry points' flags ask for:
    ``--production-mesh [--multi-pod]`` (the reference's
    :func:`make_production_mesh` of the visible cards, ``("data",
    "model")`` (16, 16) or ``("pod", "data", "model")`` (2, 16, 16); with
    fewer cards it raises, naming the count, as ``jax.make_mesh`` does),
    ``--mesh D,M`` (clamped to the visible cards as :func:`make_host_mesh`
    clamps), ``--virtual`` (that shape with every shard on the one
    device), or by default every visible card on ``data`` (the JAX
    package's ``make_host_mesh(len(jax.devices()))``)."""
    dev = resolve_device(device)
    if production:
        prod = make_production_mesh(multi_pod=multi_pod)
        if virtual:
            *pod, data, model = prod.axis_sizes
            return LMMesh.virtual(dev, data, model,
                                  pod=pod[0] if pod else None)
        devs = _visible(dev)
        if len(devs) < prod.size:
            raise ValueError(f"Number of devices {len(devs)} must be >= "
                             f"the product of mesh_shape {prod.axis_sizes}")
        return LMMesh(devs[:prod.size], prod.axis_sizes, prod.axis_names)
    if multi_pod:
        raise ValueError("--multi-pod needs --production-mesh")
    if virtual and not shape:
        raise ValueError("--virtual needs --mesh D,M or --production-mesh")
    if shape:
        data, model = map(int, shape.split(","))
        if virtual:
            return LMMesh.virtual(dev, data, model)
        return make_host_mesh(data, model, dev)
    return make_host_mesh(len(_visible(dev)), 1, dev)


def make_client_mesh(num_devices: Optional[int] = None,
                     device: DeviceLike = None) -> ClientMesh:
    """A ``clients`` mesh over up to ``num_devices`` of the visible devices
    of ``device``'s type (all of them by default; ``device`` None means
    ``cuda``), clamped to what the run can see: one device on the CPU.
    Client counts need not divide the mesh (the engine pads)."""
    devs = _visible(device)
    k = len(devs) if num_devices is None else max(
        1, min(int(num_devices), len(devs)))
    return ClientMesh(devs[:k])


def resolve_client_mesh(mesh: Union[bool, int, ClientMesh],
                        device: DeviceLike = None) -> ClientMesh:
    """A ``ProtocolConfig.mesh`` value as a :class:`ClientMesh`: ``True``
    (every visible device), an int (that many, clamped), or a ClientMesh
    with a ``clients`` axis, returned as it is."""
    if mesh is True:
        return make_client_mesh(device=device)
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        return make_client_mesh(mesh, device=device)
    if isinstance(mesh, ClientMesh):
        if "clients" not in mesh.axis_names:
            raise ValueError(
                f"client-sharded engines need a 'clients' mesh axis; got "
                f"axes {mesh.axis_names}")
        return mesh
    raise TypeError(f"mesh must be an int, True, or a ClientMesh; got "
                    f"{type(mesh).__name__}")
