"""The card's constants for the roofline analysis, the named multi-axis mesh
and its builders, and the agent mesh of the sharded gossip windows (port of
``repro.launch.mesh`` and of the one-axis ``jax.sharding.Mesh`` that
``repro.gossip.engine`` builds).

Constants, for one NVIDIA H100 SXM5 80 GB.  The JAX package's values are a
TPU v5e's; none of them carries over.  The names stay, so that
``launch.costmodel`` reads the same three constants.  Each is NVIDIA's
published peak for the SXM5 part at its full 700 W power limit (the H100
data sheet, dense rates without sparsity); a card set below 700 W runs
slower under load, so a share of these peaks is stated with the card's
power limit beside it.

``AgentMesh``: an ordered tuple of ``torch.device``s on the axis
``"agents"``, one per shard of the agent axis; shard s holds agents
``[s N/S, (s + 1) N/S)``.  ``local_devices(device)`` lists every card of
the session's device type (``cuda:0 .. cuda:k-1``; on the CPU ``[cpu]``),
the counterpart of ``jax.devices()``.  A mesh may repeat a device: the
repeated entries are virtual shards that run one after another on that
device, as the reference's own sharded tests run 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``) in one process.  One
process drives every shard (single controller, as the reference).

``Mesh``: named axes in order (``shape``, read as
``jax.sharding.Mesh.shape`` is, so the sharding rules of
``launch.sharding`` port as they stand) over a row-major tuple of
``torch.device``s, one per mesh position.  Devices may repeat (virtual
shards, as above), and an abstract mesh has none: the sharding rules and
the dry run only read its shape, and a function that computes over an
abstract mesh runs every position on its input's device.  Axis semantics,
as the reference's: ``pod`` is the paper's agent axis (each pod one agent
holding its own posterior; eq. (6) the only traffic across pods),
``data`` batch / FSDP sharding within an agent, ``model`` tensor and expert
parallelism.  ``make_production_mesh`` gives the reference's (16, 16)
``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")`` shapes;
``mesh_n_agents`` and ``mesh_n_chips`` count positions, as the reference
counts devices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

# dense bf16 (and fp16) on the tensor cores, H100 SXM5 data sheet
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# dense TF32 on the tensor cores, and fp32 on the CUDA cores, the same sheet
PEAK_FLOPS_TF32 = 495e12  # FLOP/s
PEAK_FLOPS_FP32 = 67e12  # FLOP/s
# HBM3, 80 GB, H100 SXM5 data sheet
HBM_BW = 3.35e12  # B/s
# NVLink 4: 900 GB/s both ways per GPU, so 450 GB/s a direction (the data
# sheet's 900 GB/s is the two directions summed)
ICI_BW = 450e9  # B/s

AGENTS = "agents"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a row-major grid of devices (repeats allowed), or
    over none (abstract)."""

    axes: tuple  # ((name, size), ...) in mesh order
    devices: tuple | None = None

    def __post_init__(self):
        axes = tuple((str(name), int(size)) for name, size in self.axes)
        names = [name for name, _ in axes]
        if len(set(names)) != len(names) or any(size < 1 for _, size in axes):
            raise ValueError(f"mesh axes {axes}: names must differ and sizes be >= 1")
        object.__setattr__(self, "axes", axes)
        if self.devices is not None:
            devices = tuple(self.devices)
            if len(devices) != self.size:
                raise ValueError(f"a mesh of {self.size} positions over {len(devices)} devices")
            object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: size}`` in mesh order, as ``jax.sharding.Mesh.shape``."""
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(size for _, size in self.axes)

    def positions(self):
        """Every position's ``{axis: index}``, row-major."""
        for idx in itertools.product(*(range(size) for _, size in self.axes)):
            yield dict(zip(self.axis_names, idx))

    def device_at(self, position: dict, default=None):
        """The device of ``position`` (``{axis: index}``, absent axes 0);
        ``default`` on an abstract mesh."""
        if self.devices is None:
            return default
        flat = 0
        for name, size in self.axes:
            flat = flat * size + position.get(name, 0)
        return self.devices[flat]

    @property
    def n_cards(self) -> int:
        """Distinct devices under the positions (0 when abstract)."""
        return 0 if self.devices is None else len(set(self.devices))


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axis_names``.  ``devices``: one per
    position (row-major), or one device for every position (virtual
    shards), or ``None`` (abstract)."""
    mesh = Mesh(tuple(zip(axis_names, shape)))
    if devices is None:
        return mesh
    if not isinstance(devices, (list, tuple)):
        devices = [devices] * mesh.size
    return Mesh(mesh.axes, tuple(devices))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``; abstract unless ``devices`` are given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def mesh_n_agents(mesh) -> int:
    return mesh.shape.get("pod", 1)


def mesh_n_chips(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n


@dataclasses.dataclass(frozen=True)
class AgentMesh:
    """One mesh axis of devices; entry s runs shard s (repeats allowed)."""

    devices: tuple
    axis: str = AGENTS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("an agent mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(self.devices))

    @property
    def shape(self) -> dict[str, int]:
        """``{axis: shards}``, as ``jax.sharding.Mesh.shape`` reads."""
        return {self.axis: len(self.devices)}

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def n_cards(self) -> int:
        """Distinct devices under the shards."""
        return len(set(self.devices))


def local_devices(device) -> list:
    """Every device of ``device``'s type this process can use: the CUDA
    cards ``cuda:0 .. cuda:k-1``, or ``[cpu]``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def agent_mesh(devices, n_shards: int | None = None) -> AgentMesh:
    """The mesh of the first ``n_shards`` of ``devices`` (all of them by
    default)."""
    devices = list(devices)
    n_shards = len(devices) if n_shards is None else n_shards
    if not 1 <= n_shards <= len(devices):
        raise ValueError(f"{n_shards} shards over {len(devices)} devices")
    return AgentMesh(tuple(devices[:n_shards]))
