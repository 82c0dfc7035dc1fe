"""The card's constants for the roofline analysis, and the agent mesh of the
sharded gossip windows (port of ``repro.launch.mesh``'s constants and of
the one-axis ``jax.sharding.Mesh`` that ``repro.gossip.engine`` builds).

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

The production mesh builders (``make_production_mesh``, ``mesh_n_agents``,
``mesh_n_chips``) arrive with the sharding slice (ROADMAP queue A item 10f).
"""
from __future__ import annotations

import dataclasses

# dense bf16 (and fp16) on the tensor cores, H100 SXM5 data sheet
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# HBM3, 80 GB, H100 SXM5 data sheet
HBM_BW = 3.35e12  # B/s
# NVLink 4: 900 GB/s both ways per GPU, so 450 GB/s a direction (the data
# sheet's 900 GB/s is the two directions summed)
ICI_BW = 450e9  # B/s

AGENTS = "agents"


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
