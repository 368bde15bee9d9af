"""Device mesh construction for distributed query execution.

The counterpart of ``presto_tpu/parallel/mesh.py`` (the role of the
reference's worker-node topology, presto-main/.../metadata/
DiscoveryNodeManager.java:68 and execution/scheduler/NodeScheduler.java):
a stage's "tasks" become shards of one SPMD program laid over a mesh
axis, and the hash exchange between stages is a collective between the
shards instead of HTTP page transfers.

The JAX package runs one controller over a ``jax.sharding.Mesh``; the
port keeps that shape. A :class:`Mesh` is one axis name and an ordered
list of **slots**, each slot a torch device. The executor runs a shard
body once per slot on that slot's device, and a collective moves tensors
between slots (``parallel/exchange.py``). Several slots may share one
device: on one card a mesh of four slots runs four shards on the card,
as the JAX tests' eight virtual CPU devices share one CPU.

**Visible slots** are the visible devices of the runner's device type
(``cuda:0 .. cuda:k-1``, or the one ``cpu``), each repeated
``PRESTO_TPU_TORCH_MESH_SLOTS`` times (default 1). That variable is the
port's counterpart of XLA's forced host device count. With it unset, one
card is a mesh of one slot, and ``mesh_execution=auto`` never meshes
there, as the JAX package behaves on one chip.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import torch

from ..device import resolve_device

default_axis = "dp"

#: environment variable: slots per visible device (default 1)
SLOTS_ENV = "PRESTO_TPU_TORCH_MESH_SLOTS"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``axis`` names it, ``devices[i]`` is slot i's device."""

    axis: str
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def slots_per_device() -> int:
    """``PRESTO_TPU_TORCH_MESH_SLOTS`` (1 when unset or empty)."""
    raw = os.environ.get(SLOTS_ENV) or "1"
    try:
        k = int(raw)
    except ValueError:
        k = 0
    if k < 1:
        raise ValueError(
            f"{SLOTS_ENV} must be a positive integer, got {raw!r}")
    return k


def visible_slots(device=None) -> List[torch.device]:
    """The slots a mesh may use: every visible device of ``device``'s
    type (the GPU when None), each repeated ``slots_per_device()`` times,
    slots of one device adjacent."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(dev.type)]
    k = slots_per_device()
    return [d for d in devices for _ in range(k)]


def make_mesh(n_devices: Optional[int] = None, axis: str = default_axis,
              device=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible slots (all by
    default); ``ValueError`` past them."""
    slots = visible_slots(device)
    n = n_devices or len(slots)
    if n > len(slots):
        raise ValueError(f"requested {n} devices, have {len(slots)}")
    return Mesh(axis, tuple(slots[:n]))
