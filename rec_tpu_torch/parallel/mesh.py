"""Device meshes and process groups (port of rec_tpu/parallel/mesh.py).

A ``Mesh`` is the devices of one process along one "data" axis, each
entry a shard: images, latent blocks and batch rows split into contiguous
equal shares in entry order, weights replicated.  An entry may repeat a
device; its shards then run one after the other on that device.  That is
the port's counterpart of the JAX tests' virtual 8-device CPU mesh: the
tests shard over ``Mesh(["cpu"] * k)``, and a one-card machine over
``Mesh(["cuda:0"] * k)``, to run every sharded path with k shards.  CUDA
entries are always indexed (``cuda:k``): the port caches per-device tables
by device, and a bare ``cuda`` would mean whichever card is current.

``init_distributed`` joins a ``torch.distributed`` group over TCP with Gloo,
whatever device the process serves on: serving needs no collectives — each
process owns rows of the batch — so the group supplies only rank and world
size, and one backend keeps one tested path.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_LOOPBACK = ("localhost", "127.0.0.1", "::1")


def _host(address: str) -> str:
    """Host part of ``host:port``, IPv6 brackets stripped ("[::1]:1234" ->
    "::1")."""
    return address.rsplit(":", 1)[0].strip("[]")


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, timeout_s: float = 300.0) -> None:
    """Join the process group (a no-op for one process).

    For a localhost coordinator Gloo's sockets are pinned to the loopback
    interface, as rec_tpu pins them (Gloo may otherwise pick an interface
    whose connections are unroutable); an explicit GLOO_SOCKET_IFNAME
    wins."""
    if num_processes <= 1:
        return
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in "
                         f"[0, {num_processes})")
    if _host(coordinator_address) in _LOOPBACK:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh(tuple):
    """An ordered tuple of ``torch.device``s, one per shard.  A device may
    appear more than once; a CUDA device must carry its index."""

    def __new__(cls, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        for d in devs:
            if d.type == "cuda" and d.index is None:
                raise ValueError("mesh entries name their card (cuda:k), "
                                 "not a bare 'cuda'")
        return super().__new__(cls, devs)

    @property
    def repeats(self) -> bool:
        """Whether some device holds more than one shard."""
        return len(set(self)) < len(self)

    def describe(self) -> str:
        names = ", ".join(str(d) for d in self)
        return (f"{len(self)} entr{'y' if len(self) == 1 else 'ies'} "
                f"[{names}]" + (", repeating a device" if self.repeats
                                else ""))


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The first ``n_devices`` visible cards, ``cuda:0 .. n-1`` (every
    visible card when None); raises when fewer are visible (rec_tpu's
    ``make_mesh`` quietly takes fewer).  ``device="cpu"`` gives
    ``n_devices`` CPU entries (one when None)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else int(n_devices)))
    if dev.type != "cuda" or dev.index is not None:
        raise ValueError(f"make_mesh takes 'cuda' or 'cpu', got {device!r}")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise ValueError(f"a mesh of {n} card(s) asked for, {visible} "
                         f"visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def shard_rows(x, mesh: Mesh) -> List[torch.Tensor]:
    """Each entry's contiguous equal share of ``x``'s leading axis, on that
    entry's device (``x`` a tensor or an array); raises unless the axis is
    a multiple of the mesh."""
    n = len(x)
    if n % len(mesh):
        raise ValueError(f"leading axis {n} is not a multiple of the mesh "
                         f"({len(mesh)} entries)")
    share = n // len(mesh)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return [x[i * share:(i + 1) * share].to(dev)
            for i, dev in enumerate(mesh)]


def replicate(module: torch.nn.Module, mesh: Mesh
              ) -> List[torch.nn.Module]:
    """One copy of ``module`` per entry, with its weights: the module itself
    on entries of its own device, one copy per other device (shared by the
    entries that repeat it)."""
    home = next(module.parameters()).device
    copies = {home: module}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
    return [copies[dev] for dev in mesh]
