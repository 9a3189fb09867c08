"""Process groups for multi-process serving (port of
rec_tpu/parallel/mesh.py's bring-up).

``init_distributed`` joins a ``torch.distributed`` group over TCP with Gloo,
whatever device the process serves on: serving needs no collectives — each
process owns rows of the batch — so the group supplies only rank and world
size, and one backend keeps one tested path.  Sharding
one block axis over several devices of one process (rec_tpu's
``parallel/codec.py``) is not ported yet.
"""

from __future__ import annotations

import datetime
import os

import torch.distributed as dist

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
