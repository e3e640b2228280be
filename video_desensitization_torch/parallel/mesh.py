"""The device mesh: a (data, model) grid of devices and the helpers that
place a batch and a model on it.

* ``data`` shards the frame or image batch. Inference is collective-free:
  each device runs the whole program on its contiguous shard of the batch
  (``data_parallel_program``), and the outputs are joined in order.
  Training all-reduces the gradients over ``data`` (``train/step.py``).
* ``model`` splits the output channels of the large conv kernels of the
  trainer (``parallel/tensor.py``); 1 by default.

Inference runs in one process over its local devices. Training runs one
process per device of the mesh (``distributed_init``): rank ``r`` owns
``mesh.devices.flat[r]``, i.e. data row ``r // model`` and model column
``r % model``, and the collectives go over the process groups of its row
and column (``Mesh.group``).
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import socket
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# How long a rank waits for the others, at the rendezvous and in a
# collective, before it raises (jax.distributed's initialization timeout).
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """Every device of ``kind`` this process sees, in index order: the
    CUDA cards (raises where there is none), or the one CPU device."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"unsupported device kind {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the devices of a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A (data, model) grid of ``torch.device``s (``devices``, a numpy
    object array). Process groups are made on first use of ``group``."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self._groups: Optional[Dict[str, Any]] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def data_devices(self) -> List[torch.device]:
        """The device of each data shard: the first of each data row."""
        return list(self.devices[:, 0])

    def coords(self) -> Tuple[int, int]:
        """(data row, model column) of this process: rank 0's outside a
        process group."""
        rank = dist.get_rank() if dist.is_initialized() else 0
        return divmod(rank, self.shape["model"])

    def group(self, axis: str):
        """The process group of this rank along ``axis``, or None where the
        axis has size 1 (no collective needed). Every rank makes every
        group on the first call, so all ranks must make it together."""
        if self.shape[axis] == 1:
            return None
        if self._groups is None:
            self._groups = self._make_groups()
        return self._groups[axis]

    def _make_groups(self) -> Dict[str, Any]:
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            world = dist.get_world_size() if dist.is_initialized() else 1
            raise RuntimeError(
                f"a {self.shape['data']}x{self.shape['model']} mesh needs one process per "
                f"device ({self.size}); the process group has {world} (distributed_init)")
        d, m = self.shape["data"], self.shape["model"]
        ranks = np.arange(self.size).reshape(d, m)
        mine = {}
        # new_group is collective: every rank makes every group, in one order
        for col in range(m):
            group = dist.new_group(ranks[:, col].tolist())
            if dist.get_rank() in ranks[:, col]:
                mine["data"] = group
        for row in range(d):
            group = dist.new_group(ranks[row].tolist())
            if dist.get_rank() in ranks[row]:
                mine["model"] = group
        return mine


def make_mesh(
    devices: Optional[Sequence[torch.device]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (every CUDA card by default).

    ``data`` defaults to ``len(devices) // model``; ``data * model`` must
    equal the device count. On the CPU the one CPU device may be repeated
    (a mesh of n shards in one process, or one per process). A repeated
    CUDA device is refused unless the process group is gloo: NCCL refuses
    two ranks on one card."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    cuda = [d for d in devices if d.type == "cuda"]
    if len(set(cuda)) != len(cuda) and not (
        dist.is_initialized() and dist.get_backend() == dist.Backend.GLOO
    ):
        raise ValueError(
            "a CUDA device is repeated in the mesh: only a gloo process group takes two "
            "ranks on one card")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(data, model))


@dataclass(frozen=True)
class NamedSharding:
    """A layout on ``mesh``: for each dim of a tensor the mesh axis it is
    split over, or None; an empty ``spec`` is replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """Dim 0 (frames, images) split over ``data``; the rest replicated."""
    return NamedSharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _split(batch, n: int) -> List:
    """``n`` contiguous equal chunks of dim 0 of a tensor, an array or a
    dict of them."""
    if isinstance(batch, dict):
        parts = {k: _split(v, n) for k, v in batch.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    b = batch.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by {n} shards")
    per = b // n
    return [batch[i * per:(i + 1) * per] for i in range(n)]


def _to(x, device: torch.device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return torch.as_tensor(x).to(device, non_blocking=True)


def shard_batch(mesh: Mesh, batch) -> List:
    """The batch (a tensor, an array or a dict of them, batch-major) split
    into one contiguous shard per data row, each on its row's device."""
    devices = mesh.data_devices()
    return [_to(part, dev) for part, dev in zip(_split(batch, len(devices)), devices)]


def shard_params(mesh: Mesh, module: torch.nn.Module) -> List[torch.nn.Module]:
    """One replica of ``module`` per data shard, on its device: the module
    itself where it already lies there, a deep copy elsewhere."""
    home = next(module.parameters()).device
    return [module if dev == home else copy.deepcopy(module).to(dev)
            for dev in mesh.data_devices()]


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group of a multi-process run: ``coordinator_address``
    ("host:port") of rank 0, the world size and this process's rank, or
    with none of them torch's ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` variables. The backend is NCCL where CUDA
    is available and gloo elsewhere, unless given (gloo takes CUDA tensors
    too, through the host). A rank that waits on the others longer than
    ``PROCESS_GROUP_TIMEOUT`` raises. A second call does nothing."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    dist.init_process_group(backend, timeout=PROCESS_GROUP_TIMEOUT, **kwargs)


def local_rows(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """(data row, device) of each data row this process owns. Process p of
    W owns the devices ``devices.flat[p*n/W:(p+1)*n/W]``; a row it shares
    with other processes (a model axis) is fed by each of them."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    n, m = mesh.size, mesh.shape["model"]
    if n % world:
        raise ValueError(f"{n} mesh devices over {world} processes")
    rows = {}
    for flat in range(rank * n // world, (rank + 1) * n // world):
        rows.setdefault(flat // m, mesh.devices.flat[flat])
    return sorted(rows.items())


def shard_batch_multihost(mesh: Mesh, batch) -> List:
    """``shard_batch`` for one process of several: ``batch`` holds only the
    frames of this process's data rows (``local_rows``), in row order; each
    row's contiguous shard goes to its device, with no transfer between
    processes. In one process it is ``shard_batch``."""
    rows = local_rows(mesh)
    return [_to(part, dev) for part, (_, dev) in zip(_split(batch, len(rows)), rows)]


def data_parallel_program(mesh: Mesh, fn, n_params: int, n_batch_args: int, n_out: int):
    """``fn(params..., batch...)`` over the data shards: the program takes
    each of the first ``n_params`` arguments as one replica per shard
    (``shard_params``) and the next ``n_batch_args`` as one shard each
    (``shard_batch``), runs ``fn`` on each shard in turn with its device
    current, and joins each of the ``n_out`` outputs on dim 0 on the first
    shard's device. It makes no ``torch.distributed`` call: the shards
    share nothing."""
    devices = mesh.data_devices()

    def program(*args):
        if len(args) != n_params + n_batch_args:
            raise TypeError(f"{len(args)} arguments, expected {n_params + n_batch_args}")
        outs = []
        for i, device in enumerate(devices):
            with device_guard(device):
                out = fn(*[a[i] for a in args])
            if len(out) != n_out:
                raise ValueError(f"{len(out)} outputs, expected {n_out}")
            outs.append(out)
        if len(outs) == 1:
            return tuple(outs[0])
        return tuple(torch.cat([o[j].to(devices[0]) for o in outs]) for j in range(n_out))

    return program


def device_guard(device: torch.device):
    """``device`` made current for CUDA launches (nothing to do on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def localhost_address() -> str:
    """"127.0.0.1:<a free port>": a coordinator address for processes of
    one machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def pad_batch_to_devices(batch: np.ndarray, n: int):
    """Pad dim 0 to a multiple of ``n`` by repeating the last item; returns
    (padded, original_len)."""
    b = batch.shape[0]
    rem = (-b) % n
    if rem == 0:
        return batch, b
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b
