"""Meshes of shards: the port's counterpart of ``jax.sharding.Mesh``.

The JAX package is single-controller: one process owns every device and
``shard_map`` runs each shard from it. The port keeps that design. A
:class:`ShardMesh` names its axes and holds one ``torch.device`` per shard;
the sharded code keeps one tensor per shard in a grid of the mesh's shape
and runs every shard from one Python process. A device may repeat, and then
several shards live on it: that is how the tests put eight shards on the
CPU and how a single card carries four (the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``). On a host with several cards,
``make_mesh`` puts one shard on each.

A mesh may also span processes (:func:`init_process_mesh`, the counterpart
of ``jax.distributed.initialize`` plus a global ``make_mesh``): each shard
then has an owning process, every process holds the same global mesh, and
a grid holds tensors only for the shards its process owns. A
:class:`Transport` carries what crosses between the processes; a mesh
inside one process has none and runs exactly the one-process code.

The policies (``split_band_spatial``, ``split_rows_cols``, the automatic
fill mesh) are those of ``satellite_approximation_tpu/parallel/mesh.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


class Transport:
    """How tensors cross between the processes of a mesh: the
    ``torch.distributed`` backend (:func:`choose_backend`) and where a
    tensor waits while it travels. NCCL moves tensors on this process's
    first card; gloo moves host tensors, and a shard on a card goes
    through a pinned host buffer each way."""

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        self.wire = device if backend == "nccl" else torch.device("cpu")
        self.pin = backend == "gloo" and device.type == "cuda"
        self._groups: dict = {}

    def outgoing(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend sends it from, contiguous."""
        if self.pin and t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return buf.copy_(t)
        return t.to(self.wire).contiguous()

    def incoming(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A buffer that the backend receives into."""
        return torch.empty(tuple(shape), dtype=dtype, device=self.wire, pin_memory=self.pin)

    def group(self, ranks):
        """The process group of ``ranks`` (None for every process). Every
        process must ask for each group in the same order, members or not:
        ``dist.new_group`` is collective over the world."""
        key = tuple(ranks)
        if key not in self._groups:
            self._groups[key] = (None if len(key) == dist.get_world_size()
                                 else dist.new_group(list(key)))
        return self._groups[key]


class ShardMesh:
    """Named axes over a grid of devices, one device per shard.

    ``shape[name]`` is the axis's shard count, ``axis_names`` their order,
    ``devices`` an object array of ``torch.device`` in the mesh's shape and
    ``size`` the number of shards. On a mesh that spans processes,
    ``owners`` holds each shard's process, ``rank`` is this process and
    ``transport`` carries tensors between them (None inside one process)."""

    def __init__(self, shape, axis_names, devices, owners=None, rank: int = 0,
                 transport: Transport | None = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
        devs = [torch.device(d) for d in devices]
        if len(devs) != math.prod(shape):
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} devices, got {len(devs)}")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh's devices must be of one type, got {sorted(map(str, devs))}")
        # "cuda" names the current card; a shard's tensors report its index
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d for d in devs]
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = len(devs)
        grid = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            grid[i] = d
        self.devices = grid.reshape(shape)
        self.owners = (np.zeros(shape, dtype=int) if owners is None
                       else np.asarray(owners, dtype=int).reshape(shape))
        self.rank = int(rank)
        self.transport = transport
        if not (self.owners == self.rank).any():
            raise ValueError(f"process {self.rank} owns no shard of the mesh")

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    @property
    def spans_processes(self) -> bool:
        return self.transport is not None

    def owns(self, idx) -> bool:
        """Whether this process holds the shard at ``idx`` (a flat index or
        a mesh index)."""
        owner = self.owners.flat[idx] if isinstance(idx, (int, np.integer)) else self.owners[idx]
        return int(owner) == self.rank

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.distinct_devices()[0]

    def distinct_devices(self) -> list[torch.device]:
        """The devices of this process's shards, each once, in shard order."""
        mine = self.devices.reshape(-1)[self.owners.reshape(-1) == self.rank]
        return list(dict.fromkeys(mine))

    def require_one_process(self, what: str) -> None:
        """Raise for ``what``, a function with no cross-process form, on a
        mesh that spans processes: it would need whole shards that other
        processes hold."""
        if self.spans_processes:
            n = len(set(self.owners.reshape(-1).tolist()))
            raise NotImplementedError(
                f"{what} runs on a mesh inside one process; this mesh spans {n} processes"
            )

    def __repr__(self) -> str:
        devs = self.devices.reshape(-1)
        distinct = list(dict.fromkeys(devs))
        where = (f"{distinct[0]} x{len(devs)}" if len(distinct) == 1
                 else ", ".join(str(d) for d in devs))
        if self.spans_processes:
            n = len(set(self.owners.reshape(-1).tolist()))
            where += f"; {n} processes over {self.transport.backend}, this is {self.rank}"
        return f"ShardMesh({self.shape}, {where})"


def _cuda_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape, axis_names, devices=None) -> ShardMesh:
    """Mesh over ``prod(shape)`` shards. ``devices=None`` takes the first
    ``prod(shape)`` visible CUDA devices, one shard each, and raises when
    the host has fewer; a sequence gives one device per shard; a single
    device (``"cpu"``, ``"cuda:0"``, a ``torch.device``) holds every shard."""
    n = math.prod(shape)
    if devices is None:
        have = _cuda_devices()
        if len(have) < n:
            raise RuntimeError(
                f"a mesh of {n} shards needs {n} CUDA devices, the host has {len(have)}; "
                "pass devices= to put several shards on one device"
            )
        devices = have[:n]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    return ShardMesh(shape, axis_names, devices)


def _count(n_devices, devices) -> int:
    if n_devices is not None:
        return n_devices
    if devices is None:
        return torch.cuda.device_count()
    if isinstance(devices, (str, torch.device)):
        raise ValueError("n_devices is needed when one device holds every shard")
    return len(devices)


def split_band_spatial(n_devices: int) -> tuple[int, int]:
    """The default (b, x) split: the largest band divisor <= min(4, sqrt(n))."""
    for cand in (4, 3, 2):
        if n_devices % cand == 0 and n_devices // cand >= cand:
            return cand, n_devices // cand
    return 1, n_devices


def split_rows_cols(n_devices: int) -> tuple[int, int]:
    """Most-square (y, x) factorization with y >= x (see spatial_mesh_2d)."""
    x = 1
    f = 2
    while f * f <= n_devices:
        if n_devices % f == 0 and f <= n_devices // f:
            x = max(x, f)
        f += 1
    return n_devices // x, x


def spatial_band_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
                      devices=None) -> ShardMesh:
    """A ('b', 'x') mesh: band (data-parallel) axis x spatial (row) axis.
    The band axis is the largest divisor of n that is <= sqrt(n) and <= 4
    (:func:`split_band_spatial`); ``shape=(b, x)`` overrides it."""
    n = _count(n_devices, devices)
    if shape is not None:
        if shape[0] * shape[1] != n:
            raise ValueError(f"mesh shape {shape} does not cover {n} devices")
        return make_mesh(tuple(shape), ("b", "x"), devices)
    return make_mesh(split_band_spatial(n), ("b", "x"), devices)


def spatial_mesh_2d(n_devices: int | None = None, shape: tuple[int, int, int] | None = None,
                    devices=None) -> ShardMesh:
    """A ('b', 'y', 'x') mesh: every shard to space (b = 1), split as square
    as possible with rows >= cols (:func:`split_rows_cols`); ``shape=(b, y,
    x)`` overrides it."""
    n = _count(n_devices, devices)
    if shape is not None:
        if math.prod(shape) != n:
            raise ValueError(f"mesh shape {shape} does not cover {n} devices")
        return make_mesh(tuple(shape), ("b", "y", "x"), devices)
    y, x = split_rows_cols(n)
    return make_mesh((1, y, x), ("b", "y", "x"), devices)


def spread_devices(n_devices: int, device) -> list[torch.device]:
    """Devices for ``n_devices`` shards: one card a shard where ``device`` is
    CUDA and the host has enough cards, else ``device`` for every shard."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [device] * n_devices


def auto_fill_mesh(bands: int = 1, device=None) -> ShardMesh | None:
    """The JAX package's automatic fill mesh, for a caller to pass as
    ``SolverConfig.mesh``: a ('b', 'x') mesh over every visible CUDA device
    when ``device`` is a CUDA device and the host has more than one, else
    None. The band axis never exceeds the band count. ``"auto"`` does not
    pick it (see :func:`resolve_mesh`)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    b, x = split_band_spatial(n)
    while b > max(bands, 1):
        # fold surplus band shards into the spatial axis
        b, x = b // 2, x * 2
    return make_mesh((b, x), ("b", "x"))


def resolve_mesh(setting) -> ShardMesh | None:
    """``SolverConfig.mesh`` or ``detect(mesh=...)`` -> a mesh or None.

    A :class:`ShardMesh` is used as given; None, "off" and "auto" run on one
    device; anything else raises ``ValueError``. "auto" does not shard:
    sharding a fill over four shards of one card costs 21-32x the
    one-device fill (launches from one thread, host f64 assembly), and no
    run has yet shown several cards paying that back."""
    if isinstance(setting, ShardMesh):
        return setting
    if setting is None or setting in ("off", "auto"):
        return None
    raise ValueError(f"unknown mesh setting {setting!r}")


def process_devices(n_processes: int, per_process: int, device) -> list[list[torch.device]]:
    """Each process's shard devices: one card a shard where ``device`` is
    CUDA and the host has ``n_processes * per_process`` cards (each process
    its own), else ``device`` for every shard of every process."""
    flat = spread_devices(n_processes * per_process, device)
    flat = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d for d in flat]
    return [flat[p * per_process : (p + 1) * per_process] for p in range(n_processes)]


def choose_backend(devices_by_process) -> str:
    """The ``torch.distributed`` backend for processes whose shards live on
    ``devices_by_process``: NCCL where each process owns cards of its own
    (tensors stay on the card); gloo on the CPU, and where processes share
    a card, which NCCL refuses (two ranks on one GPU): the shards then
    travel through pinned host buffers (:class:`Transport`)."""
    owner: dict = {}
    for p, devs in enumerate(devices_by_process):
        for d in devs:
            owner.setdefault(torch.device(d), set()).add(p)
    if any(d.type != "cuda" for d in owner):
        return "gloo"
    return "nccl" if all(len(ps) == 1 for ps in owner.values()) else "gloo"


def init_process_mesh(shape, axis_names, coordinator: str, num_processes: int, process_id: int,
                      per_process: int, device=None, timeout_s: float = 600.0) -> ShardMesh:
    """Start the process group and return the global mesh, as this process
    sees it: the counterpart of ``jax.distributed.initialize(coordinator,
    num_processes, process_id)`` followed by ``make_mesh(shape,
    axis_names)``. Process p owns shards p * per_process .. (p + 1) *
    per_process - 1 in shard order, on its own cards where the host has one
    a shard (:func:`process_devices`); ``device=None`` is the card and
    raises without one. ``coordinator`` is "host:port" of process 0. A
    failed start raises; nothing falls back to another backend."""
    import datetime

    if math.prod(shape) != num_processes * per_process:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {num_processes} processes "
                         f"of {per_process} shards")
    by_process = process_devices(num_processes, per_process, resolve_device(device))
    mine = by_process[process_id]
    backend = choose_backend(by_process)
    if mine[0].type == "cuda":
        torch.cuda.set_device(mine[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    # every rank takes part in the first collective (NCCL's point-to-point
    # batches may not come first)
    if backend == "nccl":
        dist.barrier(device_ids=[mine[0].index])
    else:
        dist.barrier()
    owners = np.repeat(np.arange(num_processes), per_process)
    return ShardMesh(shape, axis_names, [d for devs in by_process for d in devs], owners=owners,
                     rank=process_id, transport=Transport(backend, mine[0]))
