"""The port's meshes: serving's `--mesh data=1` and training's data axis.

Serving: the mesh-spec parsing of the JAX package's
serving/parallel_model.py make_parallel_service: a comma list of AXIS=N,
the data axis counted in devices (CUDA devices on a card; a CPU model
counts one). The port serves one card: `data` = 1, with request batching
(`--max-batch`) on it. `data` above 1 and `model=N` (the CFG branches over
three chips) are ROADMAP Queue 1 item 11 and raise ValueError, as does a
data axis above the devices present.

Training: the counterpart of the JAX parallel/mesh.py init_distributed and
the data axis of its make_mesh. The JAX trainer puts every device of
every process on `data` and shards each batch over it; the port runs one
process a rank (torch.distributed, `DataRank`): `data` ranks over
`num_processes` processes, data / num_processes of them in each, local
rank i on cuda:i (or the CPU), global rank process_id * data /
num_processes + i. The collectives go over NCCL between cards and over
gloo on the CPU; a caller may ask for gloo on cards too, which lets ranks
share a card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import dataclasses
import logging

logger = logging.getLogger(__name__)

NOT_SERVED = "ROADMAP.md Queue 1 item 11"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data axis of `data` devices (the port serves data = 1)."""

    spec: str
    data: int


def parse_mesh_spec(spec: str, device_count: int) -> dict:
    """'data=1' -> {'data': 1}; no data axis means every device, as the
    JAX package reads it. Raises ValueError for a malformed spec."""
    axes = {}
    for part in str(spec).split(","):
        name, sep, value = part.strip().partition("=")
        if not sep or not name:
            raise ValueError(f"--mesh {spec!r}: expected AXIS=N[,AXIS=N]")
        try:
            axes[name] = int(value)
        except ValueError:
            raise ValueError(f"--mesh {spec!r}: {name} must be an integer") \
                from None
        if axes[name] < 1:
            raise ValueError(f"--mesh {spec!r}: {name} must be >= 1")
    axes.setdefault("data", device_count)
    return axes


def device_count(device) -> int:
    """Devices the data axis may span: CUDA devices for a CUDA model, one
    for a CPU model."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_data_mesh(spec: str, device) -> DataMesh:
    """The data mesh of `spec` over the devices of `device`'s kind. Raises
    ValueError where the port cannot serve it: an axis other than data
    (model=N), data above the devices present, data above 1."""
    count = device_count(device)
    axes = parse_mesh_spec(spec, count)
    data = axes.pop("data")
    if "model" in axes:
        raise ValueError(f"--mesh {spec!r}: model=N (the CFG branches over "
                         f"three chips) is not served by the port yet "
                         f"({NOT_SERVED})")
    if axes:
        raise ValueError(f"unsupported mesh axes for serving: {axes}")
    if data > count:
        raise ValueError(f"mesh data={data} but only {count} devices "
                         f"({NOT_SERVED} serves data > 1)")
    if data > 1:
        raise ValueError(f"mesh data={data}: the port serves one device "
                         f"(data=1, with --max-batch); data > 1 is "
                         f"{NOT_SERVED}")
    return DataMesh(spec=spec, data=data)


@dataclasses.dataclass(frozen=True)
class DataRank:
    """One rank of a training data axis: its global rank, the axis size
    (the world), its index among its process's ranks, its device and the
    collectives' backend (None for a lone rank)."""

    rank: int
    world: int
    local_rank: int
    device: str
    backend: str | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0 alone writes checkpoints, logs and the export."""
        return self.rank == 0

    @property
    def shard(self) -> tuple:
        return self.rank, self.world


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """A training data axis laid over processes and devices: `world`
    ranks, `local` of them in this process (process `process_id` of
    `processes`), collectives over `backend`."""

    world: int
    processes: int
    process_id: int
    local: int
    device_type: str
    backend: str | None

    def rank(self, local_rank: int) -> DataRank:
        """The DataRank of this process's local rank `local_rank`: cuda:i
        (cards shared round-robin where gloo lets ranks share them) or the
        CPU."""
        device = "cpu"
        if self.device_type == "cuda":
            import torch

            device = f"cuda:{local_rank % max(1, torch.cuda.device_count())}"
        return DataRank(rank=self.process_id * self.local + local_rank,
                        world=self.world, local_rank=local_rank,
                        device=device, backend=self.backend)


def plan_data_axis(data, num_processes, process_id, device_type: str,
                   device_count: int, backend: str | None = None
                   ) -> DataAxis:
    """The data axis of `data` ranks (None: every device of every
    process, one on the CPU) over `num_processes` processes (None: one),
    on `device_count` devices a process of `device_type` ("cuda" or
    "cpu"). The backend is NCCL on cards and gloo on the CPU unless
    `backend` names one; only gloo lets ranks share a card. Raises
    ValueError for an axis it cannot lay out."""
    processes = num_processes or 1
    pid = process_id or 0
    if processes < 1 or not 0 <= pid < processes:
        raise ValueError(f"process id {pid} of {processes} processes")
    if data is None:
        data = processes * (device_count if device_type == "cuda" else 1)
    if data < 1:
        raise ValueError(f"a data axis of {data} ranks (no {device_type} "
                         "device?)")
    if data % processes:
        raise ValueError(f"{data} data ranks do not divide over "
                         f"{processes} processes")
    local = data // processes
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if device_type != "cuda":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices; the CPU takes gloo")
        backend = "gloo"
    else:
        backend = backend or "nccl"
        if local > device_count and backend == "nccl":
            raise ValueError(
                f"{local} ranks a process need {local} CUDA devices for "
                f"NCCL, {device_count} visible (NCCL refuses two ranks on "
                "one device; gloo lets ranks share a card)")
    return DataAxis(world=data, processes=processes, process_id=pid,
                    local=local, device_type=device_type,
                    backend=backend if data > 1 else None)


def init_distributed(coordinator, num_processes, process_id, *,
                     data: int, local_rank: int = 0, device_type="cuda",
                     backend: str | None = None) -> DataRank:
    """The counterpart of the JAX init_distributed for one rank: joins the
    process group of `data` ranks at tcp://`coordinator` (host:port; rank
    0 serves it), or at `coordinator` itself where it is a URL (file://
    for ranks of one host), and returns the rank's bookkeeping. A lone
    rank (data 1) joins nothing."""
    import torch

    count = torch.cuda.device_count() if device_type == "cuda" else 1
    axis = plan_data_axis(data, num_processes, process_id, device_type,
                          count, backend)
    rank = axis.rank(local_rank)
    if rank.device.startswith("cuda"):
        torch.cuda.set_device(torch.device(rank.device))
    if axis.world > 1:
        import torch.distributed as dist

        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(axis.backend, init_method=url,
                                world_size=axis.world, rank=rank.rank)
        shared = (axis.device_type == "cuda"
                  and axis.local > torch.cuda.device_count())
        logger.info("data axis: rank %d of %d (local %d) on %s over %s%s",
                    rank.rank, axis.world, local_rank, rank.device,
                    axis.backend, ", ranks sharing cards" if shared else "")
    return rank
