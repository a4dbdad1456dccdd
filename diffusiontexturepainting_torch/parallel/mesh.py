"""The port's meshes: serving's `--mesh data=N` and `--mesh model=3`, and
training's (data, model) axes.

Serving: the mesh-spec parsing of the JAX package's serving/run.py and
serving/parallel_model.py make_parallel_service: a comma list of AXIS=N.
`data=N` (no data axis means every device, as the JAX package reads it)
shards a batch of requests over N devices and pins stroke sessions to
them (serving/parallel_model.py); `model=3` runs the CFG triple-batch
UNet a guidance branch a device (parallel/cfg_shard.py). The devices are
an explicit list where a caller gives one, which may repeat a device (a
test, the one-card smoke), else every CUDA device of the machine (a CPU
model counts one). What the JAX package refuses is refused here with its
message: more devices than present, `model` other than 3, `model`
combined with another axis, --max-batch with `model`, an axis other than
data and model.

Training: the counterpart of the JAX parallel/mesh.py init_distributed,
make_mesh and param_spec. The JAX trainer lays every device of every
process on a (data, model) mesh; the port runs one process a rank
(torch.distributed, `DataRank`): data x model ranks over `num_processes`
processes, world / num_processes of them in each, local rank i on cuda:i
(or the CPU), global rank process_id * world / num_processes + i, which
is (data index d, model index m) = divmod(rank, model), as the JAX mesh's
devices reshape to (data, model). A batch is sharded over `data` and
replicated over `model`: the ranks of one model group prepare the same
rows and draws. The frozen towers' leaves are sharded over the model group
on their output-channel dim where param_spec shards the JAX leaf
(`ModelShards`), and gathered on use; gradients are averaged over the data
group. The collectives go over NCCL between cards and over gloo on the
CPU; a caller may ask for gloo on cards too, which lets ranks share a card
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A data axis of `data` devices (`devices`, torch device strings, one
    a share of a batch; a list may repeat a device; empty: the serving
    model's device, `data` times)."""

    spec: str
    data: int
    devices: tuple = ()


@dataclasses.dataclass(frozen=True)
class CfgMesh:
    """A model axis of 3 devices, guidance branch i on devices[i]; the
    model's VAE, scheduler, brush encoder and composite on devices[0]."""

    spec: str
    devices: tuple

    @property
    def model(self) -> int:
        return len(self.devices)


def parse_mesh_spec(spec: str, device_count: int) -> dict:
    """'data=1' -> {'data': 1}; no data axis means every device, as the
    JAX package reads it (where no model axis is given). Raises ValueError
    for a malformed spec."""
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
    if "model" not in axes:
        axes.setdefault("data", device_count)
    return axes


def mesh_devices(device, devices=None) -> list:
    """The devices a mesh takes its axis from: `devices` where given (an
    explicit list, which may repeat a device), else every CUDA device
    (cuda:0, cuda:1, ...) for a CUDA model, ["cpu"] for a CPU one."""
    import torch

    if devices is not None:
        return [str(torch.device(d)) for d in devices]
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ["cpu"]


def make_cfg_mesh(n: int = 3, devices=None, device="cuda") -> CfgMesh:
    """The model axis of `n` devices, the first n of `devices`
    (mesh_devices); ValueError as the JAX make_cfg_mesh and
    cfg_sharded_models raise it: fewer devices than n, n other than 3."""
    present = mesh_devices(device, devices)
    if len(present) < n:
        raise ValueError(f"mesh model={n} but only {len(present)} devices")
    if n != 3:
        raise ValueError(
            f"CFG-branch sharding needs mesh axis 'model'=3 (one chip per "
            f"guidance branch), got {{'model': {n}}}")
    return CfgMesh(spec=f"model={n}", devices=tuple(present[:n]))


def make_data_mesh(spec: str, device, devices=None) -> DataMesh:
    """The data mesh of `spec` over mesh_devices(device, devices): its
    first `data` of them. Raises ValueError as the JAX
    make_parallel_service does: an axis other than data, data above the
    devices present."""
    present = mesh_devices(device, devices)
    axes = parse_mesh_spec(spec, len(present))
    data = axes.pop("data")
    if axes:
        raise ValueError(f"unsupported mesh axes for serving: {axes}")
    if data > len(present):
        raise ValueError(f"mesh data={data} but only {len(present)} "
                         "devices")
    return DataMesh(spec=spec, data=data, devices=tuple(present[:data]))


def make_serving_mesh(spec: str, device, devices=None,
                      max_batch: int | None = None):
    """run.py's --mesh: a CfgMesh where the spec names a model axis (JAX
    serving/run.py's order of refusals: another axis with it, --max-batch
    with it, too few devices, model other than 3), else a DataMesh."""
    present = mesh_devices(device, devices)
    axes = parse_mesh_spec(spec, len(present))
    if "model" not in axes:
        return make_data_mesh(spec, device, devices)
    n = axes.pop("model")
    if axes:
        raise ValueError(f"--mesh model=N cannot combine with {axes}")
    if max_batch and max_batch > 1:
        raise ValueError("--max-batch applies to --mesh data=N request "
                         "batching, not --mesh model=N")
    return make_cfg_mesh(n, present)


# --- training: the (data, model) axes ---


def param_spec_dim(shape, model_size: int):
    """The JAX param_spec's rule for a leaf of `shape` (the JAX leaf's):
    its trailing (output-channel) dim where it divides by model_size and is
    at least 2 * model_size, else None (replicated)."""
    if (model_size > 1 and len(shape) >= 1 and shape[-1] % model_size == 0
            and shape[-1] >= 2 * model_size):
        return len(shape) - 1
    return None


def jax_leaf_shapes(component: str, shapes: dict) -> dict:
    """{name: the JAX leaf's shape} of the port's tensors {name: shape} of
    `component`: the same, but for a Dense kernel, which the port keeps as
    nn.Linear's (out, in) (weights/from_jax.py; a normalization layer is
    an owner whose weight is 1-D, as jax_tree_from_state_dict reads it)."""
    from ..weights.from_jax import jax_path

    norms = {k.rsplit(".", 1)[0] for k, v in shapes.items()
             if k.endswith(".weight") and len(v) == 1}
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        path = jax_path(component, name,
                        "." in name and name.rsplit(".", 1)[0] in norms)
        transposed = path.endswith("kernel") and len(shape) == 2
        out[name] = shape[::-1] if transposed else shape
    return out


def shard_dims(component: str, shapes: dict, model_size: int) -> dict:
    """{name: the dim of the port's tensor that a model axis of model_size
    shards} for every tensor of {name: shape} that param_spec shards
    (param_spec_dim of the JAX leaf, mapped back through a Dense kernel's
    transpose); the others are replicated and absent."""
    out = {}
    for name, jshape in jax_leaf_shapes(component, shapes).items():
        dim = param_spec_dim(jshape, model_size)
        if dim is not None:
            out[name] = 0 if jshape != tuple(shapes[name]) else dim
    return out


class ModelShards:
    """The frozen towers' leaves held sharded over a model group.

    `modules` {component: module} (the component names of
    weights/from_jax.py; of "patch_encoder" only the CLIP tower, "clip.*",
    is frozen and sharded); rank `index` of a group of `size` keeps, of
    every leaf shard_dims shards, its index-th slice of that dim, moved to
    the front (the parameter's data is that slice: the module cannot run
    without gathering). gather(component) all-gathers a tower's shards in
    one collective of their bytes and returns {name: full tensor};
    full(component) puts the full tensors into the module's parameters
    for a block (no autograd: the frozen towers' encodes) and the shards
    back after. from_host(weights) makes both build the full tensors from
    host copies instead, with no collective (a rank alone: the validation
    grid)."""

    def __init__(self, modules: dict, index: int, size: int, group=None,
                 backend: str | None = None, lead: int = 0):
        import torch

        self.index, self.size = index, size
        self.lead = lead  # the global rank of the group's index 0
        self.group, self.backend = group, backend
        self.leaves = {c: {} for c in modules}  # {name: (param, dim, shape)}
        self.modules = modules
        self._host = None
        for comp, module in modules.items():
            params = dict(module.named_parameters())
            dims = shard_dims(comp, {n: tuple(p.shape) for n, p in
                                     params.items()}, size)
            for name, dim in dims.items():
                if comp == "patch_encoder" and not name.startswith("clip."):
                    continue
                p = params[name]
                full_shape = tuple(p.shape)
                with torch.no_grad():
                    p.data = p.data.movedim(dim, 0).chunk(size)[index] \
                        .clone(memory_format=torch.contiguous_format)
                self.leaves[comp][name] = (p, dim, full_shape)

    def resting_bytes(self) -> int:
        """The bytes of every frozen tower's parameters as this rank holds
        them (shards and replicated leaves)."""
        total = 0
        for comp, module in self.modules.items():
            for name, p in module.named_parameters():
                if comp != "patch_encoder" or name.startswith("clip."):
                    total += p.numel() * p.element_size()
        return total

    def gather(self, component: str, skip=()) -> dict:
        """{name: the full tensor} of every sharded leaf of `component` but
        those named in `skip` (the same on every rank)."""
        import torch

        leaves = {n: v for n, v in self.leaves[component].items()
                  if n not in skip}
        if not leaves:
            return {}
        if self._host is not None:
            host = self._host[component]
            return {n: host[n].to(p.device, p.dtype)
                    for n, (p, _, _) in leaves.items()}
        shards = [p.data.reshape(-1).view(torch.uint8)
                  for p, _, _ in leaves.values()]
        flat = torch.cat(shards)
        everyone = all_gather_bytes(flat, self.size, self.group,
                                    self.backend)
        out, at = {}, 0
        for (name, (p, dim, shape)), piece in zip(leaves.items(), shards):
            n = piece.numel()
            part = everyone[:, at:at + n].contiguous().view(p.dtype)
            at += n
            whole = part.reshape((self.size * p.shape[0],) + p.shape[1:])
            out[name] = whole.movedim(0, dim).contiguous()
            assert tuple(out[name].shape) == shape, (name, shape)
        return out

    @contextlib.contextmanager
    def full(self, component: str):
        """The module of `component` with its full parameters inside (no
        autograd: the parameters' data is swapped in and out)."""
        import torch

        full = self.gather(component)
        leaves = self.leaves[component]
        shards = {name: p.data for name, (p, _, _) in leaves.items()}
        with torch.no_grad():
            for name, t in full.items():
                leaves[name][0].data = t
        try:
            yield
        finally:
            with torch.no_grad():
                for name, (p, _, _) in leaves.items():
                    p.data = shards[name]

    @contextlib.contextmanager
    def from_host(self, weights: dict):
        """gather() and full() from `weights` ({component: fp32 host
        state_dict}) inside, cast to each parameter's dtype: no
        collective."""
        self._host = weights
        try:
            yield
        finally:
            self._host = None


def all_gather_bytes(flat, size: int, group=None, backend=None):
    """(size, n) uint8: every rank of `group`'s n bytes `flat`, in group
    rank order. NCCL gathers on the card; gloo through the host."""
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        out = torch.empty(size * flat.numel(), dtype=torch.uint8,
                          device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=group)
        return out.view(size, -1)
    out = torch.empty((size, flat.numel()), dtype=torch.uint8)
    dist.all_gather(list(out.unbind(0)), flat.cpu(), group=group)
    return out.to(flat.device)


@dataclasses.dataclass(frozen=True)
class DataRank:
    """One rank of a training mesh: its global rank, the world (data x
    model ranks), its index among its process's ranks, its device, the
    collectives' backend (None for a lone rank) and the model axis's size;
    (data index, model index) = divmod(rank, model)."""

    rank: int
    world: int
    local_rank: int
    device: str
    backend: str | None = None
    model: int = 1

    @property
    def is_main(self) -> bool:
        """Rank 0 alone writes checkpoints, logs and the export."""
        return self.rank == 0

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shard(self) -> tuple:
        """(data index, data size): the rows and draws this rank takes, the
        same for every rank of a model group."""
        return self.data_index, self.data


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """A training mesh laid over processes and devices: `world` ranks
    (data x `model`), `local` of them in this process (process
    `process_id` of `processes`), collectives over `backend`."""

    world: int
    processes: int
    process_id: int
    local: int
    device_type: str
    backend: str | None
    model: int = 1

    @property
    def data(self) -> int:
        return self.world // self.model

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
                        device=device, backend=self.backend,
                        model=self.model)


def plan_data_axis(data, num_processes, process_id, device_type: str,
                   device_count: int, backend: str | None = None,
                   model: int = 1) -> DataAxis:
    """The mesh of `data` x `model` ranks (data None: every device of every
    process over `model`, as the JAX make_mesh; one on the CPU) over
    `num_processes` processes (None: one), on `device_count` devices a
    process of `device_type` ("cuda" or "cpu"). The backend is NCCL on
    cards and gloo on the CPU unless `backend` names one; only gloo lets
    ranks share a card. Raises ValueError for a mesh it cannot lay out."""
    processes = num_processes or 1
    pid = process_id or 0
    if processes < 1 or not 0 <= pid < processes:
        raise ValueError(f"process id {pid} of {processes} processes")
    if model < 1:
        raise ValueError(f"a model axis of {model} ranks")
    if data is None:
        data = (processes * device_count // model if device_type == "cuda"
                else 1)
    if data < 1:
        raise ValueError(f"a data axis of {data} ranks (no {device_type} "
                         "device?)")
    world = data * model
    if world % processes:
        raise ValueError(f"{world} ranks ({data} data x {model} model) do "
                         f"not divide over {processes} processes"
                         if model > 1 else
                         f"{data} data ranks do not divide over "
                         f"{processes} processes")
    local = world // processes
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
    return DataAxis(world=world, processes=processes, process_id=pid,
                    local=local, device_type=device_type,
                    backend=backend if world > 1 else None, model=model)


def init_distributed(coordinator, num_processes, process_id, *,
                     data: int, local_rank: int = 0, device_type="cuda",
                     backend: str | None = None, model: int = 1) -> DataRank:
    """The counterpart of the JAX init_distributed for one rank: joins the
    process group of `data` x `model` ranks at tcp://`coordinator`
    (host:port; rank 0 serves it), or at `coordinator` itself where it is a
    URL (file:// for ranks of one host), and returns the rank's
    bookkeeping. A lone rank joins nothing."""
    import torch

    count = torch.cuda.device_count() if device_type == "cuda" else 1
    axis = plan_data_axis(data, num_processes, process_id, device_type,
                          count, backend, model)
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
        logger.info("mesh: rank %d of %d (local %d, data %d of %d, model "
                    "%d of %d) on %s over %s%s", rank.rank, axis.world,
                    local_rank, rank.data_index, rank.data,
                    rank.model_index, rank.model, rank.device, axis.backend,
                    ", ranks sharing cards" if shared else "")
    return rank


def mesh_groups(rank: DataRank):
    """(data group, model group) of `rank`: the ranks of its model index
    (over which gradients are averaged) and those of its data index (over
    which the frozen towers are sharded). Every rank makes every group, in
    the same order (dist.new_group's rule): the model groups by data
    index, then the data groups by model index. A whole-world data group is
    the default group (None); a model axis of 1 has no model group."""
    import torch.distributed as dist

    data, model = rank.data, rank.model
    if model == 1:
        return None, None
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    return data_groups[rank.model_index], model_groups[rank.data_index]
