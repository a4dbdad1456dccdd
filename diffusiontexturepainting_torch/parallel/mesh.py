"""The serving mesh of the port: what `--mesh data=1` needs.

Port of the mesh-spec parsing of the JAX package's
serving/parallel_model.py make_parallel_service: a comma list of AXIS=N,
the data axis counted in devices (CUDA devices on a card; a CPU model
counts one). The port serves one card: `data` = 1, with request batching
(`--max-batch`) on it. `data` above 1 and `model=N` (the CFG branches over
three chips) are ROADMAP Queue 1 item 11 and raise ValueError, as does a
data axis above the devices present.
"""

from __future__ import annotations

import dataclasses

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
