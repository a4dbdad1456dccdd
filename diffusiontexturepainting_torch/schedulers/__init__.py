"""Scheduler registry: the JAX package's seven names over its five
schedulers (diffusiontexturepainting_tpu/schedulers/__init__.py), DDIM the
serving default."""

from __future__ import annotations

from .ddim import DDIMScheduler
from .dpm_solver import DPMSolverMultistepScheduler
from .euler_ancestral import EulerAncestralScheduler
from .lms import LMSDiscreteScheduler
from .pndm import PNDMScheduler

_REGISTRY = {
    "DDIM": DDIMScheduler,
    "DPM": DPMSolverMultistepScheduler,
    "DPM++": DPMSolverMultistepScheduler,
    "EulerA": EulerAncestralScheduler,
    "PNDM": PNDMScheduler,
    "LMSD": LMSDiscreteScheduler,
    "LMS": LMSDiscreteScheduler,
}


def make_scheduler(name: str, **kwargs):
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown scheduler {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)


def available_schedulers():
    return sorted(_REGISTRY)
