"""Client settings (the analog of the reference's carb settings,
kit_app/.../util/settings.py:11, extension.toml:67-69).

From diffusiontexturepainting_tpu/utils/settings.py, with its variable
names and defaults, keeping only the values a module of the port reads:
client/library.py takes a remote model's URL and every model's resolution
from here. Resolution order: environment variable > programmatic override
> default.
"""

from __future__ import annotations

import os

_OVERRIDES: dict = {}

DEFAULTS = {
    "DTP_SERVER_URL": "ws://localhost:6060/websocket/",
    "DTP_RESOLUTION": "256",
}


def get(name: str, default=None) -> str:
    if name in os.environ:
        return os.environ[name]
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    return DEFAULTS.get(name, default)


def set_override(name: str, value):
    _OVERRIDES[name] = str(value)


def resolution() -> int:
    return int(get("DTP_RESOLUTION"))
