"""The painting client's binary protocol, for the requests the port serves.

Byte for byte the layout of the JAX package's serving/server_io.py
(tests/test_torch_port_serving.py holds the two codecs and the two request
handlers equal), little-endian:

  request   [u8 type][u8 steps][u8 context_pad][u8 tg_steps][u16 width]
            [f32 cfg_weight][f32 tg_weight] + image
  response  [u8 type] + image
  image     [i32 width][i32 height][i32 channels][u8 pixels, HWC]

`handle_request_bytes` answers NEW_BRUSH_IMAGE (a brush preview) and
NEW_STAMP, in the order of the JAX package's serving/handler.py.
"""

from __future__ import annotations

import enum
import struct

import numpy as np

from .model_base import float01_to_uint8

_TYPE = struct.Struct("<B")
_SETTINGS = struct.Struct("<BBBHff")  # steps, context_pad, tg_steps, width,
#                                       cfg_weight, tg_weight
_IMAGE = struct.Struct("<iii")  # width, height, channels


class RequestType(enum.IntEnum):
    NEW_BRUSH_IMAGE = 0
    NEW_STAMP = 2
    RETURN_PREVIEW = 3
    RETURN_STAMP = 4


def _image_bytes(image: np.ndarray) -> bytes:
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"image must be HWC uint8, got {image.dtype} "
                         f"{image.shape}")
    h, w, c = image.shape
    return _IMAGE.pack(w, h, c) + np.ascontiguousarray(image).tobytes()


def _image_at(raw: bytes, offset: int) -> np.ndarray:
    w, h, c = _IMAGE.unpack_from(raw, offset)
    return np.frombuffer(raw, np.uint8, count=h * w * c,
                         offset=offset + _IMAGE.size).reshape(h, w, c)


def encode_request(kind: RequestType, image: np.ndarray, steps: int = 20,
                   width: int = 256, context_pad: int = 150,
                   cfg_weight: float = 2.0, tg_weight: float = 0.0,
                   tg_steps: int = 0) -> bytes:
    """A full request: type, settings header, image."""
    return (_TYPE.pack(kind)
            + _SETTINGS.pack(int(steps) & 0xFF, int(context_pad) & 0xFF,
                             int(tg_steps) & 0xFF, int(width) & 0xFFFF,
                             float(cfg_weight), float(tg_weight))
            + _image_bytes(image))


def decode_request(raw: bytes):
    """-> (type, settings dict, image view of `raw`)."""
    (kind,) = _TYPE.unpack_from(raw, 0)
    steps, context_pad, tg_steps, width, cfg_weight, tg_weight = \
        _SETTINGS.unpack_from(raw, _TYPE.size)
    settings = dict(steps=steps, context_pad=context_pad, tg_steps=tg_steps,
                    width=width, cfg_weight=cfg_weight, tg_weight=tg_weight)
    return kind, settings, _image_at(raw, _TYPE.size + _SETTINGS.size)


def encode_response(kind: RequestType, image: np.ndarray) -> bytes:
    return _TYPE.pack(kind) + _image_bytes(image)


def decode_response(raw: bytes):
    """-> (type, image view of `raw`)."""
    return _TYPE.unpack_from(raw, 0)[0], _image_at(raw, _TYPE.size)


def handle_request_bytes(model, raw: bytes) -> bytes:
    """Decode one request, run the model, return the encoded reply."""
    kind, settings, image = decode_request(raw)
    if kind == RequestType.NEW_BRUSH_IMAGE:
        model.set_brush(image[..., :3])
        context = model.create_preview_brush_context(model.image)
        result = model.generate(context, **settings)
        return encode_response(RequestType.RETURN_PREVIEW,
                               float01_to_uint8(result))
    if kind == RequestType.NEW_STAMP:
        return encode_response(RequestType.RETURN_STAMP,
                               model.generate_u8(image, **settings))
    raise NotImplementedError(f"request type {kind} is not served by the "
                              "port")
