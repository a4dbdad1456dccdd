"""The painting client's binary protocol, for the requests the port serves.

Byte for byte the layout of the JAX package's serving/server_io.py
(tests/test_torch_port_serving.py holds the two codecs and the two request
handlers equal), little-endian:

  request   [u8 type][u8 steps][u8 context_pad][u8 tg_steps][u16 width]
            [f32 cfg_weight][f32 tg_weight] + payload
  response  [u8 type] + payload
  image     [i32 width][i32 height][i32 channels][u8 pixels, HWC]

NEW_BRUSH_PROMPT (type 1) carries [u32 length][utf-8 prompt] after the
settings header.

Stroke sessions (types 16-23) carry after the settings header: an RGBA
canvas image (BEGIN_SESSION), [i32 x0][i32 y0][u8 flags] (STAMP_AT and
ERASE_AT; flag 1 return pixels, flag 2 overpaint) or nothing (FETCH_CANVAS,
END_SESSION). Their replies: RETURN_ACK [u32 seq], RETURN_CANVAS + image,
RETURN_STAMP + image, or RETURN_ERROR [u32 length][utf-8 message].

`handle_request_bytes` answers NEW_BRUSH_PROMPT and NEW_BRUSH_IMAGE (a
brush preview), NEW_STAMP and the session requests, in the order of the JAX
package's serving/handler.py, with its two diagnostics: `debug_dir` saves
each request's images as `{time:.3f}_{tag}_{name}.npy` (tags brush_prompt,
brush, stamp), and `profile_dir` writes a torch.profiler trace of each
request there (CPU and, on a card, CUDA activity; Chrome JSON), the first
PROFILE_TRACE_CAP requests of a process only.
"""

from __future__ import annotations

import enum
import logging
import os
import struct
import time

import numpy as np

from .model_base import ensure_float01, float01_to_uint8, procedural_brush

logger = logging.getLogger(__name__)

_TYPE = struct.Struct("<B")
_SETTINGS = struct.Struct("<BBBHff")  # steps, context_pad, tg_steps, width,
#                                       cfg_weight, tg_weight
_IMAGE = struct.Struct("<iii")  # width, height, channels
_COORDS = struct.Struct("<iiB")  # x0, y0, flags
_U32 = struct.Struct("<I")

COORDS_FLAG_RETURN_PIXELS = 1
COORDS_FLAG_OVERPAINT = 2
_ERROR_BYTES = 4096  # a RETURN_ERROR message is cut to this


class RequestType(enum.IntEnum):
    NEW_BRUSH_IMAGE = 0
    NEW_BRUSH_PROMPT = 1  # [u32 length][utf-8 prompt] -> RETURN_PREVIEW
    NEW_STAMP = 2
    RETURN_PREVIEW = 3
    RETURN_STAMP = 4
    BEGIN_SESSION = 16  # canvas -> RETURN_ACK 0
    STAMP_AT = 17  # coords -> RETURN_STAMP, or RETURN_ACK without pixels
    ERASE_AT = 18  # coords -> RETURN_STAMP, or RETURN_ACK without pixels
    FETCH_CANVAS = 19  # -> RETURN_CANVAS
    END_SESSION = 20  # -> RETURN_ACK
    RETURN_ACK = 21
    RETURN_CANVAS = 22
    RETURN_ERROR = 23


def is_session_request(kind: int) -> bool:
    return RequestType.BEGIN_SESSION <= kind <= RequestType.END_SESSION


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


def _header(kind: RequestType, steps: int = 20, width: int = 256,
            context_pad: int = 150, cfg_weight: float = 2.0,
            tg_weight: float = 0.0, tg_steps: int = 0) -> bytes:
    """Type and settings header."""
    return (_TYPE.pack(kind)
            + _SETTINGS.pack(int(steps) & 0xFF, int(context_pad) & 0xFF,
                             int(tg_steps) & 0xFF, int(width) & 0xFFFF,
                             float(cfg_weight), float(tg_weight)))


def encode_request(kind: RequestType, image: np.ndarray,
                   **settings) -> bytes:
    """A full request: type, settings header, image."""
    return _header(kind, **settings) + _image_bytes(image)


def _decode_header(raw: bytes):
    """-> (type, settings dict, offset of the payload)."""
    (kind,) = _TYPE.unpack_from(raw, 0)
    steps, context_pad, tg_steps, width, cfg_weight, tg_weight = \
        _SETTINGS.unpack_from(raw, _TYPE.size)
    settings = dict(steps=steps, context_pad=context_pad, tg_steps=tg_steps,
                    width=width, cfg_weight=cfg_weight, tg_weight=tg_weight)
    return kind, settings, _TYPE.size + _SETTINGS.size


def decode_request(raw: bytes):
    """-> (type, settings dict, image view of `raw`)."""
    kind, settings, offset = _decode_header(raw)
    return kind, settings, _image_at(raw, offset)


def encode_prompt_payload(prompt: str) -> bytes:
    data = prompt.encode("utf-8")
    return _U32.pack(len(data)) + data


def decode_prompt_payload(raw: bytes, offset: int = 0) -> str:
    (length,) = _U32.unpack_from(raw, offset)
    start = offset + _U32.size
    return bytes(raw[start:start + length]).decode("utf-8")


def encode_brush_prompt_request(prompt: str, **settings) -> bytes:
    """A full NEW_BRUSH_PROMPT request: type, settings header, prompt."""
    return (_header(RequestType.NEW_BRUSH_PROMPT, **settings)
            + encode_prompt_payload(prompt))


# --- stroke sessions ---


def encode_coords(x0: int, y0: int, return_pixels: bool = True,
                  overpaint: bool = False) -> bytes:
    flags = ((COORDS_FLAG_RETURN_PIXELS if return_pixels else 0)
             | (COORDS_FLAG_OVERPAINT if overpaint else 0))
    return _COORDS.pack(int(x0), int(y0), flags)


def decode_coords(raw: bytes, offset: int) -> dict:
    x0, y0, flags = _COORDS.unpack_from(raw, offset)
    return dict(x0=x0, y0=y0,
                return_pixels=bool(flags & COORDS_FLAG_RETURN_PIXELS),
                overpaint=bool(flags & COORDS_FLAG_OVERPAINT))


def encode_begin_session(canvas: np.ndarray, **settings) -> bytes:
    return encode_request(RequestType.BEGIN_SESSION, canvas, **settings)


def encode_stamp_at(x0: int, y0: int, return_pixels: bool = True,
                    overpaint: bool = False, **settings) -> bytes:
    return (_header(RequestType.STAMP_AT, **settings)
            + encode_coords(x0, y0, return_pixels, overpaint))


def encode_erase_at(x0: int, y0: int, return_pixels: bool = True) -> bytes:
    return (_header(RequestType.ERASE_AT)
            + encode_coords(x0, y0, return_pixels))


def encode_fetch_canvas() -> bytes:
    return _header(RequestType.FETCH_CANVAS)


def encode_end_session() -> bytes:
    return _header(RequestType.END_SESSION)


def encode_ack(seq: int) -> bytes:
    return _TYPE.pack(RequestType.RETURN_ACK) + _U32.pack(int(seq)
                                                          & 0xFFFFFFFF)


def decode_ack(raw: bytes) -> tuple[int, int]:
    """-> (type, seq)."""
    return _TYPE.unpack_from(raw, 0)[0], _U32.unpack_from(raw, _TYPE.size)[0]


def encode_error(message: str) -> bytes:
    data = str(message).encode("utf-8")[:_ERROR_BYTES]
    return _TYPE.pack(RequestType.RETURN_ERROR) + _U32.pack(len(data)) + data


def decode_error(raw: bytes) -> tuple[int, str]:
    """-> (type, message)."""
    (length,) = _U32.unpack_from(raw, _TYPE.size)
    start = _TYPE.size + _U32.size
    return (_TYPE.unpack_from(raw, 0)[0],
            bytes(raw[start:start + length]).decode("utf-8", "replace"))


def encode_response(kind: RequestType, image: np.ndarray) -> bytes:
    return _TYPE.pack(kind) + _image_bytes(image)


def decode_response(raw: bytes):
    """-> (type, image view of `raw`)."""
    return _TYPE.unpack_from(raw, 0)[0], _image_at(raw, _TYPE.size)


def _next_session_seq(model) -> int:
    model._session_seq = getattr(model, "_session_seq", 0) + 1
    return model._session_seq


def handle_session_request(model, raw: bytes) -> bytes:
    """One stroke-session request (is_session_request) -> its reply. A
    STAMP_AT or ERASE_AT without pixels replies RETURN_ACK with the next
    sequence number as soon as the model has dispatched it; BEGIN_SESSION
    restarts the sequence at 0."""
    R = RequestType
    kind, settings, offset = _decode_header(raw)
    if kind == R.BEGIN_SESSION:
        model.begin_session(_image_at(raw, offset))
        model._session_seq = 0
        return encode_ack(0)
    if kind in (R.STAMP_AT, R.ERASE_AT):
        coords = decode_coords(raw, offset)
        if kind == R.STAMP_AT:
            crop = model.stamp_at(coords["x0"], coords["y0"],
                                  return_pixels=coords["return_pixels"],
                                  overpaint=coords["overpaint"], **settings)
        else:
            crop = model.erase_at(coords["x0"], coords["y0"],
                                  return_pixels=coords["return_pixels"])
        if coords["return_pixels"]:
            return encode_response(R.RETURN_STAMP, np.asarray(crop))
        return encode_ack(_next_session_seq(model))
    if kind == R.FETCH_CANVAS:
        return encode_response(R.RETURN_CANVAS, model.fetch_canvas())
    if kind == R.END_SESSION:
        model.end_session()
        return encode_ack(_next_session_seq(model))
    raise ValueError(f"request type {kind} is not a session request")


_nvcf_key_warned = False


def brush_from_prompt(prompt: str, size: int) -> np.ndarray:
    """The prompt's brush: always the procedural one. The JAX package asks
    a hosted text-to-image service when DTP_NVCF_API_KEY is set and decodes
    its reply with Pillow; the port has neither network nor Pillow, so it
    warns once that it ignores the key."""
    global _nvcf_key_warned
    if os.environ.get("DTP_NVCF_API_KEY") and not _nvcf_key_warned:
        _nvcf_key_warned = True
        logger.warning("DTP_NVCF_API_KEY is set, but the port does not call "
                       "the text-to-image service: NEW_BRUSH_PROMPT uses the "
                       "procedural brush")
    return procedural_brush(prompt, size=size)


def _preview_reply(model, settings) -> bytes:
    """RETURN_PREVIEW of the model's current brush."""
    context = model.create_preview_brush_context(model.image)
    result = model.generate(context, **settings)
    return encode_response(RequestType.RETURN_PREVIEW,
                           float01_to_uint8(result))


def _debug_dump(debug_dir, tag, **arrays):
    """Save a request's images for offline inspection."""
    if not debug_dir:
        return
    os.makedirs(debug_dir, exist_ok=True)
    stamp = f"{time.time():.3f}"
    for name, arr in arrays.items():
        np.save(os.path.join(debug_dir, f"{stamp}_{tag}_{name}.npy"), arr)


# the most requests a process traces under profile_dir (a trace costs the
# request's latency and disk): then one warning, and no more traces
PROFILE_TRACE_CAP = 32
_profile_traces = 0


def _traced(profile_dir, fn):
    """fn() under a torch.profiler trace written to profile_dir as
    Chrome JSON, `{time:.3f}_{n:02d}.trace.json`."""
    global _profile_traces
    import torch
    from torch.profiler import ProfilerActivity, profile

    _profile_traces += 1
    if _profile_traces == PROFILE_TRACE_CAP:
        logger.warning("profile_dir: trace cap (%d) reached - further "
                       "requests will not be traced", PROFILE_TRACE_CAP)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        reply = fn()
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{time.time():.3f}_{_profile_traces:02d}.trace.json"))
    return reply


def handle_request_bytes(model, raw: bytes, debug_dir: str | None = None,
                         profile_dir: str | None = None) -> bytes:
    """Decode one request, run the model, return the encoded reply."""
    if profile_dir and _profile_traces < PROFILE_TRACE_CAP:
        return _traced(profile_dir, lambda: handle_request_bytes(
            model, raw, debug_dir=debug_dir))
    if raw[0] == RequestType.NEW_BRUSH_PROMPT:
        _, settings, offset = _decode_header(raw)
        prompt = decode_prompt_payload(raw, offset)
        brush = brush_from_prompt(prompt, model.resolution())
        model.set_brush(ensure_float01(brush))
        _debug_dump(debug_dir, "brush_prompt", brush=brush)
        return _preview_reply(model, settings)
    if is_session_request(raw[0]):
        return handle_session_request(model, raw)
    kind, settings, image = decode_request(raw)
    if kind == RequestType.NEW_BRUSH_IMAGE:
        model.set_brush(ensure_float01(image[..., :3]))
        _debug_dump(debug_dir, "brush", brush=image)
        return _preview_reply(model, settings)
    if kind == RequestType.NEW_STAMP:
        # the uint8 fast path where the model has one (the torch model);
        # the mock goes through generate
        if hasattr(model, "generate_u8"):
            result = model.generate_u8(image, **settings)
        else:
            result = float01_to_uint8(
                model.generate(ensure_float01(image), **settings))
        _debug_dump(debug_dir, "stamp", canvas=image, result=result)
        return encode_response(RequestType.RETURN_STAMP, result)
    raise NotImplementedError(f"request type {kind} is not served by the "
                              "port")
