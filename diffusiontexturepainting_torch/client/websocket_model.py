"""Websocket inpainter client.

Port of diffusiontexturepainting_tpu/client/websocket_model.py over the
port's codec (serving/wire.py): it speaks the binary wire protocol to a
remote inference server, the analog of both reference client copies
(trt_inference/websocket_model.py:19-87 and kit_app/.../inference/
websocket_model.py:19-94), including the Kit client's empty-mask
short-circuit and the lazy NEW_BRUSH_IMAGE send, and sends the JAX
client's frames byte for byte.
"""

from __future__ import annotations

import numpy as np
from websockets.sync.client import connect

from ..serving import wire
from ..serving.model_base import (
    ConditionalInpainterBase,
    crop_resize_square,
    ensure_float01,
    float01_to_uint8,
)

R = wire.RequestType


def _image_reply(raw: bytes) -> np.ndarray:
    """The image of a reply; ServerError on RETURN_ERROR."""
    if raw[0] == R.RETURN_ERROR:
        raise wire.ServerError(wire.decode_error(raw)[1])
    return wire.decode_response(raw)[1]


class WebsocketConditionalInpainter(ConditionalInpainterBase):
    """Inpainter that proxies every generate call to a websocket server."""

    def __init__(self, url: str, resolution: int = 256, open_timeout: float = 30.0):
        self._resolution = int(resolution)
        self.image: np.ndarray | None = None
        if not url.startswith(("ws://", "wss://")):
            url = "ws://" + url
        # ping_interval=None: the protocol is synchronous request/response
        # and a stamp can take long (a first kernel build or graph
        # capture), so keepalive pings would go unanswered and kill the
        # connection mid-request. The reference client (websocket-client)
        # sends no pings either.
        self.ws = connect(url, open_timeout=open_timeout, max_size=None,
                          ping_interval=None)
        # the brush image (u8) whose NEW_BRUSH_IMAGE is not sent yet
        self._pending_brush: np.ndarray | None = None
        self._inflight = 0

    def close(self):
        self.ws.close()

    def resolution(self) -> int:
        return self._resolution

    def set_brush(self, image: np.ndarray) -> None:
        image = ensure_float01(image)[..., :3]
        self.image = crop_resize_square(image, self._resolution).astype(np.float32)
        # Defer the NEW_BRUSH_IMAGE send until the first generate call so the
        # settings header reflects the caller's settings (reference
        # websocket_model.py:54-56, 69-73).
        self._pending_brush = float01_to_uint8(self.image)

    def _brush_request(self, **settings) -> bytes:
        req = wire.encode_request(R.NEW_BRUSH_IMAGE, self._pending_brush,
                                  **settings)
        self._pending_brush = None
        return req

    def generate_raw(self, canvas: np.ndarray, **settings) -> np.ndarray:
        self._drain_acks()  # sync any in-flight fire-and-forget stroke
        canvas = ensure_float01(canvas)
        # Empty-mask short-circuit: nothing painted yet means the brush image
        # IS the answer; skip the server round-trip (reference Kit
        # inference/websocket_model.py:71-75). Applies even while a brush
        # send is still deferred: the reference returns the local brush
        # on an empty mask and leaves the NEW_BRUSH_IMAGE send pending for
        # the first real stamp.
        if self.image is not None and \
                float(canvas[..., 3].max(initial=0.0)) == 0.0:
            return self.image.copy()

        if self._pending_brush is not None:
            req = self._brush_request(**settings)
        else:
            req = wire.encode_request(R.NEW_STAMP, float01_to_uint8(canvas),
                                      **settings)

        self.ws.send(req)
        return ensure_float01(_image_reply(self.ws.recv())[..., :3])

    # --- stroke sessions over the wire -----------------------------------
    # Proxies the stroke-session protocol (wire.py types >= 16; design in
    # pipeline/session.py): the canvas lives on the SERVER's device, stamps
    # are 22-byte requests, and a stroke can be fired without waiting for
    # replies (`wait=False`) then synchronized once with fetch_canvas - the
    # round-trip and transfer amortize across the whole stroke instead of
    # taxing every stamp.

    def begin_session(self, canvas_u8: np.ndarray) -> None:
        self._drain_acks()  # a prior stroke's acks must not pair with ours
        self._flush_pending_brush()
        canvas_u8 = np.asarray(canvas_u8)
        if canvas_u8.dtype != np.uint8:
            canvas_u8 = float01_to_uint8(canvas_u8)
        self.ws.send(wire.encode_begin_session(canvas_u8))
        self._collect_ack()
        self._inflight = 0

    def stamp_at(self, x0: int, y0: int, return_pixels: bool = True,
                 overpaint: bool = False, wait: bool = True, **settings):
        """One stroke stamp. `wait=False` (with return_pixels=False)
        fires the request and returns immediately; the server's acks are
        collected lazily by the next synchronizing call."""
        self._flush_pending_brush(**settings)
        self.ws.send(wire.encode_stamp_at(
            x0, y0, return_pixels=return_pixels, overpaint=overpaint,
            **settings))
        return self._after_coords_request(return_pixels, wait)

    def erase_at(self, x0: int, y0: int, return_pixels: bool = True,
                 wait: bool = True):
        self.ws.send(wire.encode_erase_at(x0, y0,
                                          return_pixels=return_pixels))
        return self._after_coords_request(return_pixels, wait)

    def _after_coords_request(self, return_pixels: bool, wait: bool):
        self._inflight += 1
        if return_pixels:
            self._drain_acks(all_but=1)
            raw = self.ws.recv()
            self._inflight = 0  # our request was the only one outstanding
            return _image_reply(raw)
        if wait:
            self._drain_acks()
        return None

    def fetch_canvas(self) -> np.ndarray:
        """Synchronize the stroke and download the server canvas."""
        self._drain_acks()
        self.ws.send(wire.encode_fetch_canvas())
        return _image_reply(self.ws.recv())

    def end_session(self) -> None:
        self._drain_acks()
        self.ws.send(wire.encode_end_session())
        self._collect_ack()

    def _drain_acks(self, all_but: int = 0) -> None:
        while self._inflight > all_but:
            self._collect_ack()

    def _collect_ack(self) -> int:
        reply = self.ws.recv()
        # The server replied - the request is no longer in flight, even
        # if the reply is a RETURN_ERROR (which raises below).
        self._inflight = max(0, self._inflight - 1)
        kind, seq = wire.decode_ack(reply)
        if kind == R.RETURN_ERROR:
            raise wire.ServerError(wire.decode_error(reply)[1])
        if kind != R.RETURN_ACK:
            raise RuntimeError(f"expected RETURN_ACK, got type {kind}")
        return seq

    def _flush_pending_brush(self, **settings) -> None:
        if self._pending_brush is None:
            return
        self._drain_acks()  # the brush reply must not interleave with acks
        self.ws.send(self._brush_request(**settings))
        _image_reply(self.ws.recv())  # preview reply

    def set_brush_prompt(self, prompt: str, **settings) -> np.ndarray:
        """Send a NEW_BRUSH_PROMPT request: the server synthesizes a brush
        image from the prompt and replies with a preview."""
        self._drain_acks()  # in-flight stroke acks must not pair with
        # the preview reply (every other synchronizing call drains first)
        self.ws.send(wire.encode_brush_prompt_request(prompt, **settings))
        image = _image_reply(self.ws.recv())
        self._pending_brush = None
        self.image = None  # brush lives server-side; disable local shortcut
        return image.astype(np.float32) / 255.0
