"""The port's inference server, on the `websockets` library.

Serves what the JAX package's Tornado application serves to the painting
client: the binary protocol on the websocket at /websocket/ (each binary
frame one request, answered by serving/wire.py handle_request_bytes) and
GET /health ({"status": "ok", "model": ...}). As in the JAX package's
handler, a frame that fails (a bad request, a text frame) is logged and
the connection stays open, with no reply to that frame. Requests run one at
a time on the model, whatever the number of connections.

Stroke-session frames (types 16-20) get the JAX handler's guarantees: each
gets a reply, RETURN_ERROR when it fails, so a client that does not wait
for its stamps keeps its acknowledgements in step; the session belongs to
the connection that began it, and another connection's session frames get
RETURN_ERROR while it is active; a closing connection ends the session it
holds.

HTTP POST /inpaint is not served: the `websockets` server parses GET
requests only.

    server = create_server(model, "127.0.0.1", 6060)
    server.serve_forever()        # server.shutdown() from another thread
"""

from __future__ import annotations

import json
import logging
import threading
from http import HTTPStatus

from websockets.datastructures import Headers
from websockets.http11 import Response
from websockets.sync.server import serve

from .wire import (
    RequestType,
    encode_error,
    handle_request_bytes,
    handle_session_request,
    is_session_request,
)

logger = logging.getLogger(__name__)

WEBSOCKET_PATH = "/websocket/"
HEALTH_PATH = "/health"
# Tornado's default message limit: a 1024^2 RGBA canvas (4 MiB plus a
# 23-byte header) fits with room to spare.
MAX_MESSAGE_BYTES = 10 * 1024 * 1024


def create_server(model, host: str = "0.0.0.0", port: int = 6060,
                  model_info: str | None = None):
    """A bound websockets Server around `model` (port 0: any free port,
    `server.socket.getsockname()` tells which); serve_forever() runs it."""
    info = model_info or type(model).__name__
    lock = threading.Lock()
    owner = [None]  # the connection that holds the model's session

    def process_request(connection, request):
        path = request.path.split("?", 1)[0]
        if path == HEALTH_PATH:
            body = json.dumps({"status": "ok", "model": info}).encode()
            return Response(HTTPStatus.OK, "OK", Headers([
                ("Content-Type", "application/json; charset=UTF-8"),
                ("Content-Length", str(len(body)))]), body)
        if path != WEBSOCKET_PATH:
            return connection.respond(HTTPStatus.NOT_FOUND, "Not Found\n")
        return None  # the websocket handshake

    def session_reply(connection, message):
        """Under `lock`: the reply to a session frame, never an
        exception."""
        try:
            if owner[0] not in (None, connection) and model.session_active():
                return encode_error("stroke session held by another "
                                    "connection")
            if message[0] == RequestType.BEGIN_SESSION:
                owner[0] = connection
            reply = handle_session_request(model, message)
            if message[0] == RequestType.END_SESSION:
                owner[0] = None
            return reply
        except Exception as e:  # noqa: BLE001 - reply, never silence
            logger.exception("session request failed")
            return encode_error(f"{type(e).__name__}: {e}")

    def release(connection):
        """A closing connection ends the session it holds."""
        with lock:
            if owner[0] is not connection:
                return
            owner[0] = None
            try:
                if model.session_active():
                    model.end_session()
            except Exception:  # noqa: BLE001 - teardown must not raise
                logger.exception("failed to end the session on close")

    def handler(connection):
        try:
            for message in connection:
                try:
                    if not isinstance(message, bytes):
                        raise NotImplementedError("text messages are not "
                                                  "handled")
                    with lock:
                        if message and is_session_request(message[0]):
                            reply = session_reply(connection, message)
                        else:
                            reply = handle_request_bytes(model, message)
                    connection.send(reply)
                except Exception:  # noqa: BLE001 - a bad frame keeps it
                    logger.exception("failed to handle an incoming message")
        finally:
            release(connection)

    return serve(handler, host, port, process_request=process_request,
                 max_size=MAX_MESSAGE_BYTES, compression=None,
                 ping_interval=None)
