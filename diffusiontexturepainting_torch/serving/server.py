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

HTTP POST /inpaint on the same port (the JAX package's
InpaintHTTPHandler): the binary request in the body, the binary reply
back as application/octet-stream, byte-equal to the websocket's at the
same request counter; session types get 400 (sessions belong to a
websocket connection), and a request that fails gets 400 {"error": ...}.
The `websockets` server parses GET requests only, so each accepted
connection's first bytes are peeked (MSG_PEEK): a `POST ` is read and
answered here and the connection closed; anything else goes to the
websocket server untouched, reading the same bytes.

    server = create_server(model, "127.0.0.1", 6060)
    server.serve_forever()        # server.shutdown() from another thread

With a `service` (serving/parallel_model.py ParallelInpainterService, the
server of `--mesh data=1 --max-batch N`), the JAX handler's service branch:
each connection gets its own SessionModel (its brush, its stroke session),
and its requests run without the server's lock, so stamps of concurrent
connections meet in the service's batches. A session frame still gets a
reply, RETURN_ERROR when it fails; there is no ownership to enforce, as
each connection has its own canvas. POST /inpaint is not served there
(404, as the JAX package's mesh application has no such route), and
/health also reports the mesh, the largest batch, the batches run so far
by their number of requests and how long they waited for peers.
"""

from __future__ import annotations

import json
import logging
import socket
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
INPAINT_PATH = "/inpaint"
# Tornado's default message limit: a 1024^2 RGBA canvas (4 MiB plus a
# 23-byte header) fits with room to spare.
MAX_MESSAGE_BYTES = 10 * 1024 * 1024
MAX_HEADER_BYTES = 64 * 1024
# seconds a connection may take to send its first bytes, or a POST's
# headers and body
HTTP_TIMEOUT = 60.0
SESSION_OVER_HTTP = ("stroke-session requests require the websocket "
                     "transport (sessions are connection-scoped)")


def _http_reply(sock, status: HTTPStatus, body: bytes,
                content_type: str) -> None:
    head = (f"HTTP/1.1 {status.value} {status.phrase}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n").encode("latin-1")
    sock.sendall(head + body)


def _json_reply(sock, status: HTTPStatus, obj) -> None:
    _http_reply(sock, status, json.dumps(obj).encode(),
                "application/json; charset=UTF-8")


def _read_post(sock):
    """(path, body) of an HTTP POST whose first bytes are waiting on
    `sock`, or an HTTPStatus where it cannot be served."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        if len(buf) > MAX_HEADER_BYTES:
            return HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE
        chunk = sock.recv(65536)
        if not chunk:
            return HTTPStatus.BAD_REQUEST
        buf += chunk
    head, body = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3:
        return HTTPStatus.BAD_REQUEST
    headers = {}
    for line in lines[1:]:
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return HTTPStatus.LENGTH_REQUIRED
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        return HTTPStatus.BAD_REQUEST
    if length < 0:
        return HTTPStatus.BAD_REQUEST
    if length > MAX_MESSAGE_BYTES:
        return HTTPStatus.REQUEST_ENTITY_TOO_LARGE
    if headers.get("expect", "").lower() == "100-continue":
        sock.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
    while len(body) < length:
        chunk = sock.recv(min(1 << 20, length - len(body)))
        if not chunk:
            return HTTPStatus.BAD_REQUEST
        body += chunk
    return parts[1].split("?", 1)[0], body[:length]


def create_server(model, host: str = "0.0.0.0", port: int = 6060,
                  model_info: str | None = None,
                  debug_dir: str | None = None,
                  profile_dir: str | None = None, service=None):
    """A bound websockets Server around `model` (port 0: any free port,
    `server.socket.getsockname()` tells which); serve_forever() runs it.
    debug_dir, profile_dir: wire.handle_request_bytes's diagnostics (the
    POST endpoint, as the JAX package's, passes debug_dir only). With a
    `service`, each connection is served by service.new_session() (model
    may be None; profile_dir is not taken: run.py refuses it there)."""
    info = model_info or type(service.base if service else model).__name__
    lock = threading.Lock()
    owner = [None]  # the connection that holds the model's session

    def health():
        out = {"status": "ok", "model": info}
        if service is not None:
            out.update(mesh=service.mesh.spec, max_batch=service.max_batch,
                       batches=service.batch_counts(),
                       batch_waits=service.batch_waits())
        return out

    def process_request(connection, request):
        path = request.path.split("?", 1)[0]
        if path == HEALTH_PATH:
            body = json.dumps(health()).encode()
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

    def service_reply(session, message):
        """The reply to a frame of a service's connection, outside the
        lock; a session frame's failure is a RETURN_ERROR reply."""
        if not (message and is_session_request(message[0])):
            return handle_request_bytes(session, message,
                                        debug_dir=debug_dir)
        try:
            return handle_session_request(session, message)
        except Exception as e:  # noqa: BLE001 - reply, never silence
            logger.exception("session request failed")
            return encode_error(f"{type(e).__name__}: {e}")

    def service_handler(connection):
        session = service.new_session()
        for message in connection:
            try:
                if not isinstance(message, bytes):
                    raise NotImplementedError("text messages are not "
                                              "handled")
                connection.send(service_reply(session, message))
            except Exception:  # noqa: BLE001 - a bad frame keeps it
                logger.exception("failed to handle an incoming message")

    def handler(connection):
        if service is not None:
            return service_handler(connection)
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
                            reply = handle_request_bytes(
                                model, message, debug_dir=debug_dir,
                                profile_dir=profile_dir)
                    connection.send(reply)
                except Exception:  # noqa: BLE001 - a bad frame keeps it
                    logger.exception("failed to handle an incoming message")
        finally:
            release(connection)

    def serve_post(sock):
        """One HTTP POST /inpaint on `sock`, answered; the caller closes
        the socket."""
        got = _read_post(sock)
        if isinstance(got, HTTPStatus):
            _json_reply(sock, got, {"error": got.phrase})
            return
        path, body = got
        if path != INPAINT_PATH or service is not None:
            _json_reply(sock, HTTPStatus.NOT_FOUND, {"error": "Not Found"})
            return
        if body and is_session_request(body[0]):
            _json_reply(sock, HTTPStatus.BAD_REQUEST,
                        {"error": SESSION_OVER_HTTP})
            return
        try:
            with lock:
                reply = handle_request_bytes(model, body,
                                             debug_dir=debug_dir)
        except Exception as e:  # noqa: BLE001 - report protocol errors
            logger.exception("POST %s failed", INPAINT_PATH)
            _json_reply(sock, HTTPStatus.BAD_REQUEST, {"error": str(e)})
            return
        _http_reply(sock, HTTPStatus.OK, bytes(reply),
                    "application/octet-stream")

    server = serve(handler, host, port, process_request=process_request,
                   max_size=MAX_MESSAGE_BYTES, compression=None,
                   ping_interval=None)
    websocket_connection = server.handler

    def connection(sock, addr):
        """Route an accepted connection by its first five bytes."""
        try:
            sock.settimeout(HTTP_TIMEOUT)
            first = sock.recv(5, socket.MSG_PEEK | socket.MSG_WAITALL)
            if first == b"POST ":
                try:
                    serve_post(sock)
                finally:
                    sock.close()
                return
            sock.settimeout(None)
        except OSError:
            sock.close()
            return
        websocket_connection(sock, addr)

    server.handler = connection
    server.model = model
    server.service = service
    server.model_info = info
    return server
