"""Standalone HTTP/1.1 server for the port's ASGI app, on h11 + asyncio
(``h11`` is imported only here, when a socket server is actually started).

Run:  python -m quorum_tpu_torch.server.serve --port 8000 --config config.yaml
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any

logger = logging.getLogger(__name__)


class _ConnectionHandler:
    def __init__(self, app, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        import h11

        self.h11 = h11
        self.app = app
        self.reader = reader
        self.writer = writer
        self.conn = h11.Connection(h11.SERVER)

    async def run(self) -> None:
        h11 = self.h11
        try:
            while True:
                request = await self._next_request()
                if request is None:
                    return
                await self._handle(request)
                if h11.MUST_CLOSE in (self.conn.our_state, self.conn.their_state):
                    return
                try:
                    self.conn.start_next_cycle()
                except h11.ProtocolError:
                    return
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            self.writer.close()

    async def _next_event(self):
        h11 = self.h11
        while True:
            event = self.conn.next_event()
            if event is h11.NEED_DATA:
                data = await self.reader.read(65536)
                self.conn.receive_data(data)
                if data == b"" and self.conn.their_state is h11.IDLE:
                    return None
                continue
            return event

    async def _next_request(self):
        while True:
            event = await self._next_event()
            if event is None or isinstance(event, self.h11.ConnectionClosed):
                return None
            if isinstance(event, self.h11.Request):
                return event

    async def _read_body(self) -> bytes:
        chunks = []
        while True:
            event = await self._next_event()
            if isinstance(event, self.h11.Data):
                chunks.append(bytes(event.data))
            elif isinstance(event, self.h11.EndOfMessage) or event is None:
                return b"".join(chunks)

    async def _handle(self, request) -> None:
        h11 = self.h11
        body = await self._read_body()
        path, _, query = request.target.partition(b"?")
        scope: dict[str, Any] = {
            "type": "http", "asgi": {"version": "3.0"}, "http_version": "1.1",
            "method": request.method.decode(), "path": path.decode(),
            "raw_path": bytes(request.target), "query_string": query,
            "headers": [(k.lower(), v) for k, v in request.headers],
        }
        body_sent = False

        async def receive():
            nonlocal body_sent
            if body_sent:
                return {"type": "http.disconnect"}
            body_sent = True
            return {"type": "http.request", "body": body, "more_body": False}

        async def send(message: dict[str, Any]) -> None:
            if message["type"] == "http.response.start":
                self._send(h11.Response(status_code=message["status"],
                                        headers=list(message.get("headers", []))))
            elif message["type"] == "http.response.body":
                if message.get("body"):
                    self._send(h11.Data(data=message["body"]))
                if not message.get("more_body", False):
                    self._send(h11.EndOfMessage())
                await self.writer.drain()

        await self.app(scope, receive, send)

    def _send(self, event) -> None:
        data = self.conn.send(event)
        if data:
            self.writer.write(data)


async def start_server(app, host: str = "127.0.0.1", port: int = 0) -> asyncio.Server:
    """Bind and return the asyncio server (port 0 → ephemeral)."""

    async def on_connect(reader, writer):
        await _ConnectionHandler(app, reader, writer).run()

    return await asyncio.start_server(on_connect, host, port)


async def serve(app, host: str = "0.0.0.0", port: int = 8000) -> None:
    server = await start_server(app, host, port)
    logger.info("quorum_tpu_torch serving on %s",
                ", ".join(str(s.getsockname()) for s in server.sockets))
    async with server:
        await server.serve_forever()


def main() -> None:
    from quorum_tpu_torch.config import load_config
    from quorum_tpu_torch.engine.engine import shutdown_all_engines
    from quorum_tpu_torch.server.app import create_app

    parser = argparse.ArgumentParser(description="quorum_tpu_torch OpenAI-compatible server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--config", default=None, help="path to config.yaml")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--watch", action="store_true",
                        help="hot-reload config.yaml edits in process, keeping the cuda:// "
                             "engines an edit does not touch (QUORUM_TPU_CONFIG_WATCH=1)")
    args = parser.parse_args()
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO),
                        format="%(levelname)s:%(asctime)s:%(name)s: %(message)s")
    app = create_app(load_config(args.config), watch_config=True if args.watch else None)
    try:
        asyncio.run(serve(app, args.host, args.port))
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_all_engines()


if __name__ == "__main__":
    main()
