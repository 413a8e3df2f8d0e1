"""A directory served over HTTP on 127.0.0.1 from a thread, for download tests."""
import contextlib
import functools
import http.server
import threading
from typing import Iterator


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, format, *args):  # noqa: A002 (the base class's name)
        pass


@contextlib.contextmanager
def serve_directory(root: str) -> Iterator[str]:
    """Serve ``root`` at an ephemeral port; yields the base URL. The server
    is shut down and its thread joined on exit."""
    handler = functools.partial(_QuietHandler, directory=root)
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True, name="loopback-http")
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()
