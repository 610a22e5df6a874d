"""MSM offload service on the port: a threaded TCP server on one device.

The counterpart of `example_app/service.py`: provers connect, stream
(points, scalars) in the wire format of `protocol`, and get back the
Jacobian result and the compute time of the MSM. Each request's points
are checked on the curve before any work; the MSM runs through
`get_pipeline(default_config(n, curve), device)`, which keeps one
pipeline a (config, device) across requests.

Requests arrive on threads, one a connection. The MSMs of one device run
one at a time, under that device's lock: the launch counters of
`cuzk/kernels.py`, the pipeline cache and the cooperative launches of
`col_prefix` and `pbpr_full` are not shared safely between threads. The
decode of a request and its on-curve check run outside the lock.

    python -m tpu_msm_torch.app.service --port 9099 [--host 0.0.0.0] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import socket
import socketserver
import threading
import time
import traceback

from ..config import default_config
from ..cuzk.pipeline import get_pipeline, resolve_device
from . import protocol

_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """The one lock of a device, shared by every server of the process."""
    key = str(device)
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(key, threading.Lock())


class MSMHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sock: socket.socket = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        device = self.server.device
        while True:
            try:
                req = protocol.recv_request(sock)
            except (ValueError, ConnectionError) as e:
                try:
                    protocol.send_error(sock, str(e))
                except OSError:
                    pass
                return
            if req is None:
                return                       # clean EOF: client done
            curve_id, xs_w, ys_w, sc_w = req
            curve = protocol.CURVE_IDS[curve_id]
            try:
                points, scalars = _ingress(curve, xs_w, ys_w, sc_w)
            except ValueError as e:          # a rejected request
                try:
                    protocol.send_error(sock, f"{type(e).__name__}: {e}")
                except OSError:
                    return
                continue
            try:
                with device_lock(device):
                    pipe = get_pipeline(default_config(len(points), curve),
                                        device)
                    t0 = time.perf_counter()
                    jac = pipe.msm(points, scalars)
                    ms = (time.perf_counter() - t0) * 1e3
                protocol.send_result(sock, curve, jac, ms)
            except Exception as e:   # report it; the server keeps serving
                traceback.print_exc()
                try:
                    protocol.send_error(sock, f"{type(e).__name__}: {e}")
                except OSError:
                    return


def _ingress(curve, xs_w, ys_w, sc_w):
    """Wire words -> (affine int points, int scalars). An off-curve or
    out-of-field point raises ValueError naming it: the request gets a
    protocol error, not a result computed from it."""
    points = list(zip(protocol.words_to_ints(xs_w),
                      protocol.words_to_ints(ys_w)))
    scalars = protocol.words_to_ints(sc_w)
    p, b = curve.p, curve.b_coeff
    for i, (x, y) in enumerate(points):
        if not (0 <= x < p and 0 <= y < p) or \
                (y * y - (x * x * x + b)) % p != 0:
            raise ValueError(f"point {i} rejected: not on curve {curve.name}")
    return points, scalars


class MSMServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address, handler, device):
        self.device = device
        super().__init__(address, handler)


def serve(host: str = "127.0.0.1", port: int = 9099,
          background: bool = False, device="cuda") -> MSMServer:
    """Serve MSMs on `device` ("cuda" unless the caller asks for "cpu";
    without a card "cuda" raises here). port=0 picks a free port
    (`server.server_address[1]`). With background=True the server runs
    on a daemon thread and is returned at once; stop it with
    `shutdown()` and `server_close()`."""
    server = MSMServer((host, port), MSMHandler, resolve_device(device))
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    print(f"[msm-service] listening on {host}:{server.server_address[1]} "
          f"({server.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9099)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.host, args.port, device=args.device)


if __name__ == "__main__":
    main()
