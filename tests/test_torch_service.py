"""The port's MSM service (`tpu_msm_torch/app/service.py`, wire format
`tpu_msm_torch/app/protocol.py`) on the CPU, against `example_app/`: the
same reply bytes as `example_app/service.py` but the compute time, the
example app's client served unchanged, the error frames, and two clients
at once."""

import socket
import struct
import threading

import pytest
import torch

from example_app import client
from example_app import protocol as jprotocol
from example_app import service as jservice
from tpu_msm_torch.app import protocol, service
from tpu_msm_torch.constants import BN254_S12
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils import window


@pytest.fixture
def server(tmp_path, monkeypatch):
    # the static schedule, as the JAX service has on the CPU
    monkeypatch.setenv(window.CACHE_ENV, str(tmp_path / "cache.json"))
    srv = service.serve(port=0, background=True, device="cpu")
    yield srv
    srv.shutdown()
    srv.server_close()


def request_bytes(n: int, seed: int, curve_id: int = 0) -> bytes:
    xs, ys, sc, _ = client._gen_words(jprotocol.CURVE_IDS[curve_id], n, seed)
    return (protocol.MAGIC + struct.pack("<IQ", curve_id, n) + xs.tobytes()
            + ys.tobytes() + sc.tobytes())


def raw_reply(port: int, req: bytes, nw: int) -> bytes:
    with socket.create_connection(("127.0.0.1", port)) as sock:
        sock.sendall(req)
        head = protocol.recv_exact(sock, 12)
        assert struct.unpack("<I", head[:4])[0] == 0, head
        return head + protocol.recv_exact(sock, 8 * 3 * nw)


def test_wire_format_equals_example_app():
    assert protocol.MAGIC == jprotocol.MAGIC
    assert {k: c.name for k, c in protocol.CURVE_IDS.items()} == \
        {k: c.name for k, c in jprotocol.CURVE_IDS.items()}
    a, b = socket.socketpair()
    with a, b:
        protocol.send_error(a, "boom")
        with pytest.raises(RuntimeError, match="boom"):
            jprotocol.recv_result(b, BN254_S12)
        protocol.send_result(a, BN254_S12, (1, 2, 3), 4.5)
        res = jprotocol.recv_result(b, BN254_S12)
        assert (res.x, res.y, res.z, res.compute_ms) == (1, 2, 3, 4.5)


def test_reply_bytes_equal_example_app_service(server):
    """The same request to both servers: the same status and Jacobian
    words (both decode the window sums to affine points and run the same
    host Horner at the same static schedule); only the 8-byte compute
    time differs."""
    req = request_bytes(256, seed=3)
    nw, _ = protocol.curve_words(BN254_S12)
    ours = raw_reply(server.server_address[1], req, nw)
    jsrv = jservice.serve(port=0, background=True)
    try:
        theirs = raw_reply(jsrv.server_address[1], req, nw)
    finally:
        jsrv.shutdown()
        jsrv.server_close()
    assert len(ours) == len(theirs) == 12 + 8 * 3 * nw
    assert ours[:4] == theirs[:4] and ours[12:] == theirs[12:]


def test_example_app_client_against_the_port(server):
    r = client.msm_benchmark(256, port=server.server_address[1], verify=True)
    assert r.instance_size == 256 and r.num_instance == 1
    assert r.avg_processing_time > 0


def test_error_frames(server):
    port = server.server_address[1]
    curve = BN254_S12
    nw, sw = protocol.curve_words(curve)
    good = (curve.gen_x, curve.gen_y)
    bad = (curve.gen_x, (curve.gen_y + 1) % curve.p)     # off the curve
    xs = protocol.ints_to_words([good[0], bad[0]], nw)
    ys = protocol.ints_to_words([good[1], bad[1]], nw)
    sc = protocol.ints_to_words([3, 5], sw)
    with socket.create_connection(("127.0.0.1", port)) as sock:
        protocol.send_request(sock, 0, xs, ys, sc)
        with pytest.raises(RuntimeError, match="point 1 rejected"):
            protocol.recv_result(sock, curve)
        # the connection stays open after a rejected request
        protocol.send_request(sock, 0, xs[:1], ys[:1], sc[:1])
        res = protocol.recv_result(sock, curve)
        assert ref.jac_eq(curve, (res.x, res.y, res.z),
                          ref.scalar_mul(curve, (*good, 1), 3))
    out_of_field = protocol.ints_to_words([curve.p + curve.gen_x], nw)
    with socket.create_connection(("127.0.0.1", port)) as sock:
        protocol.send_request(sock, 0, out_of_field, ys[:1], sc[:1])
        with pytest.raises(RuntimeError, match="point 0 rejected"):
            protocol.recv_result(sock, curve)
    for head, msg in ((b"MSM2" + struct.pack("<IQ", 0, 1), "bad magic"),
                      (protocol.MAGIC + struct.pack("<IQ", 7, 1),
                       "unknown curve id 7"),
                      (protocol.MAGIC + struct.pack("<IQ", 0, 0),
                       "bad input size 0")):
        with socket.create_connection(("127.0.0.1", port)) as sock:
            sock.sendall(head)
            with pytest.raises(RuntimeError, match=msg):
                protocol.recv_result(sock, curve)


def test_two_clients_at_once(server):
    port = server.server_address[1]
    results, errors = {}, []
    barrier = threading.Barrier(2)

    def one(seed):
        try:
            curve = protocol.CURVE_IDS[0]
            xs, ys, sc, expected = client._gen_words(curve, 64, seed)
            barrier.wait(timeout=60)
            res = client.run_msm("127.0.0.1", port, 0, xs, ys, sc)
            results[seed] = ref.jac_eq(curve, (res.x, res.y, res.z),
                                       expected)
        except Exception as e:   # reported below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(s,)) for s in (21, 22)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert results == {21: True, 22: True}


def test_device_lock_is_one_per_device():
    a = service.device_lock(torch.device("cpu"))
    assert service.device_lock("cpu") is a
    assert service.device_lock("cuda:0") is not a


def test_serve_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        service.serve(port=0, background=True)
