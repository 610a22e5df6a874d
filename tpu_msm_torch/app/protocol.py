"""Wire format of the MSM offload service (version 1).

The port's own copy of `example_app/protocol.py`, byte for byte the same
format: a request is the magic "MSM1", a u32 curve id and a u64 point
count, then the x words, the y words and the scalar words; a reply is a
u32 status and an f64 compute time in ms, then the Jacobian (x, y, z)
words, or, on status 1, a u32 length and an error message. Coordinates
and scalars travel as little-endian u64 words, the layout of the native
C ABI in native/cpumsm.cpp, so native clients need no bignum library.
Curve ids 0 and 1 are the port's BN254_S12 and BLS12_377_S12.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..constants import BLS12_377_S12, BN254_S12, CurveParams

MAGIC = b"MSM1"
CURVE_IDS = {0: BN254_S12, 1: BLS12_377_S12}
CURVE_NAMES = {0: "bn254", 1: "bls12_377"}


def n_words(bits: int) -> int:
    return (bits + 63) // 64


def curve_words(curve: CurveParams) -> Tuple[int, int]:
    """(nw, sw): u64 words per base-field coordinate / per scalar."""
    return n_words(curve.p.bit_length()), n_words(curve.scalar_bits)


def ints_to_words(vals: Sequence[int], nw: int) -> np.ndarray:
    """(n, nw) little-endian u64 word array from python ints."""
    out = np.zeros((len(vals), nw), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(vals):
        for j in range(nw):
            out[i, j] = (v >> (64 * j)) & mask
    return out


def words_to_ints(arr: np.ndarray) -> List[int]:
    n, nw = arr.shape
    out = []
    for i in range(n):
        acc = 0
        for j in range(nw - 1, -1, -1):
            acc = (acc << 64) | int(arr[i, j])
        out.append(acc)
    return out


def recv_exact(sock: socket.socket, size: int) -> bytes:
    buf = bytearray()
    while len(buf) < size:
        chunk = sock.recv(min(1 << 20, size - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return bytes(buf)


def send_request(sock: socket.socket, curve_id: int,
                 xs_words: np.ndarray, ys_words: np.ndarray,
                 sc_words: np.ndarray) -> None:
    n = xs_words.shape[0]
    sock.sendall(MAGIC + struct.pack("<IQ", curve_id, n))
    sock.sendall(np.ascontiguousarray(xs_words, np.uint64).tobytes())
    sock.sendall(np.ascontiguousarray(ys_words, np.uint64).tobytes())
    sock.sendall(np.ascontiguousarray(sc_words, np.uint64).tobytes())


def recv_request(sock: socket.socket):
    """-> (curve_id, xs_words, ys_words, sc_words) or None on clean EOF."""
    try:
        head = recv_exact(sock, 16)
    except ConnectionError:
        return None
    if head[:4] != MAGIC:
        raise ValueError(f"bad magic {head[:4]!r}")
    curve_id, n = struct.unpack("<IQ", head[4:])
    if curve_id not in CURVE_IDS:
        raise ValueError(f"unknown curve id {curve_id}")
    if n == 0 or n > (1 << 28):
        raise ValueError(f"bad input size {n}")
    nw, sw = curve_words(CURVE_IDS[curve_id])

    def arr(words):
        raw = recv_exact(sock, 8 * n * words)
        return np.frombuffer(raw, np.uint64).reshape(n, words)

    return curve_id, arr(nw), arr(nw), arr(sw)


def send_result(sock: socket.socket, curve: CurveParams,
                jac: Tuple[int, int, int], compute_ms: float) -> None:
    nw, _ = curve_words(curve)
    sock.sendall(struct.pack("<Id", 0, compute_ms))
    sock.sendall(ints_to_words(list(jac), nw).tobytes())


def send_error(sock: socket.socket, message: str) -> None:
    raw = message.encode()
    sock.sendall(struct.pack("<IdI", 1, 0.0, len(raw)) + raw)


@dataclass
class MSMResult:
    x: int
    y: int
    z: int
    compute_ms: float


def recv_result(sock: socket.socket, curve: CurveParams) -> MSMResult:
    status, compute_ms = struct.unpack("<Id", recv_exact(sock, 12))
    if status != 0:
        (ln,) = struct.unpack("<I", recv_exact(sock, 4))
        raise RuntimeError("server error: " + recv_exact(sock, ln).decode())
    nw, _ = curve_words(curve)
    words = np.frombuffer(recv_exact(sock, 8 * 3 * nw),
                          np.uint64).reshape(3, nw)
    x, y, z = words_to_ints(words)
    return MSMResult(x, y, z, compute_ms)
