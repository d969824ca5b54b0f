"""The JAX package's control-plane tests (``tests/test_control_plane.py``)
against the port's copy (``financial_rag_system_tpu_torch/parallel/control.py``):
HMAC handshake, dead-peer fast-fail, and the one-op-per-batch fused
broadcast.  These run against a real TCP socket pair in-process — no
subprocesses, no devices."""

import pickle
import socket
import struct
import threading
import time

import pytest

from financial_rag_system_tpu_torch.parallel import control
from financial_rag_system_tpu_torch.parallel.control import (
    ACK,
    BroadcastIndex,
    ControlServer,
    _client_handshake,
    _recv_msg,
)

_LEN = struct.Struct("!Q")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connect(port, timeout=30.0) -> socket.socket:
    """Connect with retry — the server thread may not have bound yet."""
    deadline = time.time() + timeout
    while True:
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=10)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)


class _ScriptedWorker(threading.Thread):
    """Connects, optionally handshakes, then acks every op and records it."""

    def __init__(self, port, *, token=None, ack=True, die_after=None):
        super().__init__(daemon=True)
        self.port = port
        self.token = token
        self.ack = ack
        self.die_after = die_after  # ops to process before closing abruptly
        self.ops = []
        self.error = None

    def run(self):
        sock = _connect(self.port)
        try:
            if self.token is not None:
                _client_handshake(sock, self.token)
            n = 0
            while True:
                op, args = pickle.loads(_recv_msg(sock))
                self.ops.append(op)
                n += 1
                if self.die_after is not None and n > self.die_after:
                    return
                if self.ack:
                    sock.sendall(ACK)
                if op == "shutdown":
                    return
        except Exception as exc:  # noqa: BLE001 — surfaced via self.error
            self.error = exc
        finally:
            # close eagerly: a stored exception traceback would otherwise
            # pin the socket open and stall the server's handshake read
            sock.close()


def _server_async(port, n_workers=1, **kw):
    """ControlServer() blocks in accept; build it on a thread."""
    out = {}

    def build():
        out["server"] = ControlServer("127.0.0.1", port, n_workers, **kw)

    t = threading.Thread(target=build, daemon=True)
    t.start()
    return t, out


def test_ops_broadcast_and_ack_roundtrip():
    port = _free_port()
    t, out = _server_async(port)
    w = _ScriptedWorker(port)
    w.start()
    t.join(timeout=30)
    server = out["server"]
    got = server.run("search", (1, 2), lambda: "local-result")
    assert got == "local-result"
    server.shutdown()
    w.join(timeout=10)
    assert w.ops == ["search", "shutdown"] and w.error is None


def test_handshake_rejects_wrong_token(monkeypatch):
    monkeypatch.setenv("FRS_CONTROL_TOKEN", "right-secret")
    port = _free_port()
    t, out = _server_async(port)
    bad = _ScriptedWorker(port, token=b"wrong-secret")
    bad.start()
    bad.join(timeout=30)
    # the impostor is dropped: either its own coordinator-check fails
    # (mutual auth) or the server closes the socket on a bad proof
    assert bad.error is not None
    # the server kept listening and accepts a correctly-keyed worker
    good = _ScriptedWorker(port, token=b"right-secret")
    good.start()
    t.join(timeout=30)
    server = out["server"]
    assert server.run("search", (), lambda: 42) == 42
    server.shutdown()
    good.join(timeout=10)
    assert good.error is None


def test_unauthenticated_peer_cannot_occupy_a_slot(monkeypatch):
    """A peer that never speaks the handshake must not receive the op
    stream (it would get pickled corpus data)."""
    monkeypatch.setenv("FRS_CONTROL_TOKEN", "s3cret")
    port = _free_port()
    t, out = _server_async(port)

    # raw connection that sends garbage instead of a handshake
    raw = _connect(port)
    raw.sendall(b"\x00" * 64)
    # server must drop it and keep waiting; a real worker then connects
    good = _ScriptedWorker(port, token=b"s3cret")
    good.start()
    t.join(timeout=30)
    server = out["server"]
    server.run("search", (), lambda: None)
    # the garbage peer gets at most the 48-byte handshake challenge and a
    # close — never an op frame (which would carry the pickled payload)
    raw.settimeout(2.0)
    received = b""
    try:
        while len(received) < 4096:
            data = raw.recv(1024)
            if not data:
                break
            received += data
    except OSError:
        pass
    assert len(received) <= 48 and b"search" not in received
    server.shutdown()
    good.join(timeout=10)
    assert "search" in good.ops


def test_worker_rejects_spoofed_coordinator(monkeypatch):
    """Mutual auth: a coordinator that cannot prove the token must be
    refused BEFORE the worker deserializes any op (pickle => RCE)."""
    port = _free_port()
    listener = socket.create_server(("127.0.0.1", port))

    def fake_coordinator():
        conn, _ = listener.accept()
        nonce_w = conn.recv(16)
        assert nonce_w
        # wrong key => wrong proof
        conn.sendall(b"\x01" * 16 + b"\x02" * 32)
        time.sleep(0.5)
        conn.close()

    t = threading.Thread(target=fake_coordinator, daemon=True)
    t.start()
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    with pytest.raises(ConnectionError, match="authentication"):
        _client_handshake(sock, b"the-real-token")
    listener.close()


def test_dead_worker_fails_fast_and_poisons_the_server():
    port = _free_port()
    t, out = _server_async(port, ack_deadline_s=1.0)
    w = _ScriptedWorker(port, ack=False)  # receives ops, never acks
    w.start()
    t.join(timeout=30)
    server = out["server"]
    start = time.time()
    with pytest.raises(ConnectionError, match="ack"):
        server.run("search", (), lambda: None)
    assert time.time() - start < 10  # seconds, not the 600 s socket default
    # subsequent ops fail fast without touching the socket
    start = time.time()
    with pytest.raises(ConnectionError, match="down"):
        server.run("upsert", (), lambda: None)
    assert time.time() - start < 1


def test_fused_batch_is_one_op():
    import numpy as np

    port = _free_port()
    t, out = _server_async(port)
    w = _ScriptedWorker(port)
    w.start()
    t.join(timeout=30)
    server = out["server"]

    class _Inner:
        pass

    bi = BroadcastIndex(server, _Inner())
    ids = np.zeros((2, 8), np.int32)
    res = bi.fused_batch(ids, ids, ids, [(0, -1), (1, -1)], lambda: "ran")
    assert res == "ran"
    server.shutdown()
    w.join(timeout=10)
    assert w.ops == ["fused", "shutdown"]


def test_ack_timeout_env_default(monkeypatch):
    monkeypatch.setenv("FRS_CONTROL_ACK_TIMEOUT_S", "7.5")
    assert control.ack_timeout_s() == 7.5
    monkeypatch.delenv("FRS_CONTROL_ACK_TIMEOUT_S")
    assert control.ack_timeout_s() == 30.0
