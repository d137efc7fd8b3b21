"""Rendezvous key-value store + fence — the PMIx-equivalent.

≈ the PMIx client/server pair (``PMIx_Put``/``PMIx_Commit``/
``PMIx_Fence``/``PMIx_Get``, SURVEY.md §2.7, §3.2): the out-of-band
bootstrap every distributed job needs for rank wire-up.  The launcher
(``tpurun``, ≈ mpirun hosting the PMIx server) runs :class:`KVSServer`;
every worker process connects a :class:`KVSClient` (address from the
environment, like the PMIx unix-socket handshake) and performs the
modex dance: put its DCN endpoint, fence, get peers lazily.

Wire protocol: length-prefixed JSON frames over TCP — tiny control
traffic only (endpoints, fence counters), never bulk data.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Any


def _send_frame(sock: socket.socket, obj: Any) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("kvs peer closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = struct.unpack("!I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n).decode())


class KVSServer:
    """Single-threaded-per-connection KVS + fence counter server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._data: dict[str, Any] = {}
        self._fences: dict[str, set[int]] = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address = "%s:%d" % self._sock.getsockname()
        self._running = True
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = _recv_frame(conn)
                op = msg["op"]
                if op == "put":
                    with self._cond:
                        self._data[msg["key"]] = msg["value"]
                        self._cond.notify_all()
                    _send_frame(conn, {"ok": True})
                elif op == "get":
                    timeout = msg.get("timeout", 30.0)
                    deadline = time.monotonic() + timeout
                    with self._cond:
                        while msg["key"] not in self._data:
                            left = deadline - time.monotonic()
                            if left <= 0 or not msg.get("wait", True):
                                break
                            self._cond.wait(left)
                        val = self._data.get(msg["key"])
                        found = msg["key"] in self._data
                    _send_frame(conn, {"ok": found, "value": val})
                elif op == "get_prefix":
                    # bulk scan (the sharded-modex leg: one group
                    # leader pulls every 'dcn.' endpoint in ONE op
                    # instead of P ranks each issuing P-1 gets)
                    with self._cond:
                        pfx = msg["prefix"]
                        out = {k: v for k, v in self._data.items()
                               if k.startswith(pfx)}
                    _send_frame(conn, {"ok": True, "value": out})
                elif op == "fence":
                    name, rank, size = msg["name"], msg["rank"], msg["size"]
                    deadline = time.monotonic() + msg.get("timeout", 120.0)
                    with self._cond:
                        self._fences.setdefault(name, set()).add(rank)
                        self._cond.notify_all()
                        while len(self._fences[name]) < size:
                            left = deadline - time.monotonic()
                            if left <= 0:
                                _send_frame(conn, {"ok": False, "error": "fence timeout"})
                                break
                            self._cond.wait(left)
                        else:
                            _send_frame(conn, {"ok": True})
                elif op == "shutdown":
                    _send_frame(conn, {"ok": True})
                    return
                else:
                    _send_frame(conn, {"ok": False, "error": f"bad op {op}"})
        except (ConnectionError, OSError):
            return

    def peek(self, key: str, default: Any = None) -> Any:
        """In-process non-blocking read (the launcher/daemon side owns
        the server object, so it need not dial its own socket to poll
        job-completion keys)."""
        with self._cond:
            return self._data.get(key, default)

    def put_local(self, key: str, value: Any) -> None:
        """In-process put (the daemon publishes job directives on the
        same store the workers' KVSClients read)."""
        with self._cond:
            self._data[key] = value
            self._cond.notify_all()

    def seed_fence(self, name: str, ranks) -> None:
        """Pre-populate a fence set (daemon restart recovery): the
        original boot's fences died with the crashed daemon's server,
        but a future respawned rank still replays them — seeding the
        full rank set keeps those replays instant instead of a
        120-second timeout against an empty set."""
        with self._cond:
            self._fences.setdefault(name, set()).update(int(r) for r in ranks)
            self._cond.notify_all()

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class KVSClient:
    """Worker-side handle (≈ the PMIx client)."""

    def __init__(self, address: str):
        self._lock = threading.Lock()
        #: per-op call counters — the boot-scaling signature the np≥16
        #: scale soak asserts on (sharded modex: per-rank 'get' stays
        #: O(1)+lazy instead of P−1)
        self.ops: dict[str, int] = {}
        self._dial(address)

    def _dial(self, address: str) -> None:
        host, port = address.rsplit(":", 1)
        self.address = address
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.connect((host, int(port)))

    def reconnect(self, address: str) -> None:
        """Re-point this client at a NEW server (tpud restart
        re-adoption: the reborn daemon's KVS lives at a fresh port).
        Raises like a normal dial on failure; the old socket is closed
        either way."""
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._dial(address)

    def _call(self, msg: Any) -> Any:
        with self._lock:
            op = msg.get("op", "?")
            self.ops[op] = self.ops.get(op, 0) + 1
            _send_frame(self._sock, msg)
            return _recv_frame(self._sock)

    def put(self, key: str, value: Any) -> None:
        r = self._call({"op": "put", "key": key, "value": value})
        if not r.get("ok"):
            raise ConnectionError(f"kvs put failed: {r}")

    def get(self, key: str, wait: bool = True, timeout: float = 30.0) -> Any:
        r = self._call({"op": "get", "key": key, "wait": wait, "timeout": timeout})
        if not r.get("ok"):
            raise KeyError(key)
        return r["value"]

    def get_prefix(self, prefix: str) -> dict[str, Any]:
        """Bulk non-blocking scan of every key under ``prefix`` (≈ the
        PMIx "instant-on" rack-scale modex pull): one wire round-trip
        however many keys match."""
        r = self._call({"op": "get_prefix", "prefix": prefix})
        if not r.get("ok"):
            raise ConnectionError(f"kvs get_prefix failed: {r}")
        return dict(r["value"] or {})

    def fence(self, name: str, rank: int, size: int, timeout: float = 120.0) -> None:
        """Collective barrier over all ranks (≈ PMIx_Fence)."""
        r = self._call(
            {"op": "fence", "name": name, "rank": rank, "size": size, "timeout": timeout}
        )
        if not r.get("ok"):
            raise TimeoutError(f"fence {name!r} failed: {r.get('error')}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
