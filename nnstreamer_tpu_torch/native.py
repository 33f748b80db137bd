"""ctypes bindings for the native runtime core (``native/*.cc``).

Every entry point has a pure-Python fallback, so the package works
without the compiled library; with it, the host-side hot paths (wire
framing, the sparse scan, checksums) run GIL-free C++ and a classic
``QueryServer`` runs on the C++ epoll core (``native/nnstpu_server.cc``).

The port of the JAX package's ``native.py``, with its own build: the
library is compiled from ``native/nnstpu.cc`` and
``native/nnstpu_server.cc`` with ``native/Makefile``'s flags into
``nnstreamer_tpu_torch/_build/native/libnnstpu-<hash>.so``, keyed by a
hash of the sources and the flags and built under a file lock, as
``ops/_build.py`` keys the kernels. It never runs ``make`` and never
writes or loads ``native/libnnstpu.so``, the JAX package's library. The
frames and the sparse arrays are the JAX package's byte for byte.

Build on demand and print the features: ``python -m
nnstreamer_tpu_torch.native``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("native")

PKG_DIR = Path(__file__).resolve().parent
#: the C++ sources (shared with the JAX package, never written here)
SRC_DIR = PKG_DIR.parent / "native"
SOURCES = ("nnstpu.cc", "nnstpu_server.cc")
#: where the library is built (ignored by git)
BUILD_DIR = PKG_DIR / "_build" / "native"
#: ``native/Makefile``'s flags for ``libnnstpu.so``
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
LDLIBS = ["-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Optional[Path]:
    """The library for the sources as they stand, or None without them."""
    srcs = [SRC_DIR / s for s in SOURCES]
    if not all(p.is_file() for p in srcs):
        return None
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join([_compiler()] + CXXFLAGS + LDLIBS).encode())
    return BUILD_DIR / f"libnnstpu-{h.hexdigest()[:16]}.so"


def build(quiet: bool = True) -> bool:
    """Compile the library into the build directory, unless a library for
    these sources is there already. A file lock serializes concurrent
    builds, and the library is renamed into place whole, so nobody
    loads a half-written file."""
    out = library_path()
    if out is None:
        log.warning("native build: no sources in %s", SRC_DIR)
        return False
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if out.is_file():
                return True  # another process already built it
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ([_compiler()] + CXXFLAGS + ["-o", str(tmp)]
                   + [str(SRC_DIR / s) for s in SOURCES] + LDLIBS)
            subprocess.run(cmd, capture_output=quiet, check=True)
            os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        log.warning("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load the library, building it first when it is not built."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if path is None or (not path.is_file() and not build()):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        log.warning("cannot load %s: %s", path, e)
        return None
    lib.nnstpu_abi_version.restype = ctypes.c_int
    if lib.nnstpu_abi_version() != 1:
        log.warning("native ABI mismatch")
        return None
    try:
        return _bind(lib)
    except AttributeError as e:
        log.warning("native library is missing symbols (%s)", e)
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    global _lib
    # signatures
    lib.nnstpu_cpu_features.restype = ctypes.c_int
    lib.nnstpu_fnv1a.restype = ctypes.c_uint64
    lib.nnstpu_fnv1a.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.nnstpu_sparse_count.restype = ctypes.c_int64
    lib.nnstpu_sparse_count.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
    lib.nnstpu_sparse_encode.restype = ctypes.c_int64
    lib.nnstpu_sparse_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.nnstpu_sparse_decode.restype = ctypes.c_int
    lib.nnstpu_sparse_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.nnstpu_send_frame.restype = ctypes.c_int
    lib.nnstpu_send_frame.argtypes = [
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64]
    lib.nnstpu_recv_header.restype = ctypes.c_int
    lib.nnstpu_recv_header.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.nnstpu_recv_payload.restype = ctypes.c_int
    lib.nnstpu_recv_payload.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64]
    lib.nnstpu_set_nodelay.restype = ctypes.c_int
    lib.nnstpu_set_nodelay.argtypes = [ctypes.c_int]
    lib.nnstpu_server_start.restype = ctypes.c_void_p
    lib.nnstpu_server_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.nnstpu_server_port.restype = ctypes.c_int
    lib.nnstpu_server_port.argtypes = [ctypes.c_void_p]
    lib.nnstpu_server_take.restype = ctypes.c_int
    lib.nnstpu_server_take.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
    lib.nnstpu_server_send.restype = ctypes.c_int
    lib.nnstpu_server_send.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint64]
    lib.nnstpu_server_kick.restype = ctypes.c_int
    lib.nnstpu_server_kick.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.nnstpu_server_signal_stop.restype = None
    lib.nnstpu_server_signal_stop.argtypes = [ctypes.c_void_p]
    lib.nnstpu_server_stop.restype = None
    lib.nnstpu_server_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# high-level helpers (native when possible, numpy fallback otherwise)
# ---------------------------------------------------------------------------
def cpu_features() -> dict:
    lib = get_lib()
    feats = lib.nnstpu_cpu_features() if lib else 0
    return {"neon": bool(feats & 1), "avx2": bool(feats & 2),
            "avx512": bool(feats & 4), "native": lib is not None}


def fnv1a(data: bytes) -> int:
    lib = get_lib()
    if lib:
        return int(lib.nnstpu_fnv1a(data, len(data)))
    h = 0xCBF29CE484222325
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def sparse_encode_arrays(dense: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(indices u32, values) of nonzero elements, native-accelerated."""
    flat = np.ascontiguousarray(dense).reshape(-1)
    lib = get_lib()
    if lib is None or flat.dtype.itemsize not in (1, 2, 4, 8):
        idx = np.flatnonzero(flat).astype(np.uint32)
        return idx, flat[idx]
    nnz = lib.nnstpu_sparse_count(
        flat.ctypes.data, flat.size, flat.dtype.itemsize)
    if nnz < 0:
        idx = np.flatnonzero(flat).astype(np.uint32)
        return idx, flat[idx]
    idx = np.empty(nnz, np.uint32)
    vals = np.empty(nnz, flat.dtype)
    lib.nnstpu_sparse_encode(flat.ctypes.data, flat.size,
                             flat.dtype.itemsize,
                             idx.ctypes.data, vals.ctypes.data)
    return idx, vals


def sparse_decode_arrays(indices: np.ndarray, values: np.ndarray,
                         n_elems: int) -> np.ndarray:
    lib = get_lib()
    values = np.ascontiguousarray(values)
    indices = np.ascontiguousarray(indices, np.uint32)
    if lib is None:
        if len(indices) and int(indices.max()) >= n_elems:
            raise ValueError("sparse_decode: index out of range")
        dense = np.zeros(n_elems, values.dtype)
        dense[indices] = values
        return dense
    dense = np.empty(n_elems, values.dtype)
    rc = lib.nnstpu_sparse_decode(
        indices.ctypes.data, values.ctypes.data, len(indices),
        values.dtype.itemsize, dense.ctypes.data, n_elems)
    if rc != 0:
        raise ValueError("sparse_decode: index out of range")
    return dense


def send_frame(sock, magic: int, command: int, payload: bytes) -> None:
    """Framed send over a Python socket; native writev when available.

    The native path requires a truly blocking fd: CPython implements socket
    timeouts with O_NONBLOCK, and the C side retries only EINTR — so any
    socket with a timeout takes the Python path (same guard as recv_msg).
    """
    lib = get_lib()
    if lib is not None and sock.gettimeout() is None:
        rc = lib.nnstpu_send_frame(sock.fileno(), magic, command,
                                   payload, len(payload))
        if rc != 0:
            raise OSError("native send_frame failed")
        return
    import struct

    sock.sendall(struct.pack("<IIQ", magic, command, len(payload)) + payload)


class NativeServerCore:
    """Handle to the C++ epoll query-server transport (nnstpu_server.cc).

    Owns the listener + all client sockets on one native thread; Python
    sees only complete TRANSFER payloads (``wait_pop``) and pushes framed
    replies (``send``). The classic wire only: the port's reference-wire
    server stays on Python, which DENYs a mismatched client and announces
    the negotiated output caps (ROADMAP C.50). Raises OSError if the native library is missing or
    the port cannot be bound — callers fall back to the pure-Python server.

    ``stop`` is safe against concurrent callers: it signals the native core
    (blocked takes return immediately), waits for in-flight calls to drain,
    and only then frees the handle.
    """

    #: initial take buffer; grows to the reported frame size on demand
    _INITIAL_CAP = 1 << 16

    def __init__(self, host: str, port: int, caps_str: str = "",
                 max_queue: int = 64):
        import threading

        lib = get_lib()
        if lib is None:
            raise OSError("native library unavailable")
        self._lib = lib
        self._cv = threading.Condition()
        self._inflight = 0
        #: per-thread reusable take buffer — idle polls (10/s in the
        #: serversrc loop) must not churn 64 KiB allocations
        self._tls = threading.local()
        self._h = lib.nnstpu_server_start(
            (host or "").encode(), int(port), caps_str.encode(),
            int(max_queue))
        if not self._h:
            raise OSError(f"nnstpu_server: cannot bind {host}:{port}")
        self.port = int(lib.nnstpu_server_port(self._h))

    def _enter(self) -> Optional[int]:
        """Return the handle to use for ONE native call (never re-read
        self._h after this — a concurrent stop() nulls it, and the capture
        is what keeps the handle alive until _exit)."""
        with self._cv:
            if self._h is None:
                return None
            self._inflight += 1
            return self._h

    def _exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def wait_pop(self, timeout: Optional[float]
                 ) -> Optional[Tuple[int, bytes]]:
        """Block up to ``timeout`` s (None = forever) for one TRANSFER;
        (client_id, payload) or None on timeout/stop. GIL released while
        waiting."""
        h = self._enter()
        if h is None:
            return None
        try:
            cid = ctypes.c_uint32()
            ln = ctypes.c_uint64()
            buf = getattr(self._tls, "buf", None)
            if buf is None:
                buf = self._tls.buf = bytearray(self._INITIAL_CAP)
            while True:
                # None = block forever: re-arm hour-long native waits (the
                # C side wants a finite ms value)
                step_ms = 3_600_000 if timeout is None \
                    else max(0, int(timeout * 1000))
                rc = self._lib.nnstpu_server_take(
                    h, step_ms,
                    (ctypes.c_char * len(buf)).from_buffer(buf), len(buf),
                    ctypes.byref(cid), ctypes.byref(ln))
                if rc == 0:
                    return int(cid.value), bytes(buf[:ln.value])
                if rc == -3:  # head frame bigger than our buffer: grow
                    buf = self._tls.buf = bytearray(ln.value)
                    continue
                if rc == -1 and timeout is None:
                    continue  # infinite wait: keep re-arming
                return None  # timeout or stopping
        finally:
            self._exit()

    def send(self, client_id: int, cmd: int, payload: bytes) -> bool:
        h = self._enter()
        if h is None:
            return False
        try:
            rc = self._lib.nnstpu_server_send(
                h, int(client_id), int(cmd), payload, len(payload))
            return rc == 0
        finally:
            self._exit()

    def kick(self, client_id: int) -> None:
        """Disconnect one client (native parity with the pure-Python
        loop's close-on-bad-frame)."""
        h = self._enter()
        if h is None:
            return
        try:
            self._lib.nnstpu_server_kick(h, int(client_id))
        finally:
            self._exit()

    def stop(self) -> None:
        with self._cv:
            h, self._h = self._h, None
            if h is None:
                return
            self._lib.nnstpu_server_signal_stop(h)
            while self._inflight:
                self._cv.wait()
        self._lib.nnstpu_server_stop(h)


def main(argv=None):
    ok = build(quiet=False)
    print("native build:", f"ok ({library_path()})" if ok else "FAILED")
    print("features:", cpu_features())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
