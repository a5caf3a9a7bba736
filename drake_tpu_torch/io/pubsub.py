"""Python bindings for the native pub/sub transport (the DrakeLcm role).

The port's copy of ``drake_tpu/io/pubsub.py`` (which uses no JAX; the port
may not import the JAX package): the comms API shape of Drake's
lcm/drake_lcm.h (DrakeLcm(url), Publish, Subscribe, HandleSubscriptions;
systems/lcm's Serializer) over the C++ transport in the port's own copy of
``native/pubsub.cpp``, compiled on demand with g++ into
``drake_tpu_torch/_build/`` and loaded through ctypes.

Typed channels serialize named arrays (numpy arrays, or torch tensors on
any device, copied to the host) in a self-describing format (no pickle on
the wire); the bytes are the reference's for the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "pubsub.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lib = None


def _build_library() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = str(BUILD_DIR / f"pubsub_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".build.{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)
    return so_path


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_library())
        lib.ps_create.restype = ctypes.c_void_p
        lib.ps_create.argtypes = [ctypes.c_char_p]
        lib.ps_subscribe.restype = ctypes.c_int
        lib.ps_subscribe.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ps_publish.restype = ctypes.c_int
        lib.ps_publish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.ps_handle_timeout.restype = ctypes.c_int
        lib.ps_handle_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ps_receive.restype = ctypes.c_int
        lib.ps_receive.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.ps_queue_size.restype = ctypes.c_int
        lib.ps_queue_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ps_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class PubSub:
    """A comms node: DrakeLcm analog.

    url: "memq://<name>" (in-process, deterministic — the test transport,
    like drake_lcm.h:19) or "udpm://239.255.76.67:7667" (UDP multicast).
    """

    DEFAULT_URL = "udpm://239.255.76.67:7667"

    def __init__(self, url: str = "memq://default"):
        self._lib = _get_lib()
        self._handle = self._lib.ps_create(url.encode())
        if not self._handle:
            raise RuntimeError(f"failed to create pub/sub node for {url!r}")
        self.url = url
        self._callbacks: List[Tuple[int, Callable]] = []

    def publish(self, channel: str, data: bytes) -> None:
        rc = self._lib.ps_publish(self._handle, channel.encode(), data, len(data))
        if rc != 0:
            raise RuntimeError(f"publish to {channel!r} failed (len={len(data)})")

    def subscribe(self, channel: str, callback: Optional[Callable] = None) -> int:
        """Subscribe to a channel (trailing '*' = prefix wildcard).

        With a callback, messages are dispatched during handle(); without,
        use receive()/queue_size() to poll.
        """
        sub_id = self._lib.ps_subscribe(self._handle, channel.encode())
        if callback is not None:
            self._callbacks.append((sub_id, callback))
        return sub_id

    def handle(self, timeout_ms: int = 0) -> int:
        """Pump the transport and dispatch callbacks (HandleSubscriptions)."""
        n = self._lib.ps_handle_timeout(self._handle, timeout_ms)
        for sub_id, cb in self._callbacks:
            while True:
                msg = self.receive(sub_id)
                if msg is None:
                    break
                cb(msg[0], msg[1])
        return n

    def receive(self, sub_id: int) -> Optional[Tuple[str, bytes]]:
        buf = ctypes.create_string_buffer(65536)
        chan = ctypes.create_string_buffer(256)
        n = self._lib.ps_receive(
            self._handle, sub_id, buf, len(buf), chan, len(chan)
        )
        if n < 0:
            return None
        return chan.value.decode(), buf.raw[:n]

    def queue_size(self, sub_id: int) -> int:
        return self._lib.ps_queue_size(self._handle, sub_id)

    def close(self):
        if self._handle:
            self._lib.ps_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Typed serialization (the systems/lcm Serializer role).
# ---------------------------------------------------------------------------


def _host(v):
    """A numpy array of `v` (a torch tensor is detached and copied to the
    host first)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def serialize_arrays(**arrays) -> bytes:
    """Pack named numpy arrays or tensors into one self-describing message."""
    buf = _io.BytesIO()
    np.savez(buf, **{k: _host(v) for k, v in arrays.items()})
    return buf.getvalue()


def deserialize_arrays(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(_io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


class ArrayPublisher:
    """LcmPublisherSystem analog: periodic typed publishing of array states."""

    def __init__(self, node: PubSub, channel: str):
        self.node = node
        self.channel = channel

    def publish(self, **arrays):
        self.node.publish(self.channel, serialize_arrays(**arrays))


class ArraySubscriber:
    """LcmSubscriberSystem analog: holds the latest typed message."""

    def __init__(self, node: PubSub, channel: str):
        self.node = node
        self.sub_id = node.subscribe(channel)
        self.latest: Optional[Dict[str, np.ndarray]] = None
        self.count = 0

    def poll(self) -> Optional[Dict[str, np.ndarray]]:
        self.node.handle(0)
        while True:
            msg = self.node.receive(self.sub_id)
            if msg is None:
                break
            self.latest = deserialize_arrays(msg[1])
            self.count += 1
        return self.latest
