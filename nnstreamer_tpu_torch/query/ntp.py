"""SNTP client — cross-host clock correction for distributed streams.

Reference: ``gst/mqtt/ntputil.c`` (ntputil_get_epoch) does one UDP
exchange with an NTP server and takes the server transmit timestamp as
the epoch — which bakes the response's one-way latency into the result.
Here the full SNTP offset formula is used instead::

    offset = ((t1 - t0) + (t2 - t3)) / 2

with t0/t3 the client's send/receive instants and t1/t2 the server's
receive/transmit ones, so symmetric network delay cancels and the
corrected epoch excludes message latency (the exact weakness of
first-message-delta rebasing).

``corrected_epoch_ns`` caches the measured offset: one UDP round at
first use, pure ``time_ns()`` arithmetic afterwards.

Port of ``nnstreamer_tpu/query/ntp.py``: a copy with its imports
rewritten.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Iterable, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("ntp")

#: seconds between the NTP epoch (1900) and the Unix epoch (1970)
NTP_UNIX_DELTA = 2_208_988_800
_FRAC = 1 << 32

#: reference default (ntputil.c NTPUTIL_DEFAULT_HNAME / port 123)
DEFAULT_SERVERS: Tuple[Tuple[str, int], ...] = (("pool.ntp.org", 123),)


def _to_ntp(unix_ns: int) -> Tuple[int, int]:
    sec, ns = divmod(unix_ns, 1_000_000_000)
    return sec + NTP_UNIX_DELTA, (ns * _FRAC) // 1_000_000_000


def _from_ntp(sec: int, frac: int) -> int:
    """NTP (sec, frac) → Unix epoch ns; 0/0 means unset."""
    if sec == 0 and frac == 0:
        return 0
    return (sec - NTP_UNIX_DELTA) * 1_000_000_000 + \
        (frac * 1_000_000_000) // _FRAC


def sntp_offset_ns(server: str = "pool.ntp.org", port: int = 123,
                   timeout: float = 2.0) -> int:
    """One SNTP round → this host's clock offset (ns) vs the server.

    A positive value means the local clock is behind. Raises OSError /
    socket.timeout when the server is unreachable.
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        sock.settimeout(timeout)
        # LI=0 VN=4 Mode=3 (client); originate ts = our send time so the
        # server echoes it back in the originate field
        t0 = time.time_ns()
        o_sec, o_frac = _to_ntp(t0)
        req = struct.pack(">B3x11I", 0x23, *([0] * 9), o_sec, o_frac)
        sock.sendto(req, (server, port))
        data, _addr = sock.recvfrom(512)
        t3 = time.time_ns()
    finally:
        sock.close()
    if len(data) < 48:
        raise ValueError(f"ntp: short response ({len(data)}B) from {server}")
    fields = struct.unpack_from(">B3x11I", data)
    recv_sec, recv_frac = fields[8], fields[9]    # t1: server receive
    xmit_sec, xmit_frac = fields[10], fields[11]  # t2: server transmit
    t1 = _from_ntp(recv_sec, recv_frac)
    t2 = _from_ntp(xmit_sec, xmit_frac)
    if t2 == 0:
        raise ValueError(f"ntp: {server} returned no transmit timestamp")
    if t1 == 0:
        # degenerate SNTP server (like the reference's minimal exchange):
        # fall back to transmit-minus-receive-instant, latency included
        return t2 - t3
    return ((t1 - t0) + (t2 - t3)) // 2


_FAILED = object()  # sentinel: this server list was tried and unreachable

_cache_lock = threading.Lock()
#: per-server-list measured offsets — elements with different ntp-server
#: settings never poison each other's correction
_cache: dict = {}


def corrected_epoch_ns(servers: Optional[Iterable[Tuple[str, int]]] = None,
                       timeout: float = 2.0) -> int:
    """NTP-corrected Unix epoch (ns): ``time_ns() + cached offset``.

    The offset is measured once per distinct server list (reference
    ntputil loops hnames the same way); on total failure logs once and
    falls back to the uncorrected clock — the element keeps streaming,
    matching mqttsink.c's get-epoch fallback behavior.
    """
    key = tuple(servers) if servers is not None else DEFAULT_SERVERS
    with _cache_lock:
        entry = _cache.get(key)
        if entry is None:
            for host, port in key:
                try:
                    entry = sntp_offset_ns(host, port, timeout)
                    log.info("ntp: offset %+d us via %s",
                             entry // 1000, host)
                    break
                except (OSError, ValueError) as e:
                    log.warning("ntp: %s:%d unreachable (%s)", host, port, e)
            else:
                entry = _FAILED
            _cache[key] = entry
    off = 0 if entry is _FAILED else entry
    return time.time_ns() + off


def reset_offset_cache() -> None:
    """Forget measured offsets (tests / long-running re-sync)."""
    with _cache_lock:
        _cache.clear()
