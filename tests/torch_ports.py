"""Endpoints for the port's distributed tests that no other test process
takes: each pytest-xdist worker (PYTEST_XDIST_WORKER gwN) draws from a band
of its own below the kernel's ephemeral range (where bind-to-0 ports, which
the other distributed tests use, never land), skipping a port that is
taken. A process without xdist takes the band past the workers'."""

import itertools
import os
import socket

BAND = 400  # ports a worker owns
_next = itertools.count()


def _ephemeral_low():
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _worker_index():
    name = os.environ.get("PYTEST_XDIST_WORKER", "")
    return int(name[2:]) if name.startswith("gw") and name[2:].isdigit() else 31


def _free(port):
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind(("127.0.0.1", port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def endpoints(n):
    """n "127.0.0.1:<port>" endpoints from this worker's band."""
    top = _ephemeral_low() - 1
    base = top - BAND * (_worker_index() + 1)
    out = []
    while len(out) < n:
        port = base + next(_next) % BAND
        if _free(port):
            out.append("127.0.0.1:%d" % port)
    return out
