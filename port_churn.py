#!/usr/bin/env python3
"""Churn the loopback ports that the system hands out, as a busy test pool's
servers do, to show whether a test races another process for a port.

    python3 port_churn.py [--hold 3000] [--rate 2000] [--seconds 150]

Binds a listening socket on 127.0.0.1 port 0 (the system picks the port)
``--rate`` times a second and keeps the newest ``--hold`` of them open,
closing the oldest, for ``--seconds`` seconds; then prints how many it
bound.  Run it in the background beside the test, for example
``tests/test_torch_port_proc_trainer_kill.py`` on a checkout whose
process worlds bind a port found free and closed again.  Nothing leaves
the machine."""

import argparse
import collections
import socket
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hold", type=int, default=3000)
    ap.add_argument("--rate", type=float, default=2000.0)
    ap.add_argument("--seconds", type=float, default=150.0)
    a = ap.parse_args()
    held: collections.deque = collections.deque()
    n, t0 = 0, time.monotonic()
    while time.monotonic() < t0 + a.seconds:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        held.append(s)
        n += 1
        if len(held) > a.hold:
            held.popleft().close()
        lag = t0 + n / a.rate - time.monotonic()
        if lag > 0:
            time.sleep(lag)
    print(f"bound {n} ports, {a.hold} held at a time")


if __name__ == "__main__":
    main()
