#!/usr/bin/env python3
"""Time the process gang's worlds of several checkouts side by side on one
card.

    python3 world_times.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo (for example this one and a parent
commit unpacked with ``git archive`` into a git-ignored directory).  For
each ROOT in the order given, a process of its own, started in ROOT,
runs that checkout's ``chip_smoke.phase_process_gang`` (phase 24: four
member processes on gloo over CUDA tensors, formed, one SIGKILLed,
re-formed, grown back) and prints one JSON line with the checkout and
the phase's seconds: ``spawn`` (every member answering), ``formation``
(the first world's forming call), ``death_named``, ``reform`` and
``readmit`` (each forming a world), and the all-reduces.  Give a root
twice (A B B A) to see the drift of the card and the host.  The card's
name and power limit come first.  Needs a CUDA card; builds no kernel
(phase 24 launches none)."""

import json
import os
import subprocess
import sys


def one() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = cs.card_line()
    secs = cs.phase_process_gang(card)
    print("[world_times] " + json.dumps({"root": os.getcwd(), "card": card,
                                         "secs": secs}), flush=True)


def main(roots) -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    rc = 0
    for root in roots:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one"], cwd=root, timeout=600)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    if sys.argv[1:] == ["--one"]:
        one()
    elif sys.argv[1:]:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
