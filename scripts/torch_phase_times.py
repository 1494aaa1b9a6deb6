#!/usr/bin/env python3
"""Per-phase wall times of one ``chip_smoke.py`` run, from the times its
JSON lines arrive.

    python3 scripts/torch_phase_times.py [--dir CHECKOUT] [--out FILE] [-- ARGS...]

Runs ``python3 chip_smoke.py ARGS`` from ``CHECKOUT`` (default: this
checkout), passes its output through unchanged, and stamps each line of
its standard output as it arrives. ``chip_smoke.py`` prints a phase's
line when the phase (or a part of it) ends, so each line is charged the
time since the previous phase line, and a phase gets the sum over its
lines. Works for any version of the script: it reads only the
``"phase"`` key.
Writes ``{"rc", "total_s", "phase_s": {phase: seconds, ...}}`` to
``FILE`` (and as the last line of its own output), phases in the order
they first printed. Exits with the script's code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    ap.add_argument("args", nargs="*")
    a = ap.parse_args()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py", *a.args], cwd=a.dir,
                            stdout=subprocess.PIPE, text=True)
    phase_s: dict[str, float] = {}
    t_last = t0
    for line in proc.stdout:
        t = time.perf_counter()
        sys.stdout.write(line)
        sys.stdout.flush()
        try:
            phase = json.loads(line).get("phase")
        except (ValueError, AttributeError):
            phase = None
        if phase is None:
            continue
        # Each phase line is charged the time since the previous one.
        phase_s[phase] = phase_s.get(phase, 0.0) + (t - t_last)
        t_last = t
    rc = proc.wait()
    out = {"rc": rc, "total_s": time.perf_counter() - t0, "phase_s": phase_s}
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
