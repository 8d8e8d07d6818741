#!/usr/bin/env python3
"""Where chip_smoke.py's wall time goes: its main() under a stack sampler.

A daemon thread reads the main thread's stack every ``--every`` seconds
(0.25 by default) and files the sample under the phase function running
(the outermost ``phase_*`` frame of chip_smoke.py), the innermost three
chip_smoke.py frames, the innermost frame of the package and the leaf
frame.  When main() returns or fails, the per-phase totals and each
phase's most common stacks go to ``--report`` (chiprun_out/smoke_sampler.txt
by default).  Phase 5d's rank processes sample themselves the same way
(``RANKS_ENV`` names the directory) and write
``smoke_sampler_rank{r}.txt`` beside the report.  Time a phase spends waiting on its HTTP server shows as
``socket.py:readinto`` under the request's line.  The sampler's cost is
one stack walk per interval.

Run from the repository root on the machine with the card:

    python3 scripts/smoke_sampler.py [--every 0.25] [--report PATH] \\
        [-- chip_smoke arguments]
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sample(main_id, every, samples, stop):
    while not stop.is_set():
        time.sleep(every)
        frame = sys._current_frames().get(main_id)
        stack = []
        while frame is not None:
            code = frame.f_code
            stack.append((code.co_filename, code.co_name, frame.f_lineno))
            frame = frame.f_back
        stack.reverse()
        smoke = [s for s in stack if s[0].endswith("chip_smoke.py")]
        phases = [s[1] for s in smoke if s[1].startswith("phase_")]
        phase = phases[0] if phases else (smoke[-1][1] if smoke else "?")
        inner = " < ".join(f"{n}:{ln}" for _, n, ln in reversed(smoke[-3:]))
        pkg = [s for s in stack if "penroz_tpu_torch" in s[0]]
        pkg = (f"{os.path.basename(pkg[-1][0])}:{pkg[-1][1]}:{pkg[-1][2]}"
               if pkg else "-")
        leaf = f"{os.path.basename(stack[-1][0])}:{stack[-1][1]}"
        samples.append((phase, inner, pkg, leaf))


def report(samples, every, path, top=14):
    by_phase = collections.Counter(s[0] for s in samples)
    with open(path, "w") as f:
        f.write(f"{len(samples)} samples, one every {every} s\n")
        for phase, n in by_phase.most_common():
            f.write(f"\n== {phase}: {n * every:.1f} s\n")
            stacks = collections.Counter(s[1:] for s in samples
                                         if s[0] == phase)
            for (inner, pkg, leaf), m in stacks.most_common(top):
                f.write(f"  {m * every:6.1f} s  {inner}  | {pkg} | {leaf}\n")


# set by main() for phase 5d's rank processes: where their reports go
RANKS_ENV = "PENROZ_SMOKE_SAMPLER_DIR"


def sample_main_thread(path, every=0.25):
    """Sample this process's main thread until the returned function is
    called, which writes the report to ``path``."""
    samples, stop = [], threading.Event()
    threading.Thread(target=_sample, args=(
        threading.main_thread().ident, every, samples, stop),
        daemon=True).start()

    def done():
        stop.set()
        report(samples, every, path)
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--every", type=float, default=0.25)
    parser.add_argument("--report", default=os.path.join(
        ROOT, "chiprun_out", "smoke_sampler.txt"))
    parser.add_argument("smoke_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke

    report_dir = os.path.dirname(os.path.abspath(args.report))
    os.makedirs(report_dir, exist_ok=True)
    os.environ[RANKS_ENV] = report_dir
    done = sample_main_thread(args.report, args.every)
    rest = [a for a in args.smoke_args if a != "--"]
    try:
        return chip_smoke.main(rest)
    finally:
        done()


if __name__ == "__main__":
    sys.exit(main())
