#!/usr/bin/env python3
"""``chip_smoke.py`` under a wall-clock stack sampler, on a card.

    python3 scripts/sample_smoke.py [--out build/smoke_samples.json]

Runs the script as ``python3 chip_smoke.py`` would (its output and exit
code unchanged) while a thread reads the main thread's stack every 0.2 s.
Writes, as seconds (samples × period): the time under each function
(inclusive), the innermost lines, the innermost ``chip_smoke.py`` line and
the commonest stacks. Host waits show where they block: a readback or a
full launch queue is charged to the line that waits.
"""

import argparse
import collections
import json
import runpy
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PERIOD_S = 0.2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "smoke_samples.json"))
    args = ap.parse_args()
    main_id = threading.main_thread().ident
    incl, leaf, smoke_line, stacks = (collections.Counter() for _ in range(4))
    done = threading.Event()

    def sample() -> None:
        while not done.wait(PERIOD_S):
            f = sys._current_frames().get(main_id)
            seen, chain, first_smoke = set(), [], None
            while f is not None:
                name = f.f_code.co_filename.rsplit("/", 1)[-1]
                key = f"{name}:{f.f_code.co_name}"
                chain.append(f"{key}:{f.f_lineno}")
                if key not in seen:
                    incl[key] += 1
                    seen.add(key)
                if first_smoke is None and name == "chip_smoke.py":
                    first_smoke = chain[-1]
                f = f.f_back
            if chain:
                leaf[chain[0]] += 1
                stacks[" < ".join(chain[:8])] += 1
            if first_smoke:
                smoke_line[first_smoke] += 1

    threading.Thread(target=sample, daemon=True).start()
    sys.path[0] = str(ROOT)
    sys.argv = [str(ROOT / "chip_smoke.py")]
    rc = 0
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        done.set()

        def seconds(counter, n):
            return [[k, v * PERIOD_S] for k, v in counter.most_common(n)]

        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"period_s": PERIOD_S, "inclusive_s": seconds(incl, 150),
                       "leaf_s": seconds(leaf, 100), "smoke_line_s": seconds(smoke_line, 200),
                       "stacks_s": seconds(stacks, 100)}, fh, indent=0)
    return rc


if __name__ == "__main__":
    sys.exit(main())
