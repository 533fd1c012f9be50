"""The readings the correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

In one process (the set-up is paid once for imports and the card), a short
run of the cell for each seed, as `run.py` makes it, and on the same sampled
frames the numbers of the sound port against the reference and of the
control (the reference computed in bfloat16) against the reference.  One
JSON line a seed, then a summary: each number's largest sound reading (the
lower end of its limit) and least control reading (the upper end).  Not run
by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run  # noqa: E402


def calibrate(workload: str, seeds, seconds: float, **kw) -> dict:
    sound, control = {}, {}
    for seed in seeds:
        t0 = time.time()
        result, report = run.run(workload, seed, seconds, False, t_start=t0, control=True, **kw)
        found = {k: v["value"] for k, v in report.items() if k != "control"}
        line = {"seed": seed, "frames": result["attempted"], "correct": result["correct"],
                "sound": found, "control": report["control"],
                "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        print(json.dumps(line), flush=True)
        for k, v in found.items():
            sound[k] = max(sound.get(k, 0.0), v)
        for k, v in report["control"].items():
            control[k] = min(control.get(k, float("inf")), v)
    summary = {"workload": workload, "seeds": len(seeds), "sound_max": sound,
               "control_min": control}
    print(json.dumps(summary), flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    calibrate(a.workload, a.seeds, a.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
