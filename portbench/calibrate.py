"""Readings that the limits of a cell's check are set from.

    python3 portbench/calibrate.py --workload mnist-gossip --seeds 1-12 \
        --control-seeds 1-3 --fault-seeds 1-3 --out calibrate.jsonl

For each seed: one train of the program at the cell's sizes on that
seed's first inputs, held against the float64 reference as the check
holds it (the lower readings); with ``--control-seeds``, the control,
the reference itself computed in float32 with TF32 products, held the
same way (the upper readings); with ``--fault-seeds``, the program with
each fault of :mod:`portbench.harness.faults` planted.  One JSON line a
reading, to ``--out`` and standard output, then the worst of each kind.
Not run by the benchmark's runs.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi) + 1) if hi else [int(lo)])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import numpy as np
    import torch

    from portbench.harness import cells, check, faults, inputs, program

    cell = cells.load(args.workload)
    driver, logits = cells.driver(cell), cells.reference(cell).logits
    device = torch.device("cuda", 0)
    spec = driver.warm_up(cell, 0, device)
    policy = spec.resolve_policy()
    card = f"{torch.cuda.get_device_name(0)}"
    print(f"calibrate {args.workload} on {card}, set-up {time.perf_counter() - STARTED:.1f} s",
          flush=True)

    programs, controls, fault_seeds = (
        seed_list(args.seeds), seed_list(args.control_seeds), seed_list(args.fault_seeds))
    rows = []
    out = open(args.out, "a")

    def emit(row):
        rows.append(row)
        text = json.dumps(row)
        print(text, flush=True)
        out.write(text + "\n")
        out.flush()

    for seed in sorted(set(programs) | set(controls) | set(fault_seeds)):
        job = inputs.make(cell.config, seed, 0, device)
        t0 = time.perf_counter()
        ref = driver.reference_result(cell, job)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        kinds = []
        if seed in programs:
            kinds.append("program")
        if seed in controls:
            kinds.append("control")
        if seed in fault_seeds:
            kinds.extend(f"fault:{f}" for f in faults.FAULTS)
        for kind in kinds:
            t0 = time.perf_counter()
            if kind == "control":
                low = driver.reference_result(cell, job, dtype=torch.float32, tf32=True)
                got = check.Outputs(tuple(low.readouts), low.objective.numpy())
            elif kind == "program":
                got = program.train(spec, job)
            else:
                with faults.planted(kind.split(":")[1], policy):
                    got = program.train(spec, job)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            values = check.gaps(got, ref, job.r, job.x_test, logits=logits)
            emit({"workload": args.workload, "seed": seed, "kind": kind, **values,
                  "seconds": seconds, "reference_s": ref_s, "card": card})
        del job, ref
        torch.cuda.empty_cache()

    for kind in sorted({r["kind"] for r in rows}):
        mine = [r for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        worst = {n: pick(r[n] for r in mine) for n in check.NUMBERS}
        print(f"summary {args.workload} {kind} ({len(mine)} seeds, "
              f"{'max' if kind == 'program' else 'min'}): {json.dumps(worst)}; "
              f"median s {float(np.median([r['seconds'] for r in mine])):.3f}", flush=True)
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
