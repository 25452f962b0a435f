"""Benchmark of repro_torch's decentralized SSFN training on one card.

    python3 portbench/run.py --workload mnist-gossip --seed 7 --seconds 30 --trace 0

Runs the cell ``--workload`` of ``BENCHMARK.json`` from the root of a
checkout, by the driver that the cell's file names
(``portbench/workloads/<cell>.json``; the dSSFN training cells':
``portbench/drivers/dssfn_train.py``): set-up, then whole trains for
``--seconds``, then (``--trace 1``) four traced trains, then the check
of a sampled train against the plain reference.  Prints the numbers compared as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits 2, printing no result, without the cards the cell asks for, or if
JAX or the JAX package was loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level modules that may not be loaded: JAX and the JAX package
#: (``repro``; the port, ``repro_torch``, is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache of the program stays in the checkout, at fixed paths.
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench.harness import cells

    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    line = cells.driver(cell).run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                                  device=torch.device("cuda", 0), started=STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result", file=sys.stderr)
        return 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
