"""Run one cell of ``BENCHMARK.json`` once, on the NVIDIA GPU it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number the check compared
beside its limit, and the last lines of standard error repeat them.
``--dtype float32`` runs the program in float32 against the float64
reference: the check's control, which has to come out not correct.

Exits non-zero, printing no result, without a CUDA device (or fewer than
the cell asks for), and when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

import argparse
import json
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pnmol_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--dtype", choices=("float64", "float32"), default=None,
                        help="run the program in this precision (the check's control)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # CUDA's own kernel cache at a fixed place inside the checkout
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / ".bench_cache" / "cuda"))
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    sys.path.append(str(ROOT))
    from harness import manifest, runner

    cell = manifest.Cell.load(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = runner.run(cell, args.seed, args.seconds, trace=bool(args.trace),
                                dtype=args.dtype, t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("trace_window_s")
    failure = result.pop("failure")
    if failure:
        print(f"run.py: the program failed: {failure}", file=sys.stderr)
    breakdown = result.pop("breakdown", None)
    line = dict(result, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, entry in checks.items():
        print(f"check {name}: {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
