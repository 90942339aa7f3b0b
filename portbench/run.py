"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (traced
runs) and ``checks``, the numbers compared with their limits, which
also end standard error.  Without a CUDA device, or with fewer cards
than the cell asks for, it prints no result and exits with 2.

The port's kernels build into ``build/repro_torch`` inside the
checkout; PyTorch's and Triton's caches go under ``build/portbench``.
"""
import os
import sys
import time

T0 = time.perf_counter()


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    # the port's priors, whatever table a caller's environment names
    os.environ.pop("REPRO_TUNING_CACHE_DIR", None)
    # the checkout's root (for ``portbench``) and its ``src`` (for the
    # port), not this script's folder
    sys.path[0] = root
    sys.path.insert(1, os.path.join(root, "src"))
    from portbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
