"""Readings the limits of ``portbench/reference/check.py`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds <n> ... \
        [--out FILE]

For each seed, in one process and at the cell's own size: the cell's
inputs are made as a run makes them, two calls are made through the
operation's timed entry (the call a run checks beside its last call,
and the one after it), and each number of the operation's check is read
for the program's answers and for its control, the reference itself
computed in bfloat16 (:func:`portbench.reference.csc.sums_bf16`).  The
benchmark's own runs do not run this.  Prints one JSON line a seed.
"""
import argparse
import json
import os
import sys


def readings(c, seed: int, device: str) -> dict:
    import torch

    from portbench import harness

    dev = torch.device(device)
    op = harness.operation(c.traffic["op"])
    state = op.setup(harness.generator(c.config["generator"]), c.config,
                     c.traffic, seed, dev)
    first = state.pool + harness.sampled_call(seed, state.pool)
    items = (first, first + 1)
    state.prepare(0)
    state.call(0)  # the warm-up a run makes
    answers = {}
    for k in items:
        state.prepare(k)
        answers[k] = op.to_host(state.call(k))
    inputs = {k: state.host_inputs(k) for k in items}
    del state
    return {"workload": c.name, "seed": seed,
            "program": op.compare(inputs, answers),
            "control": op.control(inputs), "limits": op.LIMITS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    sys.path.insert(1, os.path.join(root, "src"))
    from portbench import harness

    c = harness.cell(harness.manifest(), args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            line = json.dumps(readings(c, seed, "cuda"))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
