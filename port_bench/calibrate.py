"""Readings for the limits of ``correct``, on the card, many seeds in one
process: the numbers each run compares (the program against the plain
reference, as ``run.py`` compares them), the control's (``core/
control.py``) or a planted fault's (``core/faults.py``).

    python3 port_bench/calibrate.py --workload t_train_bf16 \
        --seeds 11,12,13 [--control | --fault half_batch] [--seconds 1] \
        [--out readings.jsonl]

One JSON line per seed, on standard output and appended to ``--out``.
"""
import time

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.core import check, control, faults, harness  # noqa: E402

WORST = 4          # leaves listed, worst first


def _leaves(gaps) -> dict:
    """The median leaf's gap and the worst leaves of each per-leaf number,
    and its worst SS2D leaf of each kind (in_proj, A_logs, ...)."""
    if not gaps:
        return {}
    out = {}
    for number, by_leaf in gaps.items():
        ranked = sorted(by_leaf.items(), key=lambda kv: -kv[1])
        out[number + "_median"] = statistics.median(by_leaf.values())
        out[number + "_worst"] = ranked[:WORST]
        kinds = {}
        for name, v in by_leaf.items():
            if check.SS2D in name:
                kind = name.split(check.SS2D)[1]
                kinds[kind] = max(v, kinds.get(kind, 0.0))
        out[number + "_ss2d_kinds"] = kinds
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(faults.FAULTS))
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    w, config, traffic, limits = harness.resolve(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if args.control:
            from port_bench.modes import common
            reading = control.READINGS[traffic["mode"]](
                config, traffic, seed, common.card(), leaves=True)
            row = {"readings": reading, **_leaves(reading.pop("leaf_gaps",
                                                              None))}
        else:
            cell = harness.Cell(w["name"], config, traffic, limits,
                                w["chips"], seed, args.seconds, False, t0,
                                args.fault)
            out = harness.run_cell(cell)
            row = {"readings": {n: v for n, v, _ in out.checks},
                   "correct": all(v <= lim for _, v, lim in out.checks),
                   "e2e": out.e2e, **_leaves(out.ctx.get("leaf_gaps"))}
        row.update(workload=w["name"], seed=seed, control=args.control,
                   fault=args.fault, seconds=time.time() - t0)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
