"""The output check's control and planted faults, at a cell's own size.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --what control
    python3 bench/control.py --workload <cell> --seeds 1,2,3 --what half_batch
    python3 bench/control.py --workload <cell> --seeds 1,2,3 --what sound

``control``: the reference trained in TF32 (the precision below the
configuration's float32 with TF32 off), put in the program's place and
compared with the reference in float32.  A fault name (``half_batch``,
``no_exchange``, ``grad_altered``, ``state_unchanged``; see
``gnnbench/faults.py``): a whole run of the cell with that fault planted in
the system under test.  ``sound``: the same run with nothing planted, the
readings that a limit's lower end is set from.  These runs measure no time,
so they skip the settle.  One JSON line a seed with the numbers compared
and whether the check passed; the benchmark's own runs never run this.
Needs a CUDA device.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--what", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from gnnbench import faults, harness, inputs, loader
    from gnnbench.reference import Reference

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    cell = loader.cell(args.workload)
    cfg = loader.config(cell["config"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.what == "control":
            ga, labels, train, feats, w0 = inputs.make(seed, cfg, "cuda")
            ref = Reference(ga, labels, train, cfg, cell["mode"], harness.NUM_PES,
                                cell["local_batch"], seed)
            numbers = faults.control_numbers(ref, lambda ids: feats[ids], w0,
                                             harness.CHECK_STEPS,
                                             cfg["optimizer"]["beta1"], sys.stderr)
            del ga, labels, train, feats, w0, ref
            torch.cuda.empty_cache()
        else:
            harness.SETTLE_S = 0.0
            plant = (contextlib.nullcontext() if args.what == "sound"
                     else faults.planted(args.what))
            with plant:
                out = harness.run(args.workload, seed, args.seconds, False)
            numbers = {k: c["value"] for k, c in out["checks"].items()}
        failed = [k for k, v in numbers.items() if v > cell["limits"][k]]
        print(json.dumps({"workload": args.workload, "what": args.what, "seed": seed,
                          "numbers": numbers, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
