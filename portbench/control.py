"""Readings that the limits of `correct` are set from, on the card, at a
cell's own size, for many seeds in one process:

  program   the program's first steps against the reference (f32), which
            replays the program's block masks and matchings
  control   the reference with TF32 products, put in the program's place
            (the f32 reference replays its decisions)
  half      the reference on half of each batch (the mean over the rest),
            put in the program's place, against the f32 reference with its
            own decisions

    python3 -m portbench.control --workload train.mask3d.b8 \
        --seeds 11 12 13 --out control.jsonl

One JSON line per seed on standard output (and appended to --out). The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import manifest
from portbench.runners import train_step
from portbench.reference import train as reference


def readings(cell, seed: int, device="cuda", faults: bool = True) -> dict:
    """One seed's compared numbers for the program, the control and (with
    `faults`) the half-batch fault, with their times."""
    t = time.perf_counter()
    run = train_step.setup(cell, seed, device)
    prog = run.readings()
    setup_s = time.perf_counter() - t
    run.release()
    n = cell.traffic["reference_steps"]
    t = time.perf_counter()
    batches = reference.collate_all(run.scenes[:n], run.opt, device)
    collate_s = time.perf_counter() - t
    t = time.perf_counter()
    ref = run.follow(batches=batches, replay=run.decisions)
    ref_s = time.perf_counter() - t
    ctl = run.follow(tf32=True, batches=batches)
    ref_ctl = run.follow(batches=batches, replay=ctl["decisions"].steps)
    out = dict(seed=seed, setup_s=setup_s, collate_s=collate_s,
               reference_s=ref_s, losses=prog["losses"],
               ref_losses=ref["losses"],
               program=train_step.compare(prog, ref),
               program_steps=[train_step.gap(a, b) for a, b in
                              zip(prog["losses"], ref["losses"])],
               control=train_step.compare(ctl, ref_ctl),
               control_steps=[train_step.gap(a, b) for a, b in
                              zip(ctl["losses"], ref_ctl["losses"])])
    if faults:
        own = run.follow(batches=batches)
        half = reference.collate_all(
            [b[:len(b) // 2] for b in run.scenes[:n]], run.opt, device)
        out["half"] = train_step.compare(run.follow(batches=half), own)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    p.add_argument("--no-faults", action="store_true")
    args = p.parse_args(argv)
    cell = manifest.find_cell(manifest.load_manifest(), args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        line = json.dumps(dict(readings(cell, seed,
                                        faults=not args.no_faults),
                               workload=cell.name))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
