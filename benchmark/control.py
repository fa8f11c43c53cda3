#!/usr/bin/env python3
"""The controls of the benchmark's checks: for each seed, the cell's
set-up and a short window as a run makes them, then the check twice on
what they captured, once with the program's outputs and once with the
reference computed one precision lower in the program's place
(``drivers/<kind>.check(..., control=True)``).  The control has to fail
at least one of the cell's limits.  With ``--fault`` a fault of
``harness/faults.py`` is planted in the program instead, and the
program's numbers under it are reported.  Prints one JSON line per seed:

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>] [--fault <f>]

It needs the card, as a run does; the benchmark's runs do not run it."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("unchanged", "half", "altered"),
                    help="plant this fault in the program instead (harness/faults.py) and "
                         "report the program's numbers under it")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the short window the evaluation cells sample their steps from")
    args = ap.parse_args(argv)
    import torch
    from harness import cli, registry
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    reg = registry.Registry()
    for seed in args.seeds:
        run = cli.Run(reg, args.workload, seed, args.seconds, False, torch.device("cuda:0"))
        line = fault_line(run, args.fault) if args.fault else control_line(run)
        print(json.dumps(line), flush=True)
    return 0


def control_line(run) -> dict:
    """The program's numbers and the control's for one seed, with the
    verdict of each under the cell's limits."""
    from harness import cli, judge
    driver = run.registry.driver(run.cell["driver"])
    st = driver.setup(run)
    driver.window(run, st)
    driver.release(run, st)
    program = driver.check(run, st)
    control = driver.check(run, st, control=True)
    ok_p, _ = judge.verdict(program, run.limits)
    ok_c, _ = judge.verdict(control, run.limits)
    return {"workload": run.name, "seed": run.seed, "program_correct": ok_p,
            "control_correct": ok_c, "program": program, "control": control}


def fault_line(run, fault: str) -> dict:
    """The program's numbers with ``fault`` planted underneath its set-up
    and window, and their verdict under the cell's limits."""
    from harness import faults, judge
    driver = run.registry.driver(run.cell["driver"])
    with faults.planted(run.cell["driver"], fault):
        st = driver.setup(run)
        driver.window(run, st)
    driver.release(run, st)
    numbers = driver.check(run, st)
    ok, _ = judge.verdict(numbers, run.limits)
    return {"workload": run.name, "seed": run.seed, "fault": fault, "program_correct": ok,
            "program": numbers}


if __name__ == "__main__":
    sys.exit(main())
