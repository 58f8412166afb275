"""The readings that a cell's limits are set from, in one process.

    python3 -m azbench.readings --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--plies 0,59] [--out file.json]

For each seed the cell's games play from the opening, as a run plays
them, to a ply drawn from the seed in the range ``--plies``; that ply's
call is then compared as a run compares its kept call
(:mod:`azbench.check`): the sound readings, whose largest is each
limit's lower end. For each control seed the same ply is searched again
with the control in the program's forward: the plain reference with its
tower in int4, the precision below the configuration's int8. For each
fault seed it is searched again with each fault of :mod:`azbench.faults`
planted. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

from .spec import load_cell


def control_forward(sd, config):
    """The control in the program's forward: the plain reference with its
    tower in int4, returning what the program's forward returns."""
    from .reference.network import PlainNet
    net = PlainNet(sd, config["num_blocks"], 7, config["activation_scale_block"])

    def forward(x):
        log_p, v = net(x)
        return log_p.float(), v.float()[:, None]
    return forward


def readings(cell, seeds, control_seeds, fault_seeds, plies, device):
    import torch

    from . import check
    from .faults import FAULTS, planted
    from .run import prepare, stream

    cfg, traffic = cell.config, cell.traffic
    rows = []
    for seed in dict.fromkeys(seeds + control_seeds + fault_seeds):
        kinds = (["sound"] * (seed in seeds) + ["control"] * (seed in control_seeds)
                 + list(FAULTS) * (seed in fault_seeds))
        t0 = time.perf_counter()
        sess = prepare(cell, seed, device)
        play = sess.play
        target = random.Random(stream(seed, "ply")).randint(*plies)
        for _ in range(target):
            sess.ply()
        at = (play.boards, play.ply_no, play.actions.clone(), play.gen.get_state())
        for kind in kinds:
            play.boards, play.ply_no = at[:2]
            play.actions.copy_(at[2])
            play.gen.set_state(at[3])
            if kind == "sound":
                ply = sess.ply()
            elif kind == "control":
                net = control_forward(sess.sd, cfg)
                ply = play.ply(lambda: play.search(net))
            else:
                ply = planted(sess, kind)()
            kept = ply._replace(actions=play.actions[:ply.ply].clone())
            sample = check.sample_games(traffic["games"], cfg["activation_scale_block"],
                                        traffic["check_blocks"],
                                        torch.Generator().manual_seed(stream(seed, "sample")))
            numbers, failed = check.compare(cfg, traffic, kept, sample, sess.sd,
                                            stream(seed, "sample"))
            row = {"kind": kind, "seed": seed, "ply": ply.ply,
                   "live": int((~ply.result.root_terminal).sum()),
                   "correct": check.verdict(numbers, cfg["limits"]),
                   "failed_games": int(failed.sum()), **numbers}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del ply, kept
        del sess, play
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(f"readings: seed {seed} to ply {target}, {len(kinds)} calls "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m azbench.readings")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--plies", default="0,59")
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch
    seeds = [[int(s) for s in v.split(",") if s]
             for v in (args.seeds, args.control_seeds, args.fault_seeds)]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    plies = tuple(int(p) for p in args.plies.split(","))
    rows = readings(load_cell(args.workload), *seeds, plies, device)
    summary = {}
    for kind in dict.fromkeys(r["kind"] for r in rows):
        mine = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: [min(r[k] for r in mine), max(r[k] for r in mine)]
                         for k in mine[0] if k not in ("kind", "seed", "ply", "correct")}
        summary[kind]["correct"] = [r["correct"] for r in mine]
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                       "rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
