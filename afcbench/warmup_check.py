"""The stage the comparison skips, checked by itself: every run's
reference starts from the program's warmed flow and its calibrated C_D0,
so this recomputes the uncontrolled warmup of a cell's scenarios with the
plain reference, from the impulsive start the configuration states, and
compares the flow and C_D0 with the program's.

    python3 -m afcbench.warmup_check --workload <cell>

Prints one JSON line: the start (the program's first state against the
reference's, before any step), the warmed flow's largest field gap over
the field's largest value, and the C_D0 gap over C_D0.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m afcbench.warmup_check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    repo = Path(__file__).resolve().parents[1]
    if str(repo / "src") not in sys.path:
        sys.path.insert(0, str(repo / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from afcbench import cells, check, program
    from afcbench.reference import cfd as R
    from repro_torch.cfd import solver
    cell = cells.load_cell(args.workload, root=repo)
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    env, _, _ = program.build_env(cfg, mix, dev)
    t_prog = time.perf_counter() - t0
    grid = check.ref_grid(cfg, mix)
    n = max(1, int(round(float(cfg["env"]["warmup_time"])
                         / float(cfg["env"]["dt"]))))
    out = {"workload": cell.name, "dt_steps": n, "program_s": t_prog}
    for scn in dict.fromkeys(check.env_scenarios(cfg, mix)):
        re, act, _, geom = R.SCENARIOS[scn]
        group = (re, float(act == "rotary"), geom)
        flow_p, cd0_p = env._group_cache[group]
        b = R.make_batch(grid, [scn], dev)._replace(per_body=False)
        g = b.geom
        u0 = g["inlet_u"][:, :, None] * (1.0 - g["chi_u"])
        start = solver.init_state(env.cfg.grid,
                                  env._geometry(geom)[0], dev)
        t0 = time.perf_counter()
        flow0 = R.Flow(u0, torch.zeros_like(g["chi_v"]),
                       torch.zeros(1, grid.ny, grid.nx, device=dev))
        with torch.no_grad():
            flow, cd, _ = R.interval(grid, b, flow0,
                                     torch.zeros(1, device=dev), n)
        cd0 = float(cd[0, -max(1, n // 4):].mean())
        out[scn] = {
            "start": max(check._rel(a[None], b_) for a, b_ in
                         zip(start, flow0)),
            "flow": max(check._rel(a[None], b_) for a, b_ in
                        zip(flow_p, flow)),
            "cd0": abs(cd0_p - cd0) / abs(cd0), "cd0_program": cd0_p,
            "cd0_reference": cd0,
            "reference_s": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
