#!/usr/bin/env python
"""Whether the parity pipeline's answer on the card depends on the batch it is
solved in, on the linear-algebra backend, or on the device (needs a GPU).

    python tools/parity_batch_probe.py [--tree DIR] [--cpu-scenarios 4096]

Phase 12a's scenarios (``chip_smoke.engine_inputs``: phase 3's jittered
h=16 trot at its first solve tick, B=4096) go through the parity pipeline
(``chip_smoke.parity_routes(...)["parity"]``: ``build_qp_ff`` +
``ipm.solve_batch`` with ``PARITY_CONFIG`` and the low words) on the card
at B=4096 with PyTorch's default, cuSOLVER and MAGMA linear algebra, in
batches of 256, and for PROBE's scenarios one at a time; and on the CPU in
batches of 256 over the first ``--cpu-scenarios``.  Each pair is compared as
max |U - V| / (1 + |V|) over the first-step GRFs per scenario.  ``--tree``
runs the port and chip_smoke.py of another checkout (an unpacked earlier
commit), so two versions can be compared in one call.  Prints one JSON line
and appends it to chiprun_out/parity_batch_probe.jsonl.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

PROBE = (0, 198, 530, 941, 3025)
CHUNK = 256


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   ".."))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--cpu-scenarios", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from chip_smoke import B_MAIN, engine_inputs, parity_routes
    from pympc_quadruped_tpu_torch import tree
    from pympc_quadruped_tpu_torch.models import aliengo

    if not torch.cuda.is_available():
        print("parity_batch_probe: no CUDA device", file=sys.stderr)
        return 1
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t0 = time.perf_counter()
    mpc, robot, inputs = engine_inputs(dev, B_MAIN)

    def parity(device, sl):
        sub = tuple(t[sl].to(device) for t in inputs)
        n = sub[0].shape[0]
        return parity_routes(tree.to(mpc, device), tree.tile(aliengo(device=device), n),
                             sub)["parity"]().double().cpu()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    U = {}
    parity(dev, slice(0, B_MAIN))  # warm-up
    U["card_4096"], ms = timed(lambda: parity(dev, slice(0, B_MAIN)))
    for lib in ("cusolver", "magma"):
        torch.backends.cuda.preferred_linalg_library(lib)
        U[f"card_4096_{lib}"] = parity(dev, slice(0, B_MAIN))
    torch.backends.cuda.preferred_linalg_library("default")
    U["card_256"] = torch.cat([parity(dev, slice(lo, lo + CHUNK))
                               for lo in range(0, B_MAIN, CHUNK)])
    U["card_alone"] = torch.cat([parity(dev, slice(i, i + 1)) for i in PROBE])
    nc = args.cpu_scenarios
    t_cpu = time.perf_counter()
    U["cpu_256"] = torch.cat([parity(cpu, slice(lo, min(lo + CHUNK, nc)))
                              for lo in range(0, nc, CHUNK)])
    t_cpu = time.perf_counter() - t_cpu

    def rel(a, b):
        return ((a - b).abs() / (1.0 + b.abs()))[:, :12].amax(-1)

    def cmp(a, b):
        r = rel(a, b)
        worst = torch.argsort(r, descending=True)[:5]
        return {"max": float(r.max()), "p99": float(torch.quantile(r, 0.99)),
                "above_1e-3": int((r > 1e-3).sum()), "worst": [int(i) for i in worst]}

    probe = list(PROBE)
    in_cpu = all(i < nc for i in probe)
    record = {
        "label": args.label, "scenarios": B_MAIN, "cpu_scenarios": nc, "horizon": mpc.horizon,
        "card_4096_vs_cpu": cmp(U["card_4096"][:nc], U["cpu_256"]),
        "card_256_vs_cpu": cmp(U["card_256"][:nc], U["cpu_256"]),
        "card_4096_vs_card_256": cmp(U["card_4096"], U["card_256"]),
        "cusolver_vs_cpu": cmp(U["card_4096_cusolver"][:nc], U["cpu_256"]),
        "magma_vs_cpu": cmp(U["card_4096_magma"][:nc], U["cpu_256"]),
        "cusolver_vs_magma": cmp(U["card_4096_cusolver"], U["card_4096_magma"]),
        "probe": probe,
        "probe_alone_vs_4096": rel(U["card_alone"], U["card_4096"][probe]).tolist(),
        "probe_alone_vs_256": rel(U["card_alone"], U["card_256"][probe]).tolist(),
        "probe_4096_vs_cpu": (rel(U["card_4096"][probe], U["cpu_256"][probe]).tolist()
                              if in_cpu else None),
        "card_4096_ms": ms, "cpu_s": t_cpu, "wall_s": time.perf_counter() - t0,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip(),
    }
    line = json.dumps(record)
    print(line, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "parity_batch_probe.jsonl"), "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
