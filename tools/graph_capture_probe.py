"""Which batched solves capture in a CUDA graph on this card.

    python tools/graph_capture_probe.py

For each candidate way to solve B=4096 SPD 28x28 systems with 18
right-hand sides (the Kalman filter's innovation solve in
``pympc_quadruped_tpu_torch/estimation/kf.py``), and for
``repeat_interleave``, a fresh process warms the op up on a side stream,
captures it in a ``torch.cuda.CUDAGraph``, replays it and compares the
replay with the eager result.  One line per candidate: "captures" (and
whether the replay equals eager) or "capture FAILS" with the error.  Each
candidate runs alone because a failed capture (or an abort inside a
library) can leave the process unusable.  Needs a CUDA card; imports torch
only.
"""
from __future__ import annotations

import subprocess
import sys

CANDIDATES = ("linalg.solve_ex", "cholesky_ex+cholesky_solve",
              "cholesky_ex+solve_triangular", "cholesky_ex+solve_triangular float64",
              "repeat_interleave(3)")


def probe(name: str) -> None:
    import torch

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    M = torch.randn(4096, 28, 28, device=dev, generator=gen)
    S = M @ M.transpose(-1, -2) + 30 * torch.eye(28, device=dev)
    R = torch.randn(4096, 28, 18, device=dev, generator=gen)
    v = torch.rand(4096, 4, device=dev, generator=gen)

    def chol_tri(A, rhs):
        L = torch.linalg.cholesky_ex(A)[0]
        y = torch.linalg.solve_triangular(L, rhs, upper=False)
        return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)

    fn = {
        "linalg.solve_ex": lambda: torch.linalg.solve_ex(S, R)[0],
        "cholesky_ex+cholesky_solve":
            lambda: torch.cholesky_solve(R, torch.linalg.cholesky_ex(S)[0]),
        "cholesky_ex+solve_triangular": lambda: chol_tri(S, R),
        "cholesky_ex+solve_triangular float64": lambda: chol_tri(S.double(), R.double()),
        "repeat_interleave(3)": lambda: v.repeat_interleave(3, dim=-1),
    }[name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ref = fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"{name}: capture FAILS: {type(e).__name__}: {str(e).splitlines()[0]}", flush=True)
        return
    print(f"{name}: captures; replay equals eager: {torch.equal(out, ref)}", flush=True)


def main() -> int:
    if len(sys.argv) > 1:
        probe(sys.argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("graph_capture_probe: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for name in CANDIDATES:
        proc = subprocess.run([sys.executable, __file__, name], capture_output=True, text=True)
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        print(lines[-1] if proc.returncode == 0 and lines else
              f"{name}: capture FAILS: process exited {proc.returncode}: "
              f"{lines[-1] if lines else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
