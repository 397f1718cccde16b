"""Operations and bytes that each kernel's work needs, frozen, and the
card's published peaks.

The counts follow from the cell's shapes and the solver's configured
sweeps, not from how one implementation does the work, so a kernel that
does the same job with less work reads a higher share of its roofline and
never more than 100%.  A share is the least time the card could take (the
larger of operations over the FP32 peak and bytes over the memory rate)
over the measured time of a launch.

- ``invert_spd``: an n x n SPD inverse needs n^3 operations (a Cholesky
  factorisation, n^3/3, and the inverse from it, 2n^3/3), whatever the
  method.  The port's kernel runs a symmetrised 2x2 block Schur recursion
  and a Newton-Schulz refinement, ~6.5 n^3 at n = 192; counting those, as
  ``chip_smoke.condensed_flops`` does, would credit a later kernel that
  inverts with less work with more than 100%.  Bytes: K read once and
  K^-1 written once, float32.
- ``iterate``: per configured sweep one n x n matrix-vector product (2n^2)
  and the cone projection and updates, 115 operations per 3-vector block
  (``chip_smoke.condensed_flops``).  Bytes: K^-1 and the vectors q, d, x0,
  es, rho, l, u, z0, y0 read once, x and y written once.
- ``riccati_admm``: the Riccati factorisation's products and 12x12
  Gauss-Jordan per step, and per sweep and step the cone, affine and
  rollout work (``chip_smoke.riccati_flops``); bytes of its operands
  (``chip_smoke.phase_times``).
"""
from __future__ import annotations

#: One H100 SXM (NVIDIA's data sheet, 700 W): FP32 outside the tensor
#: cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

NS, NU = 13, 12          # state and input sizes of the prediction model
CONE_ROWS = 5            # pyramid rows per foot in the condensed kernels
STEP_ROWS = 20           # cone rows per horizon step in the Riccati kernel


def condensed_sizes(horizon: int):
    """(n, m): variables and cone rows of the condensed QP."""
    return NU * horizon, CONE_ROWS * 4 * horizon


def invert_spd(n: int):
    """(operations, bytes) of one scenario's inverse."""
    return float(n) ** 3, 4.0 * 2 * n * n


def iterate(n: int, m: int, sweeps: int):
    """(operations, bytes) of one scenario's sweeps."""
    ops = sweeps * (2.0 * n * n + (38 + 77) * n / 3)
    return ops, 4.0 * (n * n + 3 * n + 6 * m + n + m)


def riccati_admm(horizon: int, sweeps: int):
    """(operations, bytes) of one scenario's Riccati-ADMM solve."""
    h = horizon
    gauss_jordan = sum(2 * NU - 1 - k for k in range(NU)) * (1 + 2 * (NU - 1))
    factor = 2 * (2 * NS ** 3 + NS * NU * NS + NU * NU * NS + 2 * NU * NS * NS
                  + NU * NS * NU + NS * NS * NU) + gauss_jordan
    sweep = (2 * (NU * NS + NU * NU + NS * (NU + NS) + NU * NS + NS * (NS + NU))
             + 4 * 40 + 20 * 10)
    floats = (NS * NS + NS * NU + 2 * h * NU + 1 + NS * h + NS + 3 * STEP_ROWS * h
              + (NU + 2 * STEP_ROWS) * h + (NU + STEP_ROWS) * h)
    return float(h * factor + sweeps * h * sweep), 4.0 * floats


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
