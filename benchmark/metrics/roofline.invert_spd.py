"""The SPD-inverse kernel (``csrc/admm.cu`` ``admm_invert_kernel``) against
n^3 operations and 2 n^2 floats a scenario (:mod:`benchmark.counts`)."""
from benchmark import counts
from benchmark.metrics._roofline import share


def read(rec, cell, cfg):
    n, _ = counts.condensed_sizes(cfg["mpc"]["horizon"])
    return share(rec, ("admm_invert_kernel",), counts.invert_spd(n))
