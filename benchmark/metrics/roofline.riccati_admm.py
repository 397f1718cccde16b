"""The Riccati-ADMM kernel (``csrc/riccati_admm.cu`` ``riccati_admm_kernel``)
against its factorisation's and configured sweeps' work
(:mod:`benchmark.counts`)."""
from benchmark import counts
from benchmark.metrics._roofline import share


def read(rec, cell, cfg):
    return share(rec, ("riccati_admm_kernel",),
                 counts.riccati_admm(cfg["mpc"]["horizon"], cfg["solver_cfg"]["iterations"]))
