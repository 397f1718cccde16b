"""The ADMM-iterate kernel (``csrc/admm_iterate.cu``, its register or wide
variant) against the configured sweeps' work (:mod:`benchmark.counts`)."""
from benchmark import counts
from benchmark.metrics._roofline import share


def read(rec, cell, cfg):
    n, m = counts.condensed_sizes(cfg["mpc"]["horizon"])
    return share(rec, ("admm_iterate_kernel", "admm_iterate_wide_kernel"),
                 counts.iterate(n, m, cfg["solver_cfg"]["iterations"]))
