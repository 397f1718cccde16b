"""Runnable entry points of the port (``python -m
pympc_quadruped_tpu_torch.examples.<name>``), counterparts of the JAX
package's ``examples/`` scripts."""
