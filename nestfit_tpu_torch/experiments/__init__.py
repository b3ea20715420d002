"""Experiments built on the port (port of ``nestfit_tpu/experiments``)."""

from nestfit_tpu_torch.experiments.varnoise import run_varnoise_sweep
