"""The benchmark's plain reference: NumPy and PyTorch at any float dtype.

Nothing here imports ``nestfit_tpu_torch`` (or JAX).  Every table,
line catalog and rule is a frozen copy, so that a change to the program
cannot move the yardstick:

- ``lines.json``: the NH3 and N2H+ line catalogs and physical constants;
- ``hyperfine.py``, ``model_ammonia.py``, ``model_diazenylium.py``: the
  forward models and the chi-square likelihood;
- ``priors.py`` with ``priors/<name>.json``: the tabulated prior
  transforms (PPF lookups and the resolved centroid placement);
- ``evidence.py``: the batched-kill quadrature, lnZ, its error and the
  weighted marginal quantiles;
- ``ladder.py``: the cube ladder's retry, boundary and ``nbest`` rules.

The reference computes in float64 by default; the control of
``benchmark/control.py`` runs the same code in bfloat16.
"""
