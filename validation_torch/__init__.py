"""The evidence-validation suite of the PyTorch/CUDA port
(``nestfit_tpu_torch``): the counterparts of ``validation/``'s scripts,
run on the port's own agreement records."""
