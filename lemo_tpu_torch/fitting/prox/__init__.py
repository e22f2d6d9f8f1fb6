"""The PROX sliding-window fitter (port of `lemo_tpu/fitting/prox`)."""
