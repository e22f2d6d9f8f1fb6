"""Fitting engine and the AMASS Stage-2 temporal fitter."""
