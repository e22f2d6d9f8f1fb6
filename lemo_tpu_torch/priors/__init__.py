"""Learned motion priors over torch-layout parameter dicts."""
