"""Training loops for the learned motion priors and VPoser."""
