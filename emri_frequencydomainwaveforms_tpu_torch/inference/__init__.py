"""Ensemble MCMC: the tempered stretch-move sampler, priors, state and
chain backends (single branch, fixed dimension)."""
