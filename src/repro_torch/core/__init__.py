"""Algorithm 1, MADS control, sparsification, policies and the loop runner."""
