"""SpMV kernels, their wrappers and the dispatch."""
