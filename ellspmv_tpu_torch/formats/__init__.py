"""Sparse matrix containers: COO and ELLPACK."""
