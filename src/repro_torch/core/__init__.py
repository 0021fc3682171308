"""Host tree (bulk load, Alg. 4/5/7/8; copied from the JAX package) and
the batched device search as torch ops."""
