"""galaxysql_tpu_torch: the PyTorch/CUDA port of galaxysql_tpu.

Same layout as the JAX package (`chunk/`, `expr/`, `kernels/`, `exec/`, `plan/`,
`sql/`, `storage/`, `meta/`, `server/`, `types/`, `utils/`), over torch tensors on an
explicit device carried by `server.instance.Instance`.  The Pallas kernels of the
reference run here as hand-written CUDA kernels for Hopper (`kernels/csrc/`), built
with nvcc at first use.  The package imports neither jax nor galaxysql_tpu.
"""
