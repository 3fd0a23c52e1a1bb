"""Plain PyTorch references, fp32 with TF32 off.  They import nothing of
the port, of ``jax`` or of the JAX package, and read the packaged weights
as data files."""
