"""The benchmark of the PyTorch/CUDA port (``splatloc_tpu_torch``): cells of
a configuration and a traffic mix, run one at a time by ``portbench.run``.
It imports nothing of the JAX package."""
