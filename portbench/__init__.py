"""The benchmark of the renderer's PyTorch and CUDA port
(`raytracingweekend_tpu_torch`): `python3 -m portbench.run --help`."""
