"""Multi-rank rendering and inverse rendering on torch.distributed: the
port of raytracingweekend_tpu/parallel/ (mesh.py, distributed.py,
scaling.py) and of `__graft_entry__.dryrun_multichip` (dryrun.py)."""
