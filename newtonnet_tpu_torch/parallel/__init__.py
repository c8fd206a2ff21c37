'''Parallelism of the port (the JAX package's parallel/): the ('data',
'graph') process mesh, multi-process set-up over torch.distributed, the
data-parallel Trainer's collectives and the dense graph-parallel request.
The halo exchange (the JAX package's parallel/halo.py) is not ported yet
(ROADMAP.md A, "parallelism").'''
