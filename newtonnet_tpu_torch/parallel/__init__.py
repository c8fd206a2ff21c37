'''Parallelism of the port (the JAX package's parallel/): the ('data',
'graph') process mesh, multi-process set-up over torch.distributed, the
data-parallel Trainer's collectives, the dense graph-parallel request
(graph_parallel.py) and halo-exchange graph parallelism (halo.py: serving,
training and, through md/halo_md.py, MD of one large system split in
slabs over the graph ranks).'''
