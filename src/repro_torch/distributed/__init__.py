# The distributed layer on torch.distributed: collectives over named
# mesh axes, the sharding rules, the pipeline executor and gradient
# compression (counterparts of repro/distributed).
