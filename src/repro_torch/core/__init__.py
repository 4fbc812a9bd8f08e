# The LC/DC system in PyTorch: topology, traffic, PRNG, the stage
# controller and the batched sweep engine.
