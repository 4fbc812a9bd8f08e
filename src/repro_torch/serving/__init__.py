from repro_torch.serving.batcher import ContinuousBatcher, Request  # noqa: F401
