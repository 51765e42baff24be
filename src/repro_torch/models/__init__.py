"""Port of ``repro.models``: the model zoo's layers, SSM blocks and the
``Model`` composer over the ten architectures of ``repro_torch.configs``."""
