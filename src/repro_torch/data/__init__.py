"""Training data of the port (the JAX package's ``repro.data``)."""

from repro_torch.data.synthetic import SyntheticDataset, batch_for_step
