"""The port's parallel layer (the JAX package's ``parallel/``): logical
axis rules over a ``torch.distributed`` DeviceMesh, the int8
error-feedback gradient all-reduce and the GPipe pipeline."""

from repro_torch.parallel.sharding import (Sharding, constrain,
                                           enforce_divisibility,
                                           logical_context, rules_for,
                                           spec_for, tree_shardings,
                                           tree_specs)
