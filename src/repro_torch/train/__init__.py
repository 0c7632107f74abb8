"""Training of the port on one device (the JAX package's
``repro.train``)."""

from repro_torch.train.step import (cross_entropy, make_train_step,
                                    make_prefill_step, make_decode_step,
                                    TrainState, init_train_state)
from repro_torch.train.loop import TrainLoop, LoopConfig
