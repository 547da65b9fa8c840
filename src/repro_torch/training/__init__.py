"""Training substrate of the port: optimizers, the train step and loop,
gradient compression, checkpoints and the straggler monitor.
``__all__`` is the reference's."""
from repro_torch.training.optimizer import (AdamW, SGD, AdamWState,
                                            warmup_cosine)
from repro_torch.training.train_loop import (TrainLoopConfig, make_train_step,
                                             run_loop)
from repro_torch.training import checkpoint
from repro_torch.training.compression import compress, init_ef, wire_bytes
from repro_torch.training.elastic import Action, StragglerMonitor

__all__ = ["AdamW", "SGD", "AdamWState", "warmup_cosine", "TrainLoopConfig",
           "make_train_step", "run_loop", "checkpoint", "compress",
           "init_ef", "wire_bytes", "Action", "StragglerMonitor"]
