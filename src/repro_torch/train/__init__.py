"""Training and serving steps over the model stack: the loss, microbatched
gradient accumulation and the optimizers (``step.py``, ``optim.py``), and
the prefill and decode steps (``serve.py``)."""

from repro_torch.train.optim import OptConfig, adamw_init, adamw_update, lr_at  # noqa: F401
from repro_torch.train.step import TrainState, make_train_step, train_state_specs  # noqa: F401
from repro_torch.train import serve  # noqa: F401
