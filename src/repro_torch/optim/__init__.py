from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, make_optimizer, sgd, momentum, adamw, warmup_cosine,
)
