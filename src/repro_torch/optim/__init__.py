"""First-order optimizers, LR schedules and zeroth-order SGD over a param
tree (dicts of tensors), mirroring the reference's optim package."""
from repro_torch.optim.optimizers import (adam_init, adam_update,  # noqa
                                          make_optimizer, momentum_init,
                                          sgd_update)
from repro_torch.optim.schedules import (constant, cosine,  # noqa
                                         make_schedule, wsd)
from repro_torch.optim.zo_sgd import zo_sgd_step  # noqa
