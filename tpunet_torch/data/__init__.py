"""Data: CIFAR-10 (or its seeded synthetic stand-in), the token datasets
of the LM (``lm``), the seeded batch order, and the on-device
augmentation (``augment``)."""

from tpunet_torch.data.cifar10 import (get_dataset, load_cifar10,  # noqa: F401
                                       synthetic_cifar10)
from tpunet_torch.data.lm import (get_lm_dataset, synthetic_lm,  # noqa: F401
                                  text_lm, text_lm_packed)
from tpunet_torch.data.pipeline import (eval_batches,  # noqa: F401
                                        host_index_sequence, steps_per_epoch,
                                        timed_batches, train_batches)
