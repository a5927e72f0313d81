"""The port's data modules against tpunet's: the seeded synthetic CIFAR-10
stand-in and every batch order are bit-equal for several (seed, epoch),
so a port run sees exactly the images of the JAX run."""

import numpy as np
import pytest

from tpunet.data import cifar10 as jcifar
from tpunet.data import pipeline as jpipe
from tpunet_torch.config import DataConfig
from tpunet_torch.data import cifar10 as pcifar
from tpunet_torch.data import pipeline as ppipe
from tpunet.config import DataConfig as JaxDataConfig
import _torch_threads  # noqa: E402,F401

SEEDS_EPOCHS = [(42, 1), (42, 2), (0, 1), (7, 13)]


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_cifar10_bit_equal(seed):
    want = jcifar.synthetic_cifar10(n_train=96, n_test=40, seed=seed)
    got = pcifar.synthetic_cifar10(n_train=96, n_test=40, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_get_dataset_synthetic_matches():
    got = pcifar.get_dataset(DataConfig(dataset="synthetic",
                                        synthetic_train_size=64,
                                        synthetic_test_size=16))
    want = jcifar.get_dataset(JaxDataConfig(dataset="synthetic",
                                            synthetic_train_size=64,
                                            synthetic_test_size=16))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed,epoch", SEEDS_EPOCHS)
def test_host_index_sequence_bit_equal(seed, epoch):
    for procs, index in ((1, 0), (2, 1), (4, 2)):
        kw = dict(global_batch=32, seed=seed, epoch=epoch,
                  process_index=index, process_count=procs)
        assert np.array_equal(ppipe.host_index_sequence(1000, **kw),
                              jpipe.host_index_sequence(1000, **kw))
    assert ppipe.steps_per_epoch(1000, 32) == jpipe.steps_per_epoch(1000, 32)


@pytest.mark.parametrize("seed,epoch", SEEDS_EPOCHS)
def test_train_batches_bit_equal(seed, epoch):
    x, y = jcifar.synthetic_cifar10(n_train=200, n_test=1, seed=1)[:2]
    got = list(ppipe.train_batches(x, y, global_batch=48, seed=seed,
                                   epoch=epoch))
    want = list(jpipe.train_batches(x, y, global_batch=48, seed=seed,
                                    epoch=epoch))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


@pytest.mark.parametrize("n,batch", [(100, 32), (96, 32), (5, 8)])
def test_eval_batches_bit_equal(n, batch):
    x, y = jcifar.synthetic_cifar10(n_train=1, n_test=n, seed=2)[2:]
    got = list(ppipe.eval_batches(x, y, global_batch=batch))
    want = list(jpipe.eval_batches(x, y, global_batch=batch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sum(m.sum() for _, _, m in got) == n
