"""Card-only tests of the port: each hand-written kernel against its plain
version, and the model and Predictor on the card.

Marked ``cuda``; each skips without a CUDA device. This file imports no
JAX and nothing of tpunet, so that it runs on a machine with PyTorch and
no JAX (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import tpunet_torch.models.mobilenetv2 as mnv2
from tpunet_torch.config import DataConfig, ModelConfig
from tpunet_torch.infer.predict import Predictor
from tpunet_torch.models import create_model
from tpunet_torch.ops import depthwise_conv3x3, depthwise_conv3x3_reference

pytestmark = pytest.mark.cuda

# (n, h, w, c, stride), as tests/test_torch_depthwise.py, plus a
# MobileNetV2 shape.
SHAPES = [
    (2, 8, 8, 8, 1), (2, 8, 8, 8, 2), (1, 9, 7, 24, 2), (2, 7, 9, 24, 1),
    (1, 11, 11, 40, 2), (2, 6, 6, 40, 1), (1, 5, 5, 12, 2),
    (2, 56, 56, 144, 2),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(shape, seed, dtype):
    n, h, w, c, _ = shape
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n, h, w, c, generator=g).to("cuda", dtype),
            torch.randn(3, 3, c, generator=g).to("cuda", dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_depthwise_kernel_equals_plain(cuda, shape, dtype):
    """The kernel repeats the plain version's arithmetic (same tap order,
    no fused multiply-add), so the two agree to the bit."""
    x, w = _inputs(shape, 0, dtype)
    before = depthwise_conv3x3.launches
    got = depthwise_conv3x3(x, w, shape[-1])
    assert depthwise_conv3x3.launches == before + 1
    want = depthwise_conv3x3_reference(x, w, shape[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_depthwise_unaligned_input_takes_scalar_path(cuda):
    """C % 8 == 0 but x not 16-byte aligned: the scalar path, same result."""
    x, w = _inputs((2, 9, 9, 16, 2), 1, torch.bfloat16)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    torch.testing.assert_close(depthwise_conv3x3(xu, w, 2),
                               depthwise_conv3x3_reference(x, w, 2),
                               rtol=0, atol=0)


def test_model_kernel_path_equals_plain_path(cuda, monkeypatch):
    """Width 0.5 bf16 MobileNetV2: 17 launches per forward, and the same
    logits as with the plain depthwise version on the card."""
    model = create_model(ModelConfig(width_mult=0.5,
                                     use_pallas_depthwise=True))
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    x = x.to("cuda").contiguous(memory_format=torch.channels_last)
    before = depthwise_conv3x3.launches
    with torch.inference_mode():
        got = model(x)
    assert depthwise_conv3x3.launches == before + 17
    monkeypatch.setattr(mnv2, "depthwise_conv3x3", depthwise_conv3x3_reference)
    with torch.inference_mode():
        want = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_predictor_on_card_agrees_with_cpu(cuda):
    """Float32 on both sides: the card's Predictor and the CPU's give the
    same probabilities up to summation order (cuDNN vs the CPU's convs)."""
    cfg = ModelConfig(dtype="float32", width_mult=0.5,
                      use_pallas_depthwise=True)
    data = DataConfig(image_size=64)
    gpu = Predictor(cfg, data, device="cuda")
    cpu = Predictor(cfg, data, device="cpu")
    img = np.random.default_rng(3).integers(0, 256, (48, 80, 3), np.uint8)
    np.testing.assert_allclose(gpu.predict_probs(img), cpu.predict_probs(img),
                               rtol=1e-4, atol=1e-5)
