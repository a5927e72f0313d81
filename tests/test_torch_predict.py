"""Parity of the port's Predictor and ClassifyBatcher with tpunet's.

Same weights (tests/_torch_port.py) and the same uint8 images, one
upscaled and one downscaled to the model size, give the same class
probabilities to 1e-4 through ``tpunet.infer.predict.Predictor`` and
``tpunet_torch.infer.predict.Predictor`` (float32, CPU). The resize is
checked against ``jax.image.resize(..., "bilinear")`` on its own to
1e-5, including the antialiased downscale of the main path's 500x375
photos to 224.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.config import DataConfig as JaxDataConfig
from tpunet.config import ModelConfig as JaxModelConfig
from tpunet.config import ServeConfig as JaxServeConfig
from tpunet.infer.predict import Predictor as JaxPredictor
from tpunet_torch.config import DataConfig, ModelConfig, ServeConfig
from tpunet_torch.infer import app
from tpunet_torch.infer.predict import Predictor, preprocess, resize_bilinear
from tpunet_torch.models.convert import state_dict_from_jax
from tpunet_torch.obs.registry import Registry
from tpunet_torch.serve import ClassifyBatcher

from _torch_port import SIZE, WIDTH, jax_variables
import _torch_threads  # noqa: E402,F401

# (h, w) of uint8 test images: upscaled, downscaled, mixed, one axis
# already at the model size.
IMAGE_SIZES = [(20, 24), (48, 64), (20, 64), (32, 50)]


@pytest.fixture(scope="module")
def variables():
    return jax_variables(seed=1)


@pytest.fixture(scope="module")
def predictor(variables):
    params, stats = variables
    return Predictor(ModelConfig(dtype="float32", width_mult=WIDTH),
                     DataConfig(image_size=SIZE),
                     state_dict=state_dict_from_jax(params, stats),
                     device="cpu")


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("src,dst", [
    ((20, 24), 32), ((48, 64), 32), ((32, 50), 32), ((7, 90), 32),
    ((375, 500), 224), ((224, 224), 224), ((32, 32), 224)], ids=str)
def test_resize_matches_jax_bilinear(src, dst):
    x = np.random.default_rng(3).random((*src, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (dst, dst, 3),
                                       method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_preprocess_takes_the_device_explicitly():
    """No default device: the caller says where the work runs. On the CPU
    it is the resize of the JAX Predictor, then the normalization."""
    img = _image(48, 64, seed=4)
    data = DataConfig(image_size=SIZE)
    with pytest.raises(TypeError):
        preprocess(img, data)
    got = preprocess(img, data, "cpu")
    assert got.device.type == "cpu" and got.shape == (SIZE, SIZE, 3)
    want = (np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32) / 255.0,
                                        (SIZE, SIZE, 3), method="bilinear"))
            - np.asarray(data.mean, np.float32)) / np.asarray(data.std,
                                                             np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", IMAGE_SIZES, ids=str)
def test_probs_match_tpunet_predictor(variables, predictor, hw):
    params, stats = variables
    jpred = JaxPredictor(
        model_cfg=JaxModelConfig(dtype="float32", width_mult=WIDTH),
        data_cfg=JaxDataConfig(image_size=SIZE),
        variables={"params": params, "batch_stats": stats})
    img = _image(*hw, seed=hw[0])
    want = jpred.predict_probs(img)
    got = predictor.predict_probs(img)
    assert got.shape == (10,) and got.dtype == np.float32
    # Not uniform: the weights separate the classes.
    assert want.max() - want.min() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_topk_order_and_threshold(predictor):
    img = _image(32, 32, seed=7)
    probs = predictor.predict_probs(img)
    res = predictor.predict(img, topk=3, conf_threshold=1.0)
    assert len(res.topk) == 3
    assert [n for n, _ in res.topk] == [predictor.class_names[i]
                                        for i in np.argsort(probs)[::-1][:3]]
    assert res.topk[0][1] >= res.topk[1][1] >= res.topk[2][1]
    assert res.uncertain and res.predicted == "uncertain"
    res0 = predictor.predict(img, topk=5, conf_threshold=0.0)
    assert len(res0.topk) == 5
    assert not res0.uncertain and res0.predicted == res0.topk[0][0]
    assert res0.confidence == pytest.approx(float(probs.max()))


def test_pil_and_float_inputs(predictor):
    from PIL import Image
    arr = _image(32, 40, seed=9)
    p1 = predictor.predict_probs(Image.fromarray(arr))
    p2 = predictor.predict_probs(arr)
    p3 = predictor.predict_probs(arr.astype(np.float32) / 255.0)
    np.testing.assert_allclose(p1, p2, atol=1e-6)
    np.testing.assert_allclose(p1, p3, atol=0.02)  # uint8 quantization


def test_checkpoint_file_loads(variables, tmp_path):
    params, stats = variables
    path = tmp_path / "best.pth"
    torch.save(state_dict_from_jax(params, stats), path)
    a = Predictor(ModelConfig(dtype="float32", width_mult=WIDTH),
                  DataConfig(image_size=SIZE), checkpoint=str(path),
                  device="cpu")
    b = Predictor(ModelConfig(dtype="float32", width_mult=WIDTH),
                  DataConfig(image_size=SIZE),
                  state_dict=state_dict_from_jax(params, stats), device="cpu")
    img = _image(24, 24)
    np.testing.assert_array_equal(a.predict_probs(img), b.predict_probs(img))


def test_batcher_concurrent_submits_equal_single_predictions(predictor):
    reg = Registry()
    batcher = ClassifyBatcher(predictor, batch_max=4, window_ms=20.0,
                              registry=reg)
    images = [_image(*IMAGE_SIZES[i % len(IMAGE_SIZES)], seed=20 + i)
              for i in range(10)]
    out = [None] * len(images)

    def client(i):
        out[i] = batcher.submit(images[i], timeout=60.0)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(images))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert not batcher.healthy
    # Batch 4 and batch 1 take different CPU conv paths: same
    # arithmetic, other summation order, so the 1e-4 parity tolerance.
    for img, probs in zip(images, out):
        np.testing.assert_allclose(probs, predictor.predict_probs(img),
                                   rtol=1e-4, atol=1e-5)
    snap = reg.snapshot()
    assert snap["serve_classify_requests_total"] == len(images)
    batches = snap["serve_classify_batches_total"]
    assert 3 <= batches <= len(images)  # at most 4 per batch
    assert snap["serve_classify_batch_size_count"] == batches
    assert snap["serve_classify_s_count"] == batches


def test_batcher_fails_the_batch_not_the_worker(predictor, monkeypatch):
    batcher = ClassifyBatcher(predictor, batch_max=2, window_ms=1.0)
    try:
        def broken(batch):
            raise RuntimeError("device lost")
        monkeypatch.setattr(predictor, "forward", broken)
        with pytest.raises(RuntimeError, match="device lost"):
            batcher.submit(_image(32, 32), timeout=30.0)
        monkeypatch.undo()
        assert batcher.healthy
        probs = batcher.submit(_image(32, 32), timeout=30.0)
        assert np.isclose(probs.sum(), 1.0, atol=1e-5)
    finally:
        batcher.close()
    with pytest.raises(ValueError):
        ClassifyBatcher(predictor, batch_max=0)


def test_web_app_classify(predictor):
    classify = app.make_classify(predictor)
    assert classify(None) == {}
    img = _image(40, 30, seed=4)
    out = classify(img)
    assert list(out) == list(predictor.class_names)
    assert sum(out.values()) == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(list(out.values()),
                               predictor.predict_probs(img), atol=1e-7)


def test_config_defaults_match_tpunet():
    jd, pd = dataclasses.asdict(JaxDataConfig()), dataclasses.asdict(DataConfig())
    assert pd == {k: jd[k] for k in pd}
    js, ps = dataclasses.asdict(JaxServeConfig()), dataclasses.asdict(ServeConfig())
    assert ps == {k: js[k] for k in ps}
