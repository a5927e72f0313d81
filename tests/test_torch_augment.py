"""The port's on-device augmentation against tpunet's.

The transform is compared at fixed parameters: each image's parameters
are drawn here from JAX's own key tree — the split order of
``_augment_one`` (flip, rotation, crop, jitter keys), ``_color_jitter``
(brightness, contrast, saturation, hue) and ``_rrc_params`` (scale,
ratio, top, left) — and fed to ``augment_with_params``; the result must
equal ``make_train_augment(cfg)(key, images)`` to 1e-5. The port's own
sampler is checked for its ranges. Also: the eval preprocess against
``make_eval_preprocess``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunet.config import DataConfig as JaxDataConfig
from tpunet.data import augment as jaug
from tpunet_torch.config import DataConfig
from tpunet_torch.data import augment as paug
import _torch_threads  # noqa: E402,F401


def _jax_params(key, n, cfg):
    """Each image's parameters, drawn exactly as tpunet's augmentation
    draws them from ``key``."""
    rows = []
    for k in jax.random.split(key, n):
        kf, kr, kc, kj = jax.random.split(k, 4)
        kb, kcn, ks, kh = jax.random.split(kj, 4)
        ka, krr, ky, kx = jax.random.split(kc, 4)
        area = float(paug.SRC * paug.SRC)
        target = jax.random.uniform(ka, (), minval=cfg.rrc_scale[0],
                                    maxval=cfg.rrc_scale[1]) * area
        ratio = jnp.exp(jax.random.uniform(
            krr, (), minval=math.log(cfg.rrc_ratio[0]),
            maxval=math.log(cfg.rrc_ratio[1])))
        w = jnp.clip(jnp.sqrt(target * ratio), 1.0, paug.SRC)
        h = jnp.clip(jnp.sqrt(target / ratio), 1.0, paug.SRC)
        rows.append({
            "flip": jax.random.bernoulli(kf),
            "angle": jax.random.uniform(
                kr, (), minval=-cfg.rotation_degrees,
                maxval=cfg.rotation_degrees) * (math.pi / 180.0),
            "brightness": jax.random.uniform(
                kb, (), minval=1 - cfg.jitter_brightness,
                maxval=1 + cfg.jitter_brightness),
            "contrast": jax.random.uniform(
                kcn, (), minval=1 - cfg.jitter_contrast,
                maxval=1 + cfg.jitter_contrast),
            "saturation": jax.random.uniform(
                ks, (), minval=1 - cfg.jitter_saturation,
                maxval=1 + cfg.jitter_saturation),
            "hue": jax.random.uniform(kh, (), minval=-cfg.jitter_hue,
                                      maxval=cfg.jitter_hue),
            "top": jax.random.uniform(ky, (), minval=0.0,
                                      maxval=paug.SRC - h),
            "left": jax.random.uniform(kx, (), minval=0.0,
                                       maxval=paug.SRC - w),
            "height": h, "width": w})
    return {name: torch.from_numpy(np.stack([np.asarray(r[name])
                                             for r in rows]))
            for name in paug.PARAM_NAMES}


def _images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                np.uint8)


@pytest.mark.parametrize("overrides", [
    {},                                      # the reference stack, shears
    {"rotation_degrees": 40.0},              # > 30 degrees: 4-tap gather
    {"rotation_degrees": 0.0, "jitter_hue": 0.0, "jitter_contrast": 0.0},
], ids=["default", "rot40", "no_rot_hue_contrast"])
def test_train_augment_matches_tpunet_at_jax_drawn_params(overrides):
    kw = dict(image_size=48, **overrides)
    jcfg, pcfg = JaxDataConfig(**kw), DataConfig(**kw)
    images = _images(4, 0)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaug.make_train_augment(jcfg)(key, jnp.asarray(images)))
    params = _jax_params(key, 4, jcfg)
    got = paug.augment_with_params(torch.from_numpy(images), params, pcfg)
    assert got.shape == want.shape == (4, 48, 48, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_augment_at_model_size():
    """224 px, the reference's size: the same comparison on two images."""
    jcfg, pcfg = JaxDataConfig(), DataConfig()
    images = _images(2, 1)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaug.make_train_augment(jcfg)(key, jnp.asarray(images)))
    got = paug.augment_with_params(torch.from_numpy(images),
                                   _jax_params(key, 2, jcfg), pcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [32, 48, 224])
def test_eval_preprocess_matches_tpunet(size):
    images = _images(3, 2)
    want = np.asarray(jaug.make_eval_preprocess(JaxDataConfig(
        image_size=size))(jnp.asarray(images)))
    got = paug.make_eval_preprocess(DataConfig(image_size=size))(
        torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(paug.resize_matrix_np(size, 32),
                                  jaug.resize_matrix_np(size, 32))


def test_sampled_params_follow_tpunet_ranges():
    cfg = DataConfig()
    p = paug.sample_augment_params(torch.Generator().manual_seed(0), 4000, cfg)
    assert set(p) == set(paug.PARAM_NAMES)
    rad = cfg.rotation_degrees * math.pi / 180
    assert float(p["angle"].abs().max()) <= rad + 1e-6
    assert abs(float(p["flip"].float().mean()) - 0.5) < 0.03
    for name, strength in (("brightness", cfg.jitter_brightness),
                           ("contrast", cfg.jitter_contrast),
                           ("saturation", cfg.jitter_saturation)):
        assert float((p[name] - 1).abs().max()) <= strength + 1e-6
    assert float(p["hue"].abs().max()) <= cfg.jitter_hue + 1e-6
    hw = p["height"] * p["width"]
    assert float(hw.min()) >= cfg.rrc_scale[0] * 1024 * 0.999 - 1e-3 or \
        float(p["height"].max()) == 32.0 or float(p["width"].max()) == 32.0
    for side, off in (("height", "top"), ("width", "left")):
        assert float(p[side].min()) >= 1.0 and float(p[side].max()) <= 32.0
        assert float(p[off].min()) >= 0.0
        assert bool((p[off] <= 32.0 - p[side] + 1e-5).all())
    # The same generator state gives the same draws.
    q = paug.sample_augment_params(torch.Generator().manual_seed(0), 4000, cfg)
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_train_augment_runs_from_a_generator():
    cfg = dataclasses.replace(DataConfig(), image_size=40)
    out = paug.make_train_augment(cfg)(torch.Generator().manual_seed(1),
                                       torch.from_numpy(_images(3, 4)))
    assert out.shape == (3, 40, 40, 3) and bool(torch.isfinite(out).all())
