"""On-device data augmentation, port of ``tpunet/data/augment.py``.

The reference's torchvision stack (Resize(224) -> RandomResizedCrop(224,
scale=(0.7, 1.0)) -> RandomHorizontalFlip -> ColorJitter(0.3, 0.3, 0.3,
0.1) -> RandomRotation(15) -> Normalize) as tpunet runs it on the
device, in the same order (``_augment_one``): flip; rotation at the
32 px source (three shears up to 30 degrees, a 4-tap bilinear gather
above); color jitter at the source; the random-resized-crop box as two
separable bilinear matrices to the output size; torchvision's black
rotation corners as a closed-form coverage mask at the output size;
normalize. Every step is batched over the images (``einsum``/``bmm`` and
elementwise ops), with no loop over images.

Randomness is split from the transform: :func:`sample_augment_params`
draws each image's parameters from a ``torch.Generator``, and
:func:`augment_with_params` applies them. The JAX package draws from its
key tree instead, so the two give other numbers from one seed; a test
feeds the port the parameters that JAX's keys draw. Under data
parallelism the train augment draws the parameters of the global batch
and each rank takes its rows, so N ranks see the images one rank would.

Mixup/CutMix (tpunet's ``mixup_cutmix``, after the augment) is split the
same way: :func:`sample_mix_params` draws one step's permutation, the
choice between the two and the Beta draw (all from one draw of the step
generator), and :func:`mix_with_params` applies them. The permutation
runs over the global batch: every rank draws the same one, fetches the
partner rows it needs from the other ranks with one collective
(:func:`make_mix`), and so computes its rows of what one process would.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpunet_torch.config import DataConfig
from tpunet_torch.parallel.dist import fetch_rows
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size

SRC = 32  # CIFAR-10 native resolution

_GRAY = (0.299, 0.587, 0.114)
PARAM_NAMES = ("flip", "angle", "brightness", "contrast", "saturation",
               "hue", "top", "left", "height", "width")


# ---------------------------------------------------------------------------
# Bilinear resampling as separable matrices
# ---------------------------------------------------------------------------


def _hat_weights(s: torch.Tensor, src_size: int) -> torch.Tensor:
    """[..., out] continuous source coords -> [..., out, src] bilinear hat
    weights, coords clamped to the frame (both taps then exist and their
    weights sum to 1)."""
    s = torch.clamp(s, 0.0, src_size - 1.0)
    j = torch.arange(src_size, dtype=torch.float32, device=s.device)
    return torch.clamp_min(1.0 - (s[..., None] - j).abs(), 0.0)


def _bilinear_matrix(start: torch.Tensor, size: torch.Tensor, out_size: int,
                     src_size: int) -> torch.Tensor:
    """[B, out_size, src_size] sampling matrices of a 1-D crop + resize:
    output index i samples ``start + (i + 0.5) * size / out_size - 0.5``."""
    i = torch.arange(out_size, dtype=torch.float32, device=start.device)
    return _hat_weights(start[:, None] + (i + 0.5) * size[:, None] / out_size
                        - 0.5, src_size)


def resize_matrix_np(out_size: int, src_size: int) -> np.ndarray:
    """Static full-image resize matrix (eval path), as a numpy constant."""
    i = np.arange(out_size, dtype=np.float32)
    s = np.clip((i + 0.5) * src_size / out_size - 0.5, 0.0, src_size - 1.0)
    j = np.arange(src_size, dtype=np.float32)
    w = np.maximum(0.0, 1.0 - np.abs(s[:, None] - j[None, :]))
    return w / w.sum(axis=1, keepdims=True)


def _apply_separable(img: torch.Tensor, row_m: torch.Tensor,
                     col_m: torch.Tensor) -> torch.Tensor:
    """img [B,H,W,C], row_m [B,Ho,H], col_m [B,Wo,W] -> [B,Ho,Wo,C]."""
    img = torch.einsum("boh,bhwc->bowc", row_m, img)
    return torch.einsum("bpw,bowc->bopc", col_m, img)


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------


def _f32(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn(a)`` evaluated in float64 and rounded to float32: the correctly
    rounded value, which XLA's float32 cos/sin/tan give and torch's
    vectorised float32 versions miss by an ulp now and then."""
    return fn(a.double()).float()


def _inverse_rot_coords(h: int, w: int, angle: torch.Tensor):
    """[B,h,w] source coordinates (sy, sx) of each output pixel under the
    inverse rotation about the image center."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=angle.device),
        torch.arange(w, dtype=torch.float32, device=angle.device),
        indexing="ij")
    cos = _f32(torch.cos, angle)[:, None, None]
    sin = _f32(torch.sin, angle)[:, None, None]
    sy = cos * (yy - cy) + sin * (xx - cx) + cy
    sx = -sin * (yy - cy) + cos * (xx - cx) + cx
    return sy, sx


def _rotate_bilinear(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate [B,H,W,C] images by ``angle`` [B] radians, 4-tap bilinear
    gather with edge fill (the train path above 30 degrees)."""
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    sy, sx = _inverse_rot_coords(h, w, angle)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    bi = torch.arange(b, device=img.device)[:, None, None]

    def gather(yi, xi):
        yc = torch.clamp(yi, 0, h - 1).long()
        xc = torch.clamp(xi, 0, w - 1).long()
        return img[bi, yc, xc]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _shear_mats(shifts: torch.Tensor, size: int) -> torch.Tensor:
    """[B,L] per-line shifts -> [B,L,size,size] banks of 1-D bilinear
    shift-with-edge-clamp matrices."""
    i = torch.arange(size, dtype=torch.float32, device=shifts.device)
    return _hat_weights(i + shifts[..., None], size)


def _rotate_shear(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate [B,H,W,C] by ``angle`` [B] radians as three shears (Paeth):
    shear_x(t) . shear_y(s) . shear_x(t), t = -tan(a/2), s = sin(a), edge
    fill; each shear a bank of per-line resample matrices."""
    h, w = img.shape[1], img.shape[2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    t = -_f32(torch.tan, angle / 2.0)[:, None]
    s = _f32(torch.sin, angle)[:, None]
    ar_h = torch.arange(h, dtype=torch.float32, device=img.device)
    ar_w = torch.arange(w, dtype=torch.float32, device=img.device)
    mx = _shear_mats(t * (ar_h - cy), w)
    my = _shear_mats(s * (ar_w - cx), h)
    img = torch.einsum("bhij,bhjc->bhic", mx, img)   # x-shear
    img = torch.einsum("bwij,bjwc->biwc", my, img)   # y-shear
    return torch.einsum("bhij,bhjc->bhic", mx, img)  # x-shear (same bank)


def _rotation_border_mask(size: int, angle: torch.Tensor) -> torch.Tensor:
    """[B,size,size] bilinear coverage of a ``size``-square frame rotated
    by ``angle``: torchvision's rotate-last black corners, closed form."""
    sy, sx = _inverse_rot_coords(size, size, angle)

    def cov(s):
        i0 = torch.floor(s)
        f = s - i0
        v0 = ((i0 >= 0) & (i0 <= size - 1)).float()
        v1 = ((i0 + 1 >= 0) & (i0 + 1 <= size - 1)).float()
        return (1.0 - f) * v0 + f * v1

    return cov(sy) * cov(sx)


# ---------------------------------------------------------------------------
# Color jitter (torchvision-strength ops, fixed order)
# ---------------------------------------------------------------------------


def _gray(x: torch.Tensor) -> torch.Tensor:
    return x @ torch.tensor(_GRAY, dtype=torch.float32, device=x.device)


def _rgb_to_hsv(x: torch.Tensor):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.amax(x, dim=-1)
    minc = torch.amin(x, dim=-1)
    v = maxc
    d = maxc - minc
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe_d = torch.where(d == 0, one, d)
    s = torch.where(maxc == 0, torch.zeros_like(maxc),
                    d / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, torch.zeros_like(h),
                    torch.remainder(h / 6.0, 1.0))
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.long(), 6)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    idx = i[..., None]
    rs = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, idx)
    gs = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, idx)
    bs = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, idx)
    return torch.cat([rs, gs, bs], dim=-1)


def _color_jitter(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  cfg: DataConfig) -> torch.Tensor:
    """x [B,H,W,3] in [0, 1]; brightness, contrast, saturation, hue."""
    def per_image(v):
        return v[:, None, None, None]

    if cfg.jitter_brightness > 0:
        x = torch.clamp(x * per_image(p["brightness"]), 0.0, 1.0)
    if cfg.jitter_contrast > 0:
        c = per_image(p["contrast"])
        mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
        x = torch.clamp(c * x + (1 - c) * mean, 0.0, 1.0)
    if cfg.jitter_saturation > 0:
        s = per_image(p["saturation"])
        gray = _gray(x)[..., None]
        x = torch.clamp(s * x + (1 - s) * gray, 0.0, 1.0)
    if cfg.jitter_hue > 0:
        h, s_, v = _rgb_to_hsv(x)
        x = _hsv_to_rgb(torch.remainder(h + p["hue"][:, None, None], 1.0),
                        s_, v)
    return x


# ---------------------------------------------------------------------------
# Parameters and the transform
# ---------------------------------------------------------------------------


def sample_augment_params(generator: torch.Generator, n: int,
                          cfg: DataConfig) -> Dict[str, torch.Tensor]:
    """Draw the augmentation parameters of ``n`` images from
    ``generator``, with tpunet's distributions: a fair flip, a uniform
    rotation angle in +-rotation_degrees (radians), uniform jitter
    factors, and the random-resized-crop box (uniform scale and
    log-ratio, clamped to the frame, uniform offset). Float32 tensors of
    shape [n] on the generator's device (``flip`` is bool)."""
    u = torch.rand((n, 8), generator=generator, device=generator.device)

    def uniform(col, lo, hi):
        return lo + (hi - lo) * u[:, col]

    area = float(SRC * SRC)
    target = uniform(4, cfg.rrc_scale[0], cfg.rrc_scale[1]) * area
    ratio = torch.exp(uniform(5, math.log(cfg.rrc_ratio[0]),
                              math.log(cfg.rrc_ratio[1])))
    w = torch.clamp(torch.sqrt(target * ratio), 1.0, float(SRC))
    h = torch.clamp(torch.sqrt(target / ratio), 1.0, float(SRC))
    rot = cfg.rotation_degrees
    return {
        "flip": u[:, 0] < 0.5,
        "angle": uniform(1, -rot, rot) * (math.pi / 180.0),
        "brightness": uniform(2, 1 - cfg.jitter_brightness,
                              1 + cfg.jitter_brightness),
        "contrast": uniform(3, 1 - cfg.jitter_contrast,
                            1 + cfg.jitter_contrast),
        "saturation": uniform(6, 1 - cfg.jitter_saturation,
                              1 + cfg.jitter_saturation),
        "hue": uniform(7, -cfg.jitter_hue, cfg.jitter_hue),
        "top": torch.rand(n, generator=generator,
                          device=generator.device) * (SRC - h),
        "left": torch.rand(n, generator=generator,
                           device=generator.device) * (SRC - w),
        "height": h,
        "width": w,
    }


def augment_with_params(images_u8: torch.Tensor,
                        params: Dict[str, torch.Tensor],
                        cfg: DataConfig) -> torch.Tensor:
    """uint8 [B,32,32,3] -> float32 [B,S,S,3] (S = cfg.image_size), on the
    images' device, with the given per-image parameters."""
    dev = images_u8.device
    p = {k: params[k].to(dev, non_blocking=True) for k in PARAM_NAMES}
    x = images_u8.float() / 255.0
    x = torch.where(p["flip"][:, None, None, None], x.flip(2), x)
    if cfg.rotation_degrees > 0:
        # Content rotation at the 32 px source, edge fill; the shears
        # stay exact only while they stay inside the frame, so ranges
        # above 30 degrees take the gather (a static choice, as in tpunet).
        if cfg.rotation_degrees <= 30.0:
            x = _rotate_shear(x, p["angle"])
        else:
            x = _rotate_bilinear(x, p["angle"])
    x = _color_jitter(x, p, cfg)
    row_m = _bilinear_matrix(p["top"], p["height"], cfg.image_size, SRC)
    col_m = _bilinear_matrix(p["left"], p["width"], cfg.image_size, SRC)
    x = _apply_separable(x, row_m, col_m)
    if cfg.rotation_degrees > 0:
        x = x * _rotation_border_mask(cfg.image_size, p["angle"])[..., None]
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=dev)
    return (x - mean) / std


def make_train_augment(cfg: DataConfig) -> Callable:
    """fn(generator, images_u8 [B,32,32,3]) -> float32 [B,S,S,3]; ``B``
    is this rank's share of the global batch, whose parameters are drawn
    (a [B * ranks, 8] draw on the CPU costs nothing) and sliced."""
    def augment(generator, images_u8):
        n = images_u8.shape[0]
        lo = n * axis_index("data")
        params = sample_augment_params(generator, n * axis_size("data"), cfg)
        return augment_with_params(
            images_u8, {k: v[lo:lo + n] for k, v in params.items()}, cfg)
    return augment


def make_eval_preprocess(cfg: DataConfig) -> Callable:
    """fn(images_u8 [B,32,32,3]) -> float32 [B,S,S,3]: Resize(image_size)
    + Normalize (the reference's test transform) as two batched matrix
    products with a static resize matrix."""
    rm_np = resize_matrix_np(cfg.image_size, SRC)
    cache: Dict[torch.device, tuple] = {}

    def preprocess(images_u8):
        dev = images_u8.device
        if dev not in cache:
            cache[dev] = (
                torch.from_numpy(rm_np).to(dev),
                torch.tensor(cfg.mean, dtype=torch.float32, device=dev),
                torch.tensor(cfg.std, dtype=torch.float32, device=dev))
        rm, mean, std = cache[dev]
        x = images_u8.float() / 255.0
        x = torch.einsum("oh,bhwc->bowc", rm, x)
        x = torch.einsum("pw,bowc->bopc", rm, x)
        return (x - mean) / std
    return preprocess


# ---------------------------------------------------------------------------
# Mixup / CutMix
# ---------------------------------------------------------------------------


def sample_mix_params(generator: torch.Generator, n: int, mixup_alpha: float,
                      cutmix_alpha: float) -> Dict[str, object]:
    """One step's mixup/CutMix draws for a batch of ``n`` images, from
    one draw of ``generator``: ``perm`` (int64 [n], each image's partner),
    ``mixup`` (True: mixup, False: CutMix; with both alphas above 0 a fair
    coin), ``lam0`` ~ Beta(alpha, alpha) of the chosen method, and the
    CutMix box centre ``cy``, ``cx`` as fractions of the frame in [0, 1).
    tpunet's distributions, drawn from a numpy generator seeded by the
    step's generator (torch has no seeded Beta)."""
    if mixup_alpha <= 0 and cutmix_alpha <= 0:
        raise ValueError("mixup and cutmix are both off")
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    rng = np.random.default_rng(seed)
    perm = torch.from_numpy(rng.permutation(n))
    mixup = mixup_alpha > 0 and (cutmix_alpha <= 0 or rng.random() < 0.5)
    alpha = mixup_alpha if mixup else cutmix_alpha
    return {"perm": perm, "mixup": bool(mixup),
            "lam0": float(np.float32(rng.beta(alpha, alpha))),
            "cy": float(np.float32(rng.random())),
            "cx": float(np.float32(rng.random()))}


def cutmix_box(lam0: float, cy: float, cx: float, h: int, w: int
               ) -> torch.Tensor:
    """bool [h, w]: tpunet's CutMix box, of area (1 - lam0) centred at
    (cy * h, cx * w) and clipped at the borders, in float32 as tpunet
    computes it."""
    f32 = torch.float32
    lam0_t = torch.tensor(lam0, dtype=f32)
    rh = torch.sqrt(1.0 - lam0_t) * h
    rw = torch.sqrt(1.0 - lam0_t) * w
    cy_t = torch.tensor(cy, dtype=f32) * h
    cx_t = torch.tensor(cx, dtype=f32) * w
    y0, y1 = (cy_t - rh / 2).clamp(0, h), (cy_t + rh / 2).clamp(0, h)
    x0, x1 = (cx_t - rw / 2).clamp(0, w), (cx_t + rw / 2).clamp(0, w)
    yy = torch.arange(h, dtype=f32)
    xx = torch.arange(w, dtype=f32)
    return ((yy[:, None] >= y0) & (yy[:, None] < y1)
            & (xx[None, :] >= x0) & (xx[None, :] < x1))


def mix_with_params(images: torch.Tensor, params: Dict[str, object],
                    partners: torch.Tensor = None
                    ) -> "tuple[torch.Tensor, float]":
    """Mix ``images`` [B,S,S,3] with their ``partners`` (by default
    ``images[params["perm"]]``) -> ``(mixed images in images.dtype, lam)``: mixup ``lam * x + (1 -
    lam) * x_b`` with ``lam = lam0``, or CutMix, the partner's pixels
    inside the box and ``lam`` the surviving area. The loss is then
    ``lam * CE(y) + (1 - lam) * CE(y_b)``. ``lam`` is a host float32
    value: nothing here waits for the device."""
    if partners is None:
        partners = images[params["perm"].to(images.device,
                                            non_blocking=True)]
    if params["mixup"]:
        lam = params["lam0"]
        lam_t = torch.tensor(lam, dtype=torch.float32, device=images.device)
        out = lam_t * images + (1.0 - lam_t) * partners
        return out.to(images.dtype), lam
    h, w = images.shape[1:3]
    box = cutmix_box(params["lam0"], params["cy"], params["cx"], h, w)
    lam = float(1.0 - box.float().mean())
    box = box.to(images.device, non_blocking=True)
    return torch.where(box[None, :, :, None], partners, images), lam


def make_mix(cfg: DataConfig) -> Optional[Callable]:
    """fn(generator, images [B,S,S,3], labels [B]) -> (mixed images,
    partner labels, lam) over this rank's rows of the global batch, or
    None when mixup and CutMix are off (the step then draws nothing, so
    its generator stream is that of a run without them). Under a process
    group the draw is the global batch's, and one collective
    (:func:`fetch_rows`) brings this rank's partner rows and labels."""
    if cfg.mixup_alpha <= 0 and cfg.cutmix_alpha <= 0:
        return None

    def mix(generator, images, labels):
        n, ranks = images.shape[0], axis_size("data")
        params = sample_mix_params(generator, n * ranks, cfg.mixup_alpha,
                                   cfg.cutmix_alpha)
        if ranks == 1:
            out, lam = mix_with_params(images, params)
            return out, labels[params["perm"].to(labels.device)], lam
        partners, partner_labels = fetch_rows((images, labels),
                                              params["perm"],
                                              axis_group("data"))
        out, lam = mix_with_params(images, params, partners)
        return out, partner_labels, lam
    return mix
