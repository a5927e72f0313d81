"""The training augmentation, written out plainly for the reference.

A frozen copy of the arithmetic the port's training step applies to a
batch (the reference project's torchvision stack run on the device):
flip; rotation at the 32 px source as three shears (Paeth); colour
jitter (brightness, contrast, saturation, hue); the random-resized-crop
box as two separable bilinear matrices to the output size; the black
rotation corners as a closed-form coverage mask; normalize. Float32
throughout. It imports nothing of the program: the benchmark's yardstick
must not move when the program does.

The per-image parameters are drawn from the step's generator in the
order the port documents (``sample``): a [n, 8] uniform draw, then the
crop's top and left offsets.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SRC = 32                       # CIFAR-10's resolution
GRAY = (0.299, 0.587, 0.114)


def sample(generator: torch.Generator, n: int, aug: dict
           ) -> Dict[str, torch.Tensor]:
    """Each of ``n`` images' parameters, on the generator's device."""
    u = torch.rand((n, 8), generator=generator, device=generator.device)

    def uniform(col, lo, hi):
        return lo + (hi - lo) * u[:, col]

    area = float(SRC * SRC)
    lo_s, hi_s = aug["rrc_scale"]
    lo_r, hi_r = aug["rrc_ratio"]
    target = uniform(4, lo_s, hi_s) * area
    ratio = torch.exp(uniform(5, math.log(lo_r), math.log(hi_r)))
    w = torch.clamp(torch.sqrt(target * ratio), 1.0, float(SRC))
    h = torch.clamp(torch.sqrt(target / ratio), 1.0, float(SRC))
    rot = aug["rotation_degrees"]
    b, c, s, hue = (aug["jitter_brightness"], aug["jitter_contrast"],
                    aug["jitter_saturation"], aug["jitter_hue"])
    return {
        "flip": u[:, 0] < 0.5,
        "angle": uniform(1, -rot, rot) * (math.pi / 180.0),
        "brightness": uniform(2, 1 - b, 1 + b),
        "contrast": uniform(3, 1 - c, 1 + c),
        "saturation": uniform(6, 1 - s, 1 + s),
        "hue": uniform(7, -hue, hue),
        "top": torch.rand(n, generator=generator,
                          device=generator.device) * (SRC - h),
        "left": torch.rand(n, generator=generator,
                           device=generator.device) * (SRC - w),
        "height": h,
        "width": w,
    }


def _hat(s: torch.Tensor, size: int) -> torch.Tensor:
    s = torch.clamp(s, 0.0, size - 1.0)
    j = torch.arange(size, dtype=torch.float32, device=s.device)
    return torch.clamp_min(1.0 - (s[..., None] - j).abs(), 0.0)


def _crop_matrix(start, size, out: int) -> torch.Tensor:
    i = torch.arange(out, dtype=torch.float32, device=start.device)
    return _hat(start[:, None] + (i + 0.5) * size[:, None] / out - 0.5, SRC)


def _f32(fn, a: torch.Tensor) -> torch.Tensor:
    """``fn(a)`` correctly rounded to float32 (computed in float64)."""
    return fn(a.double()).float()


def _rotate(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] rotated by ``angle`` [B] radians: x-shear, y-shear,
    x-shear, each a bank of per-line bilinear shift matrices with the
    edge clamped."""
    h, w = img.shape[1], img.shape[2]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    t = -_f32(torch.tan, angle / 2.0)[:, None]
    s = _f32(torch.sin, angle)[:, None]
    ar_h = torch.arange(h, dtype=torch.float32, device=img.device)
    ar_w = torch.arange(w, dtype=torch.float32, device=img.device)
    i_w = torch.arange(w, dtype=torch.float32, device=img.device)
    i_h = torch.arange(h, dtype=torch.float32, device=img.device)
    mx = _hat(i_w + (t * (ar_h - cy))[..., None], w)
    my = _hat(i_h + (s * (ar_w - cx))[..., None], h)
    img = torch.einsum("bhij,bhjc->bhic", mx, img)
    img = torch.einsum("bwij,bjwc->biwc", my, img)
    return torch.einsum("bhij,bhjc->bhic", mx, img)


def _corner_mask(size: int, angle: torch.Tensor) -> torch.Tensor:
    """[B,size,size] bilinear coverage of the rotated frame."""
    c = (size - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(size, dtype=torch.float32, device=angle.device),
        torch.arange(size, dtype=torch.float32, device=angle.device),
        indexing="ij")
    cos = _f32(torch.cos, angle)[:, None, None]
    sin = _f32(torch.sin, angle)[:, None, None]
    sy = cos * (yy - c) + sin * (xx - c) + c
    sx = -sin * (yy - c) + cos * (xx - c) + c

    def cover(v):
        i0 = torch.floor(v)
        f = v - i0
        v0 = ((i0 >= 0) & (i0 <= size - 1)).float()
        v1 = ((i0 + 1 >= 0) & (i0 + 1 <= size - 1)).float()
        return (1.0 - f) * v0 + f * v1

    return cover(sy) * cover(sx)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return x @ torch.tensor(GRAY, dtype=torch.float32, device=x.device)


def _hue_shift(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc, minc = torch.amax(x, dim=-1), torch.amin(x, dim=-1)
    d = maxc - minc
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe_d = torch.where(d == 0, one, d)
    sat = torch.where(maxc == 0, torch.zeros_like(maxc),
                      d / torch.where(maxc == 0, one, maxc))
    rc, gc, bc = (maxc - r) / safe_d, (maxc - g) / safe_d, (maxc - b) / safe_d
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d == 0, torch.zeros_like(h),
                    torch.remainder(h / 6.0, 1.0))
    h = torch.remainder(h + shift[:, None, None], 1.0)
    v = maxc
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = torch.remainder(i.long(), 6)[..., None]
    p, q, t = v * (1.0 - sat), v * (1.0 - f * sat), v * (1.0 - (1.0 - f) * sat)
    pick = [torch.stack(o, dim=-1).gather(-1, i) for o in
            ([v, q, p, p, t, v], [t, v, v, q, p, p], [p, p, t, v, v, q])]
    return torch.cat(pick, dim=-1)


def apply(images_u8: torch.Tensor, p: Dict[str, torch.Tensor], aug: dict,
          out_size: int) -> torch.Tensor:
    """uint8 [B,32,32,3] -> float32 [B,S,S,3] under parameters ``p``."""
    dev = images_u8.device
    p = {k: v.to(dev) for k, v in p.items()}
    x = images_u8.float() / 255.0
    x = torch.where(p["flip"][:, None, None, None], x.flip(2), x)
    rot = aug["rotation_degrees"]
    if rot > 0:
        if rot > 30.0:
            raise ValueError("the reference rotates by shears, exact to 30 "
                             "degrees")
        x = _rotate(x, p["angle"])
    v = lambda t: t[:, None, None, None]  # noqa: E731
    if aug["jitter_brightness"] > 0:
        x = torch.clamp(x * v(p["brightness"]), 0.0, 1.0)
    if aug["jitter_contrast"] > 0:
        mean = _gray(x).mean(dim=(1, 2))[:, None, None, None]
        x = torch.clamp(v(p["contrast"]) * x + (1 - v(p["contrast"])) * mean,
                        0.0, 1.0)
    if aug["jitter_saturation"] > 0:
        g = _gray(x)[..., None]
        x = torch.clamp(v(p["saturation"]) * x
                        + (1 - v(p["saturation"])) * g, 0.0, 1.0)
    if aug["jitter_hue"] > 0:
        x = _hue_shift(x, p["hue"])
    rows = _crop_matrix(p["top"], p["height"], out_size)
    cols = _crop_matrix(p["left"], p["width"], out_size)
    x = torch.einsum("boh,bhwc->bowc", rows, x)
    x = torch.einsum("bpw,bowc->bopc", cols, x)
    if rot > 0:
        x = x * _corner_mask(out_size, p["angle"])[..., None]
    mean = torch.tensor(aug["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(aug["std"], dtype=torch.float32, device=dev)
    return (x - mean) / std
