"""MobileNetV2 in PyTorch, port of ``tpunet/models/mobilenetv2.py``.

The module tree reproduces torchvision's ``mobilenet_v2`` state_dict keys
(``features.0.0.weight``, ``features.N.conv...``, ``features.18.1.*``,
``classifier.1.weight``), so a torchvision-layout ``.pth`` — or a tpunet
checkpoint exported by ``python -m tpunet.models.convert`` — loads
strictly. The modules only hold parameters; the forward is written out
functionally to mirror the JAX package's arithmetic. Activations are
channels_last in ``dtype`` (bf16 on the card) over ``param_dtype`` (f32)
parameters, logits in f32.

Eval mode (``forward(x)``):
- what is derived from the parameters alone (weights cast to ``dtype``,
  the depthwise weights in the kernel's [3,3,C] layout, eval BN's
  ``inv``/``shift``) is computed once, without autograd, and reused
  until a parameter or buffer changes;
- eval BN is ``FusedBNAct``'s eval math: ``inv = rsqrt(var+eps)*scale``,
  ``shift = bias - mean*inv``, ``y = x.f32*inv + shift``, ReLU6, cast;
- the 17 depthwise 3x3 convs go to ``tpunet_torch.ops.depthwise_conv3x3``
  when ``use_pallas_depthwise`` is set (``ConvBN``'s routing) and to
  ``F.conv2d(groups=C)`` otherwise; every other conv is ``F.conv2d``.

Train mode (``forward(x, train=True, generator=g)``):
- the weights are cast under autograd on every call (never the eval
  cache, whose tensors carry no gradient);
- BN is ``FusedBNAct``'s train math: one pass of float32 statistics over
  the conv output, ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)``,
  the same epilogue with the batch statistics, and the running update
  ``ra = 0.9*ra + 0.1*batch`` with that biased ``var``;
- with ``fused_ir`` the 33 stride-1 expand/project 1x1 convs and their
  BN go through ``tpunet_torch.ops.fused_ir.conv1x1_bn_act``, and with
  ``use_pallas_depthwise`` the 17 depthwise convs through the depthwise
  autograd Function; the stem, the head 1x1 and the classifier stay
  ``F.conv2d``/``F.linear``, as tpunet leaves them to XLA;
- dropout keeps each pooled feature with probability ``1 - rate`` and
  scales it by ``1 / (1 - rate)``; the mask comes from ``generator``;
- with ``block_remat`` (tpunet's saved-residual policy) an inverted-
  residual block keeps for its backward only its conv outputs and the
  (C,) BN statistics: every activation-sized tensor derived from a conv
  output by the BN/ReLU6 epilogue (the cast to float32, the normalised
  value, the activation the next conv reads) is saved as a recipe and
  recomputed from them in the backward (:class:`EpilogueRemat`), with
  the same ops, so the gradients are the same to the bit. No conv runs
  again, and the BN running statistics are updated once, in the
  forward.

Under data parallelism (a process group, ``tpunet_torch.parallel``)
train mode computes the function of the global batch, as tpunet's jit
over a batch-sharded mesh does: every train-mode BN normalises by the
statistics of the whole batch (its per-channel sums summed over the
ranks, forward and backward, and divided by the global count), the
running statistics are updated from them and so agree on every rank,
and the dropout mask is drawn at the global batch's shape, of which
each rank takes its rows. Without a group the reduction is the identity
on the same code path, so one rank computes bit for bit what a run
without a group does. On a mesh (``tpunet_torch.parallel.mesh``) the
ranks are those of the 'data' axis: MobileNetV2 takes no tensor-parallel
rule, so the ranks of a 'model' group compute the same rows alike.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpunet_torch.ops import depthwise_conv3x3
from tpunet_torch.ops.depthwise import depthwise_conv3x3_train
from tpunet_torch.ops.fused_ir import bn_act_epilogue, conv1x1_bn_act
from tpunet_torch.parallel.dist import all_reduce_sum
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size

# (expansion, out_channels, num_blocks, first_stride)
INVERTED_RESIDUAL_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.9      # running = 0.9 * running + 0.1 * batch (torch's 0.1)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts like torchvision does for width multipliers."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Conv(nn.Module):
    """Bias-free conv weight [O, I/groups, k, k] (torch ``Conv2d`` keys)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride, self.groups, self.pad = stride, groups, (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))


class BN(nn.Module):
    """BatchNorm2d parameters and running statistics (torch keys)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))


class ConvBNAct(nn.Sequential):
    """torchvision's ``Conv2dNormActivation``: keys ``.0`` conv, ``.1`` BN."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(Conv(cin, cout, k, stride, groups), BN(cout))


class InvertedResidual(nn.Module):
    """Expansion -> depthwise -> linear projection, with residual add.
    ``conv`` holds torchvision's sequence: [expand,] depthwise, project
    conv, project BN."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, hidden, 1))
        layers += [ConvBNAct(hidden, hidden, 3, stride, groups=hidden),
                   Conv(hidden, cout, 1), BN(cout)]
        self.conv = nn.Sequential(*layers)


class EpilogueRemat:
    """Saved-tensor hooks of one block's forward under block remat.
    ``register(t, make)`` names a tensor that ``make()`` recomputes bit
    for bit from what the block keeps; a saved tensor that shares its
    storage (``t`` or any view of it) is packed as the recipe and the
    view's geometry, and unpacked by recomputing. The registry holds
    its tensors only for the block's forward (:meth:`clear`)."""

    def __init__(self):
        self._recipes: Dict[int, tuple] = {}

    def register(self, t: torch.Tensor, make: Callable[[], torch.Tensor]):
        self._recipes[t.untyped_storage().data_ptr()] = (t, make)

    def clear(self) -> None:
        self._recipes.clear()

    def pack(self, t: torch.Tensor):
        hit = self._recipes.get(t.untyped_storage().data_ptr())
        if hit is None or hit[0].dtype != t.dtype:
            return t
        base, make = hit
        return (make, base.shape, base.stride(), t.shape, t.stride(),
                t.storage_offset())

    @staticmethod
    def unpack(packed):
        if not isinstance(packed, tuple):
            return packed
        make, shape, stride, vshape, vstride, offset = packed
        with torch.no_grad():
            base = make()
        if base.shape != shape or base.stride() != stride:
            raise RuntimeError("block remat recomputed a tensor of another "
                               "layout than the forward's")
        return base.as_strided(vshape, vstride, offset)


class MobileNetV2(nn.Module):
    """MobileNetV2 backbone + linear classifier head.

    ``forward(x, train=False, generator=None)`` takes normalized float
    images [N,3,H,W] (any memory format) and returns float32 logits
    [N, num_classes]. ``train=True`` uses batch statistics, updates the
    running ones, and draws the dropout mask from ``generator``."""

    HEAD_KEYS = ("classifier.1.weight", "classifier.1.bias")

    def __init__(self, num_classes: int = 10, width_mult: float = 1.0,
                 dropout_rate: float = 0.2, use_pallas: bool = False,
                 dtype: torch.dtype = torch.bfloat16, fused_ir: bool = True,
                 block_remat: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_rate = dropout_rate
        self.use_pallas = use_pallas
        self.fused_ir = fused_ir
        self.block_remat = block_remat
        self.dtype = dtype
        cin = _make_divisible(32 * width_mult)
        features = [ConvBNAct(3, cin, 3, 2)]
        for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
            cout = _make_divisible(c * width_mult)
            for i in range(n):
                features.append(
                    InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
        head_ch = _make_divisible(1280 * max(1.0, width_mult))
        features.append(ConvBNAct(cin, head_ch, 1))
        self.features = nn.Sequential(*features)
        self.classifier = nn.Sequential(nn.Dropout(dropout_rate),
                                        Linear(head_ch, num_classes))
        # module -> (source state, source tensors, derived constants).
        self._consts: Dict[nn.Module, tuple] = {}

    def _derived(self, module: nn.Module, tensors: Tuple[torch.Tensor, ...],
                 make: Callable[[], Tuple[torch.Tensor, ...]]
                 ) -> Tuple[torch.Tensor, ...]:
        """``make()``'s constants, derived from ``tensors`` (a module's
        parameters and buffers), computed once and reused until one of
        them changes: load_state_dict and in-place edits bump a tensor's
        version, ``.to()`` moves its storage. The entry holds the source
        tensors, so their ids stay unique while it lives. Parameters made
        under inference_mode track no version and are never cached."""
        if any(t.is_inference() for t in tensors):
            return make()
        state = (self.dtype,) + tuple((id(t), t.data_ptr(), t._version)
                                      for t in tensors)
        hit = self._consts.get(module)
        if hit is None or hit[0] != state:
            # Plain tensors without autograd history, even when the
            # first forward runs under inference_mode.
            with torch.inference_mode(False), torch.no_grad():
                hit = (state, tensors, make())
            self._consts[module] = hit
        return hit[2]

    def _conv(self, conv: Conv, x: torch.Tensor) -> torch.Tensor:
        if self.use_pallas and conv.groups > 1:
            # [C,1,3,3] -> [3,3,C]; channels_last NCHW -> NHWC is a view.
            (w,) = self._derived(conv, (conv.weight,), lambda: (
                conv.weight.to(self.dtype)[:, 0].permute(1, 2, 0).contiguous(),))
            y = depthwise_conv3x3(x.permute(0, 2, 3, 1), w, conv.stride)
            return y.permute(0, 3, 1, 2)
        (w,) = self._derived(conv, (conv.weight,),
                             lambda: (conv.weight.to(self.dtype),))
        return F.conv2d(x, w, stride=conv.stride, padding=conv.pad,
                        groups=conv.groups)

    def _bn_affine(self, bn: BN) -> Tuple[torch.Tensor, torch.Tensor]:
        inv = torch.rsqrt(bn.running_var.float() + BN_EPSILON) * bn.weight.float()
        shift = bn.bias.float() - bn.running_mean.float() * inv
        return inv[:, None, None], shift[:, None, None]

    def _bn(self, bn: BN, x: torch.Tensor, act: bool) -> torch.Tensor:
        inv, shift = self._derived(
            bn, (bn.weight, bn.bias, bn.running_mean, bn.running_var),
            lambda: self._bn_affine(bn))
        y = x.float() * inv + shift
        if act:
            y = torch.clamp(y, 0.0, 6.0)  # ReLU6
        return y.to(self.dtype)

    def _conv_bn(self, unit: ConvBNAct, x: torch.Tensor) -> torch.Tensor:
        return self._bn(unit[1], self._conv(unit[0], x), act=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            return self._forward_train(x, generator)
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        feats = list(self.features)
        x = self._conv_bn(feats[0], x)
        for block in feats[1:-1]:
            units = list(block.conv)
            y = x
            for unit in units[:-2]:
                y = self._conv_bn(unit, y)
            y = self._bn(units[-1], self._conv(units[-2], y), act=False)
            x = y + x if block.use_res else y
        x = self._conv_bn(feats[-1], x)
        x = x.mean(dim=(2, 3))  # global average pool -> [N, C]
        # Dropout is the identity in eval mode.
        head = self.classifier[1]
        w, b = self._derived(head, (head.weight, head.bias), lambda: (
            head.weight.to(self.dtype), head.bias.to(self.dtype)))
        return F.linear(x, w, b).float()

    # -- train mode -------------------------------------------------------

    def _bn_train(self, bn: BN, x: torch.Tensor, act: bool,
                  remat: Optional[EpilogueRemat] = None) -> torch.Tensor:
        """FusedBNAct's train math on a conv output [N,C,H,W], with the
        statistics of the global batch. Under ``remat`` the float32 copy,
        the normalised value and the output are registered as recomputed
        from ``x`` and the statistics."""
        xf = x.float()
        if remat is not None:
            # Each tensor is registered before an op saves it.
            remat.register(xf, x.float)
        sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                           (xf * xf).sum(dim=(0, 2, 3))]),
                              axis_group("data"))
        count = xf.numel() // xf.shape[1] * axis_size("data")
        mean = sums[0] / count
        var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        self._update_running(bn, mean, var)
        inv = torch.rsqrt(var + BN_EPSILON) * bn.weight.float()
        shift = bn.bias.float() - mean * inv
        y = xf * inv[:, None, None] + shift[:, None, None]
        if remat is not None:
            inv_c = inv.detach()[:, None, None]
            shift_c = shift.detach()[:, None, None]

            def norm():
                return x.float() * inv_c + shift_c

            def final():
                o = norm()
                return (torch.clamp(o, 0.0, 6.0) if act else o).to(self.dtype)
            remat.register(y, norm)
        out = torch.clamp(y, 0.0, 6.0) if act else y
        out = out.to(self.dtype)
        if remat is not None:
            remat.register(out, final)
        return out

    @staticmethod
    def _update_running(bn: BN, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM)
                                                   * mean.detach())
            bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM)
                                                  * var.detach())
            bn.num_batches_tracked.add_(1)

    def _conv_train(self, conv: Conv, x: torch.Tensor) -> torch.Tensor:
        w = conv.weight.to(self.dtype)
        if self.use_pallas and conv.groups > 1:
            # [C,1,3,3] -> [3,3,C]; channels_last NCHW -> NHWC is a view.
            w = w[:, 0].permute(1, 2, 0).contiguous()
            y = depthwise_conv3x3_train(x.permute(0, 2, 3, 1), w, conv.stride)
            return y.permute(0, 3, 1, 2)
        y = F.conv2d(x, w, stride=conv.stride, padding=conv.pad,
                     groups=conv.groups)
        return y.contiguous(memory_format=torch.channels_last)

    def _unit_train(self, conv: Conv, bn: BN, x: torch.Tensor, act: bool,
                    fused: bool, remat: Optional[EpilogueRemat] = None
                    ) -> torch.Tensor:
        if fused and self.fused_ir:
            # Stride-1 1x1 conv + BN through the fused-IR op (ConvBN's
            # routing); [Co,Ci,1,1] -> [Ci,Co].
            w = conv.weight.to(self.dtype)[:, :, 0, 0].t().contiguous()
            y, mean, var, conv_out = conv1x1_bn_act(
                x.permute(0, 2, 3, 1), w, bn.weight, bn.bias, act,
                BN_EPSILON, return_conv=True)
            self._update_running(bn, mean, var)
            if remat is not None:
                # The recipe holds the conv output and (C,) tensors only,
                # never ``y`` itself.
                scale, bias, shape = bn.weight.detach(), bn.bias.detach(), y.shape
                remat.register(y, lambda: bn_act_epilogue(
                    conv_out, mean, var, scale, bias, act,
                    BN_EPSILON)[0].view(shape))
            return y.permute(0, 3, 1, 2)
        return self._bn_train(bn, self._conv_train(conv, x), act, remat)

    def _block_train(self, block: InvertedResidual, x: torch.Tensor,
                     remat: Optional[EpilogueRemat] = None) -> torch.Tensor:
        units = list(block.conv)
        y = x
        for unit in units[:-2]:
            # The expand 1x1 (fused) and the depthwise 3x3.
            y = self._unit_train(unit[0], unit[1], y, act=True,
                                 fused=unit[0].groups == 1, remat=remat)
        y = self._unit_train(units[-2], units[-1], y, act=False, fused=True,
                             remat=remat)
        return y + x if block.use_res else y

    def _forward_train(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        feats = list(self.features)
        stem = feats[0]
        x = self._unit_train(stem[0], stem[1], x, act=True, fused=False)
        for block in feats[1:-1]:
            if self.block_remat:
                remat = EpilogueRemat()
                with torch.autograd.graph.saved_tensors_hooks(
                        remat.pack, remat.unpack):
                    x = self._block_train(block, x, remat)
                remat.clear()
            else:
                x = self._block_train(block, x)
        head = feats[-1]
        x = self._unit_train(head[0], head[1], x, act=True, fused=False)
        x = x.mean(dim=(2, 3))  # global average pool -> [N, C]
        rate = self.dropout_rate
        if rate > 0.0:
            if generator is None:
                raise ValueError("train mode with dropout needs a generator")
            # The global batch's mask; this rank's rows of it.
            n = x.shape[0]
            u = torch.rand((n * axis_size("data"),) + x.shape[1:],
                           generator=generator, device=generator.device)
            r = axis_index("data")
            u = u[n * r:n * (r + 1)].to(x.device)
            x = torch.where(u < 1.0 - rate, x / (1.0 - rate),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        lin = self.classifier[1]
        return F.linear(x, lin.weight.to(self.dtype),
                        lin.bias.to(self.dtype)).float()
