"""Pipeline-parallel ViT (``vit_pp``), port of ``tpunet/models/vit_pp.py``.

tpunet writes the encoder blocks as stacked functional parameters whose
leading (layer) dim is split over the mesh's 'pipe' axis. Here the model
is the port's ViT (``tpunet_torch.models.vit``): the same blocks, the
same initialisation from the same seed (so ``vit_pp`` at a seed draws
the weights ``vit`` draws), and the same state-dict keys
(``blocks.<i>...`` in plain layer order); on a mesh whose 'pipe' axis
has S > 1 ranks each rank keeps only its stage's blocks
(:class:`PipelineStages`, the layers ``tpunet_torch.parallel.pp.PipePlan``
assigns it: L / S contiguous layers, or under ``interleaved`` v chunks
of L / (S*v)) and drops the others. Patch embedding, positions, the
final LayerNorm and the head stay on every stage, as tpunet keeps them
replicated; stage 0 runs the embedding and the last stage the head, and
their gradients are summed over 'pipe' by the train state
(``tpunet_torch.train.state.Sharding``) so the copies stay equal.

With pipe 1 the model is the port's ViT. With pipe > 1 a training step
goes through :meth:`PipelineStages.pipe_train` (the train step's loss
on the last stage, ``tpunet_torch.train.steps``), and an eval forward
runs the forward table over the microbatches and returns the last
stage's logits on every rank of the 'pipe' group. The attention core is
dense or flash (the hand-written kernels on the card, their plain
versions on the CPU, as in ``vit``); ``auto`` is flash. Dropout draws one
generator a (microbatch, stage) from one draw of the step's generator
(``tpunet_torch.parallel.pp.micro_seed``); tpunet folds its key per
(tick, stage, layer), so the masks differ from tpunet's, and parity runs
at dropout 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from tpunet_torch.models.vit import Dropout, ViT, create_vit
from tpunet_torch.parallel.dist import all_reduce
from tpunet_torch.parallel.mesh import axis_group, axis_index, axis_size
from tpunet_torch.parallel.pp import (PipePlan, StageWork, micro_seed,
                                      split_micro)


class StageBlocks(nn.Module):
    """A stage's blocks under their global layer index (``blocks.<i>``
    in the state dict, the keys of the whole model): iterated in layer
    order, indexed by the global index."""

    def __init__(self, blocks: Dict[int, nn.Module]):
        super().__init__()
        for i in sorted(blocks):
            self.add_module(str(i), blocks[i])

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


class _Work(StageWork):
    """One pipelined pass of a model over its microbatches (see
    :class:`tpunet_torch.parallel.pp.StageWork`)."""

    def __init__(self, model, inputs, extras, train, base, loss_fn,
                 aux_scale, last_kw):
        self.model, self.inputs, self.extras = model, inputs, extras
        self.train, self.base, self.loss_fn = train, base, loss_fn
        self.aux_scale, self.last_kw = aux_scale, last_kw
        self.drops: Dict[tuple, Dropout] = {}
        self.aux: list = []         # each chunk's MoE terms, detached

    def drop(self, m: int, g: int) -> Dropout:
        if (m, g) not in self.drops:
            self.drops[(m, g)] = self.model._micro_dropout(
                self.train, self.base, m, g, self.model.pp_device)
        return self.drops[(m, g)]

    def first(self, m):
        return self.drop(m, 0)(self.model._embed(self.inputs[m], self.train))

    def chunk(self, j, x, m):
        pp = self.model.pp
        aux = [] if self.train else None
        y = self.model._pipe_chunk(j, x, self.train,
                                   self.drop(m, j * pp.S + pp.s),
                                   self.extras[m], aux)
        if not aux:
            return y, None
        total = sum(aux)
        self.aux.append(total.detach())
        return y, total * self.aux_scale if self.aux_scale else None

    def last(self, m, y):
        h = self.model._pipe_head(y, self.train, **self.last_kw)
        return self.loss_fn(m, h) if self.train else h


class PipelineStages:
    """The pipeline's share of :class:`~tpunet_torch.models.vit.ViT` and
    :class:`~tpunet_torch.models.lm.TransformerLM` (mixed in before
    them). ``pp`` is the rank's :class:`PipePlan`, None at pipe 1;
    ``full_param_names`` the whole model's parameter names in its order
    and ``n_params_full`` its parameter count (the checkpoint and the
    trainer's count read them)."""

    pp: Optional[PipePlan] = None

    def _split_stages(self, cfg) -> None:
        """Keep this rank's stage of the blocks (the current mesh's
        'pipe' axis), drop the rest."""
        self.full_param_names = [n for n, _ in self.named_parameters()]
        self.n_params_full = sum(p.numel() for p in self.parameters())
        self.pp_micro = cfg.pp_microbatches
        stages = axis_size("pipe")
        if stages == 1:
            self.pp = None
            return
        self.pp = PipePlan(len(self.blocks), stages, axis_index("pipe"),
                           cfg.pp_microbatches, cfg.pp_schedule,
                           cfg.pp_virtual, axis_group("pipe"))
        mine = self.pp.layers[self.pp.s]
        self.blocks = StageBlocks({i: self.blocks[i] for i in mine})
        # Each microbatch-shard routes its own tokens (tpunet's scope
        # inside its pipeline's shard_map).
        self.aux_axes = ()

    @property
    def pp_device(self) -> torch.device:
        return self.pos_embed.device

    def _micro_dropout(self, train: bool, base: int, m: int, g: int,
                       device) -> Dropout:
        """The dropout of microbatch ``m`` on global stage ``g``: a
        generator of its own, seeded from the step's draw ``base``, the
        pair and this rank's 'data' index (as ``Encoder._dropout``)."""
        if not train or self.dropout_rate == 0.0:
            return Dropout(None, 0.0)
        seed = (micro_seed(base, m, g)
                + axis_index("data") * 0x9E3779B97F4A7C15) % 2**63
        return Dropout(torch.Generator(device=device).manual_seed(seed),
                       self.dropout_rate, self.seq_shard())

    def _pipe_chunk(self, j: int, x: torch.Tensor, train: bool,
                    drop: Dropout, segment_ids, aux: Optional[list]
                    ) -> torch.Tensor:
        """Chunk ``j`` of this stage's blocks on ``x``."""
        for i in self.pp.chunks[j]:
            x = self._block(self.blocks[i], x, train, drop, segment_ids,
                            None, aux)
        return x

    def _pipe_run(self, inputs: List[torch.Tensor], extras: list,
                  train: bool, generator: Optional[torch.Generator],
                  act_shape, loss_fn: Optional[Callable] = None,
                  aux_scale: float = 0.0, **last_kw) -> dict:
        """One pass over the microbatches ``inputs`` (stage 0's, with
        ``extras`` each microbatch's segment ids or None): forwards, and
        with ``train`` the backwards into the parameters' gradients, the
        loss of microbatch m being ``loss_fn(m, head output)`` on the
        last stage and each chunk's MoE terms weighted by ``aux_scale``.
        Returns the last stage's results by microbatch; this stage's MoE
        terms (unweighted, detached) are left for ``moe_aux_loss``."""
        base = 0
        if train and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("train mode with dropout needs a "
                                 "generator")
            base = int(torch.randint(0, 2**62, (1,), generator=generator))
        work = _Work(self, inputs, extras, train, base, loss_fn, aux_scale,
                     last_kw)
        out = self.pp.run(work, train, act_shape, self.dtype,
                          self.pp_device)
        # This stage's MoE terms of the pass (moe_aux_loss reads them).
        self._aux = work.aux
        return out

    def _pipe_gather(self, outs: dict, shape) -> torch.Tensor:
        """The last stage's outputs of every microbatch, concatenated, on
        every rank of the 'pipe' group (one all-reduce: the others add
        zeros)."""
        if self.pp.s == self.pp.S - 1:
            y = torch.cat([outs[m] for m in range(self.pp.M)])
        else:
            y = torch.zeros(shape, dtype=torch.float32,
                            device=self.pp_device)
        return all_reduce(y, axis_group("pipe"))

    @staticmethod
    def _refuse_train_forward() -> None:
        raise ValueError("a pipelined model trains through the pipelined "
                         "train step (pipe_train): its forward at pipe > 1 "
                         "is an eval forward")


class PipelinedViT(PipelineStages, ViT):
    """The ViT with its blocks split into stages over 'pipe'."""

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pp is None:
            return super().forward(x, train, generator)
        if train:
            self._refuse_train_forward()
        n = x.shape[0]
        tokens = (x.shape[2] // self.patch_size) * (x.shape[3]
                                                   // self.patch_size)
        xs = split_micro(x, self.pp.M)
        outs = self._pipe_run(xs, [None] * self.pp.M, False, None,
                              (xs[0].shape[0], tokens, self.hidden))
        return self._pipe_gather(outs, (n, self.num_classes))

    def pipe_train(self, images: torch.Tensor, generator, loss_fn,
                   aux_scale: float = 0.0) -> dict:
        """A training pass over ``images`` [N,C,H,W] (this rank's rows of
        one accumulation microbatch): ``loss_fn(m, logits of microbatch
        m)`` on the last stage; the gradients land in ``.grad``."""
        xs = split_micro(images, self.pp.M)
        tokens = (images.shape[2] // self.patch_size) * (
            images.shape[3] // self.patch_size)
        return self._pipe_run(xs, [None] * self.pp.M, True, generator,
                              (xs[0].shape[0], tokens, self.hidden),
                              loss_fn, aux_scale)

    @property
    def hidden(self) -> int:
        return self.pos_embed.shape[-1]

    def _pipe_head(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        return self._head(y, train)


def check_vit_pp(cfg) -> None:
    """tpunet's ``vit_pp.create_model`` checks against the current mesh's
    'pipe' axis, with its messages."""
    if cfg.attention not in ("dense", "flash", "auto"):
        raise ValueError(
            f"vit_pp supports dense/flash/auto attention (got "
            f"{cfg.attention!r}); sequence parallelism is the LM "
            "family's (lm/lm_pp ulysses|ring) — a 64-token patch grid "
            "has nothing to shard")
    if cfg.moe_experts > 0:
        raise ValueError("vit_pp does not support MoE blocks (the "
                         "MoE x PP composition lives in the LM "
                         "family: --model lm_pp --moe-experts N)")
    if cfg.pp_schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown pp_schedule {cfg.pp_schedule!r}; "
                         "expected gpipe|1f1b|interleaved")
    stages = axis_size("pipe")
    if cfg.pp_schedule == "interleaved":
        if stages < 2:
            raise ValueError(
                "pp_schedule='interleaved' needs a mesh 'pipe' axis "
                "> 1 (use gpipe/1f1b at pipe=1)")
        if cfg.pp_virtual < 2:
            raise ValueError(f"--pp-virtual must be >= 2 (got "
                             f"{cfg.pp_virtual})")
        if cfg.vit_depth % (stages * cfg.pp_virtual):
            raise ValueError(
                f"vit_depth {cfg.vit_depth} not divisible by "
                f"{stages} stages x {cfg.pp_virtual} virtual chunks")
        if cfg.pp_microbatches % stages:
            raise ValueError(
                f"--pp-microbatches {cfg.pp_microbatches} not "
                f"divisible by the pipe axis ({stages})")
    if cfg.remat:
        raise ValueError("vit_pp does not support --remat (the "
                         "pipeline scan already bounds activation "
                         "memory per stage; --pp-schedule 1f1b bounds "
                         "the backward)")
    if stages > 1 and cfg.vit_depth % stages:
        raise ValueError(f"vit_depth {cfg.vit_depth} not divisible by "
                         f"{stages} pipeline stages")


def create_vit_pp(cfg, image_size: int,
                  generator: torch.Generator) -> PipelinedViT:
    """The pipelined ViT of ``cfg`` on the current mesh: ``vit``'s model
    and weights, then this rank's stage of the blocks."""
    check_vit_pp(cfg)
    model = create_vit(cfg, image_size, generator, PipelinedViT)
    model._split_stages(cfg)
    return model
