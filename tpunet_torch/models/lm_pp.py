"""Pipeline-parallel causal LM (``lm_pp``), port of
``tpunet/models/lm_pp.py``.

The port's LM (``tpunet_torch.models.lm.TransformerLM``: the same blocks,
the same weights from the same seed, the same state-dict keys in plain
layer order) with its blocks split into stages over the mesh's 'pipe'
axis (:class:`tpunet_torch.models.vit_pp.PipelineStages`). The token
table, the positions and the final LayerNorm stay on every stage, as
tpunet keeps them replicated: stage 0 embeds the tokens, the last stage
runs the LayerNorm and the head tied to the table, and the table's two
gradients (the input's on stage 0, the logits' on the last stage) are
summed over 'pipe' by the train state, so every stage keeps the same
table.

What composes, as in tpunet:

- packed documents: each microbatch's segment ids mask its attention on
  every stage; the ids are batch metadata and never hop;
- ``--attention ulysses|ring`` inside the stages over the mesh's 'seq'
  axis (SP x PP, gpipe and 1f1b): every rank of a 'pipe' group holds the
  same T / S_seq positions, so the hops carry [mb, T / S_seq, C];
- MoE: every ``moe_every``-th block routes (the depth in whole
  super-layers a stage and a chunk); each microbatch-shard routes its own
  tokens at its own capacity, and the load-balance terms are summed over
  the stages and averaged over the microbatches and the 'data'/'seq'
  shards, so ``lm_pp`` equals the unpipelined MoE LM exactly at
  ``--pp-microbatches`` 1 and one data shard (tpunet's ``with_aux``
  semantics, ``tpunet/parallel/pp.py:203-209``);
- EP x PP: with a 'model' axis > 1 the MoE blocks' experts split over it
  inside the stages (``tpunet_torch.parallel.tp``'s pipeline rules) and
  everything else is whole on every 'model' rank; the tokens and the
  router enter the experts through ``copy_to_group`` and the partial
  outputs leave through ``reduce_from_group``, so autograd sums the
  partial cotangents that tpunet's 1F1B completes with its ``ep_axis``
  rule;
- ``--vocab-ce`` composes through the last stage's hidden states
  (``return_hidden``).

With pipe 1 the model is the LM. The decode paths (``generate``, the
serving engine) run the LM itself on the same state dict: an ``lm_pp``
checkpoint serves as an ``lm`` one (``tpunet_torch.infer.generate
--model lm_pp``), and tpunet's stacked trees convert in both directions
through ``tpunet_torch.models.convert``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tpunet_torch.config import SEQ_ATTENTIONS
from tpunet_torch.models.lm import TransformerLM, create_lm
from tpunet_torch.models.vit_pp import PipelineStages
from tpunet_torch.parallel.mesh import axis_size
from tpunet_torch.parallel.pp import split_micro


class PipelinedLM(PipelineStages, TransformerLM):
    """tokens [B, T] int -> logits [B, T, vocab] float32, pipelined."""

    def forward(self, tokens: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                pos_offset=0, segment_ids: Optional[torch.Tensor] = None,
                cache=None, return_hidden: bool = False, **kw):
        if self.pp is None:
            return super().forward(tokens, train, generator, pos_offset,
                                   segment_ids, cache, return_hidden, **kw)
        if train:
            self._refuse_train_forward()
        if (cache is not None or kw or torch.is_tensor(pos_offset)
                or pos_offset):
            raise ValueError("a pipelined LM decodes as the LM: serve its "
                             "checkpoint with --model lm_pp "
                             "(tpunet_torch.infer.generate)")
        b = tokens.shape[0]
        xs, es = self._micro_inputs(tokens, segment_ids)
        act = self._act_shape(xs[0])
        outs = self._pipe_run(xs, es, False, None, act,
                              return_hidden=return_hidden)
        width = self.hidden if return_hidden else self.vocab_size
        return self._pipe_gather(outs, (b, act[1], width))

    def pipe_train(self, tokens: torch.Tensor,
                   segment_ids: Optional[torch.Tensor], generator,
                   loss_fn, aux_scale: float = 0.0,
                   return_hidden: bool = False) -> dict:
        """A training pass over the token rows ``tokens`` [B, T] (this
        rank's rows of one accumulation microbatch; ``segment_ids`` their
        packing): ``loss_fn(m, logits or hidden states of microbatch m at
        this rank's positions)`` on the last stage, each MoE term times
        ``aux_scale``; the gradients land in ``.grad``."""
        xs, es = self._micro_inputs(tokens, segment_ids)
        return self._pipe_run(xs, es, True, generator, self._act_shape(xs[0]),
                              loss_fn, aux_scale,
                              return_hidden=return_hidden)

    def _micro_inputs(self, tokens, segment_ids):
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        segs = (None if segment_ids is None else
                self._seq_slice(segment_ids).to(torch.int32))
        return (split_micro(tokens, self.pp.M),
                split_micro(segs, self.pp.M))

    def _act_shape(self, tokens_m: torch.Tensor) -> tuple:
        return (tokens_m.shape[0],
                tokens_m.shape[1] // self.seq_shard()[0], self.hidden)

    def _embed(self, tokens: torch.Tensor, train: bool) -> torch.Tensor:
        """The token rows -> this rank's positions of their embedding plus
        the position table (the LM's forward without a cache)."""
        pos = self._cast(self.pos_embed, train)[:, :tokens.shape[1]]
        tokens, pos = self._seq_slice(tokens), self._seq_slice(pos)
        return F.embedding(tokens.long(), self.embed.weight).to(
            self.dtype) + pos

    def _pipe_head(self, y: torch.Tensor, train: bool,
                   return_hidden: bool = False) -> torch.Tensor:
        """The final LayerNorm, then the tied head in float32 (or the
        LayerNorm's output in float32 with ``return_hidden``)."""
        x = self._norm(self.ln, y, train)
        if return_hidden:
            return x.float()
        return torch.matmul(x.float(), self.embed.weight.t())


def check_lm_pp(cfg) -> None:
    """tpunet's ``lm_pp.create_model`` checks against the current mesh,
    with its messages."""
    if cfg.attention not in ("dense", "flash", "auto", "ulysses", "ring"):
        raise ValueError(
            f"lm_pp supports dense/flash/auto and ulysses/ring (SP x "
            f"PP) causal attention (got {cfg.attention!r})")
    if cfg.attention in SEQ_ATTENTIONS:
        sp_size = axis_size("seq")
        if (cfg.attention == "ulysses" and sp_size > 1
                and cfg.vit_heads % sp_size):
            raise ValueError(
                f"--vit-heads {cfg.vit_heads} not divisible by the "
                f"mesh 'seq' axis ({sp_size}) — Ulysses re-shards "
                "heads over it (ring SP has no head constraint)")
    stages = axis_size("pipe")
    if cfg.moe_experts > 0:
        if cfg.moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got "
                             f"{cfg.moe_every}")
        if cfg.vit_depth % cfg.moe_every:
            raise ValueError(
                f"--vit-depth {cfg.vit_depth} not divisible by "
                f"--moe-every {cfg.moe_every}: lm_pp stacks whole "
                "super-layers (moe_every-1 dense blocks + 1 MoE block)")
        if stages > 1 and (cfg.vit_depth // cfg.moe_every) % stages:
            raise ValueError(
                f"{cfg.vit_depth // cfg.moe_every} MoE super-layers "
                f"(depth {cfg.vit_depth} / moe_every {cfg.moe_every}) "
                f"not divisible by {stages} pipeline stages")
        ep = axis_size("model")
        if stages > 1 and ep > 1 and cfg.moe_experts % ep:
            raise ValueError(
                f"--moe-experts {cfg.moe_experts} not divisible by "
                f"the mesh 'model' axis ({ep}) — EP x PP shards the "
                "expert dim over it")
    if cfg.remat:
        raise ValueError("lm_pp does not support --remat (the pipeline "
                         "scan already bounds activation memory per "
                         "stage)")
    if cfg.pp_schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown pp_schedule {cfg.pp_schedule!r}; "
                         "expected gpipe|1f1b|interleaved")
    if cfg.pp_schedule == "interleaved":
        if stages < 2:
            raise ValueError(
                "pp_schedule='interleaved' needs a mesh 'pipe' axis "
                "> 1 (at pipe=1 use gpipe/1f1b — the sequential "
                "fallback would have to un-permute chunk storage)")
        if cfg.pp_virtual < 2:
            raise ValueError(f"--pp-virtual must be >= 2 (got "
                             f"{cfg.pp_virtual}); v=1 IS gpipe/1f1b")
        if cfg.vit_depth % (stages * cfg.pp_virtual):
            raise ValueError(
                f"--vit-depth {cfg.vit_depth} not divisible by "
                f"{stages} stages x {cfg.pp_virtual} virtual chunks")
        if cfg.pp_microbatches % stages:
            raise ValueError(
                f"--pp-microbatches {cfg.pp_microbatches} not "
                f"divisible by the pipe axis ({stages}) — the "
                "interleaved F-stream cycles chunks per "
                "stage-count-sized microbatch group")
        if cfg.attention in SEQ_ATTENTIONS:
            raise ValueError(
                "pp_schedule='interleaved' does not compose with SP "
                "attention (ulysses/ring) — use gpipe/1f1b for "
                "dp x sp x pp")
        if cfg.moe_experts > 0:
            lc = cfg.vit_depth // (stages * cfg.pp_virtual)
            if lc % cfg.moe_every:
                raise ValueError(
                    f"interleaved chunks hold {lc} layers "
                    f"(depth {cfg.vit_depth} / {stages} stages / "
                    f"{cfg.pp_virtual} virtual) — not whole "
                    f"super-layers of moe_every={cfg.moe_every}")
    if stages > 1 and cfg.vit_depth % stages:
        raise ValueError(
            f"--vit-depth {cfg.vit_depth} (the transformer depth "
            f"flag — for lm_pp it is the LM's layer count) is not "
            f"divisible by {stages} pipeline stages")


def create_lm_pp(cfg, generator: torch.Generator) -> PipelinedLM:
    """The pipelined LM of ``cfg`` on the current mesh: ``lm``'s model and
    weights, then this rank's stage of the blocks."""
    check_lm_pp(cfg)
    model = create_lm(cfg, generator, PipelinedLM)
    model._split_stages(cfg)
    return model
