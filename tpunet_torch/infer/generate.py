"""Text generation CLI for the LM, port of ``tpunet/infer/generate.py``.

Loads the LM's ``best.pth`` (the port's checkpoint layout), prefills the
prompt and decodes through the KV-cache step
(``tpunet_torch.models.lm.generate``). Byte-level checkpoints (trained
with ``--dataset text_lm``) round-trip UTF-8 text; other vocabs print
token ids.

    python -m tpunet_torch.infer.generate --checkpoint-dir ckpt \\
        --prompt "The " --tokens 256 --temperature 0.8

Runs on the card unless ``--device cpu``. An MoE checkpoint
(``--moe-experts`` and the other ``--moe-*`` flags of its training run)
decodes by tpunet's MoE path: the whole forward over the tokens so far
for every new token, no cache. A pipeline-trained checkpoint
(``--model lm_pp``, any ``--pp-schedule``) holds the LM's keys in plain
layer order and decodes as the LM; a ``best.pth`` holding tpunet's
stacked ``lm_pp`` tree (``blocks_*`` leaves) is unstacked first, and
``--train-pipe P --pp-virtual v`` (or a ``best_meta.json`` that gives
them) undo an interleaved run's chunk permutation, as tpunet's
``--train-pipe`` does.

Tensor parallelism (``--mesh-model M``, tpunet's TP generation): one
process a rank, ``M`` of them under ``torchrun``, a mesh of data 1 x
model M; each rank builds and loads the model on the CPU, keeps its
Megatron shard (``tpunet_torch.parallel.tp``: whole heads, its experts
of an MoE block) and moves only that to its card, and the generation
loop runs on every rank over its shard, each new token the first
rank's (broadcast). Only rank 0 prints. The heads must split evenly
over M (exit 2 otherwise). NCCL on the card, gloo on the CPU;
``--dist-backend gloo`` lets ranks share one card.

    torchrun --standalone --nproc-per-node 2 -m tpunet_torch.infer.generate \
        --checkpoint-dir ckpt --vit-hidden 768 --vit-depth 12 \
        --vit-heads 12 --mesh-model 2 --prompt "The " --tokens 64
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys
from typing import Optional

import numpy as np
import torch

from tpunet_torch.ckpt import BEST, Checkpointer
from tpunet_torch.config import CheckpointConfig, ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import (load_state_dict,
                                         lm_state_dict_from_jax,
                                         state_dict_file)
from tpunet_torch.models.lm import TransformerLM, generate
from tpunet_torch.parallel import dist
from tpunet_torch.parallel.mesh import Mesh, make_mesh, set_mesh


def heads_error(heads: int, model_axis: int) -> Optional[str]:
    """Why ``heads`` cannot serve over a 'model' axis of ``model_axis``
    ranks (tpunet's ``load_lm`` check: TP shards attention by head), or
    None when they split evenly."""
    if model_axis > 1 and heads % model_axis:
        return (f"--vit-heads {heads} not divisible by the mesh 'model' "
                f"axis ({model_axis}) — TP serving shards attention by "
                "head")
    return None


def init_tensor_parallel(model_axis: int, device: str = "cuda",
                         backend: Optional[str] = None,
                         timeout_s: Optional[float] = None
                         ) -> tuple:
    """Join this run's process group (``torchrun``'s variables) and lay
    out the mesh data 1 x model ``model_axis``; returns (the mesh, this
    rank's device). ``backend`` None: NCCL on the card, gloo on the CPU;
    ``timeout_s`` bounds every collective. Raises when a rank on the card
    has no card, or the processes are not ``model_axis``."""
    from tpunet_torch.config import MeshConfig
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--mesh-model on the card: this rank sees no "
                           "CUDA device (--device cpu runs on the CPU)")
    dist.initialize_distributed(
        device=device, backend=backend,
        timeout=None if timeout_s is None
        else datetime.timedelta(seconds=timeout_s))
    mesh = make_mesh(MeshConfig(data=1, model=model_axis))
    device = dist.local_device(kind)
    if kind == "cuda":
        torch.cuda.set_device(device)
    return mesh, device


def load_lm(model_cfg: ModelConfig, checkpoint_dir: str,
            device: str = "cuda", train_pipe: int = 0,
            mesh: Optional[Mesh] = None) -> TransformerLM:
    """The LM of ``model_cfg`` on ``device`` with the weights of
    ``<checkpoint_dir>/best.pth``; an empty ``checkpoint_dir`` serves the
    seeded random init (``create_model``'s generator seeded with 0), as
    tpunet's ``load_lm`` serves its ``PRNGKey(0)`` init. ``lm_pp``
    (tpunet's ``load_lm``): the LM decodes the pipeline-trained weights;
    a stacked tree is unstacked (``train_pipe`` > 0 with the config's
    ``pp_virtual``, or the sidecar's layout, marks an interleaved run's
    chunk-permuted stacks).

    ``mesh`` with a 'model' axis above 1: tensor-parallel serving. The
    model is built and loaded on the CPU (the checkpoint mapped, not
    read, so a rank never holds two whole copies), cut to this rank's
    Megatron shard (``convert.shard_model``: qkv/fc1 column-, out/fc2
    row-parallel, an MoE block's experts over 'model' and its router
    whole), and only the shard moves to ``device``. Raises when the
    heads do not split evenly."""
    if model_cfg.name not in ("lm", "lm_pp"):
        raise ValueError(f"generation needs the 'lm' (or 'lm_pp') "
                         f"model, got {model_cfg.name!r}")
    lm_cfg = dataclasses.replace(model_cfg, name="lm")
    tp = mesh is not None and mesh.shape["model"] > 1
    if tp:
        why = heads_error(lm_cfg.vit_heads, mesh.shape["model"])
        if why:
            raise ValueError(why)
    model = create_model(lm_cfg, device="cpu" if tp else device)
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, BEST)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no best checkpoint under "
                                    f"{checkpoint_dir!r}")
        sd = state_dict_file(path, mmap=tp)
        if model_cfg.name == "lm_pp" and "blocks_qkv_k" in sd:
            virtual = model_cfg.pp_virtual
            meta = Checkpointer(CheckpointConfig(
                directory=checkpoint_dir)).best_meta()
            # tpunet's sidecar gives an interleaved run's layout.
            if not train_pipe and meta and meta.get("pp_layout_pipe", 0):
                train_pipe = int(meta["pp_layout_pipe"])
                virtual = int(meta["pp_layout_virtual"])
            kw = ({"pipe": train_pipe, "virtual": virtual} if train_pipe
                  else {})
            sd = lm_state_dict_from_jax(sd, **kw)
        load_state_dict(model, sd)
    if tp:
        from tpunet_torch.models.convert import shard_model
        from tpunet_torch.parallel.tp import layout
        table = layout({k: tuple(p.shape) for k, p in
                        model.named_parameters()}, lm_cfg, mesh.shape)
        shard_model(model, table, lm_cfg)
        model = model.to(device)
    return model


def generate_text(model: TransformerLM, prompt: str, n_new: int,
                  temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 0.0, seed: int = 0) -> str:
    """Byte-level helper: UTF-8 prompt in, UTF-8 continuation out."""
    toks = np.frombuffer(prompt.encode("utf-8"), np.uint8)
    if toks.size == 0:
        raise ValueError("prompt must be non-empty")
    out = generate(model, torch.from_numpy(toks.astype(np.int64))[None],
                   n_new, temperature=temperature, top_k=top_k, top_p=top_p,
                   generator=_generator(model, seed))
    new = out[0, toks.size:].cpu().numpy()
    return bytes(np.clip(new, 0, 255).astype(np.uint8)).decode(
        "utf-8", errors="replace")


def _generator(model: TransformerLM, seed: int) -> torch.Generator:
    return torch.Generator(device=model.pos_embed.device).manual_seed(seed)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpunet_torch.infer.generate",
                                description="tpunet_torch LM text "
                                            "generation")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--prompt", default="The ")
    p.add_argument("--tokens", type=int, default=128,
                   help="number of new tokens to generate")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; >0 samples softmax(logits/T)")
    p.add_argument("--top-k", type=int, default=0,
                   help="truncate sampling to the k most-likely tokens "
                        "(0 = off)")
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling: smallest cumulative-"
                        "probability mass to sample from (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    # Architecture of the trained checkpoint (must match training).
    p.add_argument("--model", choices=("lm", "lm_pp"), default="lm")
    p.add_argument("--vit-hidden", type=int, default=192)
    p.add_argument("--vit-depth", type=int, default=6)
    p.add_argument("--vit-heads", type=int, default=3)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="activation dtype (the parameters stay float32)")
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-every", type=int, default=2)
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--mesh-model", type=int, default=0,
                   help="tensor-parallel generation over this many ranks "
                        "(one process a rank, under torchrun)")
    p.add_argument("--dist-backend", choices=("auto", "nccl", "gloo"),
                   default="auto",
                   help="--mesh-model's process group: auto = NCCL on "
                        "the card, gloo on the CPU; gloo lets ranks share "
                        "one card")
    p.add_argument("--train-pipe", type=int, default=0)
    p.add_argument("--pp-virtual", type=int, default=2)
    p.add_argument("--prompt-format", choices=("auto", "bytes", "ids"),
                   default="auto",
                   help="how to read --prompt: 'bytes' = UTF-8 text "
                        "(byte-level --dataset text_lm checkpoints), "
                        "'ids' = space-separated token ids; 'auto' "
                        "picks bytes iff --vocab-size is 256")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    why = heads_error(args.vit_heads, args.mesh_model)
    if why:
        print(f"python -m tpunet_torch.infer.generate: error: {why}",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    byte_prompt = (args.vocab_size == 256 if args.prompt_format == "auto"
                   else args.prompt_format == "bytes")
    if byte_prompt and args.vocab_size != 256:
        # generate_text round-trips tokens as raw bytes; any other vocab
        # would silently clip sampled ids into [0, 255].
        raise SystemExit(f"--prompt-format bytes needs vocab-size 256 "
                         f"(got {args.vocab_size})")
    if (args.top_k or args.top_p) and args.temperature <= 0:
        raise SystemExit("--top-k/--top-p filter SAMPLING; set "
                         "--temperature > 0 (temperature 0 is greedy "
                         "decoding and would silently ignore them)")
    try:
        cfg = ModelConfig(name=args.model, vit_hidden=args.vit_hidden,
                          vit_depth=args.vit_depth, vit_heads=args.vit_heads,
                          vocab_size=args.vocab_size,
                          max_seq_len=args.max_seq_len, dropout_rate=0.0,
                          dtype=args.dtype,
                          moe_experts=args.moe_experts,
                          moe_every=args.moe_every, moe_top_k=args.moe_top_k,
                          moe_capacity_factor=args.moe_capacity_factor,
                          pp_virtual=args.pp_virtual)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from None
    prompt_toks = None
    if byte_prompt:
        prompt_len = len(args.prompt.encode("utf-8"))
        if prompt_len == 0:
            raise SystemExit("--prompt must be non-empty")
    else:
        try:
            prompt_toks = [int(t) for t in args.prompt.split()]
        except ValueError:
            raise SystemExit(
                f"--prompt-format ids takes the prompt as space-"
                f"separated token ids, e.g. --prompt '5 7 3'; got "
                f"{args.prompt!r} (use --prompt-format bytes for text)"
            ) from None
        if not prompt_toks:
            raise SystemExit("--prompt must contain at least one token id")
        bad = [t for t in prompt_toks if not 0 <= t < args.vocab_size]
        if bad:
            raise SystemExit(f"prompt token(s) {bad} outside "
                             f"[0, {args.vocab_size})")
        prompt_len = len(prompt_toks)
    if prompt_len + args.tokens > cfg.max_seq_len:
        raise SystemExit(f"prompt+tokens = {prompt_len + args.tokens} "
                         f"exceeds --max-seq-len {cfg.max_seq_len}")
    if args.mesh_model <= 1:
        _generate_and_print(args, cfg, args.device, None, prompt_toks)
        return
    try:
        try:
            mesh, device = init_tensor_parallel(
                args.mesh_model, args.device,
                None if args.dist_backend == "auto" else args.dist_backend)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        _generate_and_print(args, cfg, device, mesh, prompt_toks)
    finally:
        dist.destroy()
        set_mesh(None)


def _generate_and_print(args, cfg, device, mesh, prompt_toks) -> None:
    """Load, generate and (rank 0 alone under a mesh) print: the UTF-8
    continuation of ``--prompt``, or the ids after ``prompt_toks``."""
    model = load_lm(cfg, checkpoint_dir=args.checkpoint_dir,
                    device=device, train_pipe=args.train_pipe, mesh=mesh)
    if prompt_toks is None:
        out = args.prompt + generate_text(
            model, args.prompt, args.tokens, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    else:
        toks = generate(model, torch.tensor([prompt_toks]), args.tokens,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p,
                        generator=_generator(model, args.seed))
        out = " ".join(str(t) for t in toks[0].tolist())
    if dist.process_index() == 0:
        print(out, flush=True)


if __name__ == "__main__":
    main()
