"""Text generation CLI for the LM, port of ``tpunet/infer/generate.py``.

Loads the LM's ``best.pth`` (the port's checkpoint layout), prefills the
prompt and decodes through the KV-cache step
(``tpunet_torch.models.lm.generate``). Byte-level checkpoints (trained
with ``--dataset text_lm``) round-trip UTF-8 text; other vocabs print
token ids.

    python -m tpunet_torch.infer.generate --checkpoint-dir ckpt \\
        --prompt "The " --tokens 256 --temperature 0.8

Runs on the card unless ``--device cpu``. The pipelined LM (``--model
lm_pp``), tensor-parallel serving (``--mesh-model``) and MoE
checkpoints (``--moe-*``) are refused until ROADMAP Queue A item 8.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpunet_torch.ckpt import BEST
from tpunet_torch.config import ModelConfig
from tpunet_torch.models import create_model
from tpunet_torch.models.convert import load_state_dict_file
from tpunet_torch.models.lm import TransformerLM, generate

_ITEM8 = "comes with ROADMAP Queue A item 8 (parallelism beyond DP, MoE)"


def load_lm(model_cfg: ModelConfig, checkpoint_dir: str,
            device: str = "cuda") -> TransformerLM:
    """The LM of ``model_cfg`` on ``device`` with the weights of
    ``<checkpoint_dir>/best.pth``; an empty ``checkpoint_dir`` serves the
    seeded random init (``create_model``'s generator seeded with 0), as
    tpunet's ``load_lm`` serves its ``PRNGKey(0)`` init."""
    if model_cfg.name != "lm":
        raise ValueError(f"generation needs the 'lm' model, got "
                         f"{model_cfg.name!r}")
    model = create_model(model_cfg, device=device)
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, BEST)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no best checkpoint under "
                                    f"{checkpoint_dir!r}")
        load_state_dict_file(path, model)
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
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-every", type=int, default=2)
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--mesh-model", type=int, default=0)
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
    if args.model == "lm_pp" or args.train_pipe:
        raise SystemExit(f"--model lm_pp (pipeline-trained checkpoints) "
                         f"{_ITEM8}")
    if args.mesh_model:
        raise SystemExit(f"--mesh-model (tensor-parallel serving) {_ITEM8}")
    if args.moe_experts:
        raise SystemExit(f"--moe-experts (MoE checkpoints) {_ITEM8}")
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
        cfg = ModelConfig(name="lm", vit_hidden=args.vit_hidden,
                          vit_depth=args.vit_depth, vit_heads=args.vit_heads,
                          vocab_size=args.vocab_size,
                          max_seq_len=args.max_seq_len, dropout_rate=0.0,
                          moe_every=args.moe_every, moe_top_k=args.moe_top_k,
                          moe_capacity_factor=args.moe_capacity_factor)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
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
    model = load_lm(cfg, checkpoint_dir=args.checkpoint_dir,
                    device=args.device)
    if byte_prompt:
        text = generate_text(model, args.prompt, args.tokens,
                             temperature=args.temperature, top_k=args.top_k,
                             top_p=args.top_p, seed=args.seed)
        print(args.prompt + text)
    else:
        out = generate(model, torch.tensor([prompt_toks]), args.tokens,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p,
                       generator=_generator(model, args.seed))
        print(" ".join(str(t) for t in out[0].tolist()))


if __name__ == "__main__":
    main()
