"""``python -m tpunet_torch.train``: the training CLI, port of
``tpunet/main.py`` over the flags the port honours.

    python -m tpunet_torch.train --preset single              # on the card
    python -m tpunet_torch.train --preset serial --dataset synthetic \\
        --image-size 32 --width-mult 0.5 --dtype float32 --device cpu
    python -m tpunet_torch.train --model vit_base                 # ViT-B/16
    python -m tpunet_torch.train --model lm --dataset synthetic_lm  # the LM
    python -m tpunet_torch.train --model lm --dataset text_lm \
        --text-file corpus.txt --pack-docs                    # packed docs
    torchrun --standalone --nproc-per-node N -m tpunet_torch.train \
        --preset distributed                                  # N ranks

Presets: ``serial`` (batch 64), ``single`` (batch 128), ``distributed``
(128 a rank: data parallelism, the reference's MPI script). Under
``distributed`` each process joins the process group first, even alone
(one card still reduces through NCCL), from the launcher's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``--batch-size`` is per rank, and the global batch is that times the
world size; rank 0 materialises the dataset while the others wait; the
group is left on exit. Any other flag of tpunet's CLI is refused with an
error, never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpunet_torch.config import preset
from tpunet_torch.parallel import dist
from tpunet_torch.utils import log0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpunet_torch.train",
                                description="tpunet_torch trainer")
    p.add_argument("--preset", default="single",
                   choices=["serial", "single", "distributed"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch a step; per rank under --preset distributed")
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="eval batch (default: --batch-size)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["step", "cosine", "constant"],
                   help="step = the reference's StepLR(10, 0.1)")
    p.add_argument("--warmup-epochs", type=float, default=None)
    p.add_argument("--label-smoothing", type=float, default=None)
    p.add_argument("--optimizer", default=None,
                   choices=["adam", "adamw", "sgd"],
                   help="adam is the reference stack; adamw activates "
                        "--weight-decay; sgd uses momentum 0.9")
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global gradient-norm clip; 0 = off")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="microbatches accumulated per optimizer step "
                        "(strided rows of the batch)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dataset", default=None,
                   choices=["cifar10", "synthetic", "synthetic_lm",
                            "text_lm"])
    p.add_argument("--text-file", default=None,
                   help="byte-level corpus file for --dataset text_lm")
    p.add_argument("--pack-docs", action="store_true",
                   help="text_lm: pack newline-delimited documents into "
                        "seq_len rows with segment-masked attention and "
                        "loss (no cross-document attention/prediction)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="sequence length for token datasets (model lm)")
    p.add_argument("--max-seq-len", type=int, default=None,
                   help="LM position-table size (defaults to at least "
                        "--seq-len)")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="vocab for the lm model + synthetic_lm data")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic-size", type=int, default=None,
                   help="train-set size when --dataset synthetic (test: "
                        "a quarter of it)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate the saved checkpoint (best.pth if "
                        "present, else state.pt) and exit")
    p.add_argument("--pallas-depthwise", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="route the 3x3 depthwise convs through the "
                        "hand-written kernels (tpunet's flag name)")
    p.add_argument("--fused-ir", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="train-mode expand/project 1x1 convs through the "
                        "fused conv + BN-statistics kernels (default on)")
    p.add_argument("--model", default=None,
                   choices=["mobilenet_v2", "vit", "vit_tiny", "vit_small",
                            "vit_base", "vit_pp", "lm", "lm_pp"])
    p.add_argument("--vit-patch", type=int, default=None)
    p.add_argument("--vit-hidden", type=int, default=None)
    p.add_argument("--vit-depth", type=int, default=None)
    p.add_argument("--vit-heads", type=int, default=None)
    p.add_argument("--vit-mlp-ratio", type=float, default=None)
    p.add_argument("--attention", default=None,
                   choices=["auto", "dense", "blockwise", "flash", "ring",
                            "ulysses"],
                   help="ViT attention core: auto and flash run the "
                        "hand-written flash kernels on the card")
    p.add_argument("--attention-block", type=int, default=None,
                   help="K/V chunk for --attention blockwise; the TPU "
                        "block size of --attention flash")
    p.add_argument("--width-mult", type=float, default=None)
    p.add_argument("--dropout-rate", type=float, default=None)
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--log-every-steps", type=int, default=None,
                   help="a step/loss/lr line every N steps (0 = per epoch "
                        "only, like the reference)")
    return p


def _parse(argv=None) -> argparse.Namespace:
    parser = build_argparser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)} "
                     "(tpunet flags that tpunet_torch does not honour yet "
                     "are refused; ROADMAP Queue A lists what is ported)")
    return args


def config_from_args(argv=None):
    """(TrainConfig, device) of the command line ``argv``."""
    args = _parse(argv)
    return _config(args), args.device


def _config(args: argparse.Namespace):
    cfg = preset(args.preset)
    data, model, optim, ckpt = cfg.data, cfg.model, cfg.optim, cfg.checkpoint
    for dest, obj_field in (("batch_size", "batch_size"),
                            ("eval_batch_size", "eval_batch_size"),
                            ("image_size", "image_size"),
                            ("dataset", "dataset"), ("data_dir", "data_dir")):
        val = getattr(args, dest)
        if val is not None:
            data = dataclasses.replace(data, **{obj_field: val})
    if args.synthetic_size is not None:
        data = dataclasses.replace(
            data, synthetic_train_size=args.synthetic_size,
            synthetic_test_size=max(1, args.synthetic_size // 4))
    if args.text_file is not None:
        data = dataclasses.replace(data, text_path=args.text_file)
    if args.pack_docs:
        data = dataclasses.replace(data, pack_docs=True)
    if args.seq_len is not None:
        data = dataclasses.replace(data, seq_len=args.seq_len)
    fields = {}
    for dest, obj_field in (("model", "name"),
                            ("pallas_depthwise", "use_pallas_depthwise"),
                            ("fused_ir", "fused_ir"),
                            ("width_mult", "width_mult"),
                            ("dropout_rate", "dropout_rate"),
                            ("dtype", "dtype")) + tuple(
            (f, f) for f in ("vit_patch", "vit_hidden", "vit_depth",
                             "vit_heads", "vit_mlp_ratio", "attention",
                             "attention_block")):
        val = getattr(args, dest)
        if val is not None:
            fields[obj_field] = val
    if args.max_seq_len is not None:
        fields["max_seq_len"] = args.max_seq_len
    # tpunet grows the position table to cover the requested length.
    fields["max_seq_len"] = max(fields.get("max_seq_len", model.max_seq_len),
                                data.seq_len)
    if args.vocab_size is not None:
        data = dataclasses.replace(data, vocab_size=args.vocab_size)
        fields["vocab_size"] = args.vocab_size
    model = dataclasses.replace(model, **fields)
    for dest, obj_field in (("lr", "learning_rate"),
                            ("lr_schedule", "schedule"),
                            ("warmup_epochs", "warmup_epochs"),
                            ("label_smoothing", "label_smoothing"),
                            ("optimizer", "name"),
                            ("weight_decay", "weight_decay"),
                            ("clip_norm", "clip_norm"),
                            ("grad_accum", "grad_accum")):
        val = getattr(args, dest)
        if val is not None:
            optim = dataclasses.replace(optim, **{obj_field: val})
    if args.checkpoint_dir is not None:
        ckpt = dataclasses.replace(ckpt, directory=args.checkpoint_dir)
    if args.resume:
        ckpt = dataclasses.replace(ckpt, resume=True)
    cfg = cfg.replace(data=data, model=model, optim=optim, checkpoint=ckpt)
    for dest in ("epochs", "seed", "log_every_steps"):
        val = getattr(args, dest)
        if val is not None:
            cfg = cfg.replace(**{dest: val})
    if args.eval_only:
        cfg = cfg.replace(eval_only=True)
    return cfg


def run(argv=None):
    """Train (or ``--eval-only``) as the command line ``argv`` says and
    return the Trainer; under ``distributed`` inside the process group,
    which is left on the way out, on an error too."""
    args = _parse(argv)
    cfg = _config(args)
    if args.preset != "distributed":
        return _run(cfg, args.device)
    dist.initialize_distributed(device=args.device)
    try:
        ranks = dist.process_count()
        # The reference's per-rank batch of 128: the global batch grows
        # with the world (cifar10_mpi_mobilenet_224.py:117).
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, batch_size=cfg.data.batch_size * ranks))
        log0(f"Processes: {ranks} ({dist.backend_name()}), global batch "
             f"{cfg.data.batch_size}")
        if dist.process_index() == 0:
            # Rank 0 fetches the data first, the others wait (the
            # reference's rank-0 download and barrier, :93-102).
            from tpunet_torch.data import get_dataset
            get_dataset(cfg.data)
        dist.sync_hosts("dataset-ready")
        return _run(cfg, args.device)
    finally:
        dist.destroy()


def _run(cfg, device: str):
    # Imported here: the trainer pulls in the model and the kernels.
    from tpunet_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device)
    if cfg.eval_only:
        m = trainer.evaluate_checkpoint()
        log0(f"Eval: Test Loss: {m['loss']:.4f} "
             f"Test Acc: {m['accuracy']:.4f}")
    else:
        trainer.train()
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
