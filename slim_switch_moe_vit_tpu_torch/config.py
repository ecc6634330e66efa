"""Command-line flags of the training driver.

Port of ``slim_switch_moe_vit_tpu/config.py`` (reference ``main.py:47-456``
``get_args_parser``): every flag of the JAX package, with the same names
and the same defaults, but ``--device``, which defaults to ``cuda`` and
takes ``cpu``. ``main.py`` runs every one of them; ``--fused-optimizer``
with a flag that needs the optimizer chain raises there.
"""
from __future__ import annotations

import argparse


def get_args_parser():
    parser = argparse.ArgumentParser(
        "DeiT training and evaluation script (PyTorch, H100)", add_help=False
    )
    parser.add_argument("--batch-size", default=64, type=int)
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--bce-loss", action="store_true")
    parser.add_argument("--unscale-lr", action="store_true")

    # Model parameters
    parser.add_argument("--model", default="deit_base_patch16_224", type=str,
                        metavar="MODEL", help="Name of model to train")
    parser.add_argument("--input-size", default=224, type=int,
                        help="images input size")
    parser.add_argument("--drop", type=float, default=0.0, metavar="PCT",
                        help="Dropout rate (default: 0.)")
    parser.add_argument("--drop-path", type=float, default=0.1, metavar="PCT",
                        help="Drop path rate (default: 0.1)")

    parser.add_argument("--model-ema", action="store_true")
    parser.add_argument("--no-model-ema", action="store_false", dest="model_ema")
    parser.set_defaults(model_ema=True)
    parser.add_argument("--model-ema-decay", type=float, default=0.99996)
    parser.add_argument("--model-ema-force-cpu", action="store_true",
                        default=False, help="(no-op: the EMA lives on the device)")

    # Optimizer parameters
    parser.add_argument("--opt", default="adamw", type=str, metavar="OPTIMIZER")
    parser.add_argument("--opt-eps", default=1e-8, type=float, metavar="EPSILON")
    parser.add_argument("--opt-betas", default=None, type=float, nargs="+",
                        metavar="BETA")
    parser.add_argument("--clip-grad", type=float, default=None, metavar="NORM")
    parser.add_argument("--momentum", type=float, default=0.9, metavar="M")
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="commit checkpoints on a background thread")
    parser.add_argument("--fused-optimizer", action="store_true",
                        help="single-pass AdamW(+EMA) update, the K7 "
                             "kernel (ops/fused_adamw.py); the same math and "
                             "torch.optim.AdamW's state. adamw only: with "
                             "another --opt, --clip-grad or --attn-only it "
                             "raises ValueError")

    # Learning rate schedule parameters
    parser.add_argument("--sched", default="cosine", type=str, metavar="SCHEDULER")
    parser.add_argument("--lr", type=float, default=5e-4, metavar="LR")
    parser.add_argument("--lr-noise", type=float, nargs="+", default=None)
    parser.add_argument("--lr-noise-pct", type=float, default=0.67)
    parser.add_argument("--lr-noise-std", type=float, default=1.0)
    parser.add_argument("--warmup-lr", type=float, default=1e-6, metavar="LR")
    parser.add_argument("--min-lr", type=float, default=1e-5, metavar="LR")
    parser.add_argument("--decay-epochs", type=float, default=30, metavar="N")
    parser.add_argument("--warmup-epochs", type=int, default=5, metavar="N")
    parser.add_argument("--cooldown-epochs", type=int, default=10, metavar="N")
    parser.add_argument("--patience-epochs", type=int, default=10, metavar="N")
    parser.add_argument("--decay-rate", "--dr", type=float, default=0.1,
                        metavar="RATE")

    # Augmentation parameters
    parser.add_argument("--color-jitter", type=float, default=0.3, metavar="PCT")
    parser.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1",
                        metavar="NAME")
    parser.add_argument("--smoothing", type=float, default=0.1)
    parser.add_argument("--train-interpolation", type=str, default="bicubic")
    parser.add_argument("--repeated-aug", action="store_true")
    parser.add_argument("--no-repeated-aug", action="store_false",
                        dest="repeated_aug")
    parser.set_defaults(repeated_aug=True)
    parser.add_argument("--train-mode", action="store_true")
    parser.add_argument("--no-train-mode", action="store_false", dest="train_mode")
    parser.set_defaults(train_mode=True)
    parser.add_argument("--ThreeAugment", action="store_true")
    parser.add_argument("--src", action="store_true")

    # Random erase params
    parser.add_argument("--reprob", type=float, default=0.25, metavar="PCT")
    parser.add_argument("--remode", type=str, default="pixel")
    parser.add_argument("--recount", type=int, default=1)
    parser.add_argument("--resplit", action="store_true", default=False)

    # Mixup params
    parser.add_argument("--mixup", type=float, default=0.8)
    parser.add_argument("--cutmix", type=float, default=1.0)
    parser.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
    parser.add_argument("--mixup-prob", type=float, default=1.0)
    parser.add_argument("--mixup-switch-prob", type=float, default=0.5)
    parser.add_argument("--mixup-mode", type=str, default="batch")

    # Distillation parameters
    parser.add_argument("--teacher-model", default="regnety_160", type=str,
                        metavar="MODEL")
    parser.add_argument("--teacher-path", type=str, default="")
    parser.add_argument("--distillation-type", default="none",
                        choices=["none", "soft", "hard"], type=str)
    parser.add_argument("--distillation-alpha", default=0.5, type=float)
    parser.add_argument("--distillation-tau", default=1.0, type=float)

    # Finetuning params
    parser.add_argument("--finetune", default="", help="finetune from checkpoint")
    parser.add_argument("--attn-only", action="store_true")

    # Dataset parameters
    parser.add_argument("--data-path",
                        default="/datasets01/imagenet_full_size/061417/",
                        type=str)
    parser.add_argument("--data-set", default="IMNET",
                        choices=["CIFAR100", "CIFAR10", "CAR", "FLOWER",
                                 "IMNET", "IMNET100", "INAT", "INAT19",
                                 "SYNTH"],
                        type=str)
    parser.add_argument("--inat-category", default="name",
                        choices=["kingdom", "phylum", "class", "order",
                                 "supercategory", "family", "genus", "name"],
                        type=str)

    parser.add_argument("--output_dir", default="",
                        help="path where to save, empty for no saving")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to use for training / testing")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="", help="resume from checkpoint")
    parser.add_argument("--start_epoch", default=0, type=int, metavar="N")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--eval-crop-ratio", default=0.875, type=float)
    parser.add_argument("--dist-eval", action="store_true", default=False)
    parser.add_argument("--num_workers", default=10, type=int)
    parser.add_argument("--pin-mem", action="store_true")
    parser.add_argument("--no-pin-mem", action="store_false", dest="pin_mem")
    parser.set_defaults(pin_mem=True)

    # distributed training parameters
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--dist_url", default="env://")

    # token skipping parameters
    parser.add_argument("--starting-threshold", default=1.0, type=float,
                        help="starting token skip threshold (both gates)")
    parser.add_argument("--target-threshold", default=0.9, type=float,
                        help="target token skip threshold (both gates)")
    parser.add_argument("--gate-lr", default=1e-3, type=float,
                        help="separate learning rate for skip gates")
    parser.add_argument("--gate-epoch-offset", default=10, type=float,
                        help="epochs between successive gates starting to train")

    # continual learning
    parser.add_argument("--num-tasks", default=1, type=int,
                        help="number of tasks to split dataset into")
    parser.add_argument("--rehearsal", default=False, action="store_true")
    parser.add_argument("--rehearsal-batch-size", default=512, type=int)

    # ------------------------------------------------------------------
    # additions of the JAX package
    # ------------------------------------------------------------------
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="activation compute dtype (params stay fp32); "
                             "in place of AMP (reference engine.py:52)")
    parser.add_argument("--expert-parallel", default=1, type=int,
                        help="ranks of an expert group: the world splits "
                             "into world / N data shards x N expert ranks, "
                             "each holding E / N experts (the dropless "
                             "modes gather them on every rank)")
    parser.add_argument("--num-experts", default=8, type=int)
    parser.add_argument("--moe-top-k", default=2, type=int)
    parser.add_argument("--capacity-factor", default=2.0, type=float,
                        help="train-time expert capacity factor")
    parser.add_argument("--eval-capacity-factor", default=2.0, type=float)
    parser.add_argument("--moe-dispatch", default="auto",
                        choices=["auto", "fused", "ragged", "capacity",
                                 "capacity_fused", "capacity_fused_a2a",
                                 "expert_choice", "dense"],
                        help="MoE dispatch: fused (dropless + the expert "
                             "FFN kernel), ragged (dropless, one GEMM pair "
                             "per expert), dense (exact O(E) oracle), "
                             "capacity (per-expert buffers of "
                             "--capacity-factor slots, token-major drops; "
                             "plain), capacity_fused (the same drops through "
                             "the expert FFN kernel; capacity_fused_a2a is "
                             "the same on one card, the all-to-all form "
                             "under --expert-parallel > 1), expert_choice "
                             "(each expert takes its top capacity tokens; "
                             "plain). Under --expert-parallel > 1 the "
                             "capacity modes and expert_choice split the "
                             "experts' work and the dropless modes gather "
                             "the experts; under --drop > 0 in training "
                             "fused runs ragged and capacity_fused* "
                             "capacity. auto = fused, capacity under "
                             "--expert-parallel > 1")
    parser.add_argument("--moe-balance-weight", default=0.0, type=float,
                        help="aux load-balance loss weight (0 = FastMoE naive-"
                             "gate parity)")
    parser.add_argument("--parity-dense-moe", action="store_true",
                        help="exact dropless MoE (O(E) compute) for parity runs")
    parser.add_argument("--resmoe-mode", default="parity",
                        choices=["parity", "compact"],
                        help="token-skip execution: parity = reference zero-"
                             "mask semantics (full-length attention); compact"
                             " = gather top-capacity tokens and run short "
                             "sequences")
    parser.add_argument("--token-capacity", default=1.0, type=float,
                        help="fraction of tokens computed in compact mode")
    parser.add_argument("--use-flash-attention", action="store_true",
                        help="online-softmax attention kernel (K11) in eval "
                             "forwards")
    parser.add_argument("--compilation-cache-dir", default="", type=str,
                        help="compilation cache of the JAX package; the "
                             "port compiles nothing per step and ignores it")
    parser.add_argument("--synth-size", default=512, type=int,
                        help="SYNTH dataset size")
    parser.add_argument("--synth-classes", default=10, type=int)
    parser.add_argument("--synth-learnable", action="store_true",
                        help="SYNTH labels become a visual function of the "
                             "image (learning sanity check)")
    parser.add_argument("--max-steps-per-epoch", default=None, type=int,
                        help="truncate epochs (smoke tests)")
    return parser
