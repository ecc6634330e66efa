"""Training and evaluation driver, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/main.py`` (:55-475), in its order: the
per-task continual-learning loop with a fresh optimizer and schedule per
task; the gates disabled at a task's start and annealed epoch by epoch
after the plan; rehearsal replay after each epoch and the memory filled
after each task; per epoch a checkpoint, the evaluation on all classes and
on the task's, ``log.txt`` and the plateau sidecar; ``--eval`` and
``--resume``.

The run is on ``--device`` (``cuda`` unless ``cpu`` is passed; without a
GPU it raises, never falling back). Every ``--opt`` name of the JAX
package runs, with ``--clip-grad`` and ``--attn-only`` (``optim.py``);
``--fused-optimizer`` with any of them raises ``ValueError`` where the JAX
driver warns and takes the optimizer chain.

``--finetune`` loads a DeiT / timm ``.pth`` (or a jax-ViT ``.npz``) into
the fresh model before its optimizer is made; ``--distillation-type
soft|hard`` trains a ``*_distilled`` student against ``--teacher-model``
(``regnety_160`` by default) with ``--teacher-path``'s weights, the teacher
seeing the batch after the augmentation and mixup; ``--async-checkpoint``
writes each checkpoint on a background thread.

Data and expert parallelism (JAX :141-155): the ranks join the process
group the environment describes (``parallel.init_distributed_mode``:
torchrun's or SLURM's variables and ``--dist_url``), and
``--expert-parallel N`` lays them out as (world / N) data shards x N expert
ranks. The ranks of one expert group load the same batch (seed ``--seed``
+ the data index, the samplers over the data shards) and split the
experts; the dense parameters stay replicated and are checked bit-identical
over every rank after each epoch. The learning rate scales with the data
shards, under EP ``--moe-dispatch auto`` becomes ``capacity`` (JAX
:66-69), the dropless modes gather the experts on every rank, the
optimizer's global norms sum the expert tensors over the expert group, and
checkpoints and logs are written by rank 0 alone.

Run: ``python -m slim_switch_moe_vit_tpu_torch.main --data-set SYNTH``
(every other flag at its default: ``deit_base_patch16_224`` with
RandAugment, color jitter, random erasing, mixup and cutmix), or
``--model resmoe_small_patch16_224_expert8 --epochs 2 ...``; on 4 ranks,
``torchrun --nproc-per-node 4 -m slim_switch_moe_vit_tpu_torch.main
--expert-parallel 2 --moe-dispatch capacity_fused_a2a ...``
(``SSMV_DIST_BACKEND=gloo`` where the ranks share a card).
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import engine, losses, optim
from .config import get_args_parser
from .data import (
    DataLoader,
    DistributedSampler,
    RASampler,
    SequentialSampler,
    build_dataset,
    build_device_augment,
    build_eval_normalize,
    build_split_dataset,
    make_mixup_fn,
    mixup_active,
)
from .models import create_model
from .parallel import collectives
from .parallel.distributed import init_distributed_mode, is_main_process
from .parallel.sharding import is_expert_param, make_mesh, shard_params
from .models.gates import (
    apply_epoch_anneal,
    build_anneal_plan,
    disable_all,
    gate_paths,
)
from .train_state import create_train_state
from .models.regnet import import_torch_regnet
from .utils.checkpoint import (
    import_flax_npz,
    import_torch_checkpoint,
    load_checkpoint_sched,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from .utils.device import resolve_device
from .utils.logging import TensorboardTracker, append_log_stats
from .utils.memory import RehearsalMemory


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def _refuse_fused_optimizer_chain(args) -> None:
    """``--fused-optimizer`` runs K7, AdamW alone: raise for a combination
    that needs the optimizer chain (the JAX driver warns and takes the
    chain, main.py:190-193; the port does not fall back off a kernel
    quietly)."""
    if not args.fused_optimizer:
        return
    chain = [flag for flag, on in (
        (f"--opt {args.opt}", args.opt != "adamw"),
        (f"--clip-grad {args.clip_grad}", (args.clip_grad or 0) > 0),
        ("--attn-only", args.attn_only)) if on]
    if chain:
        raise ValueError(
            f"--fused-optimizer runs the fused AdamW kernel (K7), which has "
            f"no form for {', '.join(chain)}; drop --fused-optimizer")


def finetune_from(path: str, model) -> None:
    """Load foreign weights into the freshly built ``model`` (JAX main.py
    :198-201): an ``.npz`` through ``import_flax_npz``, anything else as a
    DeiT / timm ``.pth`` through ``import_torch_checkpoint``."""
    print(f"Finetuning from {path}")
    if str(path).endswith(".npz"):
        import_flax_npz(path, model)
    else:
        import_torch_checkpoint(path, model)


def build_teacher(args, nb_classes: int):
    """The distillation teacher (JAX main.py:213-241): the registered
    ``--teacher-model`` in f32 with ``--teacher-path``'s weights (timm's
    RegNet names for a ``regnet*`` model, a DeiT ``.pth`` otherwise),
    frozen, in eval mode, on ``--device``. Returns ``teacher_apply(images)
    -> logits``."""
    print(f"Creating teacher model: {args.teacher_model}")
    teacher = create_model(args.teacher_model, num_classes=nb_classes,
                           img_size=args.input_size)
    if "regnet" in args.teacher_model:
        import_torch_regnet(args.teacher_path, teacher)
    else:
        import_torch_checkpoint(args.teacher_path, teacher)
    teacher = teacher.to(resolve_device(args.device)).eval()
    teacher.requires_grad_(False)

    def teacher_apply(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return teacher(images.float())

    teacher_apply.model = teacher
    return teacher_apply


def build_model(args, nb_classes: int, seed: int):
    kwargs = dict(
        num_classes=nb_classes,
        drop_rate=args.drop,
        drop_path_rate=args.drop_path,
        img_size=args.input_size,
        dtype=_dtype(args),
        use_flash=args.use_flash_attention,
    )
    if "moe" in args.model:
        dispatch = args.moe_dispatch
        if dispatch == "auto" and args.expert_parallel > 1:
            dispatch = "capacity"  # the JAX driver's EP default (:66-69)
        kwargs.update(
            starting_threshold=args.starting_threshold,
            target_threshold=args.target_threshold,
            num_experts=args.num_experts,
            moe_top_k=args.moe_top_k,
            capacity_factor=args.capacity_factor,
            eval_capacity_factor=args.eval_capacity_factor,
            parity_dense=args.parity_dense_moe,
            dispatch_mode=dispatch,
            resmoe_mode=args.resmoe_mode,
            token_capacity=args.token_capacity,
        )
    return create_model(args.model,
                        generator=torch.Generator().manual_seed(seed),
                        **kwargs)


def _make_loaders(args, dataset_train, dataset_val, task_dataset_val, mesh):
    # the data shards: the ranks of one expert group load the same batches
    replicas, shard = mesh.n_data, mesh.data_index
    if args.repeated_aug:
        sampler_train = RASampler(len(dataset_train), replicas, shard,
                                  shuffle=True)
        if len(dataset_train) and not len(sampler_train):
            # RASampler truncates to floor(len/256)*256 (reference
            # samplers.py:37-38): below 256 samples an epoch has no step
            print(f"WARNING: RASampler selected 0 of {len(dataset_train)} "
                  "samples (floor(len/256)*256 truncation); use "
                  "--no-repeated-aug for datasets smaller than 256 samples")
    else:
        sampler_train = DistributedSampler(len(dataset_train), replicas,
                                           shard, shuffle=True)
    if args.dist_eval:
        sampler_val = DistributedSampler(len(dataset_val), replicas, shard,
                                         shuffle=False)
    else:
        sampler_val = SequentialSampler(len(dataset_val))

    loader_train = DataLoader(dataset_train, sampler_train, args.batch_size,
                              drop_last=True, num_workers=args.num_workers)
    loader_val = DataLoader(dataset_val, sampler_val,
                            int(1.5 * args.batch_size), drop_last=False,
                            num_workers=args.num_workers)
    loader_task_val = DataLoader(
        task_dataset_val, SequentialSampler(len(task_dataset_val)),
        int(1.5 * args.batch_size), drop_last=False,
        num_workers=args.num_workers)
    return sampler_train, loader_train, loader_val, loader_task_val


def check_dense_replicas(model) -> int:
    """Raise unless every rank of the process group holds bit-identical
    dense parameters; returns their digest."""
    digest = dense_digest(model)
    t = torch.tensor([digest], dtype=torch.int64,
                     device=next(model.parameters()).device)
    everyone = collectives.gather_rows(t, torch.distributed.group.WORLD)
    if (everyone != t).any():
        raise RuntimeError(f"dense replicas differ over the ranks: digests "
                           f"{everyone.tolist()}")
    return digest


def dense_digest(model) -> int:
    """A digest of the dense (non-expert) parameters' exact bits: the sum
    of their f32 bit patterns as integers."""
    total = 0
    for name, p in model.named_parameters():
        if not is_expert_param(name):
            bits = p.detach().float().contiguous().view(torch.int32)
            total += int(bits.to(torch.int64).sum().item())
    return total


def main(args):
    """Train (or, with ``--eval``, evaluate); returns the final train
    state."""
    if args.opt not in optim.SUPPORTED_OPTIMIZERS:
        raise ValueError(f"--opt {args.opt!r} is not implemented; supported: "
                         f"{optim.SUPPORTED_OPTIMIZERS}")
    if args.sched not in optim.SUPPORTED_SCHEDULERS:
        raise ValueError(f"--sched {args.sched!r} is not implemented; "
                         f"supported: {optim.SUPPORTED_SCHEDULERS}")
    _refuse_fused_optimizer_chain(args)
    if args.distillation_type != "none" and not args.teacher_path:
        raise ValueError("need to specify teacher-path when using "
                         "distillation")
    resolve_device(args.device)
    init_distributed_mode(args)
    print(args)
    mesh = make_mesh(n_data=-1, n_expert=args.expert_parallel)

    # one seed per data shard: the ranks of an expert group draw the same
    # augmentations and DropPath masks for the batch they share
    seed = args.seed + mesh.data_index
    np.random.seed(seed)
    torch.manual_seed(seed)

    dataset_val, nb_classes = build_dataset(is_train=False, args=args)
    args.nb_classes = nb_classes

    mix_on = mixup_active(args.mixup, args.cutmix, args.cutmix_minmax)
    mixup_fn = None
    if mix_on:
        mixup_fn = make_mixup_fn(
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
            cutmix_minmax=args.cutmix_minmax, prob=args.mixup_prob,
            switch_prob=args.mixup_switch_prob,
            label_smoothing=args.smoothing, num_classes=nb_classes)

    print(f"Creating model: {args.model}")
    model = build_model(args, nb_classes, args.seed)  # the same on every rank
    if args.finetune:
        finetune_from(args.finetune, model)
    if mesh.n_data * mesh.n_expert > 1:
        shard_params(model, mesh)

    # on-device augmentation: the host ships uint8 crops
    device_augment = build_device_augment(
        input_size=args.input_size, aa=args.aa,
        color_jitter=args.color_jitter, reprob=args.reprob,
        recount=args.recount, three_augment=args.ThreeAugment)
    eval_normalize = build_eval_normalize(dtype=_dtype(args))

    betas = tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999)
    opt_init, opt_update = optim.make_optimizer(
        opt=args.opt, weight_decay=args.weight_decay, betas=betas,
        eps=args.opt_eps, momentum=args.momentum, clip_grad=args.clip_grad,
        trainable_mask=optim.attn_only_mask if args.attn_only else None,
        expert_group=mesh.expert_group)
    state = create_train_state(model, device=args.device, seed=seed,
                               opt_init=opt_init, use_ema=args.model_ema)
    n_parameters = sum(  # the whole model's, every expert counted
        p.numel() * (mesh.n_expert if is_expert_param(n) else 1)
        for n, p in model.named_parameters())
    print("number of params:", n_parameters)

    # linear lr scaling (reference main.py:615-617) by the data shards
    lr = optim.scaled_lr(args.lr, args.batch_size, mesh.n_data,
                         args.unscale_lr)
    base_criterion = losses.make_base_criterion(mix_on, args.smoothing,
                                                args.bce_loss)
    teacher_apply = None
    if args.distillation_type != "none":
        teacher_apply = build_teacher(args, nb_classes)
    train_step_pre = engine.make_train_step(
        model, opt_update, base_criterion,
        distillation_type=args.distillation_type,
        alpha=args.distillation_alpha, tau=args.distillation_tau,
        teacher_apply=teacher_apply,
        ema_decay=args.model_ema_decay if args.model_ema else None,
        moe_balance_weight=args.moe_balance_weight, mixup_fn=mixup_fn,
        bce_loss=args.bce_loss, augment_fn=device_augment,
        set_training_mode=args.train_mode,
        use_fused_optimizer=args.fused_optimizer, mesh=mesh)
    eval_step_pre = engine.make_eval_step(model, preprocess_fn=eval_normalize)

    output_dir_root = args.output_dir
    writer = None
    if output_dir_root:
        timestr = time.strftime("%Hh%Mm%Ss_on_%b_%d_%Y")
        tb_dir = os.path.join(output_dir_root, timestr)
        if is_main_process():
            os.makedirs(tb_dir, exist_ok=True)
            writer = TensorboardTracker(tb_dir)
    output_dir = Path(output_dir_root) if output_dir_root else None

    start_epoch = args.start_epoch
    if args.resume:
        state, last_epoch = restore_checkpoint(args.resume, state, mesh=mesh)
        if not args.eval:
            start_epoch = last_epoch + 1
        print(f"Resumed from {args.resume} at epoch {last_epoch}")

    memory_replay = None
    if args.rehearsal:
        print("setting up rehearsal memory")
        memory_replay = RehearsalMemory(
            args.rehearsal_batch_size, (3, args.input_size, args.input_size),
            (nb_classes,), use_indices=True)

    last_task_end = 0
    start_time = time.time()
    for task_idx in range(args.num_tasks):
        # fresh optimizer + schedule per task (reference main.py:729-734)
        state.optimizer = opt_init(model)
        sched = optim.create_scheduler(
            args.sched, lr, args.epochs,
            warmup_epochs=args.warmup_epochs,
            warmup_lr=args.warmup_lr, min_lr=args.min_lr,
            cooldown_epochs=args.cooldown_epochs,
            decay_epochs=args.decay_epochs, decay_rate=args.decay_rate,
            patience_epochs=args.patience_epochs,
            noise_range=args.lr_noise, noise_pct=args.lr_noise_pct,
            noise_std=args.lr_noise_std, noise_seed=args.seed)
        if args.resume and task_idx == 0 and hasattr(sched, "load_state_dict"):
            # plateau is stateful: restore its sidecar (reference
            # main.py:714-718)
            sched_state = load_checkpoint_sched(args.resume)
            if sched_state is not None:
                sched.load_state_dict(sched_state)
                print(f"Resumed scheduler state: {sched_state}")

        current_task_end = (nb_classes * (task_idx + 1)) // args.num_tasks
        task_nb = current_task_end - last_task_end
        dataset_train, _, dataset_indices = build_split_dataset(
            True, args, start_class=last_task_end, class_size=task_nb)
        task_dataset_val, _, _ = build_split_dataset(
            False, args, start_class=last_task_end, class_size=task_nb)
        sampler_train, loader_train, loader_val, loader_task_val = \
            _make_loaders(args, dataset_train, dataset_val, task_dataset_val,
                          mesh)

        if args.eval:
            test_stats = engine.evaluate(state, eval_step_pre, loader_val,
                                         max_steps=args.max_steps_per_epoch)
            print(f"Accuracy of the network on the {len(dataset_val)} "
                  f"test images: {test_stats['acc1']:.1f}%")
            return state

        print(f"Starting task {task_idx + 1}/{args.num_tasks}, learning "
              f"{task_nb} classes ({last_task_end}:{current_task_end}) "
              f"for {args.epochs} epochs")
        max_accuracy = 0.0

        # gate anneal plan + disable (reference main.py:808-820)
        anneal_plan = {}
        if gate_paths(model):
            anneal_plan = build_anneal_plan(model, args.epochs,
                                            args.warmup_epochs,
                                            args.gate_epoch_offset)
            disable_all(model)

        for epoch in range(max(task_idx * args.epochs, start_epoch),
                           (task_idx + 1) * args.epochs):
            sampler_train.set_epoch(epoch)
            ds = loader_train.dataset
            tf = getattr(ds, "transform", None) or getattr(
                getattr(ds, "dataset", None), "transform", None)
            if hasattr(tf, "set_epoch"):
                tf.set_epoch(epoch)
            epoch_in_task = epoch - task_idx * args.epochs
            lr_e = sched(epoch_in_task)
            lr_gate_e = args.gate_lr * (lr_e / lr if lr > 0 else 1.0)

            state, train_stats = engine.train_one_epoch(
                state, train_step_pre, loader_train, epoch,
                lr_base=lr_e, lr_gate=lr_gate_e,
                max_steps=args.max_steps_per_epoch)

            # rehearsal replay (reference main.py:841-883)
            if args.rehearsal and len(memory_replay):
                idxs = memory_replay.batch
                samples = np.stack(
                    [dataset_train.dataset[int(i)][0] for i in idxs])
                targets = np.asarray(
                    [dataset_train.dataset[int(i)][1] for i in idxs],
                    np.int64)
                state, metrics = train_step_pre(
                    state, torch.from_numpy(samples),
                    torch.from_numpy(targets), lr_e, lr_gate_e)
                print(f"Rehearsal:  lr: {lr_e}  "
                      f"loss: {float(metrics['loss'])}")

            # gate anneal step (reference main.py:886-891)
            if anneal_plan:
                apply_epoch_anneal(model, anneal_plan, epoch_in_task)

            if output_dir:
                # args ride with every checkpoint (reference main.py:898-906)
                extra = {"args": vars(args)}
                if hasattr(sched, "state_dict"):
                    extra["sched"] = sched.state_dict()
                save_checkpoint(str(output_dir / "checkpoint"), state, epoch,
                                extra=extra, is_main=is_main_process(),
                                mesh=mesh, use_async=args.async_checkpoint)
            if mesh.n_data * mesh.n_expert > 1:
                print(f"dense parameters bit-identical over "
                      f"{mesh.n_data * mesh.n_expert} rank(s), digest "
                      f"{check_dense_replicas(model)}")

            test_stats = engine.evaluate(state, eval_step_pre, loader_val,
                                         max_steps=args.max_steps_per_epoch)
            print(f"Accuracy of the network on the {len(dataset_val)} "
                  f"test images: {test_stats['acc1']:.1f}%")
            task_test_stats = engine.evaluate(
                state, eval_step_pre, loader_task_val,
                max_steps=args.max_steps_per_epoch)
            print(f"Accuracy of the network on the {len(task_dataset_val)} "
                  f"test images for this task: "
                  f"{task_test_stats['acc1']:.1f}%")
            if hasattr(sched, "observe"):
                # plateau: feed the epoch's eval acc1, as timm's loop does;
                # the sidecar saved above predates it, so rewrite it
                sched.observe(epoch_in_task, test_stats["acc1"])
                if output_dir and is_main_process():
                    with open(output_dir / "checkpoint.sched.json", "w") as f:
                        json.dump(sched.state_dict(), f, indent=2)

            if writer:
                writer.log_task_test_acc(task_test_stats["acc1"], epoch)
                writer.log_test_acc(test_stats["acc1"], epoch)
                if "loss" in train_stats:
                    writer.log_loss(train_stats["loss"], epoch)

            if max_accuracy < test_stats["acc1"]:
                max_accuracy = test_stats["acc1"]
                if output_dir:
                    save_checkpoint(str(output_dir / "best_checkpoint"),
                                    state, epoch, extra={"args": vars(args)},
                                    is_main=is_main_process(), mesh=mesh,
                                    use_async=args.async_checkpoint)
            print(f"Max accuracy: {max_accuracy:.2f}%")
            if writer:
                writer.log_scalar("max_acc", max_accuracy, epoch)

            log_stats = {
                **{f"train_{k}": v for k, v in train_stats.items()},
                **{f"test_{k}": v for k, v in test_stats.items()},
                "epoch": epoch,
                "n_parameters": n_parameters,
            }
            if output_dir and is_main_process():
                append_log_stats(str(output_dir), log_stats)

        # add task samples to rehearsal memory (reference main.py:964-972)
        if args.rehearsal:
            print("Sampling from recently completed task to add to "
                  "rehearsal memory...")
            max_samples = args.rehearsal_batch_size // (task_idx + 1)
            pick = np.random.permutation(len(dataset_indices))[:max_samples]
            chosen = np.asarray(dataset_indices)[pick]
            memory_replay.add(chosen, chosen, len(chosen))

        last_task_end = current_task_end
        start_epoch = 0  # the resume offset applies to the first task only

    wait_for_checkpoints()  # asynchronous saves land before the exit
    total_time = time.time() - start_time
    print("Training time {}".format(
        str(datetime.timedelta(seconds=int(total_time)))))
    if writer:
        writer.close()
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        "DeiT training and evaluation script (PyTorch, H100)",
        parents=[get_args_parser()])
    args = parser.parse_args()
    if args.output_dir:
        Path(args.output_dir).mkdir(parents=True, exist_ok=True)
    main(args)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
