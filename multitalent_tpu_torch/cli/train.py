"""Train a configuration on one GPU or data-parallel over several, then validate it.

Counterpart of multitalent_tpu/cli/train.py (nnunet/run/run_training.py): the
same arguments plus --device (default cuda; cpu runs the kernels' plain
PyTorch versions). Resolves (network, task, trainer, plans identifier) to the
plans file, stage and output folder
RESULTS/nnUNet/<network>/<task>/<trainer>__<plans identifier>, then
initialize -> [-pretrained_weights] -> [resume with -c] -> run_training
(fold_X/model_final_checkpoint.model) -> trainer.validate (fold_X/<--val_folder>:
the exported validation cases, summary(_<task>).json, and for softmax
trainers postprocessing.json unless --disable_postprocessing_on_folds;
--npz keeps softmax probabilities).

    python -m multitalent_tpu_torch.cli.train 3d_fullres MultiTalent_trainer_ddp TASK 0
    ... -val [--valbest]           validate model_final_checkpoint (model_best) only
    ... nnUNetTrainerV2_warmupsegheads TASK 0 -pretrained_weights x.ckpt|x.model
    ... MultiTalent_trainer_resenc_ddp TASK 0 -p PLANS_ID   the residual-encoder
                                   UNet, on plans with num_blocks_encoder/decoder
    ... MultiTalent_trainer_SwinUNETR_ddp_adam TASK 0        SwinUNETR (a patch
                                   divisible by 32), also nnUNetTrainerV2_swinunetr_adam_ddp
    ... MultiTalent_meets_mednext TASK 0                     MedNeXt (a patch
                                   divisible by 16), also Multitalent_mednextt
    python -m multitalent_tpu_torch.cli.train 3d_lowres TrainerV2 TASK 0
    ... 3d_cascade_fullres TrainerV2CascadeFullRes TASK 0    the cascade, on a
                                   two-stage plan
    ... 2d TrainerV2 TASK 0        the 2D plans (<plans id>_plans_2D.pkl, e.g. of
                                   plan_and_preprocess -pl2d ExperimentPlanner2D_v21):
                                   trains and writes its checkpoints, then the
                                   validation raises NotImplementedError, as the JAX
                                   CLI's raises a ValueError (neither predicts 2D)
    ... 3d_fullres nnUNetTrainerV2_GN TASK 0                 a variant trainer
                                   (training/variants.py: networks, augmentation,
                                   losses, optimizers, schedules, e.g.
                                   nnUNetTrainerV2_Loss_DiceTopK10, _Ranger,
                                   _reduceMomentumDuringTraining, _lReLU_convReLUIN);
                                   nnUNetTrainerV2_fp32 (or --fp32) computes in
                                   fp32 on the kernels' fp32 forms

After 3d_lowres (and its validation) the CLI loads the fold's best
checkpoint and writes the next stage's input, every case's labelmap resampled
to the full-resolution grid (training/cascade.predict_next_stage:
<data_identifier>_stage{stage+1}/<case>_segFromPrevStage.npz), which
3d_cascade_fullres trains and validates on.

-pretrained_weights takes a JAX `.ckpt` or a reference / port `.model` and
transfers every backbone weight of matching name and shape (never the heads);
with -c it is ignored.

Training spans every visible card (CUDA_VISIBLE_DEVICES narrows them; -gpus
N takes N), one process a card over NCCL, as the JAX CLI spans every device
of its mesh; `--device cpu -gpus N` runs N gloo ranks on the CPU. The CLI
starts the ranks itself, or joins the group when a launcher started it
(torchrun, or torch.distributed.launch with --local_rank; RANK and
WORLD_SIZE set, a group even at world size 1):

    torchrun --nproc_per_node=N -m multitalent_tpu_torch.cli.train 3d_fullres ...

The plans' batch is the global batch, always split over the ranks
(parallel/distributed.py; --dbs is accepted and changes nothing). A global
batch smaller than the rank count trains under the JAX package's hybrid
data x space plan (parallel/mesh.py: data = gcd(batch, ranks) groups, each
splitting its samples' patch over the rest); where no patch axis divides,
the plan trains on gcd ranks and the others exit idle, with a WARNING.
Every rank reads -c's checkpoint and -pretrained_weights; rank 0 writes the
folder; the validation splits its cases over the training ranks. Refused:
more ranks than cards, and under a space plan what does not train so yet
(trainers.space_plan_refusal: the fused route, SwinUNETR, MedNeXt, 2D plans,
other norms and losses; ROADMAP queue 1, items 14b-14f).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli.configuration import resolve_task_name
from multitalent_tpu_torch.inference.model_restore import checkpoint_state_dict
from multitalent_tpu_torch.parallel import distributed, mesh
from multitalent_tpu_torch.plans import load_plans
from multitalent_tpu_torch.training.multitalent import (MultiTalentTrainer,
                                                        MultiTalentTrainer2000ep,
                                                        MultiTalentTrainerMedNeXt,
                                                        MultiTalentTrainerResenc,
                                                        MultiTalentTrainerResenc2000ep,
                                                        MultiTalentTrainerSwinUNETR)
from multitalent_tpu_torch.training.cascade import CASCADE_TRAINERS, predict_next_stage
from multitalent_tpu_torch.training.trainers import (TrainerV2, TrainerV2_2epochs,
                                                     TrainerV2_5epochs, TrainerV2_dummyLoad,
                                                     TrainerV2ResencUNet, space_plan_refusal)
from multitalent_tpu_torch.training.variants import VARIANT_ALIASES
from multitalent_tpu_torch.training.warmup import (TrainerV2WarmupLR, TrainerV2WarmupSegHeads,
                                                   TrainerV2WarmupSegHeadsResenc,
                                                   TrainerV2WarmupSegHeadsSwin,
                                                   load_pretrained_weights)

# trainer names of the reference and of the JAX package -> the port's classes
TRAINERS = {
    # the copies and the fp16 name are the production trainer (variants.py:766)
    **dict.fromkeys(("TrainerV2", "nnUNetTrainerV2", "nnUNetTrainerV2_DP",
                     "nnUNetTrainerV2_DDP", "nnUNetTrainer", "nnUNetTrainerV2_copy1",
                     "nnUNetTrainerV2_copy2", "nnUNetTrainerV2_copy3", "nnUNetTrainerV2_copy4",
                     "nnUNetTrainerV2_fp16"), TrainerV2),
    **dict.fromkeys(("MultiTalentTrainer", "MultiTalent_trainer_ddp"), MultiTalentTrainer),
    **dict.fromkeys(("MultiTalentTrainer2000ep", "MultiTalent_trainer_ddp_2000ep"),
                    MultiTalentTrainer2000ep),
    **dict.fromkeys(("TrainerV2WarmupLR", "nnUNetTrainerV2_warmup_increasing_lr",
                     "nnUNetTrainerV2_warmup"), TrainerV2WarmupLR),
    **dict.fromkeys(("TrainerV2WarmupSegHeads", "nnUNetTrainerV2_warmupsegheads"),
                    TrainerV2WarmupSegHeads),
    **dict.fromkeys(("TrainerV2ResencUNet", "nnUNetTrainerV2_ResencUNet",
                     "nnUNetTrainerV2_ResencUNet_SimonsInit",
                     "nnUNetTrainerV2_ResencUNet_SimonsInit_20fold"), TrainerV2ResencUNet),
    **dict.fromkeys(("MultiTalentTrainerResenc", "MultiTalent_trainer_resenc_ddp"),
                    MultiTalentTrainerResenc),
    # the released zip names its 2000-epoch trainer MultiTalent_tainer_resenc_ddp
    **dict.fromkeys(("MultiTalentTrainerResenc2000ep", "MultiTalent_trainer_resenc_ddp_2000ep",
                     "MultiTalent_tainer_resenc_ddp"), MultiTalentTrainerResenc2000ep),
    **dict.fromkeys(("TrainerV2WarmupSegHeadsResenc", "nnUNetTrainerV2_warmupsegheads_resenc"),
                    TrainerV2WarmupSegHeadsResenc),
    **dict.fromkeys(("MultiTalentTrainerMedNeXt", "Multitalent_mednextt",
                     "MultiTalent_meets_mednext"), MultiTalentTrainerMedNeXt),
    # SwinUNETR; the released zip spells one trainer MultiTalent_tainer_...
    **dict.fromkeys(("MultiTalentTrainerSwinUNETR", "MultiTalent_trainer_SwinUNETR_ddp_adam",
                     "MultiTalent_tainer_SwinUNETR_ddp_adam"), MultiTalentTrainerSwinUNETR),
    # the variant zoo under its class names and reference aliases
    **{name: cls for cls, aliases in VARIANT_ALIASES.items()
       for name in (cls.__name__, *aliases)},
    **dict.fromkeys(("TrainerV2WarmupSegHeadsSwin",
                     "nnUNetTrainerV2_warmupsegheads_swinunetr_adam_lr5e4_ddp"),
                    TrainerV2WarmupSegHeadsSwin),
    # the cascade's full-resolution stage and its variants
    **CASCADE_TRAINERS,
    # the reference's benchmarking trainers
    **dict.fromkeys(("TrainerV2_2epochs", "nnUNetTrainerV2_2epochs"), TrainerV2_2epochs),
    **dict.fromkeys(("TrainerV2_5epochs", "nnUNetTrainerV2_5epochs",
                     "nnUNetTrainerV2_DDP_5epochs"), TrainerV2_5epochs),
    **dict.fromkeys(("TrainerV2_dummyLoad", "nnUNetTrainerV2_5epochs_dummyLoad",
                     "nnUNetTrainerV2_DDP_5epochs_dummyLoad"), TrainerV2_dummyLoad),
}


def get_default_configuration(network: str, task: str, network_trainer: str,
                              plans_identifier: str | None = None):
    """The path logic of multitalent_tpu/cli/configuration.py:27 with the
    port's trainer classes: (plans_file, output_folder, dataset_directory,
    batch_dice, stage, trainer_class). 2d (the `_plans_2D.pkl` plans) and
    3d_lowres take a plan's first stage with batch dice, 3d_fullres and
    3d_cascade_fullres its last without."""
    if network not in ("2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres"):
        raise ValueError(f"network {network!r}: one of 2d, 3d_fullres, 3d_lowres, "
                         "3d_cascade_fullres")
    if network_trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {network_trainer!r}; known: {sorted(TRAINERS)}")
    plans_identifier = plans_identifier or paths.default_plans_identifier
    task = resolve_task_name(task)
    dataset_directory = os.path.join(paths.preprocessing_output_dir(), task)
    suffix = "_plans_2D.pkl" if network == "2d" else "_plans_3D.pkl"
    plans_file = os.path.join(dataset_directory, plans_identifier + suffix)
    if not os.path.isfile(plans_file):
        raise FileNotFoundError(f"plans file not found: {plans_file}")
    stages = sorted(load_plans(plans_file).plans_per_stage)
    if network in ("3d_lowres", "3d_cascade_fullres") and len(stages) == 1:
        raise RuntimeError("3d_lowres/3d_cascade_fullres requires a multi-stage plan; this "
                           "dataset does not need a cascade. Use 3d_fullres.")
    first = network in ("2d", "3d_lowres")
    stage = stages[0] if first else stages[-1]
    output_folder = os.path.join(paths.network_training_output_dir(), network, task,
                                 network_trainer + "__" + plans_identifier)
    return (plans_file, output_folder, dataset_directory, first, stage,
            TRAINERS[network_trainer])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres",
                                            "3d_cascade_fullres"])
    parser.add_argument("network_trainer")
    parser.add_argument("task", help="task name or id")
    parser.add_argument("fold", help="0-11 or 'all'")
    parser.add_argument("-val", "--validation_only", action="store_true")
    parser.add_argument("-c", "--continue_training", action="store_true")
    parser.add_argument("-p", default=None, help="plans identifier")
    parser.add_argument("--use_compressed_data", action="store_true")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--npz", action="store_true",
                        help="keep the validation's softmax probabilities (.npz)")
    parser.add_argument("--fp32", action="store_true",
                        help="fp32 compute instead of bf16")
    parser.add_argument("--valbest", action="store_true",
                        help="-val: validate model_best instead of model_final_checkpoint")
    parser.add_argument("--val_folder", default="validation_raw",
                        help="the validation's folder under fold_X")
    parser.add_argument("--disable_postprocessing_on_folds", action="store_true",
                        help="skip determine_postprocessing after validation")
    parser.add_argument("-gpus", type=int, default=None,
                        help="ranks to train on (default: every visible card; 1 on the cpu)")
    parser.add_argument("--dbs", action="store_true",
                        help="accepted: the global batch is always split over the ranks")
    parser.add_argument("--local_rank", type=int, default=None,
                        help="set by torch.distributed.launch: this rank's card")
    parser.add_argument("-pretrained_weights", default=None,
                        help="a JAX .ckpt or a .model whose backbone weights to start from")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (hand-written kernels) or cpu "
                             "(their plain PyTorch versions)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    device_type = torch.device(args.device).type
    config = get_default_configuration(args.network, args.task, args.network_trainer, args.p)

    if distributed.launched():
        return _join_and_train(args, config, device_type)
    if args.gpus is not None:
        ranks = args.gpus
    else:
        # without a card the trainer refuses the cuda device itself
        ranks = max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1
    if ranks < 1:
        raise ValueError(f"-gpus {ranks}: at least one rank is needed")
    if device_type == "cuda" and ranks > torch.cuda.device_count():
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, but "
                           f"{torch.cuda.device_count()} are visible")
    if ranks == 1:
        return _train(args, config, args.device)
    plans_file, stage, trainer_class = config[0], config[4], config[5]
    plans = load_plans(plans_file)
    st = plans.stage(stage)
    plan = mesh.plan_batch_sharding(st.batch_size, st.patch_size, ranks)
    if plan.space > 1:
        refusal = space_plan_refusal(trainer_class, plans, stage)
        if refusal is not None:
            raise NotImplementedError(refusal)
    if plan.ranks < ranks:
        print(plan.description, file=sys.stderr)
    distributed.spawn(main, ranks, (argv,))
    return None


def _join_and_train(args, config, device_type: str):
    """One rank of a group that a launcher started: join it, train, leave."""
    if args.local_rank is not None and "LOCAL_RANK" not in os.environ:
        os.environ["LOCAL_RANK"] = str(args.local_rank)
    device = distributed.init_process_group(device_type)
    if device_type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // distributed.world_size()))
    try:
        plans = load_plans(config[0]).stage(config[4])
        if distributed.layout(plans.batch_size, plans.patch_size, device_type) is None:
            print(f"rank {torch.distributed.get_rank()} is idle under the plan", file=sys.stderr)
            return None
        return _train(args, config, device)
    finally:
        torch.distributed.destroy_process_group()


def _train(args, config, device):
    fold = args.fold if args.fold == "all" else int(args.fold)
    (plans_file, output_folder, dataset_directory, batch_dice, stage,
     trainer_class) = config
    trainer = trainer_class(plans_file, fold, output_folder=output_folder,
                            dataset_directory=dataset_directory, batch_dice=batch_dice,
                            stage=stage, unpack_data=not args.use_compressed_data,
                            deterministic=args.deterministic, fp16=not args.fp32,
                            device=device)
    trainer.initialize(not args.validation_only)
    if args.pretrained_weights is not None and not args.continue_training:
        pretrained = checkpoint_state_dict(args.pretrained_weights, trainer.plans,
                                           trainer.stage)
        trainer.network.load_state_dict(load_pretrained_weights(
            trainer.network.state_dict(), pretrained))
        trainer.print_to_log_file("imported pretrained backbone weights from",
                                  args.pretrained_weights)
    if not args.validation_only:
        if args.continue_training:
            trainer.load_latest_checkpoint()
        trainer.run_training()
    elif args.valbest:
        trainer.load_best_checkpoint(train=False)
    else:
        trainer.load_final_checkpoint(train=False)
    trainer.validate(save_softmax=args.npz, validation_folder_name=args.val_folder,
                     run_postprocessing_on_folds=not args.disable_postprocessing_on_folds)
    if args.network == "3d_lowres":
        trainer.load_best_checkpoint(train=False)
        trainer.next_stage_timings = predict_next_stage(trainer, os.path.join(
            dataset_directory, trainer.plans.data_identifier + f"_stage{stage + 1}"))
    return trainer


if __name__ == "__main__":
    main()
