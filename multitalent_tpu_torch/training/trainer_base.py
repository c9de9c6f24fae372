"""Generic training-loop runtime (the NetworkTrainer layer).

Parity target: nnunet/training/network_training/network_trainer.py:40-735 — the
epoch loop (1000 epochs x 250 train + 50 val iterations), moving-average based
train/val tracking and patience logic, periodic checkpointing with
latest/best/final files, timestamped text logging with retries, and the
progress.png plot.

The port's copy of multitalent_tpu/training/trainer_base.py: the base class
is pure host-side orchestration; subclasses implement `run_iteration` (one
training step on the device), the network and optimizer (`find_lr` uses
them) and the checkpoint format. Checkpoints carry the reference's names
(`model_best.model`, `model_latest.model`, `model_final_checkpoint.model`),
and `save_checkpoint` and `load_checkpoint` are the subclass's
(training/trainers.py writes the reference's `.model` files; the JAX
package's flax `.ckpt` files are read by inference/model_restore.py and, as
pretrained weights, by training/warmup.py). AMP GradScaler state is absent
(bf16 needs no loss scaling).

Under data parallelism (parallel/distributed.py) every rank runs this loop;
rank 0 alone writes the log, progress.png, debug.json and checkpoints, and
the decision to stop, which each rank takes from the same all-reduced losses
and metrics, is checked to agree across the ranks each epoch.
"""
from __future__ import annotations

import os
import time
from abc import ABC, abstractmethod
from datetime import datetime
from typing import Any

import numpy as np

from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.utils.fileops import maybe_mkdir as maybe_mkdir_p


class NetworkTrainerBase(ABC):
    def __init__(self, deterministic: bool = True, fp16: bool = True):
        # `fp16` kept for signature parity; on TPU it selects bf16 compute.
        self.fp16 = fp16
        self.deterministic = deterministic

        self.network = None          # the torch module
        self.initialized = False
        self.was_initialized = False

        self.output_folder: str | None = None
        self.fold: int | str | None = None
        self.dataset_directory: str | None = None

        self.log_file = None
        self.use_progress_bar = bool(os.environ.get("nnunet_use_progress_bar", False))

        # loop hyperparameters (network_trainer.py:95-117); env overrides exist for
        # smoke tests / CI (the reference uses dedicated 2-epoch benchmark
        # trainer subclasses for the same purpose)
        self.max_num_epochs = int(os.environ.get("MTTPU_MAX_EPOCHS", 1000))
        self.num_batches_per_epoch = int(os.environ.get("MTTPU_ITERS_PER_EPOCH", 250))
        self.num_val_batches_per_epoch = int(os.environ.get("MTTPU_VAL_ITERS", 50))
        self.also_val_in_tr_mode = False
        self.save_every = 50
        self.save_latest_only = True
        self.save_intermediate_checkpoints = True
        self.save_best_checkpoint = True
        self.save_final_checkpoint = True

        # patience / moving averages (network_trainer.py:98-114)
        self.patience = 50
        self.val_eval_criterion_alpha = 0.9
        self.train_loss_MA_alpha = 0.93
        self.train_loss_MA_eps = 5e-4
        self.lr_threshold = 1e-6

        self.train_loss_MA = None
        self.val_eval_criterion_MA = None
        self.best_MA_tr_loss_for_patience = None
        self.best_epoch_based_on_MA_tr_loss = None
        self.best_val_eval_criterion_MA = None

        self.all_tr_losses: list[float] = []
        self.all_val_losses: list[float] = []
        self.all_val_losses_tr_mode: list[float] = []
        self.all_val_eval_metrics: list[float] = []

        self.epoch = 0
        self.log_nothing = False

    # ------------------------------------------------------------------ logging
    def print_to_log_file(self, *args, also_print_to_console: bool = True,
                          add_timestamp: bool = True) -> None:
        if not distributed.is_main():
            return
        if self.log_nothing:
            if also_print_to_console:
                print(*args)
            return
        timestamp = datetime.now()
        if add_timestamp:
            args = (f"{timestamp}:",) + args
        if self.log_file is None and self.output_folder is not None:
            maybe_mkdir_p(self.output_folder)
            self.log_file = os.path.join(
                self.output_folder,
                "training_log_%d_%d_%d_%02.0d_%02.0d_%02.0d.txt"
                % (timestamp.year, timestamp.month, timestamp.day, timestamp.hour,
                   timestamp.minute, timestamp.second))
            with open(self.log_file, "w") as f:
                f.write("Starting... \n")
        if self.log_file is not None:
            # retrying writes (network_trainer.py:238-252)
            for _ in range(5):
                try:
                    with open(self.log_file, "a+") as f:
                        for a in args:
                            f.write(str(a))
                            f.write(" ")
                        f.write("\n")
                    break
                except OSError:
                    time.sleep(0.5)
        if also_print_to_console:
            print(*args)

    # ------------------------------------------------------------- progress plot
    def plot_progress(self) -> None:
        """progress.png with losses + eval metric (network_trainer.py:185-220)."""
        if not distributed.is_main():
            return
        try:
            import matplotlib
            matplotlib.use("agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(30, 24))
            ax2 = ax.twinx()
            x = list(range(self.epoch + 1))
            ax.plot(x, self.all_tr_losses, color="b", ls="-", label="loss_tr")
            ax.plot(x, self.all_val_losses, color="r", ls="-", label="loss_val, train=False")
            if len(self.all_val_losses_tr_mode) > 0:
                ax.plot(x, self.all_val_losses_tr_mode, color="g", ls="-",
                        label="loss_val, train=True")
            if len(self.all_val_eval_metrics) == len(x):
                ax2.plot(x, self.all_val_eval_metrics, color="g", ls="--",
                         label="evaluation metric")
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax2.set_ylabel("evaluation metric")
            ax.legend()
            ax2.legend(loc=9)
            fig.savefig(os.path.join(self.output_folder, "progress.png"))
            plt.close()
        except (ImportError, OSError) as e:
            self.print_to_log_file(f"failed to plot: {e}")

    # ------------------------------------------------------------- checkpointing
    def checkpoint_metadata(self) -> dict:
        """Host-side bookkeeping stored beside the weights."""
        return {
            "epoch": self.epoch + 1,
            "plot_stuff": (self.all_tr_losses, self.all_val_losses,
                           self.all_val_losses_tr_mode, self.all_val_eval_metrics),
            "best_stuff": (self.best_MA_tr_loss_for_patience,
                           self.best_epoch_based_on_MA_tr_loss,
                           self.best_val_eval_criterion_MA),
            "trainer_name": self.__class__.__name__,
            # fallback chain for restore: ad-hoc subclasses resolve to their
            # nearest registered ancestor
            "trainer_bases": [c.__name__ for c in type(self).mro()],
            "init_args": getattr(self, "init_args", ()),
        }

    @abstractmethod
    def save_checkpoint(self, fname: str, save_optimizer: bool = True) -> None:
        ...

    @abstractmethod
    def load_checkpoint(self, fname: str, train: bool = True) -> None:
        ...

    def restore_checkpoint_metadata(self, meta: dict) -> None:
        self.epoch = meta["epoch"]
        (self.all_tr_losses, self.all_val_losses, self.all_val_losses_tr_mode,
         self.all_val_eval_metrics) = meta["plot_stuff"]
        (self.best_MA_tr_loss_for_patience, self.best_epoch_based_on_MA_tr_loss,
         self.best_val_eval_criterion_MA) = meta["best_stuff"]
        # truncate logs that ran past the stored epoch (network_trainer.py:380-394)
        if len(self.all_tr_losses) != self.epoch:
            self.print_to_log_file("WARNING: stored epoch count differs from loss "
                                   "history length; truncating")
            self.all_tr_losses = self.all_tr_losses[:self.epoch]
            self.all_val_losses = self.all_val_losses[:self.epoch]
            self.all_val_losses_tr_mode = self.all_val_losses_tr_mode[:self.epoch]
            self.all_val_eval_metrics = self.all_val_eval_metrics[:self.epoch]

    def load_latest_checkpoint(self, train: bool = True) -> None:
        for name in ("model_final_checkpoint", "model_latest", "model_best"):
            p = os.path.join(self.output_folder, name + ".model")
            if os.path.isfile(p):
                return self.load_checkpoint(p, train)
        raise RuntimeError("No checkpoint found in " + str(self.output_folder))

    def load_best_checkpoint(self, train: bool = True) -> None:
        if self.fold == "all":
            return self.load_final_checkpoint(train)
        p = os.path.join(self.output_folder, "model_best.model")
        if os.path.isfile(p):
            return self.load_checkpoint(p, train)
        return self.load_final_checkpoint(train)

    def load_final_checkpoint(self, train: bool = False) -> None:
        p = os.path.join(self.output_folder, "model_final_checkpoint.model")
        if os.path.isfile(p):
            return self.load_checkpoint(p, train)
        raise RuntimeError("Final checkpoint not found. Expected: " + p)

    # --------------------------------------------------------------- MA/patience
    def update_train_loss_MA(self) -> None:
        if self.train_loss_MA is None:
            self.train_loss_MA = self.all_tr_losses[-1]
        else:
            self.train_loss_MA = (self.train_loss_MA_alpha * self.train_loss_MA
                                  + (1 - self.train_loss_MA_alpha) * self.all_tr_losses[-1])

    def update_eval_criterion_MA(self) -> None:
        """EMA of the eval metric if available else of -val loss
        (network_trainer.py:526-555)."""
        if self.val_eval_criterion_MA is None:
            if len(self.all_val_eval_metrics) == 0:
                self.val_eval_criterion_MA = -self.all_val_losses[-1]
            else:
                self.val_eval_criterion_MA = self.all_val_eval_metrics[-1]
        else:
            if len(self.all_val_eval_metrics) == 0:
                self.val_eval_criterion_MA = (
                    self.val_eval_criterion_alpha * self.val_eval_criterion_MA
                    - (1 - self.val_eval_criterion_alpha) * self.all_val_losses[-1])
            else:
                self.val_eval_criterion_MA = (
                    self.val_eval_criterion_alpha * self.val_eval_criterion_MA
                    + (1 - self.val_eval_criterion_alpha) * self.all_val_eval_metrics[-1])

    def manage_patience(self) -> bool:
        """Returns False to stop training (network_trainer.py:557-601)."""
        continue_training = True
        if self.patience is not None:
            if self.best_MA_tr_loss_for_patience is None:
                self.best_MA_tr_loss_for_patience = self.train_loss_MA
            if self.best_epoch_based_on_MA_tr_loss is None:
                self.best_epoch_based_on_MA_tr_loss = self.epoch
            if self.best_val_eval_criterion_MA is None:
                self.best_val_eval_criterion_MA = self.val_eval_criterion_MA

            if self.val_eval_criterion_MA > self.best_val_eval_criterion_MA:
                self.best_val_eval_criterion_MA = self.val_eval_criterion_MA
                if self.save_best_checkpoint:
                    self.save_checkpoint(
                        os.path.join(self.output_folder, "model_best.model"))

            if self.train_loss_MA + self.train_loss_MA_eps < self.best_MA_tr_loss_for_patience:
                self.best_MA_tr_loss_for_patience = self.train_loss_MA
                self.best_epoch_based_on_MA_tr_loss = self.epoch

            if self.epoch - self.best_epoch_based_on_MA_tr_loss > self.patience:
                if self.current_lr() > self.lr_threshold:
                    self.best_epoch_based_on_MA_tr_loss = self.epoch - self.patience // 2
                else:
                    continue_training = False
        return continue_training

    def current_lr(self) -> float:
        return float("nan")

    # ------------------------------------------------------------------ the loop
    @abstractmethod
    def initialize(self, training: bool = True) -> None:
        ...

    @abstractmethod
    def run_iteration(self, data_generator, do_backprop: bool = True,
                      run_online_evaluation: bool = False) -> float:
        ...

    def run_online_evaluation(self, *args, **kwargs) -> None:
        pass

    def finish_online_evaluation(self) -> None:
        pass

    def maybe_update_lr(self) -> None:
        pass

    def maybe_save_checkpoint(self) -> None:
        if self.save_intermediate_checkpoints and (self.epoch % self.save_every == self.save_every - 1):
            self.print_to_log_file("saving scheduled checkpoint file...")
            if not self.save_latest_only:
                self.save_checkpoint(os.path.join(
                    self.output_folder, f"model_ep_{self.epoch + 1:03d}.model"))
            self.save_checkpoint(os.path.join(self.output_folder, "model_latest.model"))
            self.print_to_log_file("done")

    def on_epoch_end(self) -> bool:
        self.finish_online_evaluation()
        self.plot_progress()
        self.maybe_update_lr()
        self.maybe_save_checkpoint()
        self.update_eval_criterion_MA()
        return self.manage_patience()

    def save_debug_information(self) -> None:
        """debug.json dump of all scalar trainer attributes
        (nnUNetTrainer.py:297-313)."""
        from multitalent_tpu_torch.utils.fileops import save_json
        if not distributed.is_main():
            return
        dct = {}
        for k in sorted(self.__dict__.keys()):
            if k.startswith("__") or k in ("plans", "state", "network",
                                           "intensity_properties", "dataset",
                                           "dataset_tr", "dataset_val"):
                continue
            v = self.__dict__[k]
            if isinstance(v, (int, float, str, bool, type(None))):
                dct[k] = v
            elif isinstance(v, (list, tuple, dict, np.ndarray)):
                dct[k] = str(v)
        if self.output_folder is not None:
            save_json(dct, os.path.join(self.output_folder, "debug.json"))

    def find_lr(self, num_iters: int = 1000, init_value: float = 1e-6,
                final_value: float = 10.0, beta: float = 0.98):
        """LR range test (network_trainer.py:685-735; the JAX package's
        trainer_base.py:349-394): one training step per LR on an exponential
        sweep, each with a new SGD + clip state at that constant LR; the
        smoothed loss is tracked and the sweep stops once it exceeds 4x its
        best. The weights, optimizer, schedule and step counter are restored
        after; lr_finder.png is written where matplotlib is. Returns
        (log10 LRs, smoothed losses)."""
        import math

        from multitalent_tpu_torch.training.train_state import SGDClipped

        mult = (final_value / init_value) ** (1 / num_iters)
        lr = init_value
        avg_loss, best_loss = 0.0, 0.0
        losses, log_lrs = [], []
        weights = {k: v.detach().clone() for k, v in self.network.state_dict().items()}
        saved = (self.optimizer, self.lr_schedule, self.step)
        try:
            for batch_num in range(1, num_iters + 1):
                self.optimizer = SGDClipped(self.network.parameters())
                self.lr_schedule = lambda step, lr=lr: lr
                loss = self.run_iteration(self.tr_gen, do_backprop=True)
                avg_loss = beta * avg_loss + (1 - beta) * loss
                smoothed = avg_loss / (1 - beta ** batch_num)
                if batch_num > 1 and smoothed > 4 * best_loss:
                    break
                if smoothed < best_loss or batch_num == 1:
                    best_loss = smoothed
                losses.append(smoothed)
                log_lrs.append(math.log10(lr))
                lr *= mult
        finally:
            self.optimizer, self.lr_schedule, self.step = saved
            self.network.load_state_dict(weights)
        try:
            import matplotlib
            matplotlib.use("agg")
            import matplotlib.pyplot as plt
            plt.figure()
            plt.plot(log_lrs[10:-5], losses[10:-5])
            plt.savefig(os.path.join(self.output_folder, "lr_finder.png"))
            plt.close()
        except (ImportError, OSError) as e:
            self.print_to_log_file(f"failed to plot lr_finder.png: {e}")
        return log_lrs, losses

    def run_training(self) -> None:
        maybe_mkdir_p(self.output_folder)
        if not self.was_initialized:
            self.initialize(True)
        self.save_debug_information()

        # optional device-trace capture (the reference offers only wall-clock epoch
        # timing; set MTTPU_PROFILE_DIR to profile a window of training steps with
        # torch.profiler, written as a Chrome trace)
        profile_dir = os.environ.get("MTTPU_PROFILE_DIR")
        profile_window = (5, 15)
        profiler = None

        while self.epoch < self.max_num_epochs:
            self.print_to_log_file("\nepoch: ", self.epoch)
            epoch_start_time = time.time()
            train_losses_epoch = []

            for it in range(self.num_batches_per_epoch):
                if profile_dir and self.epoch == 0 and it == profile_window[0]:
                    profiler = _start_profiler()
                l = self.run_iteration(self.tr_gen, True)
                if profiler is not None and it == profile_window[1]:
                    profiler.stop()
                    maybe_mkdir_p(profile_dir)
                    trace = os.path.join(profile_dir, "trace.json")
                    profiler.export_chrome_trace(trace)
                    profiler = None
                    self.print_to_log_file(f"profiler trace written to {trace}")
                train_losses_epoch.append(l)

            self.all_tr_losses.append(float(np.mean(train_losses_epoch)))
            self.print_to_log_file(f"train loss : {self.all_tr_losses[-1]:.4f}")

            val_losses = []
            for _ in range(self.num_val_batches_per_epoch):
                l = self.run_iteration(self.val_gen, False, True)
                val_losses.append(l)
            self.all_val_losses.append(float(np.mean(val_losses)) if val_losses else float("nan"))
            self.print_to_log_file(f"validation loss: {self.all_val_losses[-1]:.4f}")

            if self.also_val_in_tr_mode:
                losses = [self.run_iteration(self.val_gen, False)
                          for _ in range(self.num_val_batches_per_epoch)]
                self.all_val_losses_tr_mode.append(float(np.mean(losses)))

            self.update_train_loss_MA()
            continue_training = distributed.agree(self.on_epoch_end())
            epoch_end_time = time.time()

            self.epoch += 1
            self.print_to_log_file(
                f"This epoch took {epoch_end_time - epoch_start_time:.2f} s\n")
            if not continue_training:
                break

        self.epoch -= 1  # run_training final-epoch bookkeeping (network_trainer.py:505)
        if self.save_final_checkpoint:
            self.save_checkpoint(os.path.join(self.output_folder,
                                              "model_final_checkpoint.model"))
        self.epoch += 1

        # clean up latest (network_trainer.py:509-513)
        for name in ("model_latest.model", "model_latest.model.pkl"):
            p = os.path.join(self.output_folder, name)
            if distributed.is_main() and os.path.isfile(p):
                os.remove(p)

        if hasattr(self, "tr_gen") and hasattr(self.tr_gen, "stop"):
            self.tr_gen.stop()
        if hasattr(self, "val_gen") and hasattr(self.val_gen, "stop"):
            self.val_gen.stop()


def _start_profiler():
    """A started torch.profiler over the host and, where there is a card, the
    device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof
