"""Training: AdamW and its schedules, checkpoints, the training loop."""
from repro_torch.train.checkpoint import (CheckpointManager,
                                          checkpoint_step,
                                          latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.loop import (StragglerMonitor, TrainLoop,
                                    TrainLoopConfig, TrainState,
                                    make_grad_accum_loss)
from repro_torch.train.optimizer import (AdamState, AdamW, apply_updates,
                                         constant_schedule, cosine_schedule,
                                         global_norm)

__all__ = ["AdamState", "AdamW", "apply_updates", "constant_schedule",
           "cosine_schedule", "global_norm", "CheckpointManager",
           "checkpoint_step", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint", "StragglerMonitor", "TrainLoop",
           "TrainLoopConfig", "TrainState", "make_grad_accum_loss"]
