from repro_torch.checkpoint.ckpt import (all_steps, latest_step, restore,
                                         restore_train_state, save,
                                         save_train_state)

__all__ = ["save", "restore", "latest_step", "all_steps", "save_train_state",
           "restore_train_state"]
