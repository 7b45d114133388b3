from repro_torch.checkpoint.ckpt import all_steps, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "all_steps"]
