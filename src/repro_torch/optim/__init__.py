from repro_torch.optim.optimizers import (adamw_init, adamw_update,
                                          clip_by_global_norm,
                                          cosine_schedule, rmsprop_init,
                                          rmsprop_update)

__all__ = ["adamw_init", "adamw_update", "rmsprop_init", "rmsprop_update",
           "clip_by_global_norm", "cosine_schedule"]
