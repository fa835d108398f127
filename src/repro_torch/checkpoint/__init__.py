from repro_torch.checkpoint.ckpt import (available_steps,  # noqa: F401
                                         latest_step, load_metadata,
                                         restore_checkpoint, save_checkpoint)
