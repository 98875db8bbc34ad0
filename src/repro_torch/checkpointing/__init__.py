from repro_torch.checkpointing.io import (latest_step, load_extra, payload, restore,
                                          save, valid_steps, verify)

__all__ = ["latest_step", "load_extra", "payload", "restore", "save", "valid_steps",
           "verify"]
