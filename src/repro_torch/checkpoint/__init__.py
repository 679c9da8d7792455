from repro_torch.checkpoint.manager import (CheckpointCorruptError,  # noqa: F401
                                            CheckpointManager)
