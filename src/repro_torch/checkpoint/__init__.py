from repro_torch.checkpoint.manager import (CheckpointCorruptError,  # noqa: F401
                                            CheckpointManager)
from repro_torch.checkpoint.reshard import elastic_restore, reshard_state  # noqa: F401
