from repro_torch.train.optimizer import (AdamWConfig, AdamWState, adamw_update,
                                         init_adamw, lr_at)
from repro_torch.train.data import DataConfig, PackedLoader, SyntheticCorpus
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.train_loop import TrainConfig, Trainer
