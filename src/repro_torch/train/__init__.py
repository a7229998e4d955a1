from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.train.trainer import Trainer
