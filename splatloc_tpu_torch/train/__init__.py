from splatloc_tpu_torch.train import losses
from splatloc_tpu_torch.train.mapping import MappingTrainer, FrameStore
