from splatloc_tpu_torch.data.datasets import (ReplicaDataset, Scenes12Dataset,
                                              load_dataset)
