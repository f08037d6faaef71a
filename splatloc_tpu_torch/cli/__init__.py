from splatloc_tpu_torch.cli.config import load_config
