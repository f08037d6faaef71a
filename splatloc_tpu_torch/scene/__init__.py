from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.scene import ply
