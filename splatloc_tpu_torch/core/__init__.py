from splatloc_tpu_torch.core import transforms, sh, camera
from splatloc_tpu_torch.core.camera import Camera
