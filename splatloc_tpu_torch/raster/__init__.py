from splatloc_tpu_torch.raster.types import RasterConfig, RenderOutput
from splatloc_tpu_torch.raster.api import rasterize, render, render_features
