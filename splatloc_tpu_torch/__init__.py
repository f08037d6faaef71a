"""splatloc_tpu_torch — the PyTorch/CUDA port of splatloc_tpu for NVIDIA Hopper.

Mirrors the JAX package module for module, so every ported file has one
counterpart in ``splatloc_tpu`` to be held against. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a kernel written by
hand for ``sm_90a`` (sources under ``csrc/``, built with ``nvcc`` at first
use). The package imports neither JAX nor anything of ``splatloc_tpu``.

Ported so far (the serving forward render, the mapping trainer and
localization):

- ``core``    rotations, SE(3), spherical harmonics, the pinhole ``Camera``
- ``raster``  projection, depth sort, pair binning, the pair-walk forward
              and backward kernels and the per-Gaussian reduction
              (``hopper_raster``), the ``render`` entry point
- ``scene``   ``GaussianScene`` with slot management, Adam, densification,
              keyframe initialisation and the reference PLY format
- ``knn``     mean squared distance to the 3 nearest neighbours
- ``train``   losses, the mapping trainer and its checkpoints, the
              descriptor field's checkpoints
- ``fields``  the hash-grid descriptor field (``decode``)
- ``match``   frustum gather, auction matching, PnP+RANSAC, SuperPoint,
              the ``Localizer`` and render-loss pose refinement
- ``data``    the Replica / 12-Scenes loaders and the native IO layer
- ``eval``    PSNR / SSIM / LPIPS, pose errors, landmark selection
- ``dist``    which process writes reports
- ``cli``     the YAML config loader and ``cli.test`` (``EvalSession``)
- ``convert`` JAX-side numpy fields and weights -> port objects

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
