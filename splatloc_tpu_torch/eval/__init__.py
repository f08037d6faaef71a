from splatloc_tpu_torch.eval import metrics, selection
from splatloc_tpu_torch.eval.metrics import psnr_masked, pose_errors
from splatloc_tpu_torch.eval.selection import select_landmarks, saliency_scores
