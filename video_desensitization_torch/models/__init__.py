"""Detection networks (NCHW inside, reference torch state_dict layout)."""

from video_desensitization_torch.models.configs import cfg_mnet, cfg_re50, get_config
from video_desensitization_torch.models.retinaface import RetinaFace

__all__ = ["RetinaFace", "cfg_mnet", "cfg_re50", "get_config"]
