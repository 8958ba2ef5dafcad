from xgan_torch.utils.dirs import check_create_dir
from xgan_torch.utils.timer import StepTimer

__all__ = ["check_create_dir", "StepTimer"]
