from unscene3d_torch.config.loader import (ConfigNode, instantiate,
                                           load_config)
