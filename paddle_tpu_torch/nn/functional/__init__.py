"""paddle.nn.functional: port of paddle_tpu/nn/functional/."""
from .activation import *  # noqa: F401,F403
from .attention import (flash_attention, flash_attn_bhsd,  # noqa: F401
                        scaled_dot_product_attention)
from .common import *  # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import *  # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, normalize, rms_norm)
from .pooling import *  # noqa: F401,F403
# paddle also exposes the tensor surface's pad and diag_embed here
from ...ops.manipulation import diag_embed, pad  # noqa: F401,E402
