"""paddle.nn: port of paddle_tpu/nn/ — Layer and its containers, the
initializers, the functionals, the common/conv/norm/pool/loss/transformer
layers, the layer tail of ``layers_extra`` and gradient clipping.
``layers_rnn`` waits for a later slice."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .initializer import ParamAttr  # noqa: F401
from .layer import Layer, LayerList, ParameterList, Sequential  # noqa: F401
from .layers_common import *  # noqa: F401,F403
from .layers_conv import *  # noqa: F401,F403
from .layers_extra import *  # noqa: F401,F403
from .layers_loss import *  # noqa: F401,F403
from .layers_rnn import (RNN, BiRNN, GRU, GRUCell, LSTM,  # noqa: F401
                         LSTMCell, RNNCellBase, SimpleRNN, SimpleRNNCell,
                         _RNNBase)
from .layers_transformer import (MultiHeadAttention,  # noqa: F401
                                 Transformer, TransformerDecoder,
                                 TransformerDecoderLayer, TransformerEncoder,
                                 TransformerEncoderLayer)
