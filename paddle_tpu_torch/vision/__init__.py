"""paddle.vision: port of paddle_tpu/vision/ — the datasets
(``vision.datasets``). ``transforms``, ``ops`` and ``models`` are not
ported yet; ``models.LeNet`` is the port's ``paddle_tpu_torch.models``."""
from . import datasets

__all__ = ["datasets"]
