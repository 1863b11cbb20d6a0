"""paddle.vision: port of paddle_tpu/vision/ — the datasets (MNIST, CIFAR10
with download disabled, a seeded synthetic fallback), the transforms, and
the model zoo of ``paddle_tpu_torch.models`` (``vision.models``).
``vision.ops`` waits for a later slice."""
from . import datasets, models, transforms
from .models import LeNet, ResNet, resnet18, resnet34, resnet50, resnet101, resnet152


# ---------------------------------------------------------------------------
# image backend registry (reference: python/paddle/vision/image.py —
# set_image_backend/get_image_backend/image_load). Backends: 'pil' (if
# importable) and 'cv2' (unavailable offline); 'tensor' loads via numpy.
# ---------------------------------------------------------------------------
_image_backend = "pil"


def set_image_backend(backend):
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"expected backend 'pil'/'cv2'/'tensor', got {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image file per the selected backend (reference:
    image.py image_load). The 'tensor' backend decodes through numpy
    (npy/npz raw arrays); 'pil' requires Pillow at call time."""
    backend = backend or _image_backend
    if backend == "pil":
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                "pil backend requires Pillow; use "
                "set_image_backend('tensor') for raw-array files") from e
        return Image.open(path)
    if backend == "tensor":
        import numpy as np
        from ..tensor import to_tensor
        return to_tensor(np.load(path))
    raise RuntimeError(f"backend {backend!r} not available in this build")
