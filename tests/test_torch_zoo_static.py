"""``jit.to_static`` of a train-mode ResNet (BatchNorm buffers mutating
inside the graph) against its eager twin, seeded initial weights equal to
the reference's, and ``vision.transforms`` on seeded uint8 images equal to
the reference's."""
import numpy as np
import pytest

from torch_eager_ref import P, T, seed_both, to_np
from torch_eager_ref import few_threads  # noqa: F401

X = np.random.default_rng(0).standard_normal((2, 3, 16, 16)).astype(
    np.float32)
Y = np.array([3, 1])

pytestmark = pytest.mark.usefixtures("few_threads")


def _small_resnet():
    """The zoo's blocks at test size: a stem, a BasicBlock, a downsampling
    BottleneckBlock and the classifier."""
    from paddle_tpu_torch.models.resnet import BasicBlock, BottleneckBlock
    nn = T.nn

    class Small(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1,
                                                bias_attr=False),
                                      nn.BatchNorm2D(8), nn.ReLU())
            self.basic = BasicBlock(8, 8)
            down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2,
                                           bias_attr=False),
                                 nn.BatchNorm2D(16))
            self.bottleneck = BottleneckBlock(8, 4, stride=2,
                                              downsample=down)
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
            self.fc = nn.Linear(16, 4)

        def forward(self, x):
            x = self.bottleneck(self.basic(self.stem(x)))
            return self.fc(T.flatten(self.pool(x), 1))
    return Small()


def test_resnet_to_static_train_step_equals_its_eager_twin():
    """A compiled (aot_eager, fullgraph) train-mode ResNet: one graph; the
    losses of three Momentum steps, the weights and the BatchNorm running
    statistics equal those of an eager twin with the same weights."""
    T.seed(1)
    eager, twin = _small_resnet(), _small_resnet()
    twin.set_state_dict({k: v.numpy() for k, v in
                         eager.state_dict().items()})
    compiled = T.jit.to_static(twin, backend="aot_eager")
    out = {}
    for tag, model in (("eager", eager), ("static", compiled)):
        model.train()
        opt = T.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=model.parameters(),
            weight_decay=T.optimizer.L2Decay(1e-4))
        losses = []
        for _ in range(3):
            loss = T.nn.functional.cross_entropy(model(T.to_tensor(X)),
                                                 T.to_tensor(Y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        out[tag] = (losses, {k: to_np(v) for k, v in
                             model.state_dict().items()})
    np.testing.assert_allclose(out["static"][0], out["eager"][0], rtol=1e-5)
    assert any(k.endswith("_mean") for k in out["eager"][1])
    for k, v in out["eager"][1].items():
        np.testing.assert_allclose(out["static"][1][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert compiled._static_function.compiles == 1


def test_seeded_initial_weights_equal_the_reference():
    """``seed_both`` then the same constructor: every parameter and buffer
    of the port equals the reference's bit for bit."""
    seed_both(5)
    ref = P.vision.models.shufflenet_v2_x0_25(num_classes=4)
    port = T.vision.models.shufflenet_v2_x0_25(num_classes=4)
    rs, ts = ref.state_dict(), port.state_dict()
    assert list(rs) == list(ts)
    for k in rs:
        np.testing.assert_array_equal(to_np(ts[k]), to_np(rs[k]),
                                      err_msg=k)


# ---- vision.transforms ------------------------------------------------------
IMG = np.random.default_rng(3).integers(0, 256, (37, 29, 3), dtype=np.uint8)


def _transforms(M):
    tr = M.vision.transforms
    return [
        ("ToTensor", lambda: tr.ToTensor()),
        ("Normalize", lambda: tr.Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4],
                                           data_format="HWC")),
        ("Resize", lambda: tr.Resize((16, 20))),
        ("Resize_up", lambda: tr.Resize(48)),
        ("CenterCrop", lambda: tr.CenterCrop(17)),
        ("RandomCrop", lambda: tr.RandomCrop(16, padding=2)),
        ("RandomHorizontalFlip", lambda: tr.RandomHorizontalFlip(1.0)),
        ("RandomVerticalFlip", lambda: tr.RandomVerticalFlip(1.0)),
        ("Pad", lambda: tr.Pad(3, fill=7)),
        ("Transpose", lambda: tr.Transpose()),
        ("ColorJitter", lambda: tr.ColorJitter(0.2, 0.2, 0.2, 0.1)),
        ("Grayscale", lambda: tr.Grayscale(3)),
        ("RandomRotation", lambda: tr.RandomRotation(15)),
        ("RandomAffine", lambda: tr.RandomAffine(10, translate=(0.1, 0.1))),
        ("RandomPerspective", lambda: tr.RandomPerspective(1.0)),
        ("RandomResizedCrop", lambda: tr.RandomResizedCrop(8)),
        ("RandomErasing", lambda: tr.RandomErasing(1.0)),
        ("Compose", lambda: tr.Compose([tr.CenterCrop(24), tr.Resize(12),
                                        tr.ToTensor()])),
    ]


@pytest.mark.parametrize("idx", range(len(_transforms(P))),
                         ids=[n for n, _ in _transforms(P)])
def test_transform_equals_the_reference(idx):
    """The same numpy seed, the same image: the same bytes out. Resize
    sums its bilinear taps in float32 in another order than XLA's dot, so
    a value within an ulp of an integer can truncate one step apart: its
    uint8 outputs are held within 1 (its float ones within 1e-5); every
    other transform bitwise."""
    name, _ = _transforms(P)[idx]
    outs = []
    for M in (P, T):
        _, make = _transforms(M)[idx]
        np.random.seed(11)
        outs.append(np.asarray(make()(IMG.copy())))
    assert outs[1].dtype == outs[0].dtype and outs[1].shape == outs[0].shape
    if name.startswith("Resize") or name == "Compose":
        tol = 1 if outs[0].dtype == np.uint8 else 1e-5
        assert np.abs(outs[1].astype(np.float64) - outs[0]).max() <= tol
    else:
        np.testing.assert_array_equal(outs[1], outs[0])


def test_functional_to_tensor_is_a_port_tensor():
    t = T.vision.transforms.to_tensor(IMG)
    assert isinstance(t, T.Tensor) and t.shape == [3, 37, 29]
    np.testing.assert_array_equal(
        to_np(t), np.asarray(P.vision.transforms.to_tensor(IMG)))


# ---- nn.layers_extra --------------------------------------------------------
_XA = np.random.default_rng(5).standard_normal((2, 3, 4, 4)).astype(
    np.float32)
_XB = np.random.default_rng(6).standard_normal((2, 3, 4, 4)).astype(
    np.float32)
_LAB = np.sign(np.random.default_rng(7).standard_normal((2, 3, 4, 4))
               ).astype(np.float32)
_LAYERS = [
    ("Swish", lambda nn: nn.Swish(), (_XA,)),
    ("Softmax2D", lambda nn: nn.Softmax2D(), (_XA,)),
    ("Unfold", lambda nn: nn.Unfold(2, strides=2), (_XA,)),
    ("Fold", lambda nn: nn.Fold([4, 4], 2, strides=2),
     (_XA.reshape(2, 12, 4),)),
    ("SoftMarginLoss", lambda nn: nn.SoftMarginLoss(), (_XA, _LAB)),
    ("GaussianNLLLoss", lambda nn: nn.GaussianNLLLoss(),
     (_XA, _XB, np.abs(_XB) + 0.1)),
    ("PoissonNLLLoss", lambda nn: nn.PoissonNLLLoss(), (_XA, np.abs(_XB))),
    ("MultiLabelSoftMarginLoss", lambda nn: nn.MultiLabelSoftMarginLoss(),
     (_XA.reshape(2, -1), (_LAB.reshape(2, -1) > 0).astype(np.float32))),
]


@pytest.mark.parametrize("name,make,args", _LAYERS,
                         ids=[n for n, _, _ in _LAYERS])
def test_layers_extra_equal_the_reference(name, make, args):
    r = make(P.nn)(*[P.to_tensor(a) for a in args])
    t = make(T.nn)(*[T.to_tensor(a) for a in args])
    np.testing.assert_allclose(to_np(t), to_np(r), rtol=1e-5, atol=1e-6,
                               err_msg=name)


def test_layer_dict():
    d = T.nn.LayerDict({"a": T.nn.ReLU(), "b": T.nn.Swish()})
    assert list(d.keys()) == ["a", "b"] and "a" in d and len(d) == 2
    d["c"] = T.nn.Tanh()
    assert isinstance(d.pop("b"), T.nn.Swish) and list(d) == ["a", "c"]
