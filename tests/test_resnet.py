"""ResNet-152 backbone + encoder head parity vs torch (random weights —
pretrained are unavailable offline; the import path is identical either way)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icee_tpu.core.config import EncoderConfig
from icee_tpu.models import encoder as enc
from icee_tpu.models import resnet


def _build_torch_resnet(layers):
    """Independent torch implementation of the torchvision ResNet v1
    bottleneck architecture with torchvision-compatible parameter names
    (torchvision itself is not installed in this image), used as the parity
    oracle and to exercise ``import_torch_state_dict``."""
    import torch
    import torch.nn as nn

    class Bottleneck(nn.Module):
        expansion = 4

        def __init__(self, inplanes, planes, stride=1, downsample=None):
            super().__init__()
            self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = downsample

        def forward(self, x):
            identity = x
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            if self.downsample is not None:
                identity = self.downsample(x)
            return self.relu(out + identity)

    class ResNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.inplanes = 64
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            self.layer1 = self._make_layer(64, layers[0], 1)
            self.layer2 = self._make_layer(128, layers[1], 2)
            self.layer3 = self._make_layer(256, layers[2], 2)
            self.layer4 = self._make_layer(512, layers[3], 2)
            self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
            # randomize BN running stats so eval-mode parity is meaningful
            for mod in self.modules():
                if isinstance(mod, nn.BatchNorm2d):
                    mod.running_mean.normal_(0, 0.05)
                    mod.running_var.uniform_(0.8, 1.2)

        def _make_layer(self, planes, blocks, stride):
            import torch.nn as nn

            downsample = None
            if stride != 1 or self.inplanes != planes * 4:
                downsample = nn.Sequential(
                    nn.Conv2d(self.inplanes, planes * 4, 1, stride, bias=False),
                    nn.BatchNorm2d(planes * 4),
                )
            mods = [Bottleneck(self.inplanes, planes, stride, downsample)]
            self.inplanes = planes * 4
            for _ in range(1, blocks):
                mods.append(Bottleneck(self.inplanes, planes))
            return nn.Sequential(*mods)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    return ResNet()


@pytest.fixture(scope="module")
def torch_resnet_and_params():
    import torch

    torch.manual_seed(0)
    m = _build_torch_resnet(resnet.LAYERS_152)
    m.eval()
    params = resnet.import_torch_state_dict(m.state_dict())
    return m, params


def test_resnet152_global_features_match_torch(torch_resnet_and_params, rng):
    import torch

    m, params = torch_resnet_and_params
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        # reference global path: conv trunk + global avgpool (model.py:22-25)
        t = torch.tensor(np.transpose(x, (0, 3, 1, 2)))
        feats_t = m.avgpool(m(t))
        feats_t = feats_t.reshape(feats_t.shape[0], -1).numpy()
    feats_j, _ = resnet.global_features(params, jnp.asarray(x), train_bn=False)
    np.testing.assert_allclose(np.asarray(feats_j), feats_t, rtol=1e-3, atol=1e-4)


def test_resnet152_spatial_features_match_torch(torch_resnet_and_params, rng):
    import torch

    m, params = torch_resnet_and_params
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        t = torch.tensor(np.transpose(x, (0, 3, 1, 2)))
        fmap = m(t)
        pooled = torch.nn.AdaptiveAvgPool2d((4, 4))(fmap)
        # reference permutes to NHWC (model_att.py:28)
        ref = pooled.permute(0, 2, 3, 1).numpy()
    out, _ = resnet.spatial_features(params, jnp.asarray(x), grid=4, train_bn=False)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-3, atol=1e-4)


def test_adaptive_avg_pool_upsample_matches_torch(rng):
    """7x7 -> 14x14 (the reference's actual configuration)."""
    import torch

    x = rng.standard_normal((1, 7, 7, 5)).astype(np.float32)
    t = torch.tensor(np.transpose(x, (0, 3, 1, 2)))
    ref = torch.nn.AdaptiveAvgPool2d((14, 14))(t).permute(0, 2, 3, 1).numpy()
    out = resnet.adaptive_avg_pool(jnp.asarray(x), (14, 14))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5, atol=1e-6)


def test_batchnorm1d_train_semantics_match_torch(rng):
    """Head BN: batch stats normalize, running stats update with momentum
    0.01 and unbiased variance (torch BatchNorm1d semantics)."""
    import torch

    b, c = 8, 6
    x = rng.standard_normal((b, c)).astype(np.float32)
    bn_t = torch.nn.BatchNorm1d(c, momentum=0.01)
    bn_t.train()
    with torch.no_grad():
        out_t = bn_t(torch.tensor(x)).numpy()
    p = {
        "weight": jnp.ones((c,)),
        "bias": jnp.zeros((c,)),
        "running_mean": jnp.zeros((c,)),
        "running_var": jnp.ones((c,)),
    }
    out_j, new_p = resnet.batch_norm(jnp.asarray(x), p, train=True, momentum=0.01)
    np.testing.assert_allclose(np.asarray(out_j), out_t, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(new_p["running_mean"]), bn_t.running_mean.numpy(),
        rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(new_p["running_var"]), bn_t.running_var.numpy(),
        rtol=1e-4, atol=1e-6)


def test_encoder_head_shapes(rng):
    cfg = EncoderConfig(embed_size=20, feature_size=32)
    head = enc.init_head_params(jax.random.PRNGKey(0), cfg)
    pooled = jnp.asarray(rng.standard_normal((4, 32)).astype(np.float32))
    feats, new_head = enc.encode_global_from_pooled(head, pooled, train=True)
    assert feats.shape == (4, 20)
    # running stats moved
    assert not np.allclose(np.asarray(new_head["bn"]["running_mean"]), 0.0)


def test_bf16_conv_cast_and_parity(rng):
    """cast_conv_weights: only conv kernels go bf16 (BN stays f32); the
    bf16 backbone's features track the f32 ones; f32 params keep the conv
    bit-identical (the activation cast is a no-op)."""
    import jax.numpy as jnp
    from icee_tpu.models import resnet

    params = resnet.init_params(jax.random.PRNGKey(7))
    cast = resnet.cast_conv_weights(params, jnp.bfloat16)
    assert cast["conv1"].dtype == jnp.bfloat16
    assert cast["bn1"]["running_mean"].dtype == jnp.float32
    blk = cast["layer1"][0]
    assert blk["conv2"].dtype == jnp.bfloat16
    assert blk["bn2"]["weight"].dtype == jnp.float32
    assert blk["downsample_conv"].dtype == jnp.bfloat16

    imgs = jnp.asarray(rng.standard_normal((1, 64, 64, 3)).astype(np.float32))
    f32, _ = resnet.global_features(params, imgs, train_bn=False)
    bf16, _ = resnet.global_features(cast, imgs, train_bn=False)
    # bf16 convs with f32 accumulation compound the rounding over 152
    # layers, so assert direction/scale (normalized L2), not elementwise
    a, b = np.asarray(f32).ravel(), np.asarray(bf16).ravel()
    rel_l2 = np.linalg.norm(a - b) / np.linalg.norm(a)
    assert rel_l2 < 0.05, rel_l2
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.995, cos
    # and the f32 path is bitwise unchanged by the in-conv cast
    f32_again, _ = resnet.global_features(params, imgs, train_bn=False)
    np.testing.assert_array_equal(np.asarray(f32), np.asarray(f32_again))


def test_random_init_keeps_features_of_order_one(rng):
    """The random backbone starts every residual branch at zero (the last
    BN scale of each block), so its features stay of order one instead of
    growing through 50 blocks with untrained BN statistics."""
    import jax.numpy as jnp
    from icee_tpu.models import resnet

    params = resnet.init_params(jax.random.PRNGKey(3))
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        for blk in params[layer]:
            assert not np.any(np.asarray(blk["bn3"]["weight"]))
            assert np.all(np.asarray(blk["bn2"]["weight"]) == 1.0)
    imgs = jnp.asarray(rng.standard_normal((1, 64, 64, 3)), jnp.float32)
    feats, _ = resnet.global_features(params, imgs, train_bn=False)
    std = float(jnp.std(feats))
    assert np.isfinite(std) and 0.0 < std < 10.0
