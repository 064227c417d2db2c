"""IISPTNet: the IILE indirect-illumination U-Net, in plain lax/jnp.

Exact topology of the reference's PyTorch model (ref: ml/iispt_net.py:6-109):
7->3 channel U-Net on 32x32 hemispherical G-buffers; encoders
K/2K/4K/8K with MaxPool downsamples, LeakyReLU(0.2) + BatchNorm, bilinear
2x upsamples, skip concats, ConvTranspose(3x3, stride 1) decoder blocks,
final 1x1 conv + ReLU.  NHWC layout; inference runs fused inside the
render graph — the reference's per-thread Python child process and
stdio float32 pipe (ref: tools/childprocess.hpp, Doc.md:1-33) disappear
entirely.

The variables are a plain pytree {"params": ..., "batch_stats": ...}
with the layer names Conv_i / ConvTranspose_i / BatchNorm_i numbered in
call order, so committed checkpoints (ml/pretrained/*.npz) load as they
are.  `IISPTNet.init` / `IISPTNet.apply(vars, x, train=...,
mutable=["batch_stats"])` keep the familiar module surface.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax

K = 64
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
_DN = ("NHWC", "HWIO", "NHWC")


def _conv(p, x):
    y = lax.conv_general_dilated(x, p["kernel"], (1, 1), "SAME",
                                 dimension_numbers=_DN)
    return y + p["bias"]


def _conv_transpose(p, x):
    # stride-1 transposed conv with an unflipped kernel
    y = lax.conv_transpose(x, p["kernel"], (1, 1), "SAME",
                           dimension_numbers=_DN)
    return y + p["bias"]


def _lrelu(v):
    return jnp.where(v >= 0, v, 0.2 * v)


def _pool(v):
    return lax.reduce_window(v, -jnp.inf, lax.max, (1, 2, 2, 1),
                             (1, 2, 2, 1), "VALID")


def _up2(v):
    b, h, w, c = v.shape
    return jax.image.resize(v, (b, 2 * h, 2 * w, c), "bilinear")


def _batch_norm(p, stats, x, train):
    """BatchNorm over (N, H, W); returns (y, new running stats)."""
    if train:
        mean = jnp.mean(x, axis=(0, 1, 2))
        var = jnp.maximum(jnp.mean(x * x, axis=(0, 1, 2)) - mean * mean,
                          0.0)
        new = {"mean": BN_MOMENTUM * stats["mean"]
                       + (1.0 - BN_MOMENTUM) * mean,
               "var": BN_MOMENTUM * stats["var"]
                      + (1.0 - BN_MOMENTUM) * var}
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats
    mul = lax.rsqrt(var + BN_EPS) * p["scale"]
    return (x - mean) * mul + p["bias"], new


# (kind, output channels, kernel size) in call order — the order that
# numbers the layers
def _layers(k):
    return (
        ("Conv", k, 3), ("Conv", k, 3), ("Conv", 2 * k, 3), ("BN", 2 * k, 0),
        ("Conv", 2 * k, 3), ("Conv", 4 * k, 3), ("BN", 4 * k, 0),
        ("Conv", 4 * k, 3), ("Conv", 8 * k, 3), ("BN", 8 * k, 0),
        ("Conv", 4 * k, 3), ("ConvTranspose", 4 * k, 3), ("BN", 4 * k, 0),
        ("ConvTranspose", 2 * k, 3), ("ConvTranspose", 2 * k, 3),
        ("BN", 2 * k, 0), ("ConvTranspose", k, 3), ("ConvTranspose", k, 3),
        ("ConvTranspose", k, 3), ("Conv", 3, 1),
    )


@dataclasses.dataclass(frozen=True)
class IISPTNet:
    k: int = K

    def _forward(self, variables, x, train):
        """x: (B, 32, 32, 7) -> ((B, 32, 32, 3), new batch_stats)."""
        params = variables["params"]
        stats = variables.get("batch_stats", {})
        new_stats = {}
        counts = {}

        def name(kind):
            i = counts.get(kind, 0)
            counts[kind] = i + 1
            return f"{kind}_{i}"

        def conv(v):
            return _conv(params[name("Conv")], v)

        def convt(v):
            return _conv_transpose(params[name("ConvTranspose")], v)

        def bn(v):
            n = name("BatchNorm")
            y, new_stats[n] = _batch_norm(params[n], stats[n], v, train)
            return y

        # encoder0 (32x32, 7->K)
        x0 = _lrelu(conv(x))
        x0 = _lrelu(conv(x0))
        # encoder1 (->16x16, 2K)
        x1 = bn(_lrelu(conv(_pool(x0))))
        x1 = _lrelu(conv(x1))
        # encoder2 (->8x8, 4K)
        x2 = bn(_lrelu(conv(_pool(x1))))
        x2 = _lrelu(conv(x2))
        # encoder3 (->4x4 -> up to 8x8, 4K)
        x3 = bn(_lrelu(conv(_pool(x2))))
        x3 = _up2(_lrelu(conv(x3)))
        # decoder0: cat(x3, x2) -> 16x16
        x4 = bn(_lrelu(convt(jnp.concatenate([x3, x2], axis=-1))))
        x4 = _up2(_lrelu(convt(x4)))
        # decoder1: cat(x4, x1) -> 32x32
        x5 = bn(_lrelu(convt(jnp.concatenate([x4, x1], axis=-1))))
        x5 = _up2(_lrelu(convt(x5)))
        # decoder2: cat(x5, x0) -> output
        x6 = _lrelu(convt(jnp.concatenate([x5, x0], axis=-1)))
        x6 = _lrelu(convt(x6))
        return jax.nn.relu(conv(x6)), new_stats

    def init(self, key, x, train: bool = False):
        """Variables for inputs shaped like x: LeCun-normal kernels,
        zero biases, unit BatchNorm scales and running variances."""
        del train
        params, stats = {}, {}
        counts = {}
        cin = x.shape[-1]
        # input channels seen by each layer, following the concats
        skip = {"ConvTranspose_0": 4 * self.k, "ConvTranspose_2": 2 * self.k,
                "ConvTranspose_4": self.k}
        for kind, cout, ks in _layers(self.k):
            i = counts.get(kind, 0)
            counts[kind] = i + 1
            n = f"{'BatchNorm' if kind == 'BN' else kind}_{i}"
            if kind == "BN":
                params[n] = {"scale": jnp.ones(cout), "bias": jnp.zeros(cout)}
                stats[n] = {"mean": jnp.zeros(cout), "var": jnp.ones(cout)}
                continue
            cin += skip.get(n, 0)
            key, sub = jax.random.split(key)
            std = (ks * ks * cin) ** -0.5
            params[n] = {
                "kernel": std * jax.random.truncated_normal(
                    sub, -2.0, 2.0, (ks, ks, cin, cout)) / 0.87962566,
                "bias": jnp.zeros(cout)}
            cin = cout
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x, train: bool = False, mutable=()):
        """Forward pass.  With mutable=["batch_stats"] returns
        (y, {"batch_stats": updated running statistics})."""
        y, new_stats = self._forward(variables, x, train)
        if "batch_stats" in mutable:
            return y, {"batch_stats": new_stats}
        return y


def init_params(key, hemi_size: int = 32, k: int = K):
    net = IISPTNet(k=k)
    variables = net.init(key, jnp.zeros((1, hemi_size, hemi_size, 7)))
    return net, variables
