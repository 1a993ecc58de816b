"""Host-side pieces of the 3xTF32 tensor-core bodies of K8 and K9, on the
CPU.

K8 and K9 split each float32 operand x into hi = tf32(x) and lo =
tf32(x - hi) (round to nearest, ties away from zero: ``cvt.rna.tf32.f32``)
and form a product as lo*hi + hi*lo + hi*hi. K8's weights are split once,
on the host, into the (2, 3, 3, C8, F8) layout the kernel stages. Here: the
rounding against an independent numpy version (bit for bit), the split's
error bound (2^-22 of |x|), a 3-product dot over K = 1008 against float64
(1e-6 of sum |a b|), the packed layout against OIHW, and K9's arithmetic
(``mccnn_volume_tf32x3_plain``) within 1e-4 of the plain volume and of a
float64 one at F = 64 and 112 with the 1e4 mask equal: the tolerance K9
is held to on the card.
"""

import numpy as np
import pytest
import torch

from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K


def _rna_tf32_numpy(x: np.ndarray) -> np.ndarray:
    """Round float32 to 11 significant bits, ties away from zero, through
    frexp in float64 (no bit tricks)."""
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    scaled = m * 2.0 ** 11
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.ldexp(r / 2.0 ** 11, e).astype(np.float32)


def _unpack(packed, C_in, F):
    """The packed layout back to (F, C_in, 3, 3) OIHW, as hi + lo."""
    taps = packed[0, :, :, :C_in, :F] + packed[1, :, :, :C_in, :F]
    return taps.permute(3, 2, 0, 1).contiguous()


def _values(seed, n=20000):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_round_matches_rna_and_keeps_ten_mantissa_bits(seed):
    x = _values(seed)
    hi = K.tf32_round(torch.from_numpy(x))
    bits = hi.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0      # <= 10 mantissa bits
    np.testing.assert_array_equal(hi.numpy(), _rna_tf32_numpy(x))


def test_tf32_round_ties_go_away_from_zero():
    # 1 + 2^-11 and 1 + 3 * 2^-11 lie halfway between TF32 neighbours
    x = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -11 - 2.0 ** -23], np.float32)
    want = np.array([1 + 2.0 ** -10, 1 + 2 * 2.0 ** -10, -(1 + 2.0 ** -10),
                     1.0], np.float32)
    np.testing.assert_array_equal(K.tf32_round(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_reproduces_x(seed):
    x = torch.from_numpy(_values(seed))
    hi, lo = K.tf32_split(x)
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_3xtf32_dot_matches_float64(seed):
    """K = 1008: 9 taps x 112 channels, the accurate tower's C_in = F
    layer. The three TF32 products are exact in float64, as in the tensor
    core; only the dropped lo*lo and the rounding of lo remain."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=1008).astype(np.float32)
    b = (rng.normal(size=1008) / np.sqrt(1008)).astype(np.float32)
    ah, al = (t.double() for t in K.tf32_split(torch.from_numpy(a)))
    bh, bl = (t.double() for t in K.tf32_split(torch.from_numpy(b)))
    got = float((al * bh + ah * bl + ah * bh).sum())
    want = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    scale = float(np.abs(a.astype(np.float64) * b).sum())
    assert abs(got - want) <= 1e-6 * scale
    # one TF32 product alone misses by orders of magnitude more
    assert abs(float((ah * bh).sum()) - want) > 10 * abs(got - want)


@pytest.mark.parametrize("F,C_in", [(64, 64), (112, 112), (32, 1), (128, 128),
                                    (20, 13)])
def test_packed_weights_round_trip_to_oihw(F, C_in):
    rng = np.random.default_rng(F + C_in)
    w = torch.from_numpy((rng.normal(size=(F, C_in, 3, 3)) /
                          np.sqrt(9 * C_in)).astype(np.float32))
    packed = K.mccnn_pack_weights(w)
    C8 = -(-C_in // 8) * 8
    F8 = next(n for n in (32, 64, 112, 128) if n >= F)
    assert packed.shape == (2, 3, 3, C8, F8) and packed.dtype == torch.float32
    taps = K.conv_taps(w)                              # (3, 3, C_in, F)
    hi, lo = K.tf32_split(taps)
    assert torch.equal(packed[0, :, :, :C_in, :F], hi)
    assert torch.equal(packed[1, :, :, :C_in, :F], lo)
    assert not packed[:, :, :, C_in:].any() and not packed[..., F:].any()
    back = _unpack(packed, C_in, F)
    assert back.shape == w.shape
    assert bool(((back.double() - w.double()).abs()
                 <= 2.0 ** -22 * w.double().abs()).all())
    # weights that are TF32 already pack into hi alone and come back exact
    w_tf32 = K.tf32_round(w)
    assert torch.equal(_unpack(K.mccnn_pack_weights(w_tf32), C_in, F),
                       w_tf32)


def test_model_keeps_packed_weights_in_step():
    model = tmccnn.make_model("fast")
    for i in range(model.num_layers):
        want = (K.conv_taps if i == 0 else K.mccnn_pack_weights)(
            model.weights[i])
        assert torch.equal(getattr(model, f"layout{i}"), want)
        assert torch.equal(getattr(model, f"layout{i}"),
                           K.mccnn_weight_layout(model.weights[i]))
    other = tmccnn.make_model("fast")
    other.load_state_dict(model.state_dict())
    with torch.no_grad():
        other.weights[1].mul_(2.0)
    other.relayout()
    assert torch.equal(other.layout1, K.mccnn_pack_weights(other.weights[1]))
    assert not torch.equal(other.layout1, model.layout1)


def test_conv3x3_checks_the_packed_layout():
    x = torch.zeros(2, 64, 8, 40)
    w = torch.zeros(64, 64, 3, 3)
    b = torch.zeros(64)
    with pytest.raises(ValueError, match="layout"):
        K.mccnn_conv3x3(x, w, b, True, False,
                        layout=torch.zeros(2, 3, 3, 64, 112))
    with pytest.raises(ValueError, match="layout"):     # the C_in = 1 copy
        K.mccnn_conv3x3(x, w, b, True, False, layout=K.conv_taps(w))
    y = K.mccnn_conv3x3(x, w, b, True, False,
                        layout=K.mccnn_pack_weights(w))
    assert y.shape == (2, 64, 8, 40) and not y.any()


def _volume64(fl, fr, D, min_d, scale=24.0):
    """The MC-CNN volume in float64 (numpy), 1e4 where x < d."""
    F, H, W = fl.shape
    out = np.full((D, H, W), 1e4)
    for i in range(D):
        d = min_d + i
        if d < W:
            sim = (fl[:, :, d:].astype(np.float64) *
                   fr[:, :, :W - d].astype(np.float64)).sum(0)
            out[i, :, d:] = scale * (1.0 - sim) * 0.5
    return out


@pytest.mark.parametrize("F,min_d", [(64, 0), (112, 3)])
def test_volume_3xtf32_model_matches_plain_and_float64(F, min_d):
    """Unit features (what K9 is held to 1e-4 on, chip_smoke.py's K9_TOL):
    the 3xTF32 band product against the plain float32 channel sum and
    float64."""
    rng = np.random.default_rng(F)
    f = rng.normal(size=(2, F, 7, 70))
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    fl, fr = torch.from_numpy(f.astype(np.float32))
    got = K.mccnn_volume_tf32x3_plain(fl, fr, 40, min_d)
    plain = K.mccnn_volume_plain(fl, fr, 40, min_d)
    want = _volume64(fl.numpy(), fr.numpy(), 40, min_d)
    assert got.shape == (40, 7, 70) and got.dtype == torch.float32
    assert torch.equal(got == 1e4, plain == 1e4)
    np.testing.assert_array_equal(got.numpy() == 1e4, want == 1e4)
    assert float((got - plain).abs().max()) <= 1e-4
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    # one TF32 product alone would not do
    hi = [K.tf32_round(v) for v in (fl, fr)]
    one = K.mccnn_volume_plain(*hi, 40, min_d)
    assert float(np.abs(one.numpy() - want).max()) > 1e-4
