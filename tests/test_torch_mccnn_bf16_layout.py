"""K8's bfloat16 surface on the CPU: its weight layout, its activations'
storage, the wrapper's checks, and a model of its tile's fragment map.

The bfloat16 body (``csrc/mccnn.cu``, ``conv3x3_bf16_kernel``) reads the
(9, F8, C16) bfloat16 taps (``mccnn_pack_weights_bf16``) and bfloat16
channels-last activations, and forms its sums with ``ldmatrix`` and
``mma.m16n8k16``. The card cannot be asked here, so the index maps of the
kernel's fragments are modelled in numpy (``mccnn_conv3x3_bf16_tiled_plain``
and the row maps it uses) and held to a float64 convolution: every sum of
the model must equal it to float64 rounding (1e-12 of the sum of
|products|), on small odd shapes. The plain layer must give the same bits
from a bfloat16 channels-last input as from the float32 input holding the
same values, in both output forms.
"""

import numpy as np
import pytest
import torch

from stereo_match_tpu_torch.models import mccnn as tmccnn
from stereo_match_tpu_torch.ops import cuda_kernels as K


def _weights(F, C_in, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(F, C_in, 3, 3)) /
                             np.sqrt(9 * C_in)).astype(np.float32))


@pytest.mark.parametrize("F,C_in", [(64, 64), (112, 112), (16, 48), (20, 13),
                                    (128, 100)])
def test_bf16_layout_is_the_rounded_taps(F, C_in):
    """(9, F8, C16) bfloat16: [3 ky + kx, f, c] = bf16(w[f, c, ky, kx]),
    zero in the padding; ``mccnn_weight_layout(bf16=True)`` takes it for
    C_in > 1 and the rounded (3, 3, 1, F) taps for C_in = 1."""
    w = _weights(F, C_in, F + C_in)
    packed = K.mccnn_pack_weights_bf16(w)
    F8 = next(n for n in (32, 64, 112, 128) if n >= F)
    C16 = -(-C_in // 16) * 16
    assert packed.shape == (9, F8, C16) and packed.dtype == torch.bfloat16
    taps = K.conv_taps(K.bf16_round(w))                 # (3, 3, C_in, F)
    assert torch.equal(packed[:, :F, :C_in].float(),
                       taps.reshape(9, C_in, F).transpose(1, 2))
    assert not packed[:, F:].float().any()
    assert not packed[:, :, C_in:].float().any()
    assert torch.equal(K.mccnn_weight_layout(w, bf16=True), packed)
    w1 = _weights(F, 1, F)
    assert torch.equal(K.mccnn_weight_layout(w1, bf16=True),
                       K.conv_taps(K.bf16_round(w1)))


@pytest.mark.parametrize("C_in,relu", [(1, True), (16, True), (48, False)])
def test_plain_layer_reads_bf16_channels_last(C_in, relu):
    """The same values as a float32 (V, C, H, W) tensor or a bfloat16
    channels-last one give the same bits, float32 out or bfloat16
    channels-last out (which holds the float32 output's values)."""
    rng = np.random.default_rng(C_in)
    x32 = K.bf16_round(torch.from_numpy(
        rng.normal(size=(2, C_in, 7, 11)).astype(np.float32)))
    x16 = x32.to(torch.bfloat16, memory_format=torch.channels_last)
    assert x16.is_contiguous(memory_format=torch.channels_last)
    w = _weights(16, C_in, 3)
    b = torch.from_numpy(rng.normal(0, 0.1, 16).astype(np.float32))
    want = K.mccnn_conv3x3_plain(x32, w, b, relu, False, bf16=True)
    for x in (x32, x16):
        got = K.mccnn_conv3x3_plain(x, w, b, relu, False, bf16=True)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, want)
        out = K.mccnn_conv3x3(x, w, b, relu, False, bf16=True,
                              bf16_out=True)
        assert out.dtype == torch.bfloat16 and out.shape == want.shape
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(out.float(), want)
    norm = K.mccnn_conv3x3_plain(x16, w, b, False, True, bf16=True)
    assert torch.equal(norm, K.mccnn_conv3x3_plain(x32, w, b, False, True,
                                                   bf16=True))


def test_wrapper_refuses_other_dtypes_and_formats():
    x = torch.zeros(2, 16, 5, 7)
    w, b = torch.zeros(16, 16, 3, 3), torch.zeros(16)
    bad = [
        (x.half(), {"bf16": True}, "float32"),
        (x.to(torch.bfloat16), {"bf16": True}, "channels_last"),
        (x.to(torch.bfloat16, memory_format=torch.channels_last), {},
         "float32"),
        (x.contiguous(memory_format=torch.channels_last), {"bf16": True},
         "contiguous"),
        (x[:, :, :, :5], {"bf16": True}, "contiguous"),
        (x, {"bf16_out": True}, "bf16_out"),
    ]
    for xb, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            K.mccnn_conv3x3(xb, w, b, True, False, **kw)
    with pytest.raises(ValueError, match="bf16_out"):
        K.mccnn_conv3x3(x, w, b, False, True, bf16=True, bf16_out=True)
    with pytest.raises(ValueError, match="bf16_out"):
        K.mccnn_conv3x3_plain(x, w, b, False, True, bf16=True, bf16_out=True)
    with pytest.raises(ValueError, match="layout"):     # float32's layout
        K.mccnn_conv3x3(x, w, b, True, False, layout=K.mccnn_pack_weights(w),
                        bf16=True)


def test_bf16_tower_carries_bf16_channels_last(monkeypatch):
    """In bfloat16, each layer but the last hands the next a bfloat16
    channels-last tensor, the last gives float32 (V, F, H, W): the chain of
    plain float32 layers bit for bit."""
    model = tmccnn.make_model((16, 3), torch.bfloat16, seed=2)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 9, 13)).astype(np.float32))
    seen = []
    conv = tmccnn.mccnn_conv3x3

    def spy(h, *args, **kw):
        seen.append((h.dtype, h.is_contiguous(), kw.get("bf16_out")))
        return conv(h, *args, **kw)

    monkeypatch.setattr(tmccnn, "mccnn_conv3x3", spy)
    got = model(x)
    assert seen == [(torch.float32, True, True),
                    (torch.bfloat16, False, True),
                    (torch.bfloat16, False, False)]
    assert got.dtype == torch.float32 and got.is_contiguous()
    h = x[:, None]
    for i in range(3):
        h = K.mccnn_conv3x3_plain(h, model.weights[i], model.biases[i],
                                  i < 2, i == 2, bf16=True)
    assert torch.equal(got, h)


@pytest.mark.parametrize("tap,k16", [(0, 0), (4, 1), (8, 2)])
def test_fragment_rows_hold_the_mma_operands(tap, k16):
    """On a halo and a layout whose entries name their own indices, the
    ``ldmatrix`` registers of every lane hold the A and B elements that
    ``mma.m16n8k16`` takes there: A[m, k] = halo(row + ky, 16 mt + m + kx)
    channel 16 k16 + k, B[k, n] = layout[tap, output 8 n8 + n, channel
    16 k16 + k]."""
    ky, kx = divmod(tap, 3)
    TH, TW = K.MCCNN_TILE
    C16, F8 = 48, 112
    hy, hx, c = np.meshgrid(np.arange(TH + 2), np.arange(TW + 2),
                            np.arange(C16), indexing="ij")
    halo = (hy * 1000 + hx) * 100.0 + c          # (TH + 2, TW + 2, C16)
    o, c2 = np.meshgrid(np.arange(F8), np.arange(C16), indexing="ij")
    layout = o * 100.0 + c2                      # one tap's (F8, C16)
    g, t = np.divmod(np.arange(32), 4)
    eight = np.arange(8)
    for row in (0, 5, TH - 1):
        for mt in (0, 1):
            ar = K.mccnn_bf16_a_rows(row, mt, tap, k16)
            a = K._ldmatrix(halo[ar[:, 0:1], ar[:, 1:2], ar[:, 2:3] + eight],
                            4)
            for r in range(4):
                for e in range(2):
                    m = g + 8 * (r & 1)
                    k = 2 * t + e + 8 * (r >> 1)
                    want = ((row + ky) * 1000 + 16 * mt + m + kx) * 100.0 \
                        + 16 * k16 + k
                    np.testing.assert_array_equal(a[:, r, e], want)
    for nh, nw in ((0, 8), (1, 7)):
        for n in range(0, nw - 1, 2):
            br = K.mccnn_bf16_b_rows(nh, nw, n, tap, k16)
            b = K._ldmatrix(layout[br[:, 0:1], br[:, 1:2] + eight], 4)
            for j in range(2):
                for r in range(2):
                    for e in range(2):
                        out = 8 * (nh * nw + n + j) + g
                        k = 2 * t + e + 8 * r
                        np.testing.assert_array_equal(
                            b[:, 2 * j + r, e], out * 100.0 + 16 * k16 + k)


@pytest.mark.parametrize("V,F,C_in,H,W", [
    (1, 16, 16, 1, 1), (2, 64, 48, 9, 35), (1, 112, 112, 3, 5),
    (1, 16, 112, 8, 33), (2, 64, 16, 1, 70), (1, 112, 48, 17, 2)])
def test_tile_model_sums_equal_float64_conv(V, F, C_in, H, W):
    """The tile model's float64 sums (halo staging, the (9, F8, C16)
    layout, A and B by ldmatrix, m16n8k16 fragments, the accumulator map)
    equal a float64 convolution to 1e-12 of the sum of |products|."""
    rng = np.random.default_rng(F * C_in + H)
    x = rng.normal(size=(V, C_in, H, W))
    w = rng.normal(size=(F, C_in, 3, 3))
    got = K.mccnn_conv3x3_bf16_tiled_plain(x, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = torch.nn.functional.conv2d(tx, tw, padding=1).numpy()
    scale = torch.nn.functional.conv2d(tx.abs(), tw.abs(), padding=1).numpy()
    assert got.shape == want.shape == (V, F, H, W)
    assert np.all(np.abs(got - want) <= 1e-12 * scale)
