"""The frozen work arithmetic against hand-worked values at small shapes,
and the model FLOPs against torch's FLOP counter over the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vobench import work


def test_least_time_takes_the_binding_resource():
    assert work.least_s(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert work.least_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert work.least_s(0, 67e12, "f32") == pytest.approx(1.0)
    # 16 transcendental functions a clock on each of 132 SMs at 1.98 GHz
    assert work.least_s(0, 0, "bf16", 16 * 132 * 1.98e9) == \
        pytest.approx(1.0)


def test_corr_counts_by_hand():
    # one edge: 9 pixels x 2 levels x an 8 x 8 window x 128 channels x 2
    assert work.corr_flops(1) == 9 * 2 * 64 * 128 * 2 == 294912
    # NI*T = 2 cells of M = 3 patches, 4 live edges, 1 target and 1 host
    # slot, 8 x 8 maps at 1/4 (2 x 2 at 1/16), bf16
    b = work.corr_lattice_bytes(2, 3, 4, 1, 1, 8, 8, 2)
    assert b == (6 * 882 * 2 + 4 * 72 + 16 + 3 * 9 * 128 * 2
                 + (64 + 4) * 128 * 2)


def test_encoder_fold_counts_by_hand():
    # K2 at 8 x 8, Cx = 8, bf16: scales (16, 64), (32, 16), (64, 4)
    nbytes, flops, sfu = work.lstm_fold_work(8, 8, 8, 2)
    assert nbytes == (64 * 40 * 2 + 4 * (1024 + 128 + 768 + 16)
                      + 16 * 72 * 2 + 4 * (2048 + 256 + 3072 + 32)
                      + 4 * 136 * 2 + 4 * (4096 + 512 + 12288 + 64))
    assert flops == (64 * 2 * (768 + 768) + 16 * 2 * (1536 + 3072)
                     + 4 * 2 * (3072 + 12288))
    assert sfu == 64 * 128 + 16 * 256 + 4 * 512
    # K3 at 8 x 8, Cx = 8, hp = 16, bf16
    nbytes, flops, sfu = work.lstm_carry_fold_work(8, 8, 8, 2)
    assert nbytes == 64 * 88 * 2 + 64 * 80 * 2 + (4 * 4 * 320 + 512) * 2 \
        + 144 * 4 + 8
    assert flops == 64 * (2 * 40 * 128 + 8 * 256)
    assert sfu == 64 * 160


def test_train_corr_counts_by_hand():
    (fb, ff), (bb, bf) = work.corr_train_work(10, 2, 3, 8, 8, 4)
    maps = 2 * (64 + 4) * 128 + 2 * 3 * 9 * 128
    small = 10 * 72 + 80
    assert fb == 10 * 882 * 4 + maps * 4 + small
    assert ff == 10 * 294912
    assert bb == 10 * 882 * 4 + maps * 8 + small
    assert bf == pytest.approx(0.2 * 20 * 9 * 64 * 128 * 4)


def test_update_flops_match_the_counter():
    from vobench.reference.models.update import Update

    NI, T, M = 3, 4, 5
    E = NI * T * M
    with torch.device("meta"):
        up = Update()
        net = torch.zeros(E, 384)
        inp = torch.zeros(E, 384)
        corr = torch.zeros(E, 882)
        ii = jj = kk = torch.zeros(E, dtype=torch.long)
        with FlopCounterMode(display=False) as fc:
            up(net, inp, corr, ii, jj, kk, None, (NI, T, M),
               lattice_contig=True)
    assert fc.get_total_flops() == work.update_flops(E, M, NI)


@pytest.mark.parametrize("mode", ["MultiScale", "SingleScale"])
def test_encoder_flops_are_positive_and_scale_with_size(mode):
    a = work.encoder_flops(mode, 32, 48, 5)
    b = work.encoder_flops(mode, 64, 96, 5)
    assert a > 0 and b == pytest.approx(4 * a, rel=0.05)
