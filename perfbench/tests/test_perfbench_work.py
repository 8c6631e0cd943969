"""The work counts against hand-computed operations and bytes at the
flagship's widths (d_model 80, d_ff 320) and real lengths."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import modelconf, work

D, F = 80, 320


def test_peaks():
    assert work.PEAK_FLOPS == 495e12 and work.PEAK_BYTES == 3.35e12


def test_encoder_and_decoder_at_fifty_positions():
    # Q, K, V 3*50*80*80; scores and P V 2*50*50*80; FF 2*50*80*320
    assert work.encoder_macs(50, D, F) == 960_000 + 400_000 + 2_560_000
    # P V and scores 2*50*80; K, V 2*50*80*80; Q 80*80; FF 2*80*320
    assert work.decoder_macs(50, D, F) == 8_000 + 640_000 + 6_400 + 51_200


def test_real_positions_only():
    assert work.encoder_macs(0, D, F) == 0
    both = work.encoder_macs(np.array([10, 50]), D, F)
    assert both.sum() == work.encoder_macs(10, D, F) + work.encoder_macs(
        50, D, F)


def test_block_train_work():
    ops, nbytes = work.block_train_work([50], D, F)
    assert ops == 6 * (3_920_000 + 705_600)
    weights = 3 * 6400 + 240 + 320 + 25_600 + 320 + 25_600 + 80   # a block
    assert work.block_weights(D, F) == weights
    # enc_in and d_enc 2*50*80; dec_in, out, g, d_dec 4*80; mask 50;
    # two blocks' weights read and their gradients written
    assert nbytes == 4 * (8_000 + 320 + 50 + 4 * weights)


def test_block_serve_work_counts_the_user_once():
    one, _ = work.block_serve_work(50, 1, D, F)
    many, _ = work.block_serve_work(50, 300, D, F)
    per_candidate = 2 * (2 * 50 * 80 + 80 * 80 + 2 * 80 * 320)
    assert many - one == pytest.approx(299 * per_candidate)


def test_trunk_of_the_flagship():
    conf = modelconf.load("dmt")
    n_in = 615 + 80 + 3 * 88 + 3 * 80
    assert n_in == 1199
    experts = 4 * (1199 * 512 + 512 * 256 + 256 * 128)
    assert work.trunk_macs(conf) == experts + 2 * 1199 * 4 + 2 * 4 * 128 + \
        2 * (128 * 32 + 32)
    assert work.bias_macs(conf) == 20 * 32 + 32 * 16 + 16


def test_train_step_is_three_forwards():
    conf = modelconf.load("dmt")
    lens = {f.feature: np.full(4, min(f.max_len, 7)) for f in conf.features}
    fwd = 4 * (3 * (work.encoder_macs(7, D, F) + work.decoder_macs(7, D, F))
               + work.trunk_macs(conf) + work.bias_macs(conf))
    fwd += sum(4 * min(f.max_len, 7) * f.dim
               for f in conf.embeddings + conf.embeddings_bias)
    assert work.train_step_ops(conf, lens) == pytest.approx(6 * fwd)


def test_least_time_takes_the_larger_bound():
    assert work.least_s(495e12, 0) == 1.0
    assert work.least_s(0, 3.35e12) == 1.0
    assert work.least_s(495e12, 6.7e12) == 2.0
