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


# Each configuration's counts through its model module at fixed lengths,
# as the benchmark computed them before the module was put between the
# entries and the counts.  Every count is a sum of whole numbers or one
# division of it, so they are equal on any machine.
PINNED = {
    "dmt": {"train_step_ops": [180576288.0, 159105480.0],
            "request_ops": [1981598400.0, 1988765712.0, 2004562944.0,
                            2012113760.0],
            "train_kernel_s": {"block_s": 2.1192823880597017e-06,
                               "attention_s": 0.0},
            "serve_kernel_s": {"block_s": 2.7540788059701493e-06}},
    "dmt_2block": {"train_step_ops": [285905568.0, 242986440.0],
                   "request_ops": [2085278400.0, 2099608272.0,
                                   2131192704.0, 2146289760.0],
                   "train_kernel_s": {"block_s": 0.0,
                                      "attention_s": 7.988632835820896e-07},
                   "serve_kernel_s": {"block_s": 2.7540788059701493e-06}},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_through_the_model_module_are_pinned(name):
    from perfbench import models

    conf = modelconf.load(name)
    mod = models.of(conf.model_type)

    def lens(picks):
        return {f.feature: np.array([min(f.max_len, x) for x in picks])
                for f in conf.features}

    steps = [lens((1, 7, 23, 50)), lens((3, 10, 50, 0))]
    reqs = [{f.feature: min(f.max_len, k) for f in conf.features}
            for k in (0, 9, 37, 50)]
    want = PINNED[name]
    assert [mod.train_step_ops(conf, s) for s in steps] == \
        want["train_step_ops"]
    assert [mod.request_ops(conf, r, 300) for r in reqs] == want["request_ops"]
    assert mod.train_kernel_s(conf, steps) == want["train_kernel_s"]
    assert mod.serve_kernel_s(conf, reqs, 300) == want["serve_kernel_s"]
