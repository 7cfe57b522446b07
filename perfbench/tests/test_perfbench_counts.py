"""The frozen operation and byte counts at the cells' shapes, against
values worked out by hand."""

import pytest

from perfbench.frozen import work


def test_k2_at_fiqa_batch():
    # B = 3,328, R = 57,728 (57,638 rows in 128-row tiles), F = 2,048.
    ops, nbytes = work.head_work(3328, 57728, 2048, 57728 * 2048)
    assert ops == 2 * 3328 * 57728 * 2048 == 786_918_539_264
    # head 118,226,944 + query 13,631,488 + mask 57,728
    # + scores 768,475,136 + block maxima 4 x 3,328 x 451 = 6,003,712
    assert nbytes == 906_395_008
    bound, side = work.bound_s(ops, nbytes, work.PEAK_BF16_FLOPS)
    assert side == "compute"
    assert bound == pytest.approx(0.795669e-3, rel=1e-5)


def test_k1_at_fiqa_top1000():
    ops, nbytes = work.head_work(3328, 57728, 2048, 57728 * 2048,
                                 blockmax=False)
    assert nbytes == 906_395_008 - 6_003_712
    assert work.bound_s(ops, nbytes, work.PEAK_BF16_FLOPS)[1] == "compute"


def test_k5_at_nq_batch():
    ops, nbytes = work.similarity_work(1024, 2_681_468, 768)
    assert ops == 2 * 1024 * 2_681_468 * 768 == 4_217_584_484_352
    # query 786,432 + corpus 2,059,367,424 + scales 10,729,968
    # + scores 10,983,292,928
    assert nbytes == 13_054_176_752
    bound, side = work.bound_s(ops, nbytes, work.PEAK_INT8_OPS)
    assert side == "bytes"
    assert bound == pytest.approx(3.896769e-3, rel=1e-5)
    assert ops / work.PEAK_INT8_OPS == pytest.approx(2.131169e-3, rel=1e-5)


def test_roofline_pct():
    ops, nbytes = work.similarity_work(1024, 2_681_468, 768)
    bound = work.bound_s(ops, nbytes, work.PEAK_INT8_OPS)[0]
    assert work.roofline_pct(ops, nbytes, work.PEAK_INT8_OPS,
                             2 * bound) == pytest.approx(50.0)
